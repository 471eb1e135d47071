"""Flagship benchmark of the port: full-sort throughput on one CUDA card.

The counterpart of the root ``bench.py``. Workload: the reference's own
flagship, N = 2^27 uniform random uint32 keys (512 MB, seed 0), sorted
keys-only with `merge_sort_keys` and as a stable sort returning original
positions with `merge_sort_with_ranks`; plus `torch.sort` of the same
keys (stable, values and int64 indices) as the library bar. Times are
CUDA-event medians of ITERS = 5 runs of device work (core/timing.py).
Baseline: the reference's best full GPU LSD sort, 0.400 Gelem/s
(BASELINE.md:27).

The last line on stdout is one JSON object:
  {"metric": "sort_throughput", "value": <keys Melem/s>, "unit": "Melem/s",
   "vs_baseline": ..., "kv_value": ..., "kv_vs_baseline": ..., "n": ...,
   "torch_sort_value": ..., "device": <card name>, "card": <name, power
   limit>}

  python -m lsdradixsort_tpu_torch.bench.flagship [--verify] [--profile]

--verify first checks both sorts against `torch.sort` on the card: keys
bit for bit, and for the ranks sorted keys, keys[ranks] == sorted keys, a
permutation, and strictly ascending ranks within equal keys (stability,
as bench.py:240-252). --profile then traces one more run of each sort,
and of the composed LSD radix sort (`sort(strategy="composed")`, block
2^13) at r = 4 and r = 8, with torch.profiler and prints, before the
result line, one JSON line per sort: {"profile": <sort>, "kernels":
count, "busy_ms", "span_ms", "idle_share", "top": [[kernel, ms, calls],
...], "card"}. The timed runs are untraced. There is no CPU fallback:
without a CUDA device it fails.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from lsdradixsort_tpu_torch.core.convert import u32_to_i64
from lsdradixsort_tpu_torch.core.datagen import random_keys
from lsdradixsort_tpu_torch.core.timing import card_label, time_fn
from lsdradixsort_tpu_torch.ops.sort import merge_sort_keys, \
    merge_sort_with_ranks, sort

REFERENCE_GELEMS_PER_S = 0.400  # BASELINE.md best full-sort config
N = 1 << 27
ITERS = 5
SEED = 0
_SIGN = -(1 << 31)


def torch_sort_u32(keys: torch.Tensor):
    """Stable `torch.sort` of uint32 keys: (sorted uint32, int64 positions).
    Sorts the sign-flipped int32 view, whose order is the uint32 order."""
    vals, idx = torch.sort(keys.view(torch.int32) ^ _SIGN, stable=True)
    return (vals ^ _SIGN).view(torch.uint32), idx


def check_keys(got: torch.Tensor, want: torch.Tensor, label: str) -> None:
    """Raise unless two uint32 tensors are equal bit for bit."""
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        bad = (got.view(torch.int32) != want.view(torch.int32)).nonzero()
        raise AssertionError(f"{label}: {bad.numel()} of {want.numel()} "
                             f"rows differ, first at {int(bad[0])}")


def check_ranks(keys: torch.Tensor, sk: torch.Tensor, sr: torch.Tensor,
                want_sorted: torch.Tensor, label: str) -> None:
    """Raise unless (sk, sr) is the stable sort of keys with positions."""
    check_keys(sk, want_sorted, f"{label} keys")
    ranks = u32_to_i64(sr)
    n = keys.shape[0]
    if not torch.equal(torch.sort(ranks).values,
                       torch.arange(n, device=ranks.device)):
        raise AssertionError(f"{label}: ranks are not a permutation")
    check_keys(keys.view(torch.int32)[ranks].view(torch.uint32), sk,
               f"{label} keys[ranks]")
    same = sk.view(torch.int32)[1:] == sk.view(torch.int32)[:-1]
    if not bool((~same | (ranks[1:] > ranks[:-1])).all()):
        raise AssertionError(f"{label}: ranks not ascending within ties")


def profile_kernels(label: str, fn, *args, top: int = 16) -> dict:
    """Trace one run of fn(*args): device time per kernel and the idle
    share of the span from the first kernel's start to the last kernel's
    end."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"profile": label, "kernels": 0}
    start = min(e.time_range.start for e in kernels)
    end = max(e.time_range.end for e in kernels)
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict = {}
    for e in kernels:
        ms, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, cnt + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"profile": label, "kernels": len(kernels), "busy_ms": busy / 1e3,
            "span_ms": (end - start) / 1e3,
            "idle_share": 1 - busy / max(end - start, 1),
            "top": [[kname[:110], ms, cnt] for kname, (ms, cnt) in ranked]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flagship: no CUDA device", file=sys.stderr)
        return 1
    keys = random_keys(N, SEED, device="cuda")
    if args.verify:
        want, _ = torch_sort_u32(keys)
        check_keys(merge_sort_keys(keys), want, "merge_sort_keys")
        sk, sr = merge_sort_with_ranks(keys)
        check_ranks(keys, sk, sr, want, "merge_sort_with_ranks")
        print("# verify: keys and stable ranks OK")
    card = card_label()
    if args.profile:
        for label, fn in (("merge_sort_keys", merge_sort_keys),
                          ("merge_sort_with_ranks", merge_sort_with_ranks),
                          ("torch.sort", torch_sort_u32),
                          ("sort composed r=4",
                           lambda k: sort(k, strategy="composed", r=4)),
                          ("sort composed r=8",
                           lambda k: sort(k, strategy="composed", r=8))):
            print(json.dumps({**profile_kernels(label, fn, keys),
                              "card": card}))
    t_keys = time_fn(merge_sort_keys, keys, iters=ITERS)
    t_kv = time_fn(merge_sort_with_ranks, keys, iters=ITERS)
    t_torch = time_fn(torch_sort_u32, keys, iters=ITERS)
    g, gkv = t_keys.gelems_per_s(N), t_kv.gelems_per_s(N)
    print(json.dumps({
        "metric": "sort_throughput", "value": g * 1e3, "unit": "Melem/s",
        "vs_baseline": g / REFERENCE_GELEMS_PER_S,
        "kv_value": gkv * 1e3, "kv_vs_baseline": gkv / REFERENCE_GELEMS_PER_S,
        "n": N, "torch_sort_value": t_torch.gelems_per_s(N) * 1e3,
        "device": torch.cuda.get_device_name(0), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
