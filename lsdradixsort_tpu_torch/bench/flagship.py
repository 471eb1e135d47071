"""Flagship benchmark of the port: full-sort throughput on one CUDA card.

The counterpart of the root ``bench.py``. Workload: the reference's own
flagship, N = 2^27 uniform random uint32 keys (512 MB, seed 0), sorted
keys-only with `merge_sort_keys` and as a stable sort returning original
positions with `merge_sort_with_ranks`; plus `torch.sort` of the same
keys (stable, values and int64 indices) as the library bar. Times are
CUDA-event medians of ITERS = 5 runs of device work (core/timing.py).
Baseline: the reference's best full GPU LSD sort, 0.400 Gelem/s
(BASELINE.md:27).

Before the result line it prints three more JSON lines (one per record):

  * {"record": "sort_with_ranks_chunked", ...}: the chip-scale chunked
    sort (ops/bigsort.py) of N30 = 2^30 keys (seed 11) as 8 segments of
    2^27, chunk_log2 = 19, 2 ranges: device ms of each phase (segment
    sorts, tables, each range, the trim) from CUDA events, the total, the
    peak device memory, and whether the output verified (`RankedRanges`:
    sorted, a permutation, stable, keys[ranks] equal, without a 2^30
    sort);
  * the same for `sort_kv_chunked` with a uint32 payload (seed 12);
  * {"record": "sort64_with_ranks", "ms": {strategy: ...}}: the 64-bit
    stable sort of 2^27 (hi, lo) planes (seeds 11, 12) with "merge" (one
    ncmp = 3 chain), "merge2" (two passes) and "xla" (two stable
    torch.sorts), each verified against a stable torch.sort of the int64
    words (the JAX package's runner.py:186-206 suite).

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
import time

import torch

from lsdradixsort_tpu_torch.core.convert import order_key, u32_to_i64
from lsdradixsort_tpu_torch.core.datagen import random_keys
from lsdradixsort_tpu_torch.core.timing import card_label, time_fn
from lsdradixsort_tpu_torch.ops import bigsort
from lsdradixsort_tpu_torch.ops.sort import merge_sort_keys, \
    merge_sort_with_ranks, sort, sort64_with_ranks

REFERENCE_GELEMS_PER_S = 0.400  # BASELINE.md best full-sort config
N = 1 << 27
N30 = 1 << 30
SEGMENTS = 8
CHUNK_LOG2 = 19
NRANGES = 2
ITERS = 5
SEED = 0
_SIGN = -(1 << 31)
_SLICE = 1 << 26    # rows a checker step converts to int64 at once


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


class RankedRanges:
    """Checks the range-chunked output of a stable sort of `keys` (with
    `vals` riding) range by range, without a sort of its own: every
    (key, rank) pair strictly above the one before it, across ranges too
    (sorted, and stable with unique ranks within ties), every rank seen
    once (a permutation, with the row count), keys[ranks] equal to the
    sorted keys and vals[ranks] to the sorted vals. Device flags are
    ANDed and read once, by `finish`. `feed(ri, outs)` fits a
    range_consumer; outs = [keys, ranks(, vals)]."""

    def __init__(self, keys: torch.Tensor, vals: torch.Tensor | None = None):
        self.keys, self.vals = keys, vals
        self.seen = torch.zeros(keys.shape[0], dtype=torch.bool,
                                device=keys.device)
        self.ok = torch.ones((), dtype=torch.bool, device=keys.device)
        self.rows = 0
        self.last = None        # (key, rank) of the last row fed, int64

    def feed(self, ri, outs) -> None:
        sk, sr = outs[0], outs[1]
        for a in range(0, sk.shape[0], _SLICE):
            k = u32_to_i64(sk[a:a + _SLICE])
            r = u32_to_i64(sr[a:a + _SLICE])
            kk, rr = k, r
            if self.last is not None:
                kk = torch.cat([self.last[0], k])
                rr = torch.cat([self.last[1], r])
            tie = kk[1:] == kk[:-1]
            self.ok &= ((kk[1:] > kk[:-1]) | (tie & (rr[1:] > rr[:-1]))).all()
            self.seen[r] = True
            self.ok &= (self.keys.view(torch.int32)[r]
                        == sk[a:a + _SLICE].view(torch.int32)).all()
            if self.vals is not None:
                self.ok &= (self.vals.view(torch.int32)[r]
                            == outs[2][a:a + _SLICE].view(torch.int32)).all()
            self.last = (k[-1:], r[-1:])
            self.rows += k.shape[0]

    def finish(self, label: str) -> None:
        """Raise unless every range fed checked and the ranks are a
        permutation of the rows."""
        if self.rows != self.keys.shape[0]:
            raise AssertionError(f"{label}: {self.rows} rows out, "
                                 f"{self.keys.shape[0]} in")
        if not bool(self.ok & self.seen.all()):
            raise AssertionError(f"{label}: not the stable sort (order, "
                                 f"permutation or keys[ranks] failed)")


def chunked_record(keys: torch.Tensor, vals: torch.Tensor | None,
                   card: str) -> dict:
    """One traced run of the chunked sort of `keys` (SEGMENTS segments;
    with `vals`, sort_kv_chunked, else sort_with_ranks_chunked) after a
    small warm-up: device ms of each phase from the phase marks of
    ops/bigsort.py, the total, the wall time, the peak device memory
    above what was held, then the output verified range by range."""
    L = keys.shape[0] // SEGMENTS
    kw = dict(chunk_log2=CHUNK_LOG2, nranges=NRANGES)
    name = "sort_kv_chunked" if vals is not None else "sort_with_ranks_chunked"
    warm = keys[:SEGMENTS << 21]
    bigsort.sort_kv_chunked(list(warm.split(1 << 21)),
                            None if vals is None
                            else list(vals[:SEGMENTS << 21].split(1 << 21)),
                            **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    bigsort.TRACE = []
    t0 = time.perf_counter()
    start.record()
    try:
        outs = bigsort.sort_kv_chunked(
            list(keys.split(L)),
            None if vals is None else list(vals.split(L)), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        marks = bigsort.TRACE
    finally:
        bigsort.TRACE = None
    peak = torch.cuda.max_memory_allocated()
    phases, prev = {}, start
    for label, ev in marks:
        key = "segment sorts" if label.startswith("segment") else label
        phases[key] = phases.get(key, 0.0) + prev.elapsed_time(ev)
        prev = ev
    total = start.elapsed_time(marks[-1][1])
    check = RankedRanges(keys, vals)
    for ri in range(NRANGES):
        check.feed(ri, [o[ri] for o in outs])
    del outs
    check.finish(name)
    return {"record": name, "n": keys.shape[0], "segments": SEGMENTS,
            "chunk_log2": CHUNK_LOG2, "nranges": NRANGES, "verified": True,
            "phases_ms": phases, "total_ms": total, "wall_ms": wall * 1e3,
            "melem_s": keys.shape[0] / total / 1e3,
            "peak_gib": (peak - held) / 2**30, "held_gib": held / 2**30,
            "card": card}


def sort64_keys(hi: torch.Tensor, lo: torch.Tensor):
    """Stable torch.sort of the uint64 words (hi, lo) as int64 values whose
    signed order is the unsigned one: (sorted hi, sorted lo, int64
    positions)."""
    idx = torch.sort(order_key([hi, lo]), stable=True).indices
    return hi.view(torch.int32)[idx], lo.view(torch.int32)[idx], idx


def sort64_record(card: str) -> dict:
    """sort64_with_ranks of 2^27 uniform (hi, lo) planes with each
    strategy: verified against `sort64_keys`, then timed."""
    hi, lo = random_keys(N, 11, "cuda"), random_keys(N, 12, "cuda")
    wh, wl, widx = sort64_keys(hi, lo)
    out = {}
    for strategy in ("merge", "merge2", "xla"):
        gh, gl, gp = sort64_with_ranks(hi, lo, strategy=strategy)
        check_keys(gh, wh.view(torch.uint32), f"sort64 {strategy} hi")
        check_keys(gl, wl.view(torch.uint32), f"sort64 {strategy} lo")
        if not torch.equal(u32_to_i64(gp), widx):
            raise AssertionError(f"sort64 {strategy}: positions differ")
        del gh, gl, gp
        out[strategy] = time_fn(lambda s=strategy: sort64_with_ranks(
            hi, lo, strategy=s), iters=ITERS).ms
    return {"record": "sort64_with_ranks", "n": N, "verified": True,
            "ms": out, "melem_s": {s: N / ms / 1e3 for s, ms in out.items()},
            "merge_over_merge2": out["merge"] / out["merge2"], "card": card}


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
    big = random_keys(N30, 11, device="cuda")
    print(json.dumps(chunked_record(big, None, card)))
    print(json.dumps(chunked_record(big, random_keys(N30, 12, device="cuda"),
                                    card)))
    del big
    print(json.dumps(sort64_record(card)))
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
