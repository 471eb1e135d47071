"""The merge-path partition alone on one card: the device time of each of
its launches, from a trace, beside its CUDA-event time.

    python -m lsdradixsort_tpu_torch.bench.partition [--only TEXT]
        [--out FILE]

The partition (kernels/merge.py `merge_path_splits`, and
`merge_runs_splits` for one range of the chunked sort's final pass) runs
on the inputs the main paths give it:

  * the keys passes of `merge_sort_keys` at 2^27: uniform keys (seed 0)
    sorted in runs of 2^15, 2^18, 2^21 and 2^24 rows;
  * the key+pos passes of `merge_sort_with_ranks`, the same runs with
    each row's position as the second compared word;
  * the 64-bit chain's ncmp = 3 passes at run 2^15 and 2^24: (hi, lo,
    position) of 2^27 (hi, lo) planes (seeds 11, 12);
  * the two ranges of the 2^30 chunked pass: 8 runs of 2^27 sorted keys
    (seed 11) with their global positions, tables of 2^19-row chunks
    (`merge_tables_exact_runs`), 2 ranges.

Each case is checked bit for bit against its plain version, then timed
(`ms`: the median of 5 CUDA-event timings after a warm-up), then traced
with torch.profiler (`launches`: [kernel, device ms] of each launch of
one call in launch order, the best of 3 traces; `busy_ms` their sum).
Prints one JSON line a case; --out writes them all as a JSON list. There
is no CPU fallback: without a CUDA device it fails.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

import torch

from lsdradixsort_tpu_torch.core.convert import (i64_to_u32, row_order,
                                                 take_rows)
from lsdradixsort_tpu_torch.core.datagen import random_keys
from lsdradixsort_tpu_torch.core.timing import card_label, time_fn
from lsdradixsort_tpu_torch.kernels import merge as M

N = 1 << 27
N30 = 1 << 30
ITERS = 5


def trace_launches(fn, tries: int = 3) -> list:
    """[kernel name, device ms] of every launch of one traced fn(): of
    `tries` traces, the one that caught the most launches (a trace may
    miss some)."""
    from torch.profiler import ProfilerActivity, profile
    best = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda e: e.time_range.start)
        if len(kernels) > len(best):
            best = [[e.name[:80], e.time_range.elapsed_us() / 1e3]
                    for e in kernels]
    return best


def runs_of(streams, run):
    """The streams sorted in runs of `run` rows by all their words."""
    perm = row_order(streams, run)
    return [take_rows(s, perm) for s in streams]


def cases(dev) -> dict:
    """name -> (kernel call, plain call), inputs made at first use."""
    @functools.cache
    def keys():
        return random_keys(N, 0, dev)

    @functools.cache
    def iota():
        return torch.arange(N, dtype=torch.int32, device=dev).view(
            torch.uint32)

    @functools.cache
    def planes():
        return random_keys(N, 11, dev), random_keys(N, 12, dev)

    @functools.cache
    def sorted_runs(what, run):
        streams = {"keys": lambda: [keys()],
                   "key+pos": lambda: [keys(), iota()],
                   "hi+lo+pos": lambda: [*planes(), iota()]}[what]()
        return runs_of(streams, run)

    @functools.cache
    def pass_2_30():
        big = random_keys(N30, 11, dev)
        seg = N30 // 8
        runs = [[], []]
        for s in range(8):
            k, idx = torch.sort(big[s * seg:(s + 1) * seg].view(torch.int32)
                                ^ -(1 << 31), stable=True)
            runs[0].append((k ^ -(1 << 31)).view(torch.uint32))
            runs[1].append(i64_to_u32(idx + s * seg))
        del big
        tab = M.merge_tables_exact_runs(runs[0], 1 << 19)[0].cpu()
        return runs, tab

    out = {}
    for what, ncmp, runs in (("keys", 1, (15, 18, 21, 24)),
                             ("key+pos", 2, (15, 18, 21, 24)),
                             ("hi+lo+pos", 3, (15, 24))):
        for lg in runs:
            def call(fn, what=what, ncmp=ncmp, run=1 << lg):
                s = sorted_runs(what, run)
                return fn(s[0], s[1:], run, ncmp)
            out[f"merge_path_splits {what} ncmp={ncmp} run=2^{lg} "
                f"n=2^27"] = (
                functools.partial(call, M.merge_path_splits),
                functools.partial(call, M.merge_path_splits_plain))
    nch = N30 >> 19
    for ri in range(2):
        part = dict(chunk0=ri * nch // 2, nchunks=nch // 2,
                    chunk_elems=1 << 19)

        def call(fn, part=part):
            runs, tab = pass_2_30()
            return fn(runs, tab, **part)
        out[f"merge_runs_splits key+pos 2^30 pass range {ri} of 2"] = (
            functools.partial(call, M.merge_runs_splits),
            functools.partial(call, M.merge_runs_splits_plain))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="run only the cases whose names hold this text")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the records here as a JSON list")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("partition: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_label()
    records = []
    for name, (fn, plain) in cases(dev).items():
        if args.only not in name:
            continue
        got, want = fn(), plain()
        if not torch.equal(got, want):
            bad = int((got != want).any(dim=1).sum())
            raise AssertionError(f"{name}: {bad} table rows differ from the "
                                 f"plain version")
        del want
        launches = trace_launches(fn)
        rec = {"case": name, "ms": time_fn(fn, iters=ITERS).ms,
               "launches": launches,
               "busy_ms": sum(ms for _, ms in launches),
               "boundaries": int(got.shape[0]), "card": card}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
