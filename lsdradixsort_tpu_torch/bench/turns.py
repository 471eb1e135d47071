"""Time this checkout's tile sorts, histograms, compactions, merge-path
partitions, merge passes and merge sorts in turns with another
checkout's, on one card.

    python -m lsdradixsort_tpu_torch.bench.turns OTHER [--out FILE]
        [--only TEXT]

OTHER is the root of another checkout of the repo (an earlier commit
unpacked with `git archive` into a gitignored directory). Each turn is a
process of its own that imports one checkout's package, builds that
checkout's kernels into its own build directory, and runs the cases below
through the package's public wrappers, so nothing here depends on either
checkout's C interface. The turns run in the order other, this, this,
other. Every output is hashed, and the four turns must agree bit for bit.

Cases, on uniform keys made here from seeds (and all-equal keys): the
keys-only, key+pos and key+pos+payload tile sorts of 2^27 rows at the
2^15-row tile, and key+pos with three riders (the records' sort_lex
passes); the histograms of 2^27 uniform and all-equal keys at
r = 8, 4, 2, 1, block 2^13; the flagship's histogram of 2^30 keys at
r = 4, block 512; the compaction (`compact_stream_multi`) of the query
path's 10^8 rows padded to a multiple of 2^15 under random masks of
density 0.25 (2, 3, 9 and 16 streams), 1, 0.01 and 0 (2 streams), its
output hashed on the defined rows only; the merge-path partition
(`merge_path_splits`) of the keys passes of 2^27 uniform keys (seed 0)
sorted in runs of 2^15, 2^18, 2^21 and 2^24 rows, of those keys with
their positions (key+pos) at runs of 2^15 and 2^24, and of the 64-bit
chain's (hi, lo, position) at ncmp = 3 and run 2^15; the partition of one
range of merge_runs_splits on each of the two ranges of the 2^30 pass (8
runs of 2^27 sorted keys, seed 11, with their positions; tables of
2^19-row chunks); the merge passes themselves (`merge_pass_multi`) on
the same inputs: keys alone at runs of 2^15, 2^18, 2^21 and 2^24 rows,
key+pos at 2^15 and 2^24, key+pos+payload (a rider, seed 2) and the
64-bit chain's (hi, lo, position) at ncmp = 3 at 2^15; `merge_pass_runs`
on each of the two ranges of the 2^30 pass; merge_sort_keys and
merge_sort_with_ranks of the 2^27 keys. Each case's time is the median
of 5 CUDA-event timings after a warm-up. Prints one line a case; --out
writes every turn's times as JSON; --only runs the cases whose names
hold TEXT.
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ITERS = 5


def worker(only: str) -> dict:
    """One turn: the cases whose names hold `only`, on the package found
    on sys.path; returns {case: {"ms", "hash"}} with the package's path."""
    import torch

    import lsdradixsort_tpu_torch as pkg
    from lsdradixsort_tpu_torch.core.convert import row_order, take_rows
    from lsdradixsort_tpu_torch.kernels import compaction as CP
    from lsdradixsort_tpu_torch.kernels import histogram as H
    from lsdradixsort_tpu_torch.kernels import merge as M
    from lsdradixsort_tpu_torch.kernels import tile_sort as TS
    from lsdradixsort_tpu_torch.ops.sort import (merge_sort_keys,
                                                 merge_sort_with_ranks)

    dev = torch.device("cuda")

    def keys_of(n, seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                             device=dev, generator=g).view(torch.uint32)

    def median_ms(fn):
        fn()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(ITERS)]
        for start, end in events:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)

    def digest(out):
        h = hashlib.blake2b()
        stack = [out]
        while stack:
            x = stack.pop(0)
            if isinstance(x, torch.Tensor):
                h.update(x.contiguous().view(torch.int32).cpu().numpy()
                         .tobytes())
            else:
                stack[:0] = list(x)
        return h.hexdigest()

    # inputs, made at a case's first (untimed) call, so that --only makes
    # only those its cases read
    @functools.cache
    def sort_data():
        n = 1 << 27
        return {"keys": keys_of(n, 0),
                "iota": torch.arange(n, dtype=torch.int32,
                                     device=dev).view(torch.uint32),
                "pay": keys_of(n, 2),
                "pay2": keys_of(n, 3),
                "pay3": keys_of(n, 5),
                "all-equal": torch.full((n,), 0x5EEDBEEF, dtype=torch.int32,
                                        device=dev).view(torch.uint32),
                "big": keys_of(1 << 30, 11)}

    @functools.cache
    def compaction_data(p):
        g = torch.Generator(device=dev)
        g.manual_seed(21)
        m = torch.rand(npad, generator=g, device=dev) < p
        return m, int(m.sum())

    @functools.cache
    def streams():
        return [keys_of(npad, 20 + i) for i in range(16)]

    def compacted(p, k):
        m, cnt = compaction_data(p)
        return [o[:cnt] for o in CP.compact_stream_multi(m, streams()[:k])]

    # the merge passes' inputs: the streams sorted in runs of `run` rows
    @functools.cache
    def merge_runs(what, run):
        n = 1 << 27
        cols = {"keys": lambda: [d()["keys"]],
                "key+pos": lambda: [d()["keys"], d()["iota"]],
                "key+pos+payload": lambda: [d()["keys"], d()["iota"],
                                            d()["pay"]],
                "hi+lo+pos": lambda: [keys_of(n, 11), keys_of(n, 12),
                                      d()["iota"]]}[what]()
        perm = row_order(cols, run)
        return [take_rows(c, perm) for c in cols]

    @functools.cache
    def pass_2_30():
        seg = 1 << 27
        runs = [[], []]
        for s_ in range(8):
            k, idx = torch.sort(d()["big"][s_ * seg:(s_ + 1) * seg]
                                .view(torch.int32) ^ -(1 << 31), stable=True)
            runs[0].append((k ^ -(1 << 31)).view(torch.uint32))
            runs[1].append((idx + s_ * seg).to(torch.int32)
                           .view(torch.uint32))
        return runs, M.merge_tables_exact_runs(runs[0], 1 << 19)[0].cpu()

    def splits(what, ncmp, run):
        cols = merge_runs(what, run)
        return M.merge_path_splits(cols[0], cols[1:], run, ncmp)

    def merge_pass(what, ncmp, run):
        cols = merge_runs(what, run)
        return M.merge_pass_multi(cols[0], cols[1:], run, ncmp)

    def range_pass(ri):
        runs, tab = pass_2_30()
        nch = (1 << 30) >> 19
        return M.merge_pass_runs(runs, tab, chunk0=ri * nch // 2,
                                 nchunks=nch // 2, chunk_elems=1 << 19,
                                 buf_elems=M.DEF_BUF)

    def range_splits(ri):
        runs, tab = pass_2_30()
        nch = (1 << 30) >> 19
        return M.merge_runs_splits(runs, tab, chunk0=ri * nch // 2,
                                   nchunks=nch // 2, chunk_elems=1 << 19)

    tile_rows = (1 << 15) // TS.LANES
    npad = -(-100_000_000 // CP.TILE) * CP.TILE
    d = sort_data
    cases = {
        "sort_tiles keys n=2^27":
            lambda: TS.sort_tiles(d()["keys"], tile_rows),
        "sort_tiles_kv key+pos n=2^27":
            lambda: TS.sort_tiles_kv(d()["keys"], d()["iota"], tile_rows),
        "sort_tiles_multi key+pos+payload n=2^27":
            lambda: TS.sort_tiles_multi(d()["keys"], [d()["iota"],
                                                      d()["pay"]],
                                        tile_rows),
        "sort_tiles_multi key+pos+3 payloads n=2^27":
            lambda: TS.sort_tiles_multi(
                d()["keys"], [d()["iota"], d()["pay"], d()["pay2"],
                              d()["pay3"]], tile_rows)}
    for fam in ("uniform", "all-equal"):
        for r in (8, 4, 2, 1):
            cases[f"histogram {fam} r={r} block=2^13 n=2^27"] = (
                lambda fam=fam, r=r: H.block_digit_histograms(
                    d()["keys" if fam == "uniform" else fam], r, 0, 1 << 13))
    cases["histogram uniform r=4 block=512 n=2^30"] = (
        lambda: H.block_digit_histograms(d()["big"], 4, 0, 512))
    for p, ks in ((0.25, (2, 3, 9, 16)), (1.0, (2,)), (0.01, (2,)),
                  (0.0, (2,))):
        for k in ks:
            cases[f"compact_stream_multi p={p} streams={k} n={npad}"] = (
                lambda p=p, k=k: compacted(p, k))
    for what, ncmp, runs in (("keys", 1, (15, 18, 21, 24)),
                             ("key+pos", 2, (15, 24)),
                             ("hi+lo+pos", 3, (15,))):
        for lg in runs:
            cases[f"merge_path_splits {what} ncmp={ncmp} run=2^{lg} "
                  f"n=2^27"] = (lambda what=what, ncmp=ncmp, lg=lg:
                                splits(what, ncmp, 1 << lg))
    for ri in range(2):
        cases[f"merge_runs_splits key+pos 2^30 pass range {ri} of 2"] = (
            lambda ri=ri: range_splits(ri))
    for what, ncmp, runs in (("keys", 1, (15, 18, 21, 24)),
                             ("key+pos", 2, (15, 24)),
                             ("key+pos+payload", 2, (15,)),
                             ("hi+lo+pos", 3, (15,))):
        for lg in runs:
            cases[f"merge_pass_multi {what} ncmp={ncmp} run=2^{lg} "
                  f"n=2^27"] = (lambda what=what, ncmp=ncmp, lg=lg:
                                merge_pass(what, ncmp, 1 << lg))
    for ri in range(2):
        cases[f"merge_pass_runs key+pos 2^30 pass range {ri} of 2"] = (
            lambda ri=ri: range_pass(ri))
    cases["merge_sort_keys n=2^27"] = lambda: merge_sort_keys(d()["keys"])
    cases["merge_sort_with_ranks n=2^27"] = (
        lambda: merge_sort_with_ranks(d()["keys"]))
    res = {name: {"ms": median_ms(fn), "hash": digest(fn())}
           for name, fn in cases.items() if only in name}
    return {"package": str(Path(pkg.__file__).resolve().parent),
            "cases": res}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--out", type=Path, default=None,
                    help="write every turn's times here as JSON")
    ap.add_argument("--only", default="",
                    help="run only the cases whose names hold this text")
    args = ap.parse_args(argv)
    this = Path(__file__).resolve().parents[2]
    other = args.other.resolve()
    turns = []
    for label, root in (("other", other), ("this", this), ("this", this),
                        ("other", other)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             args.only],
            cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            print(f"turns: the {label} turn ({root}) failed:\n"
                  f"{proc.stderr[-4000:]}", file=sys.stderr)
            return 1
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        if Path(turn["package"]) != root / "lsdradixsort_tpu_torch":
            print(f"turns: the {label} turn imported {turn['package']}, not "
                  f"{root}'s package", file=sys.stderr)
            return 1
        turns.append((label, turn["cases"]))
    label = card()
    bad = 0
    for name in turns[0][1]:
        hashes = {cases[name]["hash"] for _, cases in turns}
        ms = [cases[name]["ms"] for _, cases in turns]
        agree = "bit exact" if len(hashes) == 1 else "OUTPUTS DIFFER"
        bad += len(hashes) != 1
        print(f"time other / this in turns, {name}: other {ms[0]:.3f} / "
              f"{ms[3]:.3f} ms, this {ms[1]:.3f} / {ms[2]:.3f} ms; {agree} "
              f"({label})")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": label, "order": [lb for lb, _ in turns],
             "other": str(other), "this": str(this),
             "turns": [cases for _, cases in turns]}, indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        # import the package of the checkout this turn runs in (cwd and
        # PYTHONPATH), not this file's own
        sys.path.pop(0)
        print(json.dumps(worker(sys.argv[2])))
        sys.exit(0)
    sys.exit(main())
