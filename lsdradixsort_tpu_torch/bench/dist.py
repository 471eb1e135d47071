"""The distributed path of the port at full size: each operator of
parallel/ beside the single-chip operator that computes the same result,
on the same data.

    python -m lsdradixsort_tpu_torch.bench.dist [--n 27]

`dist_ops(mesh, keys, qd)` lists them: `dist_sort` and `dist_sort_kv`
(positions as the payload) of `keys` beside `merge_sort_keys` and
`merge_sort_with_ranks`; `dist_digit_histogram` at r = 8, groups 0-3,
beside `torch.bincount` of the digits; and at bench/query.py's data
(`make_data`: n = 10^8, nb = 10^7) `dist_filter_kv`, `dist_group_by_sum`,
`dist_join`, `dist_join_multi` (the many-to-many build side), `dist_top_k`
(k = 1024) and `dist_unique` beside filter_kv, group_by_sum, hash_join,
hash_join_multi, top_k and unique. Each check holds the dist op's output,
on its defined part, against the single-chip op's: rows of this rank,
which at D = 1 are all of them; the joins' rows in the single-chip order
(by probe position, then build rank). `chip_smoke.py` phase 3 runs them
at D = 1 on NCCL and times each (CUDA events, median of 5 after a
warm-up) beside its single-chip op: the ratio is `d1_dist_overhead`, the
dist machinery's cost on one card, not a scaling efficiency. `main`
does the same without the smoke's other phases and prints one JSON line
an op. Both need a card; with D > 1 ranks (under torchrun) each rank's
check would see only its shard, so `main` refuses a world above one.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from lsdradixsort_tpu_torch.bench import query as Q
from lsdradixsort_tpu_torch.bench.flagship import check_keys
from lsdradixsort_tpu_torch.core.convert import (i64_to_u32, iota_u32,
                                                 stable_order)
from lsdradixsort_tpu_torch.core.digits import get_digit
from lsdradixsort_tpu_torch.ops import (filter_kv, group_by_sum, hash_join,
                                        hash_join_multi, top_k, unique)
from lsdradixsort_tpu_torch.ops.sort import (merge_sort_keys,
                                             merge_sort_with_ranks)
from lsdradixsort_tpu_torch.parallel import (dist_digit_histogram,
                                             dist_filter_kv,
                                             dist_group_by_sum, dist_join,
                                             dist_join_multi, dist_sort,
                                             dist_sort_kv, dist_top_k,
                                             dist_unique)

ITERS = 5
HIST_R = 8


@dataclass
class DistOp:
    name: str
    single_name: str
    run: Callable[[], tuple]        # the dist op
    single: Callable[[], tuple]     # the single-chip op
    check: Callable[[tuple, tuple], None]   # (dist out, single out)


def _same(got, want, label: str) -> None:
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        check_keys(g, w, f"{label} output {i}")


def _prefix(label: str, order=None):
    """Check of (count, *cols) against the single op's (count, *cols) on
    [:count]; `order(cols)` puts the dist rows in the single order."""
    def check(got, want):
        c = int(want[0])
        if int(got[0].reshape(())) != c:
            raise AssertionError(f"{label}: count {int(got[0].reshape(()))}"
                                 f", want {c}")
        cols = [g[:c] for g in got[1:]]
        if order is not None:
            cols = order(cols)
        _same(cols, [w[:c] for w in want[1:]], label)
    return check


def _by_probe(cols):
    """dist_join's (keys, probe_vals, build_vals, probe_pos) in probe
    order: (keys, probe_vals, build_vals), hash_join's columns."""
    perm = torch.sort(cols[3].view(torch.int32)).indices  # pos < 2^31
    return [c.view(torch.int32)[perm].view(torch.uint32) for c in cols[:3]]


def _by_probe_then_build(cols):
    """dist_join_multi's (keys, probe_pos, probe_vals, build_vals,
    build_rank) in the single-chip order: (keys, probe_vals,
    build_vals)."""
    perm = stable_order([cols[1], cols[4]])
    return [c.view(torch.int32)[perm].view(torch.uint32)
            for c in (cols[0], cols[2], cols[3])]


def _histograms(keys: torch.Tensor, r: int) -> tuple:
    """Every digit group's histogram at r, by torch.bincount."""
    return tuple(i64_to_u32(torch.bincount(
        get_digit(keys, r, g).to(torch.int64), minlength=1 << r))
        for g in range(4))


def dist_ops(mesh, keys: torch.Tensor, qd: dict) -> list[DistOp]:
    """The dist operators on `keys` (sorts, histograms) and on
    bench/query.py's data `qd`, each with its single-chip op and check.
    `keys` and the columns of `qd` are this rank's shards."""
    n = keys.shape[0]
    pos = iota_u32(n, keys.device)
    nq = qd["n"]
    return [
        DistOp("dist_sort", "merge_sort_keys",
               lambda: (dist_sort(keys, mesh),),
               lambda: (merge_sort_keys(keys),),
               lambda g, w: _same(g, w, "dist_sort")),
        DistOp("dist_sort_kv", "merge_sort_with_ranks",
               lambda: dist_sort_kv(keys, pos, mesh),
               lambda: merge_sort_with_ranks(keys),
               lambda g, w: _same(g, w, "dist_sort_kv")),
        DistOp("dist_digit_histogram", "torch.bincount",
               lambda: tuple(dist_digit_histogram(keys, HIST_R, g, mesh)
                             for g in range(4)),
               lambda: _histograms(keys, HIST_R),
               lambda g, w: _same(g, w, "dist_digit_histogram")),
        DistOp("dist_filter_kv", "filter_kv",
               lambda: dist_filter_kv(qd["keys"], qd["vals"], Q.LO, Q.HI,
                                      mesh),
               lambda: filter_kv(qd["keys"], qd["vals"], Q.LO, Q.HI),
               _prefix("dist_filter_kv")),
        DistOp("dist_group_by_sum", "group_by_sum xla",
               lambda: dist_group_by_sum(qd["keys"], qd["vals"], mesh),
               lambda: group_by_sum(qd["keys"], qd["vals"], engine="xla"),
               _prefix("dist_group_by_sum")),
        DistOp("dist_join", "hash_join merge",
               lambda: dist_join(qd["bkeys"], qd["bvals"], qd["pkeys"],
                                 qd["vals"], mesh),
               lambda: hash_join(qd["bkeys"], qd["bvals"], qd["pkeys"],
                                 qd["vals"], engine="merge"),
               _prefix("dist_join", _by_probe)),
        DistOp("dist_join_multi", "hash_join_multi xla",
               lambda: dist_join_multi(qd["bkeys_m"], qd["bvals"],
                                       qd["pkeys"], qd["vals"], mesh,
                                       max_out=2 * nq),
               lambda: hash_join_multi(qd["bkeys_m"], qd["bvals"],
                                       qd["pkeys"], qd["vals"],
                                       max_out=2 * nq),
               _prefix("dist_join_multi", _by_probe_then_build)),
        DistOp("dist_top_k", "top_k",
               lambda: dist_top_k(qd["tkeys"], Q.TOP_K, mesh),
               lambda: top_k(qd["tkeys"], Q.TOP_K),
               lambda g, w: _same(g, w, "dist_top_k")),
        DistOp("dist_unique", "unique",
               lambda: dist_unique(qd["keys"], mesh),
               lambda: unique(qd["keys"]), _prefix("dist_unique")),
    ]


def main(argv=None) -> int:
    from lsdradixsort_tpu_torch.core.datagen import random_keys
    from lsdradixsort_tpu_torch.core.timing import card_label, time_fn
    from lsdradixsort_tpu_torch.parallel import make_mesh
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=27,
                    help="log2 keys of the sorts and histograms")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dist: no CUDA device", file=sys.stderr)
        return 1
    mesh = make_mesh()
    if mesh.size != 1:
        print("dist: compares against one card; run it on a world of one",
              file=sys.stderr)
        return 1
    card = card_label()
    try:
        ops = dist_ops(mesh, random_keys(1 << args.n, 0, mesh.device),
                       Q.make_data(mesh.device))
        for op in ops:
            op.check(op.run(), op.single())
            t = time_fn(op.run, iters=ITERS)
            t1 = time_fn(op.single, iters=ITERS)
            print(json.dumps({"op": op.name, "single": op.single_name,
                              "devices": mesh.size, "ms": t.ms,
                              "single_ms": t1.ms,
                              "d1_dist_overhead": t.ms / t1.ms,
                              "card": card}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
