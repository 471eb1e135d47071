"""SELECT l_group, SUM(c) for each value column c WHERE lo <= l_shipdate
< hi GROUP BY l_group ORDER BY l_group, sums mod 2^32: (count, group
keys, [sums a column]), by boolean indexing, torch.unique and index_add_
in int64, as bench/query.py's reference does."""
from __future__ import annotations

import torch

from portbench.reference._u32 import from_i64, rows_differ, to_i64


def _groups(a: dict, dtype):
    d = to_i64(a["l_shipdate"])
    keep = (d >= 0) & (d < a["hi"])
    uk, inv = torch.unique(to_i64(a["l_group"])[keep], return_inverse=True)
    sums = []
    for v in a["values"].values():
        s = torch.zeros(uk.shape[0], dtype=dtype, device=uk.device
                        ).index_add_(0, inv, to_i64(v)[keep].to(dtype))
        if dtype.is_floating_point:
            s = s.round().to(torch.int64)
        sums.append(from_i64(s))
    return uk.shape[0], from_i64(uk), sums


def expect(a: dict):
    return _groups(a, torch.int64)


def control(a: dict):
    """The sums accumulated in float32, in the program's answer's form."""
    count, uk, sums = _groups(a, torch.float32)
    return tuple((torch.tensor(count), uk, s) for s in sums)


def compare(got, want) -> dict:
    """Summed over the value columns: the count's gap, and the rows whose
    group key or sum differs (a missing answer's rows all differ)."""
    count, uk, sums = want
    out = {"count_diff": 0, "group_mismatches": 0}
    for j, s in enumerate(sums):
        if j >= len(got):
            out["count_diff"] += count
            out["group_mismatches"] += count
            continue
        out["count_diff"] += abs(int(got[j][0]) - count)
        out["group_mismatches"] += rows_differ(list(got[j][1:3]), [uk, s],
                                               count)
    return out
