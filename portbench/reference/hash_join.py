"""Inner equi-join of lineitem (probe) with orders (build, unique keys) on
the u32 order key: (count, l_orderkey, l_extendedprice, o_orderdate) of
the matching lineitem rows, in lineitem order. A build row is found by a
search over the sorted build keys, as bench/query.py's reference does."""
from __future__ import annotations

import torch

from portbench.reference._u32 import rows_differ, take, to_i64


def _join(bk, bv, pk, pv, dtype):
    """The join with keys compared in `dtype` (int64: exactly)."""
    sb, order = torch.sort(to_i64(bk).to(dtype))
    p = to_i64(pk).to(dtype)
    at = torch.searchsorted(sb, p).clamp(max=sb.shape[0] - 1)
    hit = sb[at] == p
    bval = take(bv, order[at])
    del sb, p
    return (int(hit.sum()), take(pk, hit), take(pv, hit),
            take(bval, hit))


def expect(a: dict):
    return _join(a["o_orderkey"], a["o_orderdate"], a["l_orderkey"],
                 a["l_extendedprice"], torch.int64)


def control(a: dict):
    """Keys compared as float32, whose step above 2^24 joins a lineitem
    row to a neighbouring order."""
    count, *cols = _join(a["o_orderkey"], a["o_orderdate"], a["l_orderkey"],
                         a["l_extendedprice"], torch.float32)
    return (torch.tensor(count), *cols)


def compare(got, want) -> dict:
    count = int(got[0])
    return {"count_diff": abs(count - want[0]),
            "row_mismatches": rows_differ(list(got[1:4]), list(want[1:4]),
                                          want[0])}
