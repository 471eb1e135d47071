"""Hash-aggregate operators, GROUP BY key -> reduce(values) — the port of
lsdradixsort_tpu/ops/aggregate.py (north star config 3: "filter + hash
aggregate (GROUP BY SUM) over 100M-row columnar batch").

Sort-based, as in the JAX package: sort the rows by group key, mark the
run boundaries, reduce each run by differences of a running sum at the
run ends, and compact the boundary rows to the front (ops/filter.py
`compact`). Sums are mod 2^32, so they are exact whatever the order; the
running sum is the port's `exclusive_scan` (kernels/scan.py) plus the row.
`filtered_group_by_sum` does those steps after its sort in one pass on
the card (kernels/aggregate.py), the same sequence on the CPU.

engine="xla" is a stable `torch.sort` where the JAX package calls
`lax.sort`; engine="merge" is the port's framework sort (both through
ops/sort.py `_sort_rows`). Both give the same result.
Outputs keep the input's length: the first num_groups rows are defined.
"""
from __future__ import annotations

import torch

from lsdradixsort_tpu_torch.core import keycodec
from lsdradixsort_tpu_torch.core.convert import (iota_u32, u32_to_i64,
                                                 wrap_u32)
from lsdradixsort_tpu_torch.core.profiling import annotate
from lsdradixsort_tpu_torch.kernels.aggregate import filtered_run_sums
from lsdradixsort_tpu_torch.kernels.scan import exclusive_scan
from lsdradixsort_tpu_torch.ops.filter import compact, range_mask
from lsdradixsort_tpu_torch.ops.sort import _sort_rows

_SIGN = -(1 << 31)      # 0x80000000 as int32 bits
_REDUCTIONS = ("sum", "min", "max", "count")


def running_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of uint32 x, mod 2^32."""
    return wrap_u32(u32_to_i64(exclusive_scan(x)) + u32_to_i64(x))


def run_differences(run_end_sums: torch.Tensor) -> torch.Tensor:
    """Each run's sum from the running sums at consecutive run ends (the
    first run's from 0), mod 2^32."""
    v = u32_to_i64(run_end_sums)
    return wrap_u32(v - torch.nn.functional.pad(v[:-1], (1, 0)))


def differs_from_next(x: torch.Tensor) -> torch.Tensor:
    """True at the last row of each run of equal values of x."""
    b = x.view(torch.int32) if x.dtype == torch.uint32 else x
    return torch.cat([b[1:] != b[:-1], b.new_ones(1, dtype=torch.bool)])


def starts_run(x: torch.Tensor) -> torch.Tensor:
    """True at the first row of each run of equal values of x."""
    last = differs_from_next(x)
    return torch.cat([last.new_ones(1), last[:-1]])


def group_by_sum(group_keys: torch.Tensor, values: torch.Tensor,
                 engine: str = "xla", tile_log2: int = 15):
    """GROUP BY group_keys SUM(values): (num_groups, unique_keys_sorted,
    sums); the first num_groups rows are the result."""
    return group_by_aggregate(group_keys, values, reduction="sum",
                              engine=engine, tile_log2=tile_log2)


def group_by_aggregate(group_keys: torch.Tensor, values: torch.Tensor,
                       reduction: str = "sum", engine: str = "xla",
                       tile_log2: int = 15):
    """GROUP BY with reduction in {"sum", "min", "max", "count"}.

    Group keys may be u32/i32/f32 (groups come back sorted in that dtype's
    order). Values may be u32/i32 for sum (i32 sums wrap as two's
    complement mod 2^32) and u32/i32/f32 for min/max. f32 SUM raises
    TypeError: float addition is not associative, so no bit-exact
    order-independent sum exists."""
    if reduction not in _REDUCTIONS:
        raise ValueError(f"unknown reduction {reduction!r}")
    with annotate("lsd.group_by_aggregate"):
        kdt, vdt = group_keys.dtype, values.dtype
        codes = keycodec.encode(group_keys)
        if reduction == "sum":
            if vdt == torch.float32:
                raise TypeError("f32 SUM is order-dependent; no bit-exact "
                                "spelling (cast to int or use min/max/count)")
            values = values.view(torch.uint32)
        elif reduction in ("min", "max"):
            values = keycodec.encode(values)

        if reduction == "count":
            sk = _sort_rows(codes, engine=engine, tile_log2=tile_log2)[0]
            count, uk, run_end = compact(differs_from_next(sk), sk,
                                         iota_u32(sk.shape[0], sk.device))
            ends = u32_to_i64(run_end)
            # the run before the first ends at position -1
            before = torch.nn.functional.pad(ends[:-1], (1, 0), value=-1)
            return count, keycodec.decode(uk, kdt), wrap_u32(ends - before)
        # a sum needs no order among a group's values: the xla engine
        # sorts by the key alone
        sk, (sv,), _ = _sort_rows(codes, [values], (), engine, tile_log2,
                                  key_only=reduction == "sum")
        if reduction == "sum":
            count, uk, run_end_sums = compact(differs_from_next(sk), sk,
                                              running_sum(sv))
            return (count, keycodec.decode(uk, kdt),
                    run_differences(run_end_sums).view(vdt))
        if reduction == "min":
            # sorted by (key, value): a run's min is its first value
            count, uk, agg = compact(starts_run(sk), sk, sv)
        else:
            count, uk, agg = compact(differs_from_next(sk), sk, sv)
        return count, keycodec.decode(uk, kdt), keycodec.decode(agg, vdt)


def filtered_group_by_sum(keys: torch.Tensor, group_keys: torch.Tensor,
                          values: torch.Tensor, lo, hi, engine: str = "xla",
                          tile_log2: int = 15):
    """BASELINE config 3 as one plan: SELECT group, SUM(value) WHERE
    lo <= key < hi GROUP BY group, with one sort.

    Rejected rows get the group key 0xFFFFFFFF and the tag bit 31 in a
    packed (tag << 31) | position column, which is compared after the key:
    a real group 0xFFFFFFFF still aggregates, its kept rows sorting before
    the rejected ones. After the sort, the running sum, the run ends,
    their compaction and their sums' differences are one pass
    (kernels/aggregate.py `filtered_run_sums`). Returns (num_groups,
    unique_group_keys_sorted, sums). n < 2^31."""
    with annotate("lsd.filtered_group_by_sum"):
        n = keys.shape[0]
        with annotate("lsd.agg.mask"):
            keep = range_mask(keys, lo, hi)
            gk = torch.where(keep, group_keys.view(torch.int32),
                             -1).view(torch.uint32)
            packed = (keep.logical_not().to(torch.int32) * _SIGN
                      | torch.arange(n, dtype=torch.int32, device=keys.device)
                      ).view(torch.uint32)
            del keep
        sk, (spacked,), (sv,) = _sort_rows(gk, [packed], [values], engine,
                                           tile_log2)
        del gk, packed
        with annotate("lsd.agg.runs"):
            return filtered_run_sums(sk, spacked, sv)
