"""Filter / selection operators — the port of lsdradixsort_tpu/ops/filter.py
(north star config 3, BASELINE.json).

Outputs keep the input's length, as in the JAX package: ops return the
count of selected rows and full-length columns whose first `count` rows
are the selected rows in input order; the tail is unspecified.

  * `compact(mask, *arrays)`: from 2^15 rows up, every 32-bit column
    moves as its uint32 bits (a view, never a conversion) through the
    streaming compaction (kernels/compaction.py `_compact_rows`, one
    launch a group of 8 columns), which takes any n, so nothing is padded
    (the JAX package pads to a multiple of 2^15 with mask-0 rows; the
    defined rows are the same), and gives the count; below that, a stable
    `torch.sort` by the negated mask, as `lax.sort` is mapped elsewhere.
  * `filter_keys`, `filter_kv`: range selection lo <= key < hi.
  * `filter_in_set`, `filter_not_in_set`: IN / NOT IN a set of unique
    uint32 keys, through the hash table's semi probe
    (kernels/hash_table.py); when a chain overflows the planned depth the
    membership is a `searchsorted` over the sorted set instead, as the
    JAX package's `lax.cond` does (here one host sync on `ok`).

Counts are 0-dim uint32 tensors on the input's device.
"""
from __future__ import annotations

import torch

from lsdradixsort_tpu_torch.core.convert import (gather, i64_to_u32,
                                                 u32_to_i64)
from lsdradixsort_tpu_torch.core.profiling import host_value
from lsdradixsort_tpu_torch.kernels.compaction import (TILE, _compact_rows,
                                                       selected)
from lsdradixsort_tpu_torch.kernels.hash_table import (build_table,
                                                       plan_rows,
                                                       probe_table)


def _bits_u32(a: torch.Tensor) -> torch.Tensor:
    """Any 32-bit column as its uint32 bits (identity for uint32)."""
    if a.element_size() == 4:
        return a.contiguous().view(torch.uint32)
    raise TypeError(f"compact moves 32-bit columns, got {a.dtype}")


def compact(mask: torch.Tensor, *arrays):
    """Stable compaction: rows where mask is set move to the front, in
    order. Returns (count, *compacted_arrays); rows past count are
    unspecified."""
    sel = selected(mask)
    n = sel.shape[0]
    if arrays and n >= TILE:
        count, packed = _compact_rows(sel, [_bits_u32(a) for a in arrays])
        return (count, *(p.view(a.dtype) for p, a in zip(packed, arrays)))
    count = i64_to_u32(sel.sum())
    if not arrays:
        return (count,)
    order = torch.sort(sel.logical_not().to(torch.uint8), stable=True).indices
    return (count, *(gather(a, order) for a in arrays))


def range_mask(keys: torch.Tensor, lo, hi) -> torch.Tensor:
    """lo <= key < hi, with lo and hi taken in the keys' dtype (uint32
    keys compare as unsigned)."""
    if keys.dtype == torch.uint32:
        k = u32_to_i64(keys)
        lo, hi = int(lo) & 0xFFFFFFFF, int(hi) & 0xFFFFFFFF
        return (k >= lo) & (k < hi)
    lo = torch.as_tensor(lo).to(device=keys.device, dtype=keys.dtype)
    hi = torch.as_tensor(hi).to(device=keys.device, dtype=keys.dtype)
    return (keys >= lo) & (keys < hi)


def filter_keys(keys: torch.Tensor, lo, hi):
    """Range selection, order-preserving: (count, packed_keys)."""
    return compact(range_mask(keys, lo, hi), keys)


def filter_kv(keys: torch.Tensor, values: torch.Tensor, lo, hi):
    """Range selection over key-value rows: (count, keys, values)."""
    return compact(range_mask(keys, lo, hi), keys, values)


def _in_set_mask(keys: torch.Tensor, set_keys: torch.Tensor) -> torch.Tensor:
    """Membership of each uint32 key in set_keys: the hash table's semi
    probe, or a searchsorted over the sorted set when a chain overflows
    the planned depth."""
    nset = set_keys.shape[0]
    tk, tv, cnt, ok = build_table(set_keys, set_keys, plan_rows(nset))
    if host_value(ok):
        match, _ = probe_table(tk, tv, cnt, keys, semi=True)
        return match.view(torch.int32) == 1
    ss = torch.sort(u32_to_i64(set_keys)).values
    k = u32_to_i64(keys)
    idx = torch.searchsorted(ss, k).clamp(0, nset - 1)
    return ss[idx] == k


def filter_in_set(keys: torch.Tensor, set_keys: torch.Tensor, *values):
    """IN-list semi-join filter: rows whose key is in `set_keys` (unique
    uint32 keys), order-preserving. Returns (count, keys, *values)."""
    return compact(_in_set_mask(keys, set_keys), keys, *values)


def filter_not_in_set(keys: torch.Tensor, set_keys: torch.Tensor, *values):
    """NOT IN anti-join filter: rows whose key is not in `set_keys`.
    Returns (count, keys, *values)."""
    return compact(_in_set_mask(keys, set_keys).logical_not(), keys, *values)
