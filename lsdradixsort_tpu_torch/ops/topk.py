"""Top-K and DISTINCT operators — the port of lsdradixsort_tpu/ops/topk.py.

  * `top_k`: histogram-guided selection. One digit histogram of the high
    byte of the key codes (kernels/histogram.py) finds the smallest bin
    threshold that holds the k-th order statistic; one compaction
    (ops/filter.py `compact`) extracts the survivors; a sort of at most
    B = max(4k, 2^15) rows finishes. When the threshold bin is fat
    (skewed keys) it sorts everything instead, as the JAX package's
    `lax.cond` does (here one host sync).
  * `unique`: sort, then compaction of the run starts, with the count of
    each distinct key.

Both take u32/i32/f32 keys through core/keycodec.py.
"""
from __future__ import annotations

import torch

from lsdradixsort_tpu_torch.core import keycodec
from lsdradixsort_tpu_torch.core.convert import (iota_u32, stable_order,
                                                 u32_to_i64, wrap_u32)
from lsdradixsort_tpu_torch.core.profiling import host_value
from lsdradixsort_tpu_torch.kernels.histogram import digit_histogram
from lsdradixsort_tpu_torch.ops.aggregate import starts_run
from lsdradixsort_tpu_torch.ops.filter import compact
from lsdradixsort_tpu_torch.ops.sort import _sort_rows, sort_with_ranks

_UNIQUE_MERGE_ROWS = 1 << 17   # below it, unique sorts with torch.sort


def top_k(keys: torch.Tensor, k: int, largest: bool = True):
    """The k extreme keys and their original indices (uint32), sorted, ties
    broken by position (stable). largest=True gives the k largest in
    descending order, False the k smallest ascending."""
    n = keys.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"k={k} must be in 1..{n}")
    # codes whose k smallest, ascending, are the answer
    codes = keycodec.encode(keys, descending=largest)
    budget = min(max(4 * k, 1 << 15), n)
    fast = budget < n and n % 128 == 0
    if fast:
        hist = u32_to_i64(digit_histogram(codes, 8, 3))   # high byte
        cum = torch.cumsum(hist, 0)
        t = torch.argmax((cum >= k).to(torch.int32))     # threshold bin
        fast = host_value(cum[t] <= budget)
    if fast:
        survive = (u32_to_i64(codes) >> 24) <= t
        cnt, ck, ci = compact(survive, codes, iota_u32(n, codes.device))
        live = torch.arange(budget, device=codes.device) < u32_to_i64(cnt)
        # the compaction's tail sorts after every survivor: both words
        # max (a survivor's code may itself be 0xFFFFFFFF; its position
        # is below n, so it still wins the tie)
        ck = torch.where(live, ck[:budget].view(torch.int32), -1)
        ci = torch.where(live, ci[:budget].view(torch.int32), -1)
        order = stable_order([ck.view(torch.uint32),
                              ci.view(torch.uint32)])[:k]
        sk, perm = ck[order].view(torch.uint32), ci[order].view(torch.uint32)
    else:
        sk, perm = sort_with_ranks(codes)
        sk, perm = sk[:k], perm[:k]
    return keycodec.decode(sk, keys.dtype, descending=largest), perm


def unique(keys: torch.Tensor):
    """Sorted distinct keys with their counts: (n_unique, unique_keys,
    counts); the first n_unique rows are defined. keys u32/i32/f32."""
    n = keys.shape[0]
    codes = keycodec.encode(keys)
    engine = "merge" if n >= _UNIQUE_MERGE_ROWS else "xla"
    sk = _sort_rows(codes, engine=engine)[0]
    cnt, uk, starts = compact(starts_run(sk), sk, iota_u32(n, sk.device))
    start = u32_to_i64(starts)
    # each run ends where the next starts; the last defined run at n
    nxt = torch.cat([start[1:], start.new_full((1,), n)])
    nxt = torch.where(torch.arange(n, device=sk.device)
                      == u32_to_i64(cnt) - 1, n, nxt)
    return cnt, keycodec.decode(uk, keys.dtype), wrap_u32(nxt - start)
