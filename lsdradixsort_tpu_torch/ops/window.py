"""Window rank functions — the port of lsdradixsort_tpu/ops/window.py:
ROW_NUMBER / RANK / DENSE_RANK OVER (PARTITION BY p ORDER BY k [DESC]).

One `sort_lex` pass groups rows by partition and orders them (ties by
input position); the row of each partition's start and of each
(partition, order value) run's start comes from the fill-forward kernel
(kernels/fill_forward.py), as in the JAX package; per-row arithmetic
gives the rank; and the ranks go back to input row order. The JAX package
inverts the permutation with a sort by it (scatter-free on the TPU); the
port stores each rank at its row's original position, one indexed write
that uses every destination once.
"""
from __future__ import annotations

import torch

from lsdradixsort_tpu_torch.core import keycodec
from lsdradixsort_tpu_torch.core.convert import i64_to_u32, u32_to_i64
from lsdradixsort_tpu_torch.kernels.fill_forward import fill_forward_last
from lsdradixsort_tpu_torch.ops.sort import sort_lex

_METHODS = ("row_number", "rank", "dense_rank")


def window_rank(partition_keys: torch.Tensor, order_keys: torch.Tensor,
                method: str = "row_number", descending: bool = False,
                strategy: str = "merge", tile_log2: int = 15) -> torch.Tensor:
    """1-based ranks in INPUT ROW ORDER (uint32), SQL semantics:

      * row_number — position within the partition (ties by input order);
      * rank       — competition ranking: ties share the rank of their
                     first row; the next distinct value skips past them;
      * dense_rank — ties share a rank; no gaps.

    partition_keys / order_keys: u32/i32/f32 columns (core/keycodec.py);
    `descending` orders the ORDER BY column. strategy as in sort_lex.
    """
    if method not in _METHODS:
        raise ValueError(f"method {method!r}: pick from {_METHODS}")
    n = partition_keys.shape[0]
    dev = partition_keys.device
    (sp, sk), perm = sort_lex([partition_keys, order_keys],
                              descending=(False, descending),
                              strategy=strategy, tile_log2=tile_log2)
    # boundary detection on raw bits: any total order groups partitions
    spb = keycodec.encode(sp).view(torch.int32)
    skb = keycodec.encode(sk, descending).view(torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    is_pstart = torch.cat([one, spb[1:] != spb[:-1]])
    spb = spb.view(torch.uint32)
    _, pstart, _ = fill_forward_last(is_pstart, spb, pos)
    if method == "row_number":
        rank = u32_to_i64(pos) - u32_to_i64(pstart)
    else:
        is_pairstart = is_pstart | torch.cat([one, skb[1:] != skb[:-1]])
        if method == "rank":
            _, pairstart, _ = fill_forward_last(is_pairstart, spb, pos)
            rank = u32_to_i64(pairstart) - u32_to_i64(pstart)
        else:  # dense_rank: distinct order values at or before the row in
            # its partition = the count of run starts, rebased at the
            # partition's start
            c = torch.cumsum(is_pairstart, 0)
            _, c_at_pstart, _ = fill_forward_last(is_pstart, spb,
                                                  i64_to_u32(c))
            rank = c - u32_to_i64(c_at_pstart)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    out[u32_to_i64(perm)] = i64_to_u32(rank + 1).view(torch.int32)
    return out.view(torch.uint32)
