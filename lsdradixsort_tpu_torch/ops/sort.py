"""Sort operators — the port of lsdradixsort_tpu/ops/sort.py's flagship
family.

The framework sort ("merge", the default) is a per-tile sort
(kernels/tile_sort.py) into sorted runs of 2^tile_log2 rows followed by
8-way merge passes (kernels/merge.py), each a hand-written CUDA kernel
on a CUDA tensor and its plain PyTorch version on a CPU tensor. Inputs
are padded with 0xFFFFFFFF sentinels to a power-of-two tile count, so
every pass sees whole groups.

  * `merge_sort_keys`: keys only (the reference's workload).
  * `merge_sort_with_ranks`: stable sort returning original positions.
  * `merge_sort_multi`: (key, payload 0) order with more payloads riding.
  * `sort`, `sort_kv`, `sort_with_ranks`, `argsort`: u32/i32/f32 keys,
    ascending or descending, through the order-preserving codecs of
    core/keycodec.py.
  * `sort_lex`: stable multi-column sort, one stable pass per column,
    least significant first.
  * `sort_records`: stable sort of fixed-width binary records (an (n, R)
    uint8 tensor) by their leading key bytes in memcmp order: the key
    bytes as big-endian u32 words (core/keycodec.py `encode_bytes`),
    `sort_lex` of the words, then one gather of whole rows
    (kernels/records.py `gather_records`).
  * `sort64_with_ranks`: stable sort of 64-bit keys given as (hi, lo)
    u32 planes: "merge" is one tile sort + merge chain comparing
    (hi, lo, position) (the kernels' ncmp = 3), "merge2" two stable
    passes, low plane then high.
  * `sort_blocks_kv`: the (key, value) sort within each block, on the
    tile sort kernel.

Strategy "xla" — `jax.lax.sort` in the JAX package — is a stable
`torch.sort` of the codes here, as are the other places where the JAX
package sorts with `lax.sort` by design (the sentinel-collision path of
`merge_sort_multi`, non-32-bit payloads in `sort_kv`, `sort_with_ranks`).
The JAX package's in-graph skew fallbacks (a pass whose tables overflow
sorts with `lax.sort`) have nothing to guard: the port's merge has no
capacity.

Strategy "composed" is the LSD radix pipeline, one stable pass per r-bit
digit group, with the reference's pass structure (GPULSDRadixSort,
LSDRadixSort.cu:845-906): per-block digit histograms
(kernels/histogram.py), each block's exclusive digit offsets (the scan of
its histogram row, kernels/scan.py `block_scans`), the digit-major
transpose of the histogram (kernels/transpose.py) and its global
exclusive scan (`exclusive_scan`), then a stable rank and scatter. The
JAX package writes the local scan and the transpose as jnp (sort.py:523,
:527); the port runs them through the ported kernels, as the reference
does. The rank and scatter stay torch glue, as they are jnp there: a
stable per-block sort of the digits, gathers, and one indexed store that
uses every destination once.

The JAX engine's TPU tuning knobs (max_buf, blk, ce, pipeline) are
accepted for API parity and change nothing. The port's merge has no
buffer capacity, so there is no skew fallback: `skew_fallback=False`
keeps the (x, ok) return of `merge_sort_keys`, with ok always True.
"""
from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from lsdradixsort_tpu_torch.core import keycodec
from lsdradixsort_tpu_torch.core.convert import (gather, i64_to_u32,
                                                 iota_u32, stable_order,
                                                 u32_to_i64)
from lsdradixsort_tpu_torch.core.digits import get_digit, num_digit_groups
from lsdradixsort_tpu_torch.core.profiling import (COUNTS, annotate,
                                                   host_value)
from lsdradixsort_tpu_torch.kernels.histogram import block_digit_histograms
from lsdradixsort_tpu_torch.kernels.merge import (KWAY, MAX_STREAMS,
                                                  merge_pass, merge_pass_kv,
                                                  merge_pass_multi)
from lsdradixsort_tpu_torch.kernels.records import gather_records
from lsdradixsort_tpu_torch.kernels.scan import block_scans, exclusive_scan
from lsdradixsort_tpu_torch.kernels.tile_sort import (LANES, sort_tiles,
                                                      sort_tiles_kv,
                                                      sort_tiles_multi)
from lsdradixsort_tpu_torch.kernels.transpose import transpose_any

_STRATEGIES = ("merge", "xla", "composed")


def _padded_size(n: int, tile: int) -> int:
    """Power-of-2 tile count: every pass's run length (tile * 8^k) must
    divide the padded size."""
    return tile * (1 << max(0, (-(-n // tile) - 1).bit_length()))


def _pad(x: torch.Tensor, npad: int) -> torch.Tensor:
    """x followed by 0xFFFFFFFF sentinels up to npad rows."""
    if npad == x.shape[0]:
        return x
    fill = torch.full((npad - x.shape[0],), -1, dtype=torch.int32,
                      device=x.device)
    return torch.cat([x.view(torch.int32), fill]).view(torch.uint32)


def merge_sort_keys(keys: torch.Tensor, tile_log2: int = 15,
                    max_buf: int | None = None, blk: int | None = None,
                    skew_fallback: bool = True, ce: str = "reshape",
                    pipeline="full"):
    """The framework sort of (n,) uint32 keys: tile sort + 8-way merge
    passes. Any n >= 1. Returns the sorted keys, or (sorted, True) with
    skew_fallback=False (see the module docstring)."""
    n = keys.shape[0]
    tile = 1 << tile_log2
    npad = _padded_size(n, tile)
    with annotate("lsd.merge_sort"):
        x = sort_tiles(_pad(keys, npad), tile_rows=tile // LANES)
        run = tile
        while run < npad:
            x = merge_pass(x, run)
            run *= KWAY
        x = x[:n]
    return x if skew_fallback else (x, True)


def merge_sort_with_ranks(keys: torch.Tensor, tile_log2: int = 15,
                          max_buf: int | None = None, blk: int | None = None,
                          ce: str = "reshape", pipeline="full"):
    """Framework stable kv sort: returns (sorted_keys, original_positions).

    The row index rides through the tile sort and every merge pass and
    breaks every tie, which makes the whole pipeline stable."""
    n = keys.shape[0]
    tile = 1 << tile_log2
    npad = _padded_size(n, tile)
    # pad rows carry positions >= n: among equal sentinel keys the real
    # rows sort first, so [:n] keeps exactly the real rows
    with annotate("lsd.merge_sort"):
        x, v = sort_tiles_kv(_pad(keys, npad), iota_u32(npad, keys.device),
                             tile_rows=tile // LANES)
        run = tile
        while run < npad:
            x, v = merge_pass_kv(x, v, run)
            run *= KWAY
        return x[:n], v[:n]


def merge_sort_multi(keys: torch.Tensor, values, tile_log2: int = 15,
                     max_buf: int | None = None, blk: int | None = None,
                     ce: str = "reshape", pipeline="full"):
    """Framework sort of (keys, values[0]) lexicographic with any number of
    payload streams riding. values: list of (n,) uint32; returns
    (sorted_keys, [payloads...]).

    Padding rows are (key, val0) = (0xFFFFFFFF, 0xFFFFFFFF), which sort
    last. With >= 2 payloads a real row equal to that pair could trade its
    riding payloads with padding, so that case takes an exact stable sort
    by (key, val0, position) instead, as in the JAX package."""
    values = list(values)
    npad = _padded_size(keys.shape[0], 1 << tile_log2)
    if npad != keys.shape[0] and len(values) >= 2:
        collide = ((keys.view(torch.int32) == -1)
                   & (values[0].view(torch.int32) == -1)).any()
        if host_value(collide):
            perm = stable_order([keys, values[0]])
            return gather(keys, perm), [gather(v, perm) for v in values]
    return _merge_sort_multi(keys, values, tile_log2)


def _merge_sort_multi(keys: torch.Tensor, values, tile_log2: int):
    """merge_sort_multi without the sentinel-collision check: for callers
    whose values[0] can never be 0xFFFFFFFF."""
    n = keys.shape[0]
    tile = 1 << tile_log2
    npad = _padded_size(n, tile)
    with annotate("lsd.merge_sort"):
        x, vs = sort_tiles_multi(_pad(keys, npad),
                                 [_pad(v, npad) for v in values],
                                 tile_rows=tile // LANES)
        run = tile
        while run < npad:
            x, vs = merge_pass_multi(x, vs, run)
            run *= KWAY
        return x[:n], [v[:n] for v in vs]


def sort(keys: torch.Tensor, strategy: str = "merge", r: int = 8,
         block_size: int = 1 << 13, descending: bool = False
         ) -> torch.Tensor:
    """Sort u32/i32/f32 keys (TestGPULSDRadixSort path, cu:912-1030).
    Float keys sort in IEEE total order (core/keycodec.py)."""
    with annotate("lsd.sort"):
        code = keycodec.encode(keys, descending)
        if strategy == "merge":
            out = merge_sort_keys(code)
        elif strategy == "xla":
            out = i64_to_u32(torch.sort(u32_to_i64(code)).values)
        elif strategy == "composed":
            out = _composed_lsd_sort(code, r, block_size)
        else:
            raise ValueError(
                f"unknown strategy {strategy!r}; pick from {_STRATEGIES}")
        return keycodec.decode(out, keys.dtype, descending)


def sort_kv(keys: torch.Tensor, values, strategy: str = "merge", r: int = 8,
            block_size: int = 1 << 13, tile_log2: int = 15,
            descending: bool = False):
    """Stable key-value sort. keys: u32/i32/f32; values: any pytree of
    (n,) tensors of any dtype (one tensor, a list, a tuple, a dict, nested:
    `torch.utils._pytree`), returned in the same structure.

    "merge" runs the framework engine: the row index is the compared
    tiebreak and every 32-bit payload rides as its uint32 bits (a view,
    never a conversion); payloads of other widths take "xla", a stable
    torch.sort of the codes. "composed" (n % block_size == 0) moves each
    (n,) payload, of any dtype, by its bits at every radix pass."""
    with annotate("lsd.sort_kv"):
        code = keycodec.encode(keys, descending)
        flat, spec = pytree.tree_flatten(values)
        if strategy == "merge" and any(v.element_size() != 4 for v in flat):
            strategy = "xla"
        if strategy == "merge":
            n = keys.shape[0]
            u32 = [v.contiguous().view(torch.uint32) for v in flat]
            # values[0] is the row index (< 2^31), never the 0xFFFFFFFF of
            # a pad row, so the collision check and its host sync are
            # skipped
            sk, outs = _merge_sort_multi(
                code, [iota_u32(n, keys.device), *u32], tile_log2)
            back = [o.view(v.dtype) for o, v in zip(outs[1:], flat)]
        elif strategy == "xla":
            perm = stable_order([code])
            sk, back = gather(code, perm), [gather(v, perm) for v in flat]
        elif strategy == "composed":
            sk, back = _composed_lsd_sort_kv(code, flat, r, block_size)
        else:
            raise ValueError(
                f"unknown strategy {strategy!r}; pick from {_STRATEGIES}")
        return (keycodec.decode(sk, keys.dtype, descending),
                pytree.tree_unflatten(back, spec))


def sort_with_ranks(keys: torch.Tensor, descending: bool = False):
    """Sort keys, returning (sorted_keys, original_positions as uint32):
    the columnar primitive — use the positions to gather other columns."""
    code = keycodec.encode(keys, descending)
    perm = stable_order([code])
    sk = keycodec.decode(gather(code, perm), keys.dtype, descending)
    return sk, perm.to(torch.int32).view(torch.uint32)


def argsort(keys: torch.Tensor, descending: bool = False) -> torch.Tensor:
    """Stable argsort of u32/i32/f32 keys (uint32 positions)."""
    return sort_with_ranks(keys, descending)[1]


def sort_lex(key_cols, descending=False, strategy: str = "merge",
             tile_log2: int = 15):
    """Stable multi-column lexicographic sort: ORDER BY col0, col1, ...
    (col0 primary). Returns (sorted_cols_tuple, original_positions).

    key_cols: equal-length u32/i32/f32 columns. descending: one bool for
    all columns or one per column. Ties across all columns break by
    original position (stable).

    One stable pass per column, least significant first (the reference's
    LSD digit-group loop, LSDRadixSort.cu:62-69, with whole columns as
    digits), on the merge engine or, with strategy="xla", a stable
    torch.sort. Each pass sorts by one column with the current position
    as the unique tiebreak, the running permutation and the other columns
    riding; a pass moves at most MAX_STREAMS streams, and the columns past
    that follow the pass's sorted position stream by a gather."""
    cols = list(key_cols)
    k = len(cols)
    if k == 0:
        raise ValueError("sort_lex needs at least one key column")
    if isinstance(descending, bool):
        descending = (descending,) * k
    if len(descending) != k:
        raise ValueError("descending must be a bool or one per column")
    if strategy not in ("merge", "xla"):
        raise ValueError(f"strategy {strategy!r}: pick 'merge' or 'xla'")
    codes = [keycodec.encode(c, d) for c, d in zip(cols, descending)]
    n = cols[0].shape[0]
    dev = cols[0].device
    perm = iota_u32(n, dev)
    for i in reversed(range(k)):
        others = [codes[j] for j in range(k) if j != i]
        if strategy == "merge":
            ride = others[:MAX_STREAMS - 3]
            key_s, outs = _merge_sort_multi(
                codes[i], [iota_u32(n, dev), perm, *ride], tile_log2)
            perm = outs[1]
            rest = outs[2:]
            if len(others) > len(ride):
                order = u32_to_i64(outs[0])
                rest += [gather(c, order) for c in others[len(ride):]]
        else:
            order = stable_order([codes[i]])
            key_s, perm = gather(codes[i], order), gather(perm, order)
            rest = [gather(c, order) for c in others]
        it = iter(rest)
        codes = [key_s if j == i else next(it) for j in range(k)]
    decoded = tuple(keycodec.decode(c, col.dtype, d)
                    for c, col, d in zip(codes, cols, descending))
    return decoded, perm


def sort_records(records: torch.Tensor, key_bytes: int = 10,
                 strategy: str = "merge", tile_log2: int = 15
                 ) -> torch.Tensor:
    """Stable sort of fixed-width binary records: a new (n, R) uint8
    tensor holding the rows of `records` (a contiguous (n, R) uint8
    tensor) ordered by their first `key_bytes` bytes compared as unsigned
    bytes (memcmp order, as the Sort Benchmark's valsort checks); rows
    with equal keys keep their input order.

    The key bytes become ceil(key_bytes / 4) big-endian u32 words
    (`keycodec.encode_bytes`), `sort_lex` of the words gives the
    permutation (one stable pass a word, least significant first, on the
    merge engine, or torch.sort with strategy="xla"), and
    `gather_records` moves the whole rows once."""
    with annotate("lsd.sort_records"):
        with annotate("lsd.records.keys"):
            words = keycodec.encode_bytes(records, key_bytes)
        if records.shape[0] == 0:
            return records.clone()
        with annotate("lsd.records.sort"):
            _, perm = sort_lex(words, strategy=strategy,
                               tile_log2=tile_log2)
        del words
        with annotate("lsd.records.gather"):
            return gather_records(records, perm)


def sort64_with_ranks(key_hi: torch.Tensor, key_lo: torch.Tensor,
                      dtype: str = "uint64", descending: bool = False,
                      strategy: str = "merge", tile_log2: int = 15):
    """Stable sort by a 64-bit key column given as (hi, lo) u32 planes.
    Returns (sorted_hi, sorted_lo, original_positions as uint32). dtype is
    the logical key type: "uint64", "int64" or "float64" (IEEE total
    order, as the 32-bit codec).

    "merge" (the default, as in the JAX package) is the single chain: one
    tile sort and merge passes comparing (hi, lo, position), the kernels'
    ncmp = 3 mode. "merge2" is two stable merge-engine passes, by the low
    plane and then by the high plane (the reference's digit-group loop
    with r = 32). "xla" is the same two passes as stable torch.sorts."""
    chi, clo = keycodec.encode64(key_hi, key_lo, dtype, descending)
    n = key_hi.shape[0]
    dev = key_hi.device
    if strategy == "merge":
        hi_o, lo_o, perm = _merge1_sort64(chi, clo, tile_log2=tile_log2)
    elif strategy == "merge2":
        # the sorted position tiebreak of pass 1 is the pass-1 permutation
        lo_s, (perm1, hi_s) = _merge_sort_multi(clo, [iota_u32(n, dev), chi],
                                                tile_log2)
        hi_o, (_, lo_o, perm) = _merge_sort_multi(
            hi_s, [iota_u32(n, dev), lo_s, perm1], tile_log2)
    elif strategy == "xla":
        order = stable_order([clo])
        lo_s, perm1, hi_s = gather(clo, order), order, gather(chi, order)
        order = stable_order([hi_s])
        hi_o, lo_o = gather(hi_s, order), gather(lo_s, order)
        perm = i64_to_u32(perm1[order])
    else:
        raise ValueError(f"strategy {strategy!r}: pick 'merge', 'merge2' "
                         f"or 'xla'")
    hi_o, lo_o = keycodec.decode64(hi_o, lo_o, dtype, descending)
    return hi_o, lo_o, perm


def _merge1_sort64(chi: torch.Tensor, clo: torch.Tensor, tile_log2: int = 15):
    """Single-chain stable 64-bit sort: one tile sort and merge passes
    whose compares order by (hi, lo, position) — ncmp = 3 in both
    kernels. Returns (hi, lo, positions). Pad rows are (0xFFFFFFFF,
    0xFFFFFFFF, >= n) and positions are unique, so they sort last and the
    order is total and stable by construction."""
    n = chi.shape[0]
    tile = 1 << tile_log2
    npad = _padded_size(n, tile)
    hi, (lo, pos) = sort_tiles_multi(
        _pad(chi, npad), [_pad(clo, npad), iota_u32(npad, chi.device)],
        tile_rows=tile // LANES, ncmp=3)
    run = tile
    while run < npad:
        hi, (lo, pos) = merge_pass_multi(hi, [lo, pos], run, ncmp=3)
        run *= KWAY
    return hi[:n], lo[:n], pos[:n]


def sort_blocks_kv(keys: torch.Tensor, values: torch.Tensor,
                   block_size: int = 1 << 14):
    """(key, value) sort within each `block_size` block on the tile sort
    kernel (the reference's block-local sort, TestLSDBinaryRadixSort,
    cu:423-477). The value breaks key ties as a signed int32, as in
    `sort_tiles_kv`: unique values below 2^31 (row ids) make it a stable
    key sort. block_size: a power-of-two multiple of 128; n a multiple of
    block_size."""
    return sort_tiles_kv(keys, values, tile_rows=block_size // LANES)


# ---------------------------------------------------------------------------
# Composed LSD radix pipeline (reference pass structure, cu:845-906)
# ---------------------------------------------------------------------------

_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def _digit_dtype(r: int):
    """The narrowest dtype that holds an r-bit digit: the per-block sort
    then moves fewer bytes."""
    return torch.uint8 if r <= 8 else torch.int16 if r <= 15 else torch.int32


def _pass_destinations(keys: torch.Tensor, r: int, group: int,
                       block_size: int):
    """One stable radix pass's plan, as (order, dst), both (nb, B) int64:
    the row at sorted position j of block b is row order[b, j] of that
    block, and goes to dst[b, j].

    dst = global_offset[digit][block] + local_rank: the global offsets are
    the exclusive scan of the digit-major (transposed) histogram matrix
    (cu:877-895), and a row's local rank, its stable rank among equal
    digits in its block (cu:829-833), is its position in the block sorted
    stably by digit less the block's count of smaller digits. The JAX
    package inverts the sort's permutation to put dst in row order; the
    port scatters straight from sorted order, which gives the same output.
    """
    n = keys.shape[0]
    nb, bins = n // block_size, 1 << r
    hist = block_digit_histograms(keys, r, group, block_size)   # (nb, bins)
    # per-block exclusive digit offsets: each histogram row scanned
    lofs, _ = block_scans(hist.view(-1), bins)
    # digit-major global offsets: transpose + flat exclusive scan
    gofs = exclusive_scan(transpose_any(hist).view(-1))
    # where block b's digit-d rows start in the output, less their offset
    # in the block: dst = start[b, d] + sorted position
    start = (u32_to_i64(gofs).view(bins, nb).t()
             - u32_to_i64(lofs).view(nb, bins))
    digits = get_digit(keys, r, group).to(_digit_dtype(r))
    sorted_digits, order = torch.sort(digits.view(nb, block_size), dim=1,
                                      stable=True)
    del digits
    COUNTS["int64_bytes"] += 8 * sorted_digits.numel()
    dst = start.gather(1, sorted_digits.to(torch.int64))
    del sorted_digits
    dst += torch.arange(block_size, device=keys.device)
    return order, dst


def _composed_pass(keys: torch.Tensor, payloads, r: int, group: int,
                   block_size: int):
    """One stable radix pass: keys and every (n,) payload moved by their
    bits to the pass's destinations."""
    order, dst = _pass_destinations(keys, r, group, block_size)
    dst = dst.view(-1)
    outs = []
    for s in (keys, *payloads):
        bits = s.contiguous().view(_INT_OF_WIDTH[s.element_size()])
        src = bits.view(order.shape).gather(1, order).view(-1)
        out = torch.empty_like(bits)
        out.index_copy_(0, dst, src)       # every destination exactly once
        outs.append(out.view(s.dtype))
        del src
    return outs[0], outs[1:]


def _check_composed(keys: torch.Tensor, payloads, block_size: int) -> None:
    n = keys.shape[0]
    if n % block_size:
        raise ValueError(f"composed strategy needs n % block_size == 0 "
                         f"(n={n}, block_size={block_size})")
    for v in payloads:
        if v.dim() != 1 or v.shape[0] != n:
            raise ValueError(f"composed payloads must be (n,) = ({n},), "
                             f"got {tuple(v.shape)}")


def _composed_lsd_sort(keys: torch.Tensor, r: int, block_size: int
                       ) -> torch.Tensor:
    return _composed_lsd_sort_kv(keys, [], r, block_size)[0]


def _composed_lsd_sort_kv(keys: torch.Tensor, values, r: int,
                          block_size: int):
    values = list(values)
    _check_composed(keys, values, block_size)
    for group in range(num_digit_groups(r)):
        keys, values = _composed_pass(keys, values, r, group, block_size)
    return keys, values
