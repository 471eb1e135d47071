"""Sort operators — the port of lsdradixsort_tpu/ops/sort.py's flagship
family.

The framework sort ("merge", the default) is a per-tile sort
(kernels/tile_sort.py) into sorted runs of 2^tile_log2 rows followed by
8-way merge passes (kernels/merge.py), each a hand-written CUDA kernel
on a CUDA tensor and its plain PyTorch version on a CPU tensor.

Every sort of the port's operators goes through one seam here:

  * `_merge_chain`, the merge engine's one chain over exactly the n rows
    it is handed: the tile sort (the last tile may be short) and the
    merge passes (the last run may be short). The position word it
    makes, when asked, is an iota. Nothing is padded, so no real row can
    meet a pad row, and the JAX package's sentinel check has nothing to
    guard.
  * `_sort_rows`, the one engine switch: rows stably sorted by a key and
    its compared words, riders moved along, on "merge" (the chain),
    "xla" (a stable torch.sort of the codes, where the JAX package calls
    `jax.lax.sort`) or "auto" (merge on a CUDA tensor, torch.sort on a
    CPU tensor). It holds the rule for payload widths and the one error
    for an unknown engine.

The public sorts:

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
from lsdradixsort_tpu_torch.core.profiling import COUNTS, annotate
from lsdradixsort_tpu_torch.kernels.histogram import block_digit_histograms
from lsdradixsort_tpu_torch.kernels.merge import (KWAY, MAX_STREAMS,
                                                  merge_pass_multi)
from lsdradixsort_tpu_torch.kernels.records import gather_records
from lsdradixsort_tpu_torch.kernels.scan import block_scans, exclusive_scan
from lsdradixsort_tpu_torch.kernels.tile_sort import (LANES, sort_tiles,
                                                      sort_tiles_kv,
                                                      sort_tiles_multi)
from lsdradixsort_tpu_torch.kernels.transpose import transpose_any


def _merge_chain(words, riders=(), tile_log2: int = 15, *,
                 positions: bool = False, tiles: str = "multi"):
    """The merge engine's chain: (n,) uint32 `words` (the key first, then
    the compared payloads) and `riders`, contiguous, tile sorted and
    merged 8 ways until one run covers their n rows. Returns (sorted_key,
    [the other words, riders]). Any n: the last tile and the last run of
    each pass may be short, and each kernel keeps the rows that do not
    exist out of device memory (they would sort after every real row), so
    no stream is padded and the chain allocates nothing beyond n rows a
    stream. `COUNTS["ragged_sorts"]` counts the calls whose n is not a
    power-of-two count of whole tiles.

    positions: the row positions follow the words as the last compared
    word, the unique tiebreak that makes the sort stable. They lie below
    2^31, so the kv tile sort, which compares the position as a signed
    int32, orders them as the unsigned merge passes do.

    tiles: the tile-sort wrapper, "keys" (`sort_tiles`, one word, no
    riders), "kv" (`sort_tiles_kv`, the key and one compared word) or
    "multi" (`sort_tiles_multi`, comparing every word); the merge passes
    are `merge_pass_multi` comparing every word, which `merge_pass` and
    `merge_pass_kv` are."""
    n = words[0].shape[0]
    tile = 1 << tile_log2
    if n < tile or n & (n - 1):
        COUNTS["ragged_sorts"] += 1
    if positions:
        words = [*words, iota_u32(n, words[0].device)]
    ncmp = len(words)
    with annotate("lsd.merge_sort"):
        x, *vs = [s.contiguous() for s in (*words, *riders)]
        if tiles == "keys":
            x = sort_tiles(x, tile_rows=tile // LANES)
        elif tiles == "kv":
            x, v = sort_tiles_kv(x, vs[0], tile_rows=tile // LANES)
            vs = [v]
        else:
            x, vs = sort_tiles_multi(x, vs, tile_rows=tile // LANES,
                                     ncmp=ncmp)
        run = tile
        while run < n:
            x, vs = merge_pass_multi(x, vs, run, ncmp)
            run *= KWAY
        return x, vs


def merge_sort_keys(keys: torch.Tensor, tile_log2: int = 15,
                    max_buf: int | None = None, blk: int | None = None,
                    skew_fallback: bool = True, ce: str = "reshape",
                    pipeline="full"):
    """The framework sort of (n,) uint32 keys: tile sort + 8-way merge
    passes. Any n >= 1. Returns the sorted keys, or (sorted, True) with
    skew_fallback=False (see the module docstring)."""
    x, _ = _merge_chain([keys], (), tile_log2, tiles="keys")
    return x if skew_fallback else (x, True)


def merge_sort_with_ranks(keys: torch.Tensor, tile_log2: int = 15,
                          max_buf: int | None = None, blk: int | None = None,
                          ce: str = "reshape", pipeline="full"):
    """Framework stable kv sort: returns (sorted_keys, original_positions).

    The row index rides through the tile sort and every merge pass and
    breaks every tie, which makes the whole pipeline stable."""
    x, (v,) = _merge_chain([keys], (), tile_log2, positions=True,
                           tiles="kv")
    return x, v


def merge_sort_multi(keys: torch.Tensor, values, tile_log2: int = 15,
                     max_buf: int | None = None, blk: int | None = None,
                     ce: str = "reshape", pipeline="full"):
    """Framework sort of (keys, values[0]) lexicographic with any number of
    payload streams riding, stable: rows equal on (key, values[0]) keep
    their input order, riders included (the JAX package pads with
    (0xFFFFFFFF, 0xFFFFFFFF) rows and sorts a real row equal to that pair
    exactly by another path; the chain pads nothing). values: list of
    (n,) uint32; returns (sorted_keys, [payloads...])."""
    values = list(values)
    return _merge_chain([keys, *values[:1]], values[1:], tile_log2)


def _engine(engine: str, device: torch.device) -> str:
    """The engine a sort runs on: "auto" is the merge engine for CUDA
    tensors and a stable torch.sort ("xla") for CPU tensors, where the
    kernels' plain versions would dominate."""
    if engine == "auto":
        return "merge" if device.type == "cuda" else "xla"
    if engine not in ("merge", "xla"):
        raise ValueError(f"unknown engine {engine!r}: the sort engines are "
                         f"'merge', 'xla' and 'auto'")
    return engine


def _sort_rows(key: torch.Tensor, by=(), riders=(), engine: str = "merge",
               tile_log2: int = 15, *, positions: bool = False,
               key_only: bool = False):
    """The operators' one engine switch: the rows (key, *by, *riders)
    stably sorted by (key, *by), returned as (key, [by...], [riders...]),
    with the sorted row positions (uint32) after by when `positions`.

    key and by are (n,) uint32 words; riders (n,) tensors of any dtype,
    returned in their dtype. "merge" moves 32-bit riders as their uint32
    bits (a view, never a conversion); a rider of another width sends the
    sort to "xla". On "merge", a sort with `positions` or without by has
    the chain make the position word, its unique tiebreak, compared last;
    riders past what one pass moves follow it by a gather. Otherwise by
    is one word, the caller's unique tiebreak, and the sort goes through
    `merge_sort_multi`. "xla" compares key and by
    with `stable_order` (key alone when `key_only`: the caller's by word
    ascends in row order, so stability gives its order, or the caller
    needs no order among equal keys) and gathers the rest; keys alone
    take one torch.sort of their int64 values."""
    engine = _engine(engine, key.device)
    by, riders = list(by), list(riders)
    if engine == "merge" and any(r.element_size() != 4 for r in riders):
        engine = "xla"
    if engine == "xla":
        if not (by or riders or positions):
            return i64_to_u32(torch.sort(u32_to_i64(key)).values), [], []
        order = stable_order([key] if key_only else [key, *by])
        sby = [gather(w, order) for w in by]
        if positions:
            sby.append(order.to(torch.int32).view(torch.uint32))
        return gather(key, order), sby, [gather(r, order) for r in riders]
    if not (by or riders or positions):
        return merge_sort_keys(key, tile_log2=tile_log2), [], []
    u32 = [r.contiguous().view(torch.uint32) for r in riders]
    if positions or not by:
        nw = len(by) + 1                    # the position word is outs[nw-1]
        ride = MAX_STREAMS - 1 - nw
        sk, outs = _merge_chain([key, *by], u32[:ride], tile_log2,
                                positions=True)
        if len(riders) > ride:
            order = u32_to_i64(outs[nw - 1])
            outs += [gather(r, order) for r in u32[ride:]]
    else:
        nw = len(by)
        sk, outs = merge_sort_multi(key, [*by, *u32], tile_log2=tile_log2)
    return sk, outs[:len(by) + positions], [
        o.view(r.dtype) for o, r in zip(outs[nw:], riders)]


def sort(keys: torch.Tensor, strategy: str = "merge", r: int = 8,
         block_size: int = 1 << 13, descending: bool = False
         ) -> torch.Tensor:
    """Sort u32/i32/f32 keys (TestGPULSDRadixSort path, cu:912-1030).
    Float keys sort in IEEE total order (core/keycodec.py). strategy: a
    sort engine or "composed"."""
    with annotate("lsd.sort"):
        code = keycodec.encode(keys, descending)
        if strategy == "composed":
            out = _composed_lsd_sort(code, r, block_size)
        else:
            out = _sort_rows(code, engine=strategy)[0]
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
        if strategy == "composed":
            sk, back = _composed_lsd_sort_kv(code, flat, r, block_size)
        else:
            sk, _, back = _sort_rows(code, (), flat, strategy, tile_log2)
        return (keycodec.decode(sk, keys.dtype, descending),
                pytree.tree_unflatten(back, spec))


def sort_with_ranks(keys: torch.Tensor, descending: bool = False):
    """Sort keys, returning (sorted_keys, original_positions as uint32):
    the columnar primitive — use the positions to gather other columns."""
    code = keycodec.encode(keys, descending)
    sk, (perm,), _ = _sort_rows(code, engine="xla", positions=True)
    return keycodec.decode(sk, keys.dtype, descending), perm


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
    codes = [keycodec.encode(c, d) for c, d in zip(cols, descending)]
    perm = iota_u32(cols[0].shape[0], cols[0].device)
    for i in reversed(range(k)):
        others = [codes[j] for j in range(k) if j != i]
        key_s, _, (perm, *rest) = _sort_rows(codes[i], (), [perm, *others],
                                             strategy, tile_log2)
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
    if strategy == "merge":
        hi_o, (lo_o, perm), _ = _sort_rows(chi, [clo], (), "merge",
                                           tile_log2, positions=True)
    else:
        # the first pass's sorted positions ride the second as its
        # permutation
        engine = "merge" if strategy == "merge2" else strategy
        lo_s, (perm1,), (hi_s,) = _sort_rows(clo, (), [chi], engine,
                                             tile_log2, positions=True)
        hi_o, _, (lo_o, perm) = _sort_rows(hi_s, (), [lo_s, perm1], engine,
                                           tile_log2)
    hi_o, lo_o = keycodec.decode64(hi_o, lo_o, dtype, descending)
    return hi_o, lo_o, perm


def sort_blocks_kv(keys: torch.Tensor, values: torch.Tensor,
                   block_size: int = 1 << 14):
    """(key, value) sort within each `block_size` block on the tile sort
    kernel (the reference's block-local sort, TestLSDBinaryRadixSort,
    cu:423-477). The value breaks key ties as a signed int32, as in
    `sort_tiles_kv`: unique values below 2^31 (row ids) make it a stable
    key sort. block_size: a power-of-two multiple of 128; the last block
    may be short."""
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
