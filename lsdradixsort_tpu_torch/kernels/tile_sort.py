"""Per-tile sort — the port of lsdradixsort_tpu/kernels/tile_sort.py.

Every tile of ``tile_rows * 128`` rows is sorted ascending:

  * `sort_tiles`: keys only (replaces `_bitonic_keys_kernel`).
  * `sort_tiles_kv`: by (key, val), val compared as a SIGNED int32 — the
    JAX kernel casts val to int32 with no bias (tile_sort.py:207). The
    quirk only matters for tied keys with vals >= 2^31 and is kept so the
    port is bit exact (replaces `_bitonic_kernel`).
  * `sort_tiles_multi`: by the key and the first ncmp-1 payloads
    (ncmp = 1, 2 or 3; 3 is the 64-bit (hi, lo, position) sort), compared
    unsigned; the other payloads ride (replaces `_bitonic_multi_kernel`).
    The TPU network leaves the order of rows tied on the compared words
    to the network; the port sorts riders stably (by their row index),
    which is one of those orders.

On a CUDA tensor each wrapper launches the hand-written kernel in
``csrc/tile_sort.cu`` (its header says what bounds it on the H100 and how
the design copes); on a CPU tensor it runs the plain PyTorch version
beside it, which `chip_smoke.py` also runs on the card to check the
kernel. `LAUNCHES` counts kernel launches per wrapper and `PLAIN_CALLS`
runs of the plain versions. `interpret` and `ce` are the TPU's lowering
knobs, in the JAX package's argument order: accepted and ignored.
"""
from __future__ import annotations

import ctypes

import torch

from lsdradixsort_tpu_torch.core.convert import row_order, take_rows
from lsdradixsort_tpu_torch.kernels import _build

LANES = 128
_SIGN = 1 << 31

LAUNCHES = {"sort_tiles": 0, "sort_tiles_kv": 0, "sort_tiles_multi": 0}
PLAIN_CALLS = {"sort_tiles": 0, "sort_tiles_kv": 0, "sort_tiles_multi": 0}


def _check_tiles(keys: torch.Tensor, streams, tile_rows: int) -> int:
    """Validate the inputs; return log2 of the tile."""
    if tile_rows < 1 or tile_rows & (tile_rows - 1):
        raise ValueError(f"tile_rows={tile_rows} must be a power of 2")
    tile = tile_rows * LANES
    n = keys.shape[0]
    if n % tile:
        raise ValueError(f"n={n} must be a multiple of tile={tile}")
    for s in (keys, *streams):
        if s.dtype != torch.uint32 or s.dim() != 1 or s.shape[0] != n:
            raise ValueError("streams must be (n,) torch.uint32, got "
                             f"{s.dtype} {tuple(s.shape)}")
        if not s.is_contiguous() or s.device != keys.device:
            raise ValueError("streams must be contiguous, on one device")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    return tile.bit_length() - 1


def _ncmp(values, ncmp) -> int:
    if ncmp is None:
        ncmp = 2 if values else 1
    if ncmp not in (1, 2, 3) or ncmp - 1 > len(values):
        raise ValueError(f"ncmp={ncmp} with {len(values)} payloads")
    return ncmp


# --- plain PyTorch versions -------------------------------------------------

def _sort_tiles_plain(words, riders, tile: int, flip1: bool = False):
    perm = row_order(words, tile, flip1)
    return [take_rows(s, perm) for s in (*words, *riders)]


def sort_tiles_plain(keys, tile_rows: int = 128,
                     interpret: bool | None = None, ce: str = "roll"):
    _check_tiles(keys, (), tile_rows)
    PLAIN_CALLS["sort_tiles"] += 1
    return _sort_tiles_plain([keys], [], tile_rows * LANES)[0]


def sort_tiles_kv_plain(keys, values, tile_rows: int = 128,
                        interpret: bool | None = None, ce: str = "roll"):
    _check_tiles(keys, (values,), tile_rows)
    PLAIN_CALLS["sort_tiles_kv"] += 1
    return tuple(_sort_tiles_plain([keys, values], [], tile_rows * LANES,
                                   flip1=True))


def sort_tiles_multi_plain(keys, values, tile_rows: int = 128,
                           interpret: bool | None = None, ce: str = "roll",
                           ncmp: int | None = None):
    values = list(values)
    _check_tiles(keys, values, tile_rows)
    ncmp = _ncmp(values, ncmp)
    PLAIN_CALLS["sort_tiles_multi"] += 1
    out = _sort_tiles_plain([keys, *values[:ncmp - 1]], values[ncmp - 1:],
                            tile_rows * LANES)
    return out[0], out[1:]


# --- CUDA kernels -----------------------------------------------------------

def _launch(words, riders, tile_log2: int, flip1: bool):
    """Sort the tiles of `words` (u32 streams, the key first; None for the
    row-index word) with csrc/tile_sort.cu, then gather the riders by the
    index word. Returns the sorted words (index word dropped) and riders."""
    key = words[0]
    n = key.shape[0]
    dst = [torch.empty_like(key) for _ in words]
    stream = ctypes.c_void_p(torch.cuda.current_stream(key.device).cuda_stream)
    with torch.cuda.device(key.device):
        sort = _build.function("lsd_sort_tiles", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p])
        _build.check(sort(_build.pointers(words), _build.pointers(dst),
                          len(words), n, tile_log2, _SIGN if flip1 else 0,
                          stream), "lsd_sort_tiles")
        out_r = []
        if riders:
            gather = _build.function("lsd_gather_tiles", [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
            for r in riders:
                o = torch.empty_like(r)
                _build.check(gather(r.data_ptr(), o.data_ptr(),
                                    dst[-1].data_ptr(), n, tile_log2, stream),
                             "lsd_gather_tiles")
                out_r.append(o)
    if riders:
        dst = dst[:-1]
    return dst, out_r


def sort_tiles(keys: torch.Tensor, tile_rows: int = 128,
               interpret: bool | None = None,
               ce: str = "roll") -> torch.Tensor:
    """Sort uint32 keys ascending within each tile (keys only)."""
    if keys.device.type == "cpu":
        return sort_tiles_plain(keys, tile_rows)
    tile_log2 = _check_tiles(keys, (), tile_rows)
    (ok,), _ = _launch([keys], [], tile_log2, flip1=False)
    LAUNCHES["sort_tiles"] += 1
    return ok


def sort_tiles_kv(keys: torch.Tensor, values: torch.Tensor,
                  tile_rows: int = 128, interpret: bool | None = None,
                  ce: str = "roll"):
    """(key, value)-sort within each tile of `tile_rows * 128` rows; the
    value breaks ties as a signed int32 and moves with its key. Pass
    unique values (e.g. row ids < 2^31) for a stable key sort. Returns
    (sorted_keys, values_along)."""
    if keys.device.type == "cpu":
        return sort_tiles_kv_plain(keys, values, tile_rows)
    tile_log2 = _check_tiles(keys, (values,), tile_rows)
    (ok, ov), _ = _launch([keys, values], [], tile_log2, flip1=True)
    LAUNCHES["sort_tiles_kv"] += 1
    return ok, ov


def sort_tiles_multi(keys: torch.Tensor, values, tile_rows: int = 128,
                     interpret: bool | None = None, ce: str = "roll",
                     ncmp: int | None = None):
    """Tile-local sort with any number of payload streams.

    values: list of (n,) uint32. The first ncmp-1 (default 1) are compared
    after the key, unsigned; the rest ride uncompared, in input order
    within rows tied on the compared words. Returns
    (sorted_keys, [payloads...])."""
    values = list(values)
    if keys.device.type == "cpu":
        return sort_tiles_multi_plain(keys, values, tile_rows, ncmp=ncmp)
    tile_log2 = _check_tiles(keys, values, tile_rows)
    ncmp = _ncmp(values, ncmp)
    compared, riders = values[:ncmp - 1], values[ncmp - 1:]
    words = [keys, *compared] + ([None] if riders else [])
    out, out_r = _launch(words, riders, tile_log2, flip1=False)
    LAUNCHES["sort_tiles_multi"] += 1
    return out[0], [*out[1:], *out_r]
