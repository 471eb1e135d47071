"""Exclusive prefix sums — the port of lsdradixsort_tpu/kernels/scan.py.

  * `exclusive_scan`: exclusive prefix sum of a 1-D u32 or i32 tensor of
    any length, mod 2^32, in the input's dtype.
  * `exclusive_scan_hierarchical`: the same function, the reference's
    hierarchical way (GPUPrefixSum, LSDRadixSort.cu:265-302).
  * `block_prefix_sums`: the exclusive scan of each block of `block_size`
    words, and each block's total (BlockPrefixSumKernel with carry-out,
    cu:180-207).

The TPU's exclusive_scan is one sweep that threads a carry through grid
steps run in order; CUDA CTAs run in no order, so on the card
(``csrc/scan.cu``, whose header gives the design and what bounds it):

  * `exclusive_scan` is reduce-then-scan: the total of each 4096-word
    tile, an exclusive scan of those totals (`exclusive_scan_hierarchical`
    on the card), then each tile scanned again from its offset.
  * `exclusive_scan_hierarchical` is scan-then-propagate: each tile
    scanned with its total written out, the totals scanned the same way
    (recursively), and the offsets added back.
  * `block_prefix_sums` is one launch of the tile scan, segmented by
    block; a block larger than a tile is looped over with a carry.

`block_rows` is the TPU's tile knob: accepted and ignored. On a CPU tensor
each wrapper runs its plain PyTorch version (an int64 `cumsum` masked to
32 bits), which `chip_smoke.py` also runs on the card to check the
kernels. `LAUNCHES` and `PLAIN_CALLS` count both.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from lsdradixsort_tpu_torch.core.convert import i64_to_u32, u32_to_i64
from lsdradixsort_tpu_torch.kernels import _build

LANES = 128
_MASK = 0xFFFFFFFF
_NAMES = ("exclusive_scan", "exclusive_scan_hierarchical",
          "block_prefix_sums")

LAUNCHES = dict.fromkeys(_NAMES, 0)
PLAIN_CALLS = dict.fromkeys(_NAMES, 0)


def _check(x: torch.Tensor) -> None:
    if x.dtype not in (torch.uint32, torch.int32) or x.dim() != 1:
        raise ValueError(f"scans take (n,) uint32 or int32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _check_blocks(x: torch.Tensor, block_size: int) -> None:
    n = x.shape[0]
    if n % block_size or block_size % LANES:
        raise ValueError(f"n={n} must be divisible by block_size={block_size},"
                         f" block_size by {LANES}")


def _out(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """int64 values mod 2^32 as a tensor of like's 32-bit dtype."""
    return i64_to_u32(t & _MASK).view(like.dtype)


# --- plain PyTorch versions -------------------------------------------------

def _scan_plain(x: torch.Tensor, name: str) -> torch.Tensor:
    _check(x)
    PLAIN_CALLS[name] += 1
    v = u32_to_i64(x)
    return _out(torch.cumsum(v, 0) - v, x)


def exclusive_scan_plain(x: torch.Tensor, block_rows: int = 512
                         ) -> torch.Tensor:
    return _scan_plain(x, "exclusive_scan")


def exclusive_scan_hierarchical_plain(x: torch.Tensor, block_rows: int = 512
                                      ) -> torch.Tensor:
    return _scan_plain(x, "exclusive_scan_hierarchical")


def _block_scans_plain(x: torch.Tensor, seg: int):
    PLAIN_CALLS["block_prefix_sums"] += 1
    v = u32_to_i64(x).view(-1, seg)
    return _out(torch.cumsum(v, 1) - v, x).view(-1), _out(v.sum(1), x)


def block_prefix_sums_plain(x: torch.Tensor, block_size: int):
    _check(x)
    _check_blocks(x, block_size)
    return _block_scans_plain(x, block_size)


# --- CUDA kernels -----------------------------------------------------------

@functools.cache
def _tile() -> int:
    """Words a tile of csrc/scan.cu holds."""
    fn = _build.library().lsd_scan_tile
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _seg_scan(x, out, totals, offsets, seg: int) -> None:
    fn = _build.function("lsd_seg_scan", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p])
    _build.check(fn(_ptr(x), _ptr(out), _ptr(totals), _ptr(offsets),
                    x.shape[0], seg, _stream(x)), "lsd_seg_scan")


def exclusive_scan(x: torch.Tensor, block_rows: int = 512) -> torch.Tensor:
    """Exclusive prefix sum of a 1-D uint32/int32 tensor (any length),
    mod 2^32, in x's dtype. Replaces GPUPrefixSum + AddBlockSumsKernel
    (cu:265-302); no divisibility constraint."""
    if x.device.type == "cpu":
        return exclusive_scan_plain(x)
    _check(x)
    x = x.contiguous()
    n = x.shape[0]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        tile = _tile()
        offsets = None
        if n > tile:
            totals = torch.empty(-(-n // tile), dtype=x.dtype,
                                 device=x.device)
            fn = _build.function("lsd_tile_totals", [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p])
            _build.check(fn(_ptr(x), _ptr(totals), n, _stream(x)),
                         "lsd_tile_totals")
            offsets = exclusive_scan_hierarchical(totals)
        _seg_scan(x, out, None, offsets, tile)
    LAUNCHES["exclusive_scan"] += 1
    return out


def exclusive_scan_hierarchical(x: torch.Tensor, block_rows: int = 512
                                ) -> torch.Tensor:
    """Exclusive prefix sum via the reference's hierarchical decomposition
    (GPUPrefixSum, cu:265-302): the same contract as `exclusive_scan`."""
    if x.device.type == "cpu":
        return exclusive_scan_hierarchical_plain(x)
    _check(x)
    x = x.contiguous()
    n = x.shape[0]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        tile = _tile()
        scratch_len, m = 0, n
        while m > tile:
            m = -(-m // tile)
            scratch_len += m
        scratch = torch.empty(max(scratch_len, 1), dtype=x.dtype,
                              device=x.device)
        fn = _build.function("lsd_scan_propagate", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p])
        _build.check(fn(_ptr(x), _ptr(out), _ptr(scratch), n, _stream(x)),
                     "lsd_scan_propagate")
    LAUNCHES["exclusive_scan_hierarchical"] += 1
    return out


def block_scans(x: torch.Tensor, seg: int):
    """(exclusive scan of each segment of `seg` words, segment totals) for
    any seg >= 1 dividing n: the launch behind `block_prefix_sums`, which
    the composed sort also calls on its histogram rows (2^r words)."""
    _check(x)
    if seg < 1 or x.shape[0] % seg:
        raise ValueError(f"n={x.shape[0]} must be divisible by seg={seg}")
    if x.device.type == "cpu":
        return _block_scans_plain(x, seg)
    x = x.contiguous()
    out = torch.empty_like(x)
    totals = torch.empty(x.shape[0] // seg, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _seg_scan(x, out, totals, None, seg)
    LAUNCHES["block_prefix_sums"] += 1
    return out, totals


def block_prefix_sums(x: torch.Tensor, block_size: int):
    """Independent exclusive scan of each block + per-block totals:
    (scans (n,), totals (n / block_size,)), in x's dtype. Requires
    n % block_size == 0 and block_size % 128 == 0."""
    _check(x)
    _check_blocks(x, block_size)
    return block_scans(x, block_size)
