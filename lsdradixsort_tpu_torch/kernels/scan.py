"""Exclusive prefix sums — the port of lsdradixsort_tpu/kernels/scan.py.

  * `exclusive_scan`: exclusive prefix sum of a 1-D integer tensor of any
    length, mod 2^k for its k-bit dtype, in the input's dtype.
  * `exclusive_scan_hierarchical`: the same function, the reference's
    hierarchical way (GPUPrefixSum, LSDRadixSort.cu:265-302).
  * `block_prefix_sums`: the exclusive scan of each block of `block_size`
    words, and each block's total (BlockPrefixSumKernel with carry-out,
    cu:180-207).

The TPU's exclusive_scan is one sweep that threads a carry through grid
steps run in order; CUDA CTAs run in no order, so on the card
(``csrc/scan.cu``, whose header gives the design and what bounds it):

  * `exclusive_scan` is one pass with decoupled look-back: each CTA scans
    8192 words once and takes its offset from the status words of the
    CTAs before it. One C call and one launch; the status words live in
    scratch kept per stream, which every launch leaves zero.
  * `exclusive_scan_hierarchical` keeps the reference's three steps
    (block totals, a scan of the totals, each block scanned plus its
    offset) in one cooperative launch: a persistent grid walks the data
    in rounds of one HIER_BLOCK-word block a CTA, held on chip from its
    total to its store across a grid barrier, so each word is read and
    written once: min(the CTAs the card holds at once, the blocks) CTAs,
    and as many rounds as cover the blocks.
  * `block_prefix_sums` is one launch: short power-of-two blocks (the
    composed sort's histogram rows) are scanned in registers, a lane or a
    few lanes of a warp a block; other blocks by the tile scan, segmented
    by block, a block larger than a tile looped over with a carry.

The kernels add u32 words; i32 is the same bits. An 8- or 16-bit integer
tensor is scanned as int32 and cast back, as the JAX package's scans take
any integer dtype: the sum mod 2^32, then mod 2^k, is the sum mod 2^k.
64-bit tensors are refused (the JAX package has none without x64).

`block_rows` and `interpret` are the TPU's knobs: accepted and ignored.
On a CPU tensor each wrapper runs its plain PyTorch version (an int64
`cumsum` masked to 32 bits), which `chip_smoke.py` also runs on the card
to check the kernels. `LAUNCHES` and `PLAIN_CALLS` count both.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from lsdradixsort_tpu_torch.core.convert import i64_to_u32, u32_to_i64
from lsdradixsort_tpu_torch.core.profiling import annotate
from lsdradixsort_tpu_torch.kernels import _build

LANES = 128
_MASK = 0xFFFFFFFF
_WORDS = (torch.uint32, torch.int32)
_NARROW = (torch.uint8, torch.int8, torch.uint16, torch.int16)
_NAMES = ("exclusive_scan", "exclusive_scan_hierarchical",
          "block_prefix_sums")

LAUNCHES = dict.fromkeys(_NAMES, 0)
PLAIN_CALLS = dict.fromkeys(_NAMES, 0)


_DTYPES = frozenset(_WORDS + _NARROW)
HIER_BLOCK = 16 * 512 * 4   # words a CTA of the hierarchical scan holds a
#                             round (kHierBlock, csrc/scan.cu)


def _check(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPES or x.ndim != 1:
        raise ValueError(f"scans take (n,) integers of 8, 16 or 32 bits, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_cuda and x.device.type != "cpu":
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


def exclusive_scan_plain(x: torch.Tensor, block_rows: int = 512,
                         interpret: bool | None = None) -> torch.Tensor:
    if x.dtype in _NARROW:
        return exclusive_scan_plain(x.to(torch.int32)).to(x.dtype)
    return _scan_plain(x, "exclusive_scan")


def exclusive_scan_hierarchical_plain(x: torch.Tensor, block_rows: int = 512,
                                      interpret: bool | None = None
                                      ) -> torch.Tensor:
    if x.dtype in _NARROW:
        return exclusive_scan_hierarchical_plain(x.to(torch.int32)).to(x.dtype)
    return _scan_plain(x, "exclusive_scan_hierarchical")


def _block_scans_plain(x: torch.Tensor, seg: int):
    if x.dtype in _NARROW:
        return tuple(t.to(x.dtype) for t in
                     _block_scans_plain(x.to(torch.int32), seg))
    PLAIN_CALLS["block_prefix_sums"] += 1
    v = u32_to_i64(x).view(-1, seg)
    return _out(torch.cumsum(v, 1) - v, x).view(-1), _out(v.sum(1), x)


def block_prefix_sums_plain(x: torch.Tensor, block_size: int,
                            interpret: bool | None = None):
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


@functools.cache
def _lookback():
    """(words a CTA of the single-pass scan covers, its C entry)."""
    lib = _build.library()
    lib.lsd_scan_lookback_words.argtypes = []
    lib.lsd_scan_lookback_words.restype = ctypes.c_int
    return lib.lsd_scan_lookback_words(), _build.function(
        "lsd_exclusive_scan", [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_void_p])


def exclusive_scan(x: torch.Tensor, block_rows: int = 512,
                   interpret: bool | None = None) -> torch.Tensor:
    """Exclusive prefix sum of a 1-D integer tensor (any length), mod 2^k,
    in x's dtype. Replaces GPUPrefixSum + AddBlockSumsKernel
    (cu:265-302); no divisibility constraint."""
    if x.device.type == "cpu":
        return exclusive_scan_plain(x)
    _check(x)
    if x.dtype in _NARROW:
        return exclusive_scan(x.to(torch.int32)).to(x.dtype)
    with annotate("lsd.kernel.exclusive_scan"):
        x = x.contiguous()
        n = x.shape[0]
        out = torch.empty_like(x)
        # the small scans are bound by host time: the raw stream handle,
        # the device passed to the C entry, the status scratch kept per
        # stream
        words, fn = _lookback()
        dev = x.device.index
        stream = torch._C._cuda_getCurrentRawStream(dev)
        status = _build.lookback_status(dev, stream, -(-n // words) + 2)
        _build.check(fn(x.data_ptr(), out.data_ptr(), status.data_ptr(), n,
                        dev, stream), "lsd_exclusive_scan")
    LAUNCHES["exclusive_scan"] += 1
    return out


@functools.cache
def _hier():
    """(the card's CTA ceiling for the hierarchical scan, by device; its C
    entry)."""
    lib = _build.library()
    if lib.lsd_scan_hier_block() != HIER_BLOCK:
        raise RuntimeError("csrc/scan.cu kHierBlock differs from HIER_BLOCK")
    lib.lsd_scan_hier_ctas.argtypes = [ctypes.c_int]
    lib.lsd_scan_hier_ctas.restype = ctypes.c_int
    return lib.lsd_scan_hier_ctas, _build.function(
        "lsd_scan_hierarchical", [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_void_p])


def hierarchical_ctas(device: torch.device) -> int:
    """CTAs of the hierarchical scan the card holds at once (its SMs times
    the CTAs an SM takes): the grid of a scan that fills them."""
    ctas = _hier()[0](torch.device(device).index or 0)
    if ctas <= 0:
        raise RuntimeError("lsd_scan_hier_ctas: no cooperative launch of "
                           "scan_rounds fits this card")
    return ctas


def exclusive_scan_hierarchical(x: torch.Tensor, block_rows: int = 512,
                                interpret: bool | None = None
                                ) -> torch.Tensor:
    """Exclusive prefix sum via the reference's hierarchical decomposition
    (GPUPrefixSum, cu:265-302): the same contract as `exclusive_scan`."""
    if x.device.type == "cpu":
        return exclusive_scan_hierarchical_plain(x)
    _check(x)
    if x.dtype in _NARROW:
        return exclusive_scan_hierarchical(x.to(torch.int32)).to(x.dtype)
    with annotate("lsd.kernel.exclusive_scan_hierarchical"):
        x = x.contiguous()
        n = x.shape[0]
        out = torch.empty_like(x)
        dev = x.device.index
        # two round parities of one total a CTA
        scratch = torch.empty(2 * hierarchical_ctas(x.device), dtype=x.dtype,
                              device=x.device)
        _build.check(_hier()[1](x.data_ptr(), out.data_ptr(),
                                scratch.data_ptr(), n, dev,
                                torch._C._cuda_getCurrentRawStream(dev)),
                     "lsd_scan_hierarchical")
    LAUNCHES["exclusive_scan_hierarchical"] += 1
    return out


@functools.cache
def _seg_scan():
    return _build.function("lsd_seg_scan", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def block_scans(x: torch.Tensor, seg: int):
    """(exclusive scan of each segment of `seg` words, segment totals) for
    any seg >= 1 dividing n: the launch behind `block_prefix_sums`, which
    the composed sort also calls on its histogram rows (2^r words)."""
    _check(x)
    n = x.shape[0]
    if seg < 1 or n % seg:
        raise ValueError(f"n={n} must be divisible by seg={seg}")
    if not x.is_cuda:
        return _block_scans_plain(x, seg)
    if x.dtype in _NARROW:
        return tuple(t.to(x.dtype) for t in block_scans(x.to(torch.int32),
                                                        seg))
    # the histogram rows' scans are bound by host time: the C entry cached,
    # the raw stream handle, the device passed to the C entry, one
    # allocation (scans, then totals) split in two only once the kernel is
    # launched (cheaper to issue than two allocations, or than two slices
    # of one: bench/small_ops.py `host_parts`)
    with annotate("lsd.kernel.block_scans"):
        x = x.contiguous()
        buf = x.new_empty(n + n // seg)
        dev = x.get_device()
        ptr = buf.data_ptr()
        _build.check(_seg_scan()(x.data_ptr(), ptr, ptr + 4 * n, n, seg, dev,
                                 torch._C._cuda_getCurrentRawStream(dev)),
                     "lsd_seg_scan")
    LAUNCHES["block_prefix_sums"] += 1
    return buf.split_with_sizes([n, n // seg])


def block_prefix_sums(x: torch.Tensor, block_size: int,
                      interpret: bool | None = None):
    """Independent exclusive scan of each block + per-block totals:
    (scans (n,), totals (n / block_size,)), in x's dtype. Requires
    n % block_size == 0 and block_size % 128 == 0."""
    _check(x)
    _check_blocks(x, block_size)
    return block_scans(x, block_size)
