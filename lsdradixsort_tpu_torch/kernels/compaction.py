"""Order-preserving stream compaction — the port of
lsdradixsort_tpu/kernels/compaction.py.

  * `compact_stream_multi(mask, xs)`: k (n,) uint32 streams and one 0/1
    mask; in each output the first sum(mask) rows are that stream's
    selected rows in input order. The tail is unspecified (it is whatever
    the output buffer held). n must be a multiple of 32768, as in the JAX
    package (whose ops/filter.py pads with mask 0).
  * `compact_stream(mask, x)`: the same for one stream.
  * `_compact_rows(mask, xs)`: the same at any n, with the count of
    selected rows: what ops/filter.py `compact` runs, without padding.

The TPU kernel walks its tiles in order with a bitonic partition of each
32K tile, a carry of < 128 rows and DMAs at a running output cursor,
because TPU grid steps run in order and the TPU has no scatter. On the
card (``csrc/compaction.cu``, whose header gives the design and what
bounds it) compaction is one pass a group of up to MAX_STREAMS streams:
a CTA counts the mask of its tile, publishes the count, stages the
selected rows' chunks of every stream in shared memory, finds the tile's
output offset by decoupled look-back (``csrc/single_pass.cuh``, the
look-back of the port's `exclusive_scan`) and writes the tile's selected
rows there in order. More streams take one launch a group
(`stream_groups`); the later launches read the tile offsets the first
one kept. Any n below 2^32 and any alignment of the mask and streams.

`interpret` is the TPU's knob: accepted and ignored. On a CPU tensor the
wrapper runs the plain PyTorch version (boolean indexing, tail zeroed),
which `chip_smoke.py` also runs on the card to check the kernel.
`LAUNCHES` (one a launch) and `PLAIN_CALLS` count both.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from lsdradixsort_tpu_torch.core.convert import i64_to_u32
from lsdradixsort_tpu_torch.core.profiling import annotate
from lsdradixsort_tpu_torch.kernels import _build

TILE = 1 << 15          # n granularity of the JAX kernel (256 x 128 rows)
CTA_THREADS = 256       # threads of a CTA of csrc/compaction.cu (kThreads)
MAX_STREAMS = 8         # streams the CUDA kernel moves in one launch

LAUNCHES = {"compact_stream_multi": 0}
PLAIN_CALLS = {"compact_stream_multi": 0}


def tile_rows(k: int) -> int:
    """Rows a CTA of csrc/compaction.cu takes when its launch moves k
    streams: 32 a thread for one or two streams (half the look-backs),
    16 for more, whose staged rows would leave room for one CTA an SM."""
    return CTA_THREADS * (32 if k <= 2 else 16)


def _check(mask: torch.Tensor, xs, tiled: bool = True) -> None:
    if not xs:
        raise ValueError("compact_stream_multi needs at least one stream")
    n = xs[0].shape[0]
    if tiled and n % TILE:
        raise ValueError(f"n={n} must be a multiple of {TILE}")
    if n >= 1 << 32:
        raise ValueError(f"n={n} must be below 2^32")
    if mask.dim() != 1 or mask.shape[0] != n:
        raise ValueError(f"mask must be ({n},), got {tuple(mask.shape)}")
    for x in xs:
        if x.dtype != torch.uint32 or x.dim() != 1 or x.shape[0] != n:
            raise ValueError("streams must be (n,) torch.uint32, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != mask.device:
            raise ValueError("mask and streams must be on one device")
    if mask.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {mask.device}")


def stream_groups(k: int) -> list[range]:
    """The streams each launch moves: k streams in consecutive groups of
    at most MAX_STREAMS."""
    return [range(lo, min(lo + MAX_STREAMS, k))
            for lo in range(0, k, MAX_STREAMS)]


def selected(mask: torch.Tensor) -> torch.Tensor:
    """A 0/1 (or bool) mask of any integer dtype as a bool tensor."""
    if mask.dtype == torch.bool:
        return mask
    if mask.element_size() == 4:
        return mask.view(torch.int32) != 0
    return mask != 0


def _plain(sel: torch.Tensor, xs) -> list[torch.Tensor]:
    PLAIN_CALLS["compact_stream_multi"] += 1
    outs = []
    for x in xs:
        picked = x.view(torch.int32)[sel]
        out = torch.zeros_like(x.view(torch.int32))
        out[:picked.shape[0]] = picked
        outs.append(out.view(torch.uint32))
    return outs


def compact_stream_multi_plain(mask: torch.Tensor, xs,
                               interpret: bool | None = None):
    """Plain PyTorch version: boolean indexing of each stream, the tail
    zeroed."""
    xs = list(xs)
    _check(mask, xs)
    return _plain(selected(mask), xs)


@functools.cache
def _entry():
    return _build.function("lsd_compact", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


_SPAN = "lsd.kernel.compact_stream_multi"


def _launch(mask: torch.Tensor, xs):
    """(count, outs) from the kernel: one launch a group of streams."""
    n, k = xs[0].shape[0], len(xs)
    count = torch.empty(1, dtype=torch.int32, device=mask.device)
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    if n == 0:
        return count.zero_().view(torch.uint32).reshape(()), outs
    m = selected(mask).contiguous().view(torch.uint8)   # bool bytes, 0/1
    rows = tile_rows(min(k, MAX_STREAMS))
    tiles = -(-n // rows)
    dev = mask.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    status = _build.lookback_status(dev, stream, tiles + 2)
    offsets = (torch.empty(tiles, dtype=torch.int32, device=mask.device)
               if k > MAX_STREAMS else None)
    for i, g in enumerate(stream_groups(k)):
        _build.check(_entry()(
            m.data_ptr(), _build.pointers(xs[g.start:g.stop]),
            _build.pointers(outs[g.start:g.stop]), len(g), n, rows,
            status.data_ptr(), None if offsets is None else offsets.data_ptr(),
            int(i > 0), count.data_ptr(), dev, stream), "lsd_compact")
        LAUNCHES["compact_stream_multi"] += 1
    return count.view(torch.uint32).reshape(()), outs


def compact_stream_multi(mask: torch.Tensor, xs,
                         interpret: bool | None = None):
    """Order-preserving compaction of k uint32 streams by one mask, one
    pass a group of MAX_STREAMS. Returns a list of (n,) uint32 tensors;
    see the module docstring."""
    xs = list(xs)
    if mask.device.type == "cpu":
        return compact_stream_multi_plain(mask, xs)
    _check(mask, xs)
    with annotate(_SPAN):
        return _launch(mask, xs)[1]


def compact_stream(mask: torch.Tensor, x: torch.Tensor,
                   interpret: bool | None = None) -> torch.Tensor:
    """Order-preserving compaction of one uint32 stream by mask: the first
    sum(mask) rows are x's selected rows in order; the tail is
    unspecified. n must be a multiple of 32768."""
    return compact_stream_multi(mask, [x])[0]


def _compact_rows(mask: torch.Tensor, xs):
    """(count, outs): `compact_stream_multi` at any n below 2^32, with the
    count of selected rows as a 0-dim uint32 tensor. On a CPU tensor the
    plain version, whose tail is zero."""
    xs = list(xs)
    _check(mask, xs, tiled=False)
    if mask.device.type == "cpu":
        sel = selected(mask)
        return i64_to_u32(sel.sum()), _plain(sel, xs)
    with annotate(_SPAN):
        return _launch(mask, xs)
