"""Order-preserving stream compaction — the port of
lsdradixsort_tpu/kernels/compaction.py.

  * `compact_stream_multi(mask, xs)`: k (n,) uint32 streams and one 0/1
    mask; in each output the first sum(mask) rows are that stream's
    selected rows in input order. The tail is unspecified (it is whatever
    the output buffer held). n must be a multiple of 32768, as in the JAX
    package (ops/filter.py pads with mask 0).
  * `compact_stream(mask, x)`: the same for one stream.

The TPU kernel walks its tiles in order with a bitonic partition of each
32K tile, a carry of < 128 rows and DMAs at a running output cursor,
because TPU grid steps run in order and the TPU has no scatter. CUDA
blocks run in no order, so on the card (``csrc/compaction.cu``, whose
header gives the design and what bounds it) compaction is count, scan,
scatter: each tile's selected rows are counted, the port's
`exclusive_scan` (kernels/scan.py) turns the counts into tile offsets,
and each tile scatters its selected rows to offset + rank in the tile.
Order is preserved by construction. One scatter launch moves up to
MAX_STREAMS streams; more streams share the one count and scan and are
scattered in groups of MAX_STREAMS (`stream_groups`).

`interpret` is the TPU's knob: accepted and ignored. On a CPU tensor the
wrapper runs the plain PyTorch version (boolean indexing, tail zeroed),
which `chip_smoke.py` also runs on the card to check the kernel.
`LAUNCHES` and `PLAIN_CALLS` count both.
"""
from __future__ import annotations

import ctypes

import torch

from lsdradixsort_tpu_torch.kernels import _build
from lsdradixsort_tpu_torch.kernels.scan import exclusive_scan

TILE = 1 << 15          # n granularity of the JAX kernel (256 x 128 rows)
BLOCK_ROWS = 1 << 12    # rows a block of csrc/compaction.cu counts (kTile)
MAX_STREAMS = 8         # streams the CUDA kernel moves in one launch

LAUNCHES = {"compact_stream_multi": 0}
PLAIN_CALLS = {"compact_stream_multi": 0}


def _check(mask: torch.Tensor, xs) -> None:
    if not xs:
        raise ValueError("compact_stream_multi needs at least one stream")
    n = xs[0].shape[0]
    if n % TILE:
        raise ValueError(f"n={n} must be a multiple of {TILE}")
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
    """The streams each scatter launch moves: k streams in consecutive
    groups of at most MAX_STREAMS."""
    return [range(lo, min(lo + MAX_STREAMS, k))
            for lo in range(0, k, MAX_STREAMS)]


def selected(mask: torch.Tensor) -> torch.Tensor:
    """A 0/1 (or bool) mask of any integer dtype as a bool tensor."""
    if mask.dtype == torch.bool:
        return mask
    if mask.element_size() == 4:
        return mask.view(torch.int32) != 0
    return mask != 0


def compact_stream_multi_plain(mask: torch.Tensor, xs,
                               interpret: bool | None = None):
    """Plain PyTorch version: boolean indexing of each stream, the tail
    zeroed."""
    xs = list(xs)
    _check(mask, xs)
    PLAIN_CALLS["compact_stream_multi"] += 1
    sel = selected(mask)
    outs = []
    for x in xs:
        picked = x.view(torch.int32)[sel]
        out = torch.zeros_like(x.view(torch.int32))
        out[:picked.shape[0]] = picked
        outs.append(out.view(torch.uint32))
    return outs


def compact_stream_multi(mask: torch.Tensor, xs,
                         interpret: bool | None = None):
    """Order-preserving compaction of k uint32 streams by one mask, in one
    count-scan-scatter. Returns a list of (n,) uint32 tensors; see the
    module docstring."""
    xs = list(xs)
    if mask.device.type == "cpu":
        return compact_stream_multi_plain(mask, xs)
    _check(mask, xs)
    n = xs[0].shape[0]
    m = selected(mask).contiguous().view(torch.uint8)   # bool bytes, 0/1
    if m.data_ptr() % 16:                      # the count kernel's loads
        m = m.clone()
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    with torch.cuda.device(mask.device):
        counts = torch.empty(n // BLOCK_ROWS, dtype=torch.uint32,
                             device=mask.device)
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(mask.device).cuda_stream)
        fn = _build.function("lsd_compact_counts", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p])
        _build.check(fn(m.data_ptr(), counts.data_ptr(), counts.shape[0], n,
                        stream), "lsd_compact_counts")
        offsets = exclusive_scan(counts)
        fn = _build.function("lsd_compact_scatter", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p])
        for g in stream_groups(len(xs)):
            _build.check(fn(m.data_ptr(), offsets.data_ptr(),
                            _build.pointers(xs[g.start:g.stop]),
                            _build.pointers(outs[g.start:g.stop]), len(g), n,
                            stream), "lsd_compact_scatter")
    LAUNCHES["compact_stream_multi"] += 1
    return outs


def compact_stream(mask: torch.Tensor, x: torch.Tensor,
                   interpret: bool | None = None) -> torch.Tensor:
    """Order-preserving compaction of one uint32 stream by mask: the first
    sum(mask) rows are x's selected rows in order; the tail is
    unspecified. n must be a multiple of 32768."""
    return compact_stream_multi(mask, [x])[0]
