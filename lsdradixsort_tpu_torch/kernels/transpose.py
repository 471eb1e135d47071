"""Matrix transpose — the port of lsdradixsort_tpu/kernels/transpose.py.

  * `transpose`: the plain `a.t().contiguous()`, as the JAX package's
    `transpose` is XLA's `.T`.
  * `transpose_tiled`: the kernel (TransposeSMEMKernel, LSDRadixSort.cu:
    512-544). 4-byte dtypes; (rows, cols) -> (cols, rows). `tile` is the
    TPU's block: only its divisibility check is kept, for API parity.

On a CUDA tensor `transpose_tiled` launches ``csrc/transpose.cu`` (a
thread a 4 x 4 block in registers for up to 32 columns, else 32 x 32
shared-memory tiles; its header says what bounds it); on a CPU tensor it
runs the plain version, which `chip_smoke.py` also runs on the card to
check the kernel. `LAUNCHES` and `PLAIN_CALLS` count both.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from lsdradixsort_tpu_torch.core.profiling import annotate
from lsdradixsort_tpu_torch.kernels import _build

LAUNCHES = {"transpose_tiled": 0}
PLAIN_CALLS = {"transpose_tiled": 0}


def transpose(a: torch.Tensor) -> torch.Tensor:
    """Transpose a 2-D tensor (Transpose golden: LSDRadixSort.cu:483-494)."""
    return a.t().contiguous()


def _check(a: torch.Tensor) -> None:
    if a.ndim != 2 or a.element_size() != 4:
        raise ValueError(f"transpose_tiled takes a 2-D tensor of a 4-byte "
                         f"dtype, got {a.dtype} {tuple(a.shape)}")
    if not a.is_cuda and a.device.type != "cpu":
        raise ValueError(f"unsupported device {a.device}")


def transpose_plain(a: torch.Tensor) -> torch.Tensor:
    _check(a)
    PLAIN_CALLS["transpose_tiled"] += 1
    return a.t().contiguous()


@functools.cache
def _transpose():
    return _build.function("lsd_transpose", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def transpose_any(a: torch.Tensor) -> torch.Tensor:
    """(cols, rows) transpose of a 2-D 4-byte tensor of any shape: the
    launch behind `transpose_tiled`, which the composed sort also calls on
    its (blocks, 2^r) histogram."""
    if not a.is_cuda:
        return transpose_plain(a)
    _check(a)
    rows, cols = a.shape
    # the histogram's transpose is bound by host time: the C entry cached,
    # the raw stream handle, the device passed to the C entry
    with annotate("lsd.kernel.transpose_any"):
        a = a.contiguous()
        out = a.new_empty((cols, rows))
        dev = a.get_device()
        stream = torch._C._cuda_getCurrentRawStream(dev)
        _build.check(_transpose()(a.data_ptr(), out.data_ptr(), rows, cols,
                                  dev, stream), "lsd_transpose")
    LAUNCHES["transpose_tiled"] += 1
    return out


def transpose_tiled(a: torch.Tensor, tile: int = 256,
                    interpret: bool | None = None) -> torch.Tensor:
    """Tiled transpose (TransposeSMEMKernel equivalent, cu:512-544).
    Requires both dims divisible by `tile`; `interpret` is the TPU's knob,
    accepted and ignored."""
    rows, cols = a.shape
    if rows % tile or cols % tile:
        raise ValueError(f"dims {tuple(a.shape)} must be divisible by "
                         f"tile={tile}")
    return transpose_any(a)
