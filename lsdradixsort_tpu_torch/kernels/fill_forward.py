"""Fill-forward of the last flagged row — the port of
lsdradixsort_tpu/kernels/fill_forward.py.

`fill_forward_last(flag, key, val)`: for each row i, the (key, val) of
the last row j <= i with flag[j], and valid = 1; rows before the first
flagged row get (0, 0, 0), as the TPU kernel's zeroed carry gives them.
Any n < 2^31; all three outputs are (n,) uint32. This is the segmented
broadcast behind the join: build rows are flagged, and each probe row
reads the nearest build row before it.

The TPU kernel does log2(tile) masked roll steps inside a tile and
threads a carry through grid steps that run in order; its docstring rules
out cummax plus gather because XLA's gather is slow on the TPU. On the
card (``csrc/fill_forward.cu``, whose header gives the design and what
bounds it) it is exactly that: an inclusive max-scan of
``flag ? i : -1`` (per tile in shared memory, with a pass that carries
each tile's last flagged row forward), then a gather of key and val at
that index, which is near and cached.

`tile_rows` and `interpret` are the TPU's knobs: accepted and ignored. On
a CPU tensor the wrapper runs the plain PyTorch version (`torch.cummax`
and a gather), which `chip_smoke.py` also runs on the card to check the
kernel. `LAUNCHES` and `PLAIN_CALLS` count both.
"""
from __future__ import annotations

import ctypes

import torch

from lsdradixsort_tpu_torch.core.profiling import annotate
from lsdradixsort_tpu_torch.kernels import _build
from lsdradixsort_tpu_torch.kernels.compaction import selected

BLOCK_ROWS = 1 << 12    # rows a block of csrc/fill_forward.cu fills (kTile)

LAUNCHES = {"fill_forward_last": 0}
PLAIN_CALLS = {"fill_forward_last": 0}


def _check(flag: torch.Tensor, key: torch.Tensor, val: torch.Tensor) -> None:
    n = flag.shape[0]
    if flag.dim() != 1:
        raise ValueError(f"flag must be (n,), got {tuple(flag.shape)}")
    if n >= 1 << 31:
        raise ValueError(f"n={n} must be below 2^31")
    for x in (key, val):
        if x.dtype != torch.uint32 or x.dim() != 1 or x.shape[0] != n:
            raise ValueError(f"key and val must be ({n},) torch.uint32, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != flag.device:
            raise ValueError("flag, key and val must be on one device")
    if flag.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {flag.device}")


def fill_forward_last_plain(flag: torch.Tensor, key: torch.Tensor,
                            val: torch.Tensor, tile_rows: int = 512,
                            interpret: bool | None = None):
    """Plain PyTorch version: cummax of the flagged positions, a gather."""
    _check(flag, key, val)
    PLAIN_CALLS["fill_forward_last"] += 1
    n = flag.shape[0]
    pos = torch.arange(n, device=flag.device)
    last = torch.where(selected(flag), pos, -1).cummax(0).values
    valid = last >= 0
    at = last.clamp(min=0)
    zero = torch.zeros((), dtype=torch.int32, device=flag.device)
    return (torch.where(valid, key.view(torch.int32)[at], zero)
            .view(torch.uint32),
            torch.where(valid, val.view(torch.int32)[at], zero)
            .view(torch.uint32),
            valid.to(torch.int32).view(torch.uint32))


def fill_forward_last(flag: torch.Tensor, key: torch.Tensor,
                      val: torch.Tensor, tile_rows: int = 512,
                      interpret: bool | None = None):
    """(keys, vals, valid), each (n,) uint32: the key and val of the last
    flagged row at or before each row, and whether there is one. flag is
    bool or a 0/1 integer tensor; key and val are uint32."""
    if flag.device.type == "cpu":
        return fill_forward_last_plain(flag, key, val)
    _check(flag, key, val)
    n = flag.shape[0]
    with annotate("lsd.kernel.fill_forward_last"):
        f = selected(flag).contiguous().view(torch.uint8)
        key, val = key.contiguous(), val.contiguous()
        outs = [torch.empty_like(key) for _ in range(3)]
        with torch.cuda.device(flag.device):
            # one int32 a tile: each tile's last flagged row, then its carry
            scratch = torch.empty(max(-(-n // BLOCK_ROWS), 1),
                                  dtype=torch.int32, device=flag.device)
            fn = _build.function("lsd_fill_forward", [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p])
            stream = torch.cuda.current_stream(flag.device).cuda_stream
            _build.check(fn(f.data_ptr(), key.data_ptr(), val.data_ptr(),
                            scratch.data_ptr(), scratch.shape[0],
                            *(o.data_ptr() for o in outs), n,
                            ctypes.c_void_p(stream)), "lsd_fill_forward")
    LAUNCHES["fill_forward_last"] += 1
    return tuple(outs)
