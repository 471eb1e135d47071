"""Gather of whole fixed-width records by a permutation.

`gather_records(records, perm)`: out[i] = records[perm[i]] for an (n, R)
uint8 tensor of records and an (m,) uint32 tensor of row indices (each
below n), as `ops/sort.py` `sort_records` moves the records after their
keys are sorted. The JAX package has no such op: it moves no row wider
than one u32 word, and `core/convert.py` `gather` moves one 32-bit column
by int64 indices.

On the card (``csrc/records.cu``, whose header gives the design and what
bounds it) one launch copies the rows, taking the u32 permutation as it
is. On a CPU tensor the wrapper runs the plain PyTorch version, an
`index_select` of the rows by the permutation's int32 view, which
`chip_smoke.py` also runs on the card to check the kernel. `LAUNCHES` and
`PLAIN_CALLS` count both; every call adds the bytes of the rows it moves
to `record_bytes` (core/profiling.py).
"""
from __future__ import annotations

import ctypes

import torch

from lsdradixsort_tpu_torch.core.profiling import COUNTS, annotate
from lsdradixsort_tpu_torch.kernels import _build

MAX_WIDTH = 1 << 23     # bytes a row (csrc/records.cu: kRows rows in int)

LAUNCHES = {"gather_records": 0}
PLAIN_CALLS = {"gather_records": 0}


def _check(records: torch.Tensor, perm: torch.Tensor) -> None:
    if records.dtype != torch.uint8 or records.dim() != 2:
        raise ValueError(f"records must be an (n, R) uint8 tensor, got "
                         f"{records.dtype} {tuple(records.shape)}")
    if perm.dtype != torch.uint32 or perm.dim() != 1:
        raise ValueError(f"perm must be an (m,) uint32 tensor, got "
                         f"{perm.dtype} {tuple(perm.shape)}")
    if perm.device != records.device:
        raise ValueError("records and perm must be on one device")
    if records.shape[0] >= 1 << 31 or perm.shape[0] >= 1 << 31:
        raise ValueError("rows must number below 2^31")
    if records.shape[1] > MAX_WIDTH:
        raise ValueError(f"rows of {records.shape[1]} bytes: at most "
                         f"{MAX_WIDTH}")
    if records.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {records.device}")


def gather_records_plain(records: torch.Tensor,
                         perm: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the rows selected by the permutation's int32
    view (its values are below 2^31)."""
    _check(records, perm)
    PLAIN_CALLS["gather_records"] += 1
    COUNTS["record_bytes"] += perm.shape[0] * records.shape[1]
    return records.index_select(0, perm.view(torch.int32))


def gather_records(records: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """A new (m, R) uint8 tensor whose row i is records[perm[i]]."""
    if records.device.type == "cpu":
        return gather_records_plain(records, perm)
    _check(records, perm)
    m, width = perm.shape[0], records.shape[1]
    with annotate("lsd.kernel.gather_records"):
        records, perm = records.contiguous(), perm.contiguous()
        out = torch.empty((m, width), dtype=torch.uint8,
                          device=records.device)
        with torch.cuda.device(records.device):
            fn = _build.function("lsd_gather_records", [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p])
            stream = torch.cuda.current_stream(records.device).cuda_stream
            _build.check(fn(records.data_ptr(), perm.data_ptr(),
                            out.data_ptr(), m, width,
                            ctypes.c_void_p(stream)), "lsd_gather_records")
    LAUNCHES["gather_records"] += 1
    COUNTS["record_bytes"] += m * width
    return out
