"""u32 columns in plain torch: CUDA torch has no indexing of uint32
tensors and CPU torch no uint32 compares or arithmetic, so values go
through int64 and bits through int32 views."""
from __future__ import annotations

import torch

SIGN = -(1 << 31)       # 0x80000000 as int32 bits


def to_i64(t: torch.Tensor) -> torch.Tensor:
    """u32 values as int64 in [0, 2^32)."""
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def from_i64(t: torch.Tensor) -> torch.Tensor:
    """int64 values, taken mod 2^32, as u32."""
    t = t & 0xFFFFFFFF
    return (t - ((t >> 31) << 32)).to(torch.int32).view(torch.uint32)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for a u32 column (idx: int64 positions or a bool mask)."""
    return x.view(torch.int32)[idx].view(torch.uint32)


def ascending_order(keys: torch.Tensor, stable: bool = True) -> torch.Tensor:
    """Positions that sort u32 keys ascending (unsigned), ties in input
    order: the sign-flipped int32 bits sort as the unsigned values."""
    return torch.sort(keys.view(torch.int32) ^ SIGN, stable=stable).indices


def float_order(keys: torch.Tensor) -> torch.Tensor:
    """Positions that sort u32 keys by their float32 roundings, stably:
    keys closer than a float32 step keep their input order."""
    return torch.sort(to_i64(keys).to(torch.float32), stable=True).indices


def rows_differ(got, want, n: int) -> int:
    """Rows among the first n at which any got column differs from its
    want column, bit for bit; rows that a got column lacks differ."""
    m = min([n] + [g.shape[0] for g in got])
    bad = torch.zeros(m, dtype=torch.bool, device=want[0].device)
    for g, w in zip(got, want, strict=True):
        g = g.to(w.device)
        bad |= g[:m].view(torch.int32) != w[:m].view(torch.int32)
    return int(bad.sum()) + (n - m)
