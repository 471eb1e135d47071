"""Moving columns between numpy and the port's tensors, bit for bit.

The system has no weights: the state it carries is the data. The JAX
package consumes numpy u32/i32/f32 arrays; `from_numpy` turns the same
arrays into tensors of the same dtype and bits on a chosen device, and
`to_numpy` brings a tensor back, so both packages can be fed one input
and their outputs compared with numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from lsdradixsort_tpu_torch.core.profiling import COUNTS

_NP_TO_TORCH = {
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}
_SIGN = 1 << 31


def from_numpy(a, device="cpu") -> torch.Tensor:
    """A 32-bit numpy array (u32/i32/f32) as a contiguous tensor of the
    same dtype and bits on `device`."""
    a = np.ascontiguousarray(a)
    if a.dtype not in _NP_TO_TORCH:
        raise TypeError(f"32-bit columns are u32/i32/f32, got {a.dtype}")
    # carry the bits as int32 (every device copies int32), then reinterpret
    bits = torch.from_numpy(a.view(np.int32).copy()).to(device)
    return bits.view(_NP_TO_TORCH[a.dtype])


def u32_to_i64(t: torch.Tensor) -> torch.Tensor:
    """uint32 values as int64 in [0, 2^32), where every device has
    compares and arithmetic. Counted in `int64_bytes`
    (core/profiling.py)."""
    COUNTS["int64_bytes"] += 8 * t.numel()
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def i64_to_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) back to uint32 (inverse of u32_to_i64)."""
    return (t - ((t >> 31) << 32)).to(torch.int32).view(torch.uint32)


def order_key(words, flip1: bool = False) -> torch.Tensor:
    """int64 whose ascending order is the lexicographic unsigned order of
    one or two u32 words (word 1 compared signed when flip1)."""
    key = u32_to_i64(words[0])
    if len(words) == 1:
        return key
    val = u32_to_i64(words[1])
    if flip1:
        val = val ^ _SIGN
    return (key - _SIGN) * (1 << 32) + val


def wrap_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values mod 2^32 as uint32: the wraparound of u32 arithmetic
    done on `u32_to_i64` values."""
    return i64_to_u32(t & 0xFFFFFFFF)


def row_order(words, width: int, flip1: bool = False) -> torch.Tensor:
    """Stable ascending order within each row of `width` u32 rows compared
    lexicographically on their words (word 1 signed when flip1), as a
    (rows, width) int64 permutation. Words past the second are sorted
    first, least significant first, then once by the first two."""
    perm = None
    for w in reversed(words[2:]):
        perm = _stable_rows(u32_to_i64(w).view(-1, width), perm)
    return _stable_rows(order_key(words[:2], flip1).view(-1, width), perm)


def segment_orders(words, width: int, flip1: bool = False):
    """`row_order` of u32 rows cut into segments of `width` rows, the last
    ending at n (it may be shorter): (lo, hi, perm) of rows [lo, hi), for
    the whole segments together, then for the short last one."""
    n = words[0].shape[0]
    full = n - n % width
    return [(lo, hi, row_order([w[lo:hi] for w in words],
                               min(width, hi - lo), flip1))
            for lo, hi in ((0, full), (full, n)) if hi > lo]


def sort_segments(words, riders, width: int, flip1: bool = False):
    """The u32 streams words, then riders, each segment of `width` rows
    (the last may be shorter) stably sorted by the words."""
    parts = [[take_rows(s[lo:hi], perm) for s in (*words, *riders)]
             for lo, hi, perm in segment_orders(words, width, flip1)]
    if not parts:
        return [*words, *riders]
    return [torch.cat(c) if len(c) > 1 else c[0] for c in zip(*parts)]


def _stable_rows(key: torch.Tensor, perm) -> torch.Tensor:
    """perm refined by a stable sort of each row of key taken along it."""
    if perm is not None:
        key = key.gather(1, perm)
    idx = torch.sort(key, dim=1, stable=True).indices
    return idx if perm is None else perm.gather(1, idx)


def stable_order(words) -> torch.Tensor:
    """Stable ascending order (int64 positions) of u32 rows compared
    lexicographically on their words."""
    return row_order(words, words[0].shape[0]).view(-1)


def gather(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """x[perm]; a 32-bit tensor is carried as its int32 bits."""
    if x.element_size() == 4:
        return x.view(torch.int32)[perm].view(x.dtype)
    return x[perm]


def take_rows(s: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Gather u32 stream `s`, viewed as perm's (rows, width), by perm."""
    rows, width = perm.shape
    return (s.view(torch.int32).view(rows, width).gather(1, perm)
            .reshape(-1).view(torch.uint32))


def iota_u32(n: int, device) -> torch.Tensor:
    """0, 1, ..., n-1 as uint32 (n < 2^31)."""
    return torch.arange(n, dtype=torch.int32, device=device).view(
        torch.uint32)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A 32-bit tensor (u32/i32/f32) as a numpy array of the same bits."""
    np_dt = _TORCH_TO_NP.get(t.dtype)
    if np_dt is None:
        raise TypeError(f"32-bit columns are u32/i32/f32, got {t.dtype}")
    return t.detach().view(torch.int32).cpu().numpy().view(np_dt)
