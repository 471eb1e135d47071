"""Digit math for radix decomposition of integer keys.

The port's own copy of lsdradixsort_tpu/core/digits.py (which imports
jax.numpy): the reference's ``GET_R_BITS(n, r, i)`` macro (Utils.h:22),
the i-th r-bit digit of a key, on torch tensors, with numpy mirrors for
the golden models.

CPU torch has no reliable shifts on ``torch.uint32``, so digits are taken
from the bit-identical int32 view, with the arithmetic shift's copies of
the sign bit masked off, or from int64 values for keys of other widths.
"""
from __future__ import annotations

import numpy as np
import torch

KEY_BITS = 32
KEY_DTYPE = torch.uint32


def num_digit_groups(r: int, key_bits: int = KEY_BITS) -> int:
    """Number of r-bit digit groups in a key (reference: LSDRadixSort.cu:64)."""
    if r <= 0 or r > key_bits:
        raise ValueError(f"digit width r={r} must be in [1, {key_bits}]")
    return (key_bits + r - 1) // r


def _as_i32(mask: int) -> int:
    """A 32-bit mask as the int32 value with the same bits."""
    return mask - (1 << 32) if mask >= 1 << 31 else mask


def get_digit(keys: torch.Tensor, r: int, group: int) -> torch.Tensor:
    """The `group`-th r-bit digit of each key (Utils.h:22), as int32.

    As in the JAX package: the key is taken as uint32, a shift of 32 bits
    or more leaves 0, and a digit of 32 bits keeps its bits in the int32.
    """
    shift = r * group
    if keys.element_size() == 4 and not keys.is_floating_point():
        bits = keys.view(torch.int32)
        if shift >= KEY_BITS:
            return torch.zeros_like(bits)
        # the arithmetic shift copies bit 31 into the top `shift` bits:
        # the mask keeps only the key's own bits
        mask = ((1 << r) - 1) & ((1 << (KEY_BITS - shift)) - 1)
        return (bits >> shift) & _as_i32(mask)
    wide = keys.to(torch.int64) & 0xFFFFFFFF
    digit = (wide >> min(shift, 63)) & ((1 << r) - 1)
    return (digit - ((digit >> 31) << 32)).to(torch.int32)


def get_digit_np(keys: np.ndarray, r: int, group: int) -> np.ndarray:
    """numpy mirror of :func:`get_digit` for golden models."""
    mask = np.uint32((1 << r) - 1)
    shifted = (keys.astype(np.uint32) >> np.uint32(r * group))
    return (shifted & mask).astype(np.int64)


def low_bits_mask(r: int, group: int) -> int:
    """Mask covering digit groups 0..group inclusive (the already-sorted
    prefix after LSD pass `group`)."""
    total = min(r * (group + 1), KEY_BITS)
    return (1 << total) - 1 if total < 64 else (1 << 64) - 1
