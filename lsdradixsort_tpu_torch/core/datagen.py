"""Deterministic data generation on a `torch.Generator`.

Counterpart of lsdradixsort_tpu/core/datagen.py: every input is
reproducible from an integer seed and is generated on the chosen device,
the card unless the caller names another (as `jax.random` draws on the
default device).
The bits differ from `jax.random`'s, so tests that compare the two
packages make their inputs with numpy and pass them through
`core.convert.from_numpy` instead.
"""
from __future__ import annotations

import torch

from lsdradixsort_tpu_torch.core.convert import i64_to_u32, iota_u32
from lsdradixsort_tpu_torch.core.convert import to_numpy as _to_numpy

_WORDS = (torch.uint32, torch.int32, torch.float32)   # convert.to_numpy's


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def random_keys(n: int, seed: int = 0, device="cuda",
                dtype=torch.uint32) -> torch.Tensor:
    """n uniform random keys over the full range of the dtype's bits (1,
    2, 4 or 8 bytes: uint32, int32 or float32 bit patterns, uint8, ...),
    generated on `device`. A dtype in the third place is taken as the
    dtype, as in the JAX package's `random_keys(n, seed, dtype)`."""
    if isinstance(device, torch.dtype):
        device, dtype = ("cuda" if isinstance(dtype, torch.dtype)
                         else dtype), device
    size = torch.empty((), dtype=dtype).element_size()
    words = -(-n * size // 4)
    bits = torch.randint(-(1 << 31), 1 << 31, (words,), dtype=torch.int32,
                         device=device, generator=_generator(seed, device))
    return bits.view(torch.uint8)[:n * size].view(dtype)


def random_kv(n: int, seed: int = 0, device="cuda"):
    """(keys, values): uniform u32 keys and distinct row ids as values, so
    stability is checkable bit for bit."""
    return random_keys(n, seed, device), iota_u32(n, device)


def random_keys_bounded(n: int, lo: int, hi: int, seed: int = 0,
                        device="cuda") -> torch.Tensor:
    """Uniform u32 keys in [lo, hi), 0 <= lo < hi <= 2^32."""
    if not 0 <= lo < hi <= 1 << 32:
        raise ValueError(f"need 0 <= lo < hi <= 2^32, got [{lo}, {hi})")
    vals = torch.randint(lo, hi, (n,), dtype=torch.int64, device=device,
                         generator=_generator(seed, device))
    return i64_to_u32(vals)


def skewed_keys(n: int, seed: int = 0, hot_fraction: float = 0.9,
                hot_key: int = 0xDEADBEEF, device="cuda") -> torch.Tensor:
    """Adversarially skewed u32 keys: each row is `hot_key` with
    probability `hot_fraction`, else a uniform 32-bit key (the JAX
    package's distribution and arguments, not its bits)."""
    g = _generator(seed, device)
    uniform = torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                            device=device, generator=g)
    is_hot = torch.rand(n, device=device, generator=g) < hot_fraction
    hot = hot_key - (1 << 32) if hot_key >= 1 << 31 else hot_key  # i32 bits
    return torch.where(is_hot, hot, uniform).view(torch.uint32)


def to_numpy(*tensors):
    """numpy copies of the tensors, in their own dtypes: one array for one
    tensor, else a tuple."""
    out = tuple(_to_numpy(t) if t.dtype in _WORDS
                else t.detach().cpu().numpy() for t in tensors)
    return out[0] if len(out) == 1 else out
