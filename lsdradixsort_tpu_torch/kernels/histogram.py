"""Per-block digit histograms — the port of
lsdradixsort_tpu/kernels/histogram.py.

  * `block_digit_histograms`: (n,) u32 keys -> (n / block_size, 2^r) u32,
    row b counting the r-bit digit `group` of keys [b * B, (b + 1) * B):
    the contract of BuildHistogramsKernel (LSDRadixSort.cu:660-702).
  * `digit_histogram`: the whole array's (2^r,) counts, the sum of the
    block histograms at the JAX package's block choice (`_pick_block`).

The TPU kernel counts with byte- or nibble-packed one-hot counters
(`counter_bits` 8 or 4) because the TPU has no atomics. Both give the
same counts; the port checks `counter_bits` and otherwise ignores it. On a
CUDA tensor `block_digit_histograms` launches ``csrc/histogram.cu`` (its
header says what bounds it and how the design copes): for r up to 12 the
counters live in shared memory, a column a lane, a copy a warp or a copy
a CTA (`hist_plan`), and each counting group walks units of at most
UNIT_KEYS keys; for r = 13..31 a second kernel keeps them in device
memory with global atomics. On a CPU tensor it runs the plain PyTorch
version beside it (`torch.bincount` of block * 2^r + digit), which
`chip_smoke.py` also runs on the card to check the kernel. `LAUNCHES`
and `PLAIN_CALLS` count both.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from lsdradixsort_tpu_torch.core.convert import i64_to_u32, u32_to_i64
from lsdradixsort_tpu_torch.core.digits import get_digit
from lsdradixsort_tpu_torch.core.profiling import annotate
from lsdradixsort_tpu_torch.kernels import _build

LANES = 128
MAX_R = 31           # 2^r counters a block; a 32-bit digit has no room

LAUNCHES = {"block_digit_histograms": 0}
PLAIN_CALLS = {"block_digit_histograms": 0}

# csrc/histogram.cu's counting groups and counters, by r: a column of
# counters a lane (LANE, r <= LANE_MAX_R), a copy a warp (WARP, r <=
# WARP_MAX_R), a copy a CTA of CTA_THREADS (CTA, r <= SHARED_MAX_R); above
# that, the device-memory kernel
LANE, WARP, CTA = 0, 1, 2
LANE_MAX_R, WARP_MAX_R, SHARED_MAX_R = 4, 8, 12
CTA_THREADS = 256
UNIT_KEYS = 1 << 13     # keys a counting group counts before it writes


class HistPlan(NamedTuple):
    """How csrc/histogram.cu counts blocks of `block_size` keys at r <=
    SHARED_MAX_R: counters kept as `mode` says by groups of
    `group_threads`, each block counted as `parts` units of `unit` keys
    (the last unit of a block may be shorter), `units` in all."""
    mode: int
    group_threads: int
    unit: int
    parts: int
    units: int


def hist_plan(n: int, block_size: int, r: int) -> HistPlan:
    """The counting plan of n keys in blocks of `block_size` (a multiple
    of LANES that divides n) at r <= SHARED_MAX_R."""
    if not 0 <= r <= SHARED_MAX_R:
        raise ValueError(f"r={r}: shared-memory counters hold r <= "
                         f"{SHARED_MAX_R}")
    mode = LANE if r <= LANE_MAX_R else WARP if r <= WARP_MAX_R else CTA
    parts = -(-block_size // UNIT_KEYS)
    unit = -(-block_size // parts // LANES) * LANES
    parts = -(-block_size // unit)
    return HistPlan(mode, CTA_THREADS if mode == CTA else 32, unit, parts,
                    n // block_size * parts)


def _check(keys: torch.Tensor, r: int, block_size: int,
           counter_bits: int) -> None:
    n = keys.shape[0]
    if n % block_size or block_size % LANES:
        raise ValueError(
            f"n={n} must be divisible by block_size={block_size}, "
            f"block_size by {LANES}")
    if counter_bits not in (4, 8):
        raise ValueError(f"counter_bits must be 4 or 8, got {counter_bits}")
    if not 0 <= r <= MAX_R:
        raise ValueError(f"r={r} must be in [0, {MAX_R}]")
    if keys.dtype not in (torch.uint32, torch.int32) or keys.dim() != 1:
        raise ValueError(f"keys must be (n,) uint32, got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")


def block_digit_histograms_plain(keys: torch.Tensor, r: int, group: int,
                                 block_size: int, counter_bits: int = 8,
                                 interpret: bool | None = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version: one bincount of block id * 2^r + digit."""
    _check(keys, r, block_size, counter_bits)
    PLAIN_CALLS["block_digit_histograms"] += 1
    n = keys.shape[0]
    nb, bins = n // block_size, 1 << r
    bin_of = get_digit(keys, r, group).to(torch.int64).view(nb, block_size)
    bin_of += torch.arange(nb, device=keys.device).unsqueeze(1) * bins
    counts = torch.bincount(bin_of.view(-1), minlength=nb * bins)
    return i64_to_u32(counts).view(nb, bins)


def block_digit_histograms(keys: torch.Tensor, r: int, group: int,
                           block_size: int, counter_bits: int = 8,
                           interpret: bool | None = None) -> torch.Tensor:
    """Per-block digit histograms: (n / block_size, 2^r) uint32.

    Requires n % block_size == 0 and block_size % 128 == 0 (the JAX
    package's contract). counter_bits (4 or 8) is the TPU kernel's
    counter packing; it never changes the counts."""
    if keys.device.type == "cpu":
        return block_digit_histograms_plain(keys, r, group, block_size,
                                            counter_bits)
    _check(keys, r, block_size, counter_bits)
    with annotate("lsd.kernel.block_digit_histograms"):
        keys = keys.contiguous()
        n = keys.shape[0]
        out = torch.empty((n // block_size, 1 << r), dtype=torch.uint32,
                          device=keys.device)
        # the device-memory kernel (r > SHARED_MAX_R) takes no plan
        plan = (hist_plan(n, block_size, r) if r <= SHARED_MAX_R
                else HistPlan(LANE, 0, 0, 0, 0))
        with torch.cuda.device(keys.device):
            fn = _build.function("lsd_block_histograms", [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
            stream = torch.cuda.current_stream(keys.device).cuda_stream
            _build.check(fn(keys.data_ptr(), out.data_ptr(), n, block_size,
                            r, group, plan.mode, plan.unit, plan.parts,
                            ctypes.c_void_p(stream)),
                         "lsd_block_histograms")
    LAUNCHES["block_digit_histograms"] += 1
    return out


def digit_histogram(keys: torch.Tensor, r: int, group: int,
                    interpret: bool | None = None) -> torch.Tensor:
    """Whole-array digit histogram: (2^r,) uint32, the sum of the block
    histograms."""
    h = block_digit_histograms(keys, r, group, _pick_block(keys.shape[0]))
    return i64_to_u32(u32_to_i64(h).sum(dim=0) & 0xFFFFFFFF)


def _pick_block(n: int) -> int:
    for block in (1 << 17, 1 << 15, 1 << 13, 1 << 10, 1 << 8, LANES):
        if n % block == 0:
            return block
    raise ValueError(f"n={n} must be a multiple of {LANES}")
