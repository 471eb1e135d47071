"""Distributed digit histogram: each rank's histogram of its shard, then
one all-reduce — the port of lsdradixsort_tpu/parallel/dist_hist.py.

The multi-host analog of BuildHistogramsKernel + the digit-major global
scan (LSDRadixSort.cu:660-702, 877-895): every rank counts its rows on
its device (kernels/histogram.py, the `block_histograms` kernel on a
CUDA tensor), then one all-reduce over the mesh gives the exact global
digit counts. The counts cross as int64 (the collectives refuse uint32);
they are below 2^32, so this is JAX's uint32 psum.
"""
from __future__ import annotations

import torch

from lsdradixsort_tpu_torch.core.convert import i64_to_u32, u32_to_i64
from lsdradixsort_tpu_torch.kernels.histogram import digit_histogram
from lsdradixsort_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh,
                                                  _check_member, psum)


def dist_digit_histogram(keys: torch.Tensor, r: int, group: int, mesh: Mesh,
                         axis: str = DATA_AXIS) -> torch.Tensor:
    """Global histogram of the `group`-th r-bit digit over the keys, each
    rank passing its shard. Returns the (2**r,) uint32 global counts on
    every rank."""
    _check_member(mesh)
    local = u32_to_i64(digit_histogram(keys, r, group))
    return i64_to_u32(psum(local, mesh))
