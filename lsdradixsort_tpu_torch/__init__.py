"""lsdradixsort_tpu_torch — the PyTorch/CUDA port of lsdradixsort_tpu for
one NVIDIA H100.

It mirrors the JAX package's layout and function names; the JAX package
stays the reference the port is tested against. Plain tensor code is
PyTorch, and each Pallas TPU kernel on the ported path is a CUDA C++
kernel for sm_90a (csrc/), built with nvcc at first use
(kernels/_build.py). On CPU tensors every kernel wrapper runs its plain
PyTorch version instead.

Layer map:
  core/      key codecs, digit math, numpy <-> tensor conversion, data
             generation, CUDA-event timing, the roofline
  kernels/   tile sort, 8-way merge pass, digit histogram, exclusive
             scans, tiled transpose (CUDA + plain versions)
  ops/       the sort operators (merge_sort_*, sort, sort_kv, ...)
  utils/     bit-exact verification helpers
  bench/     the flagship benchmark (bench/flagship.py)
"""
from lsdradixsort_tpu_torch.kernels.histogram import (block_digit_histograms,
                                                      digit_histogram)
from lsdradixsort_tpu_torch.kernels.merge import (merge_pass, merge_pass_kv,
                                                  merge_pass_multi)
from lsdradixsort_tpu_torch.kernels.scan import (block_prefix_sums,
                                                 exclusive_scan)
from lsdradixsort_tpu_torch.kernels.tile_sort import (sort_tiles,
                                                      sort_tiles_kv,
                                                      sort_tiles_multi)
from lsdradixsort_tpu_torch.ops.sort import (argsort, merge_sort_keys,
                                             merge_sort_multi,
                                             merge_sort_with_ranks, sort,
                                             sort_kv, sort_with_ranks)

__all__ = [
    "sort", "sort_kv", "argsort", "sort_with_ranks",
    "merge_sort_keys", "merge_sort_with_ranks", "merge_sort_multi",
    "sort_tiles", "sort_tiles_kv", "sort_tiles_multi",
    "merge_pass", "merge_pass_kv", "merge_pass_multi",
    "digit_histogram", "block_digit_histograms",
    "exclusive_scan", "block_prefix_sums",
]
