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
             generation, CUDA-event and host timing, the roofline,
             torch.profiler tracing
  kernels/   tile sort, 8-way merge passes (grouped runs, and runs in
             separate buffers for the chunked sort), digit histogram,
             exclusive scans, tiled transpose, stream compaction,
             fill-forward, hash-table probe, run shuffles, the gather
             of whole records (CUDA + plain versions)
  golden/    numpy golden models (the bench runner's oracles)
  native/    ctypes bindings of the repo-root native/ C++ host library
  ops/       the sort operators (merge_sort_*, sort, sort_kv, sort_lex,
             sort_records, sort64_with_ranks, sort_blocks_kv, ...), the
             chip-scale chunked sort (bigsort), the query operators
             (filter, group by, join, top-k, unique) and window ranks
  utils/     bit-exact verification helpers
  bench/     the benchmark CLI (`python -m lsdradixsort_tpu_torch.bench`,
             bench/runner.py), the flagship benchmark (bench/flagship.py)
             and the query benchmark (bench/query.py)
"""
from lsdradixsort_tpu_torch.core import datagen, digits, roofline, timing
from lsdradixsort_tpu_torch.kernels.fill_forward import fill_forward_last
from lsdradixsort_tpu_torch.kernels.histogram import (block_digit_histograms,
                                                      digit_histogram)
from lsdradixsort_tpu_torch.kernels.merge import (merge_pass, merge_pass_kv,
                                                  merge_pass_multi)
from lsdradixsort_tpu_torch.kernels.scan import (block_prefix_sums,
                                                 exclusive_scan)
from lsdradixsort_tpu_torch.kernels.shuffle import shuffle_row_runs
from lsdradixsort_tpu_torch.kernels.tile_sort import (sort_tiles,
                                                      sort_tiles_kv,
                                                      sort_tiles_multi)
from lsdradixsort_tpu_torch.ops.aggregate import (filtered_group_by_sum,
                                                  group_by_aggregate,
                                                  group_by_sum)
from lsdradixsort_tpu_torch.ops.filter import (compact, filter_in_set,
                                               filter_keys, filter_kv,
                                               filter_not_in_set)
from lsdradixsort_tpu_torch.ops.join import (hash_join, hash_join64,
                                             hash_join_multi, probe_lookup,
                                             probe_lookup64)
from lsdradixsort_tpu_torch.ops.sort import (argsort, merge_sort_keys,
                                             merge_sort_multi,
                                             merge_sort_with_ranks, sort,
                                             sort64_with_ranks,
                                             sort_blocks_kv, sort_kv,
                                             sort_lex, sort_records,
                                             sort_with_ranks)
from lsdradixsort_tpu_torch.ops.topk import top_k, unique
from lsdradixsort_tpu_torch.ops.window import window_rank

__version__ = "0.2.0"   # the JAX package's version, which the port mirrors

__all__ = [
    "sort", "sort_kv", "argsort", "sort_with_ranks",
    "sort64_with_ranks", "sort_lex", "sort_records", "sort_blocks_kv",
    "merge_sort_keys", "merge_sort_with_ranks", "merge_sort_multi",
    "sort_tiles", "sort_tiles_kv", "sort_tiles_multi", "shuffle_row_runs",
    "fill_forward_last",
    "merge_pass", "merge_pass_kv", "merge_pass_multi",
    "digit_histogram", "block_digit_histograms",
    "exclusive_scan", "block_prefix_sums",
    "compact", "filter_keys", "filter_kv", "filter_in_set",
    "filter_not_in_set", "group_by_sum", "group_by_aggregate",
    "filtered_group_by_sum", "hash_join", "hash_join_multi", "probe_lookup",
    "probe_lookup64", "hash_join64", "top_k", "unique", "window_rank",
    "digits", "datagen", "timing", "roofline",
]
