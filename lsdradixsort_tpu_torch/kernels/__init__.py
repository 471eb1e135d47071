from lsdradixsort_tpu_torch.kernels.compaction import (  # noqa: F401
    compact_stream, compact_stream_multi)
from lsdradixsort_tpu_torch.kernels.fill_forward import (  # noqa: F401
    fill_forward_last)
from lsdradixsort_tpu_torch.kernels.hash_table import (  # noqa: F401
    build_table, lane_of, plan_rows, probe_table)
from lsdradixsort_tpu_torch.kernels.histogram import (  # noqa: F401
    block_digit_histograms, digit_histogram)
from lsdradixsort_tpu_torch.kernels.merge import (merge_pass,  # noqa: F401
                                                  merge_pass_kv,
                                                  merge_pass_multi)
from lsdradixsort_tpu_torch.kernels.scan import (  # noqa: F401
    block_prefix_sums, exclusive_scan, exclusive_scan_hierarchical)
from lsdradixsort_tpu_torch.kernels.shuffle import (  # noqa: F401
    shuffle_row_runs)
from lsdradixsort_tpu_torch.kernels.tile_sort import (sort_tiles,  # noqa: F401
                                                      sort_tiles_kv,
                                                      sort_tiles_multi)
# (not `transpose`, the function: it would hide the module of that name)
from lsdradixsort_tpu_torch.kernels.transpose import (  # noqa: F401
    transpose_tiled)
