from lsdradixsort_tpu_torch.kernels.merge import (merge_pass,  # noqa: F401
                                                  merge_pass_kv,
                                                  merge_pass_multi)
from lsdradixsort_tpu_torch.kernels.tile_sort import (sort_tiles,  # noqa: F401
                                                      sort_tiles_kv,
                                                      sort_tiles_multi)
