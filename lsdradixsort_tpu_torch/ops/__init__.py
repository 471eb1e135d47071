from lsdradixsort_tpu_torch.ops.sort import (argsort,  # noqa: F401
                                             merge_sort_keys,
                                             merge_sort_multi,
                                             merge_sort_with_ranks, sort,
                                             sort_kv, sort_with_ranks)
