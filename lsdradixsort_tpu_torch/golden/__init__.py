from lsdradixsort_tpu_torch.golden.oracles import (  # noqa: F401
    lsd_radix_sort,
    lsd_radix_sort_pass,
    lsd_radix_sort_kv,
    prefix_sum,
    digit_histograms,
    transpose,
    filter_keys,
    group_by_sum,
    hash_join,
    hash_join_multi,
)
