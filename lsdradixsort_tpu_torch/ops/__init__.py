from lsdradixsort_tpu_torch.ops.sort import (argsort,  # noqa: F401
                                             merge_sort_keys,
                                             merge_sort_multi,
                                             merge_sort_with_ranks, sort,
                                             sort_kv, sort_with_ranks)
from lsdradixsort_tpu_torch.ops.filter import (compact,  # noqa: F401
                                               filter_in_set, filter_keys,
                                               filter_kv, filter_not_in_set)
from lsdradixsort_tpu_torch.ops.aggregate import (  # noqa: F401
    filtered_group_by_sum, group_by_aggregate, group_by_sum)
from lsdradixsort_tpu_torch.ops.join import (hash_join,  # noqa: F401
                                             hash_join64, hash_join_multi,
                                             probe_lookup, probe_lookup64)
from lsdradixsort_tpu_torch.ops.topk import top_k, unique  # noqa: F401
from lsdradixsort_tpu_torch.ops.window import window_rank  # noqa: F401
from lsdradixsort_tpu_torch.ops.sort import (sort64_with_ranks,  # noqa: F401
                                             sort_blocks_kv, sort_lex,
                                             sort_records)
from lsdradixsort_tpu_torch.ops.bigsort import (  # noqa: F401
    merge_runs_chunked, sort_kv_chunked, sort_with_ranks_chunked)
