"""The distributed layer of the port: the mesh as a process group
(mesh.py), the distributed histogram, sort and query operators, and a
local launcher of one process a rank (launch.py)."""
from lsdradixsort_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, shard_1d)
from lsdradixsort_tpu_torch.parallel.dist_sort import (  # noqa: F401
    dist_sort, dist_sort_kv)
from lsdradixsort_tpu_torch.parallel.dist_hist import (  # noqa: F401
    dist_digit_histogram)
from lsdradixsort_tpu_torch.parallel.dist_query import (  # noqa: F401
    dist_filter_kv, dist_group_by_sum, dist_join, dist_join_multi,
    dist_top_k, dist_unique, undistribute)
