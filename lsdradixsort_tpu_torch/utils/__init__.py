from lsdradixsort_tpu_torch.utils.verify import check_arrays, check_sorted  # noqa: F401
