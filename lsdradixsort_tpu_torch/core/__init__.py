from lsdradixsort_tpu_torch.core import convert, datagen, keycodec, timing  # noqa: F401
