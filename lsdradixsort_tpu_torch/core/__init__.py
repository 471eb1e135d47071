from lsdradixsort_tpu_torch.core import (convert, datagen, digits,  # noqa: F401
                                         keycodec, roofline, timing)
