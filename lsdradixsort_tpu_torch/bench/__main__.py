import sys

from lsdradixsort_tpu_torch.bench.runner import main

sys.exit(main())
