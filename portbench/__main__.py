"""python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>"""
import time

START = time.perf_counter()     # set-up is counted from here

import sys  # noqa: E402

from portbench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], START))
