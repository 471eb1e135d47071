"""The control of a cell: its plain reference, computed one step below
the guarantee its configuration states (reference/<entry>.py `control`),
put in the entry's place and run through the whole harness. Its result
has to come out not correct; the numbers it prints are the upper
readings the limits are set below. The benchmark's own runs never run it.

    python3 -m portbench.control --workload <cell> --seed <n> --seconds <s>
"""
import time

START = time.perf_counter()

import sys  # noqa: E402

from portbench import layout  # noqa: E402
from portbench.run import main  # noqa: E402


def control_call(spec: dict):
    return layout.module("reference", spec["reference"]).control


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], START, call_from=control_call))
