"""python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>"""

import time

T0 = time.perf_counter()  # process start, as near as Python sees it: set-up counts from here

import sys  # noqa: E402

from portbench.run import main  # noqa: E402

sys.exit(main(t0=T0))
