"""Run one cell of the port's benchmark on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Prints the numbers compared beside their
limits as the last lines of standard error and one JSON result as the
last line of standard output; without a CUDA card it exits 2 and prints
no result.

The process pins itself to one CPU core (the last it may run on) and
asks for one OpenMP thread before torch is imported: the cells whose
host launches the work spread by 5-7 % from run to run without it, by
about 2 % with it (PERF.md). One run at a time uses a card and its
machine, so no other run shares the core.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    # the checkout's root, in place of this script's folder
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from perfbench import harness

    sys.exit(harness.main(t_process=T_PROCESS))
