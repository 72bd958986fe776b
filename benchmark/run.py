"""Entry point of the benchmark: `python3 benchmark/run.py --workload NAME
--seed N --seconds S --trace 0|1` from the root of a checkout (see
harness.py)."""
import os
import time


def process_start() -> float:
    """The process's start on the perf_counter clock (from /proc, to the
    kernel's clock tick), or now where /proc does not say."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = process_start()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import main  # noqa: E402

if __name__ == "__main__":
    main(t_process=T_PROCESS)
