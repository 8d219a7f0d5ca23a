"""Entry point of the benchmark: one run of one cell.

    python3 gpubench/run.py --workload CELL --seed N --seconds S --trace 0|1

Runs from the root of a checkout; see `gpubench/README.md`.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from gpubench.harness import main, process_start_s  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=min(process_start_s(), T_START)))
