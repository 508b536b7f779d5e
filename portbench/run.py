"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload gzip-l6.mixed-16m --seed 7 --seconds 30 --trace 0

From the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is the result (JSON); the compared
numbers and their limits are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    harness.prepare_env()
    sys.exit(harness.main(sys.argv[1:], T_START))
