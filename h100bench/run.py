"""Run one cell of the benchmark once and print its result line.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout on a machine with an NVIDIA GPU; the
cells are in ``BENCHMARK.json``. The last line on standard output is the
result as one JSON object; the numbers the check compared are the last
lines on standard error. Without a card it prints no result and exits 3.
"""

import time

STARTED = time.perf_counter()  # set-up counts from here, before torch loads

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The checkout's root in place of this script's folder, so that the
# benchmark's modules load as ``h100bench.*`` and the port beside it.
sys.path[0] = str(Path(__file__).resolve().parents[1])

from h100bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(STARTED))
