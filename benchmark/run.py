"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (harness/main.py)."""

import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=STARTED))
