"""Run one cell of the EDAN engine's benchmark on the card this process
sees, and print its result as the last line of standard output.

    python3 edanbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, configurations and metrics are those of ``BENCHMARK.json`` at
the root of the checkout (see ``edanbench/harness.py``).
"""
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(_ROOT / "src"), str(_ROOT)]

from edanbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t0=T0))
