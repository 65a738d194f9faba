"""Run one cell of the port's benchmark on this machine's cards.

    python3 portbench/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

Prints the run's settings and, last, the numbers of its correctness
check to standard error, and one JSON line (the result) to standard
output.  Exits non-zero, printing no result, where there is no CUDA
device or too few of them, or the process holds JAX or the JAX package
once the window has closed.  See portbench/README.md.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
