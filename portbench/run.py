#!/usr/bin/env python3
"""Run one benchmark cell of raytracer2_tpu_torch once, on the GPU:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root. Prints one line per set-up part, the card's
name, power limit and clocks, the compared numbers with their limits (on
standard error) and, last on standard output, the result as one JSON
object. Exits 2 without printing a result when no CUDA device (or fewer
than the cell asks for) is present, and 3 when the process loaded JAX or
the JAX package.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
