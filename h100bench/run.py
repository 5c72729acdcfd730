#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``lyft3d_tpu_torch`` (the PyTorch
and CUDA port) on the card this process sees.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line last on standard output
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and ``checks``: each compared number with its
limit, also the last lines on standard error). Exits 2 without enough CUDA
devices and 3 if the process holds JAX or the JAX package.
"""

import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from h100bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(started=STARTED))
