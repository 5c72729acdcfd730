#!/usr/bin/env python3
"""Phase 37 of ``chip_smoke.py`` (the learning demos) on the CPU: the run
that ``LEARN_MARGIN`` was set from. Run from the root of this repository:

    python3 tools/learning_rehearsal.py [--threads 8]

The phase's own code on ``torch.device("cpu")``: the demos train in float32
there and the kernels' plain versions run, so no launch is counted (the
counts read 1 for every kernel, which the phase's launch check passes) and
nothing waits on a card. It prints the phase's lines (each family's loss
fall against its margin) and, where a fall misses its margin, the phase's
assertion; ~10 min at 8 threads.
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke

    torch.set_num_threads(args.threads)
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.empty_cache = lambda: None
    kernels = ("bev_raster", *chip_smoke.TRAIN_COUNTERS, *chip_smoke.PRC_KERNELS)
    chip_smoke.learn_counts = lambda reset=False: dict.fromkeys(kernels, 1)
    t0 = time.perf_counter()
    try:
        chip_smoke.learning_phase(torch.device("cpu"), "CPU rehearsal, float32")
    except AssertionError as e:
        print(f"margin missed: {e}", flush=True)
        raise SystemExit(1)
    finally:
        print(f"rehearsal in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
