"""Phase 36 of ``chip_smoke.py`` (tensor parallelism on a 2 x 2 layout)
alone, on the cards of one host. Run from the root of this repository:

    python3 tools/tensor_parallel_phase.py

It builds the three kernel libraries the phase launches (the raster, the
fill and the stencil), then runs ``chip_smoke.tensor_parallel_phase``:
four gloo ranks sharing card 0 on a machine with fewer than four cards,
NCCL over four cards otherwise. It prints the phase's lines and exits
non-zero where a check fails.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    import torch

    import chip_smoke
    from lyft3d_tpu_torch.ops import bev_raster, column_sparse, dense_fill

    if not torch.cuda.is_available():
        raise SystemExit("tensor_parallel_phase: a CUDA card is required")
    t0 = time.perf_counter()
    for load in (bev_raster._kernel_library, dense_fill._kernel_library, column_sparse._kernel_library):
        load()
    card = chip_smoke.card_line()
    chip_smoke.log(f"built in {time.perf_counter() - t0:.1f} s; {card}; torch {torch.__version__} "
                   f"cuda {torch.version.cuda}; count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    chip_smoke.tensor_parallel_phase(torch.device("cuda", 0), card)
    chip_smoke.log(f"phase 36 in {time.perf_counter() - t0:.1f} s [{card}]")


if __name__ == "__main__":
    main()
