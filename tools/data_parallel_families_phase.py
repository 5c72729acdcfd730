"""Phase 38 of ``chip_smoke.py`` (every family's data-parallel train step
over ranks, held to one process, then the multichip dry run) alone, on the
cards of one host. Run from the root of this repository:

    python3 tools/data_parallel_families_phase.py

It builds the eight kernel libraries in parallel, then runs
``chip_smoke.data_parallel_families_phase``: on one card two gloo ranks
sharing it and a one-rank NCCL group, NCCL over up to four cards
otherwise, then ``dryrun_multichip(max(cards, 2))``. It prints the
phase's lines and exits non-zero where a check fails.
"""

import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def build():
    """The eight kernel libraries, one ``nvcc`` each in parallel (``main()``'s step 2)."""
    from lyft3d_tpu_torch.ops import bev_raster, column_sparse, dense_fill, subm_conv_kernel
    from lyft3d_tpu_torch.ops import pointnet2 as p2

    loaders = [bev_raster._kernel_library, dense_fill._kernel_library, p2._fps_library, p2._ball_query_library,
               p2._knn_library, p2._roi_select_library, column_sparse._kernel_library,
               subm_conv_kernel._kernel_library]
    with ThreadPoolExecutor(len(loaders)) as pool:
        list(pool.map(lambda load: load(), loaders))


def main():
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("data_parallel_families_phase: a CUDA card is required")
    t0 = time.perf_counter()
    build()
    card = chip_smoke.card_line()
    chip_smoke.log(f"built in {time.perf_counter() - t0:.1f} s; {card}; torch {torch.__version__} "
                   f"cuda {torch.version.cuda}; count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    launches = chip_smoke.data_parallel_families_phase(torch.device("cuda", 0), card)
    chip_smoke.log(f"phase 38 in {time.perf_counter() - t0:.1f} s: launches {launches} [{card}]")


if __name__ == "__main__":
    main()
