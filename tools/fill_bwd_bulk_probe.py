"""Times the fill backward's deleted bulk-copy kernel at each of its
configurations beside the warp kernel, on one CUDA card.

The bulk-copy kernel moved the gathered rows through shared memory with
``cp.async.bulk`` (a producer warp, an mbarrier a stage of rows, one bulk
store a stage). It was measured against the warp gather, lost and was
deleted. Commit 5c5873c holds it, and the warp kernel under the name "regs"
(the same code as ``fill_bwd_warp_kernel``). Run from the root of this
repository, on a machine with a card:

    mkdir -p build/bulk && git archive 5c5873c | tar -x -C build/bulk
    python3 tools/fill_bwd_bulk_probe.py build/bulk

The script imports that tree's package and ``chip_smoke``, builds its
``dense_fill.cu`` and, at each shape of :data:`SHAPES`, prints the time
queued (``chip_smoke.queued_ms``) of every (rows a stage, stages a block)
that fits the bulk kernel's shared memory, of that tree's rule for the
bulk kernel and of the warp kernel, each result ``torch.equal`` to the plain
gather first.
"""

import sys
from pathlib import Path

# (what, B, V, C, rows, dtype, a 10% sentinel tail)
SHAPES = [
    ("pillars shape", 8, 25000, 64, 246016, "bfloat16", True),
    ("pillars shape", 8, 25000, 64, 246016, "float32", True),
    ("pillars step's launch", 8, 25000, 64, 246016, "bfloat16", False),
    ("sparse steps' launch", 4, 8192, 64, 307520, "bfloat16", False),
]
# (rows a stage, stages a block)
CONFIGS = [(32, 8), (64, 4), (128, 1), (128, 2), (128, 4), (256, 2)]


def main(tree):
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fill_bwd_bulk_probe: needs a CUDA card")
    import chip_smoke
    from lyft3d_tpu_torch.ops import dense_fill

    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(21)
    rule = dense_fill._fill_bwd_tiles
    for what, b, v, c, rows, dtype, tail in SHAPES:
        ids = chip_smoke.fill_bwd_ids(b, v, rows, g, sentinel_tail=tail).to(dev)
        grad = torch.randn(b, rows, c, generator=g).to(getattr(torch, dtype)).to(dev)
        want = dense_fill.fill_rows_by_id_bwd_ref(grad, ids, rows)
        row_bytes = c * grad.element_size()
        runs = [(f"bulk_{t}x{s}", "bulk", (t, s)) for t, s in CONFIGS
                if t * s * row_bytes <= dense_fill.BULK_BLOCK_BYTES]
        runs += [(f"bulk_rule_{rule(b, v, row_bytes)[0]}x{rule(b, v, row_bytes)[1]}", "bulk", None),
                 ("warp", "regs", None)]
        times = []
        for name, kernel, config in runs:
            dense_fill._fill_bwd_tiles = rule if config is None else (lambda *_, cfg=config: cfg)
            got = dense_fill._fill_bwd_cuda(grad, ids, rows, kernel=kernel)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} differs from the plain gather at {what}")
            ms = chip_smoke.queued_ms(lambda: dense_fill._fill_bwd_cuda(grad, ids, rows, kernel=kernel))
            times.append(f"{name}={ms:.4f}")
        dense_fill._fill_bwd_tiles = rule
        print(f"fill backward, {what}: B={b} V={v} C={c} rows={rows} {dtype} torch.equal=True "
              f"queued_ms " + " ".join(times), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
