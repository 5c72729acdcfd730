"""Times the stencil's two tensor-core tiles against each other at every
shape where both take it, for the rule in ``stencil_mma_variant``
(``lyft3d_tpu_torch/ops/column_sparse.py``).

The unit tile (``conv_mma_kernel``) takes up to 256 lanes and 128 columns;
the wide tile (``conv_wide_kernel``) up to 640 of each. The rule sends a
shape to one of them. This script records the stencil calls of one forward
pass of the FHD unit middle (uniform cloud) and of the dense-z column middle
(uniform and LiDAR-like cloud) at 4 x 262,144 points, bfloat16, random
weights from a seed, and for each call whose forward or ``d_src`` fits both
tiles times both on the same inputs: the forward on the bfloat16 rows,
``d_src`` on a float32 cotangent with every third row zero, as
``StencilConv.backward`` hands it over. Each tile's output is held to the
rule's (forward 1e-5 of its scale, ``d_src`` 2^-7: both round to bfloat16).
The order is rule, other, other, rule; both times of each are printed.

One JSON line a launch, then one a (middle, side, rule's tile) group with
the sums; the card's name and power limit on every line. Usage, from the
repo root on the card::

    python3 tools/stencil_tile_ab.py
"""

import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


@contextlib.contextmanager
def tile(cs, route):
    """Every shape both tiles take goes to ``route`` while inside."""
    import torch

    rule = cs.stencil_mma_variant

    def forced(k, n, nc=1, src_dtype=torch.bfloat16):
        var = rule(k, n, nc, src_dtype)
        make = cs._unit_tile if route == "unit" else cs._wide_tile
        return make(k, var["kp"], var["n_pad"], src_dtype)

    cs.stencil_mma_variant = forced
    try:
        yield
    finally:
        cs.stencil_mma_variant = rule


def both_take(cs, k, n, nc):
    var = cs.stencil_mma_variant(k, n, nc)
    return var["kp"] <= 256 and var["n_pad"] <= 128


def main():
    import torch

    import chip_smoke as smoke
    from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet
    from lyft3d_tpu_torch.ops import column_sparse as cs
    from lyft3d_tpu_torch.ops.sparse_conv import ActiveSet
    from lyft3d_tpu_torch.ops.voxelize import voxelize

    if not torch.cuda.is_available():
        raise SystemExit("stencil_tile_ab.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    g = torch.Generator(device=dev).manual_seed(41)
    runs = [("units", "uniform cloud", smoke.fhd_points(smoke.FHD_BATCH, smoke.FHD_POINTS, seed=39)),
            ("columns", "uniform cloud", smoke.fhd_points(smoke.FHD_BATCH, smoke.FHD_POINTS, seed=39)),
            ("columns", "lidar cloud", smoke.lidar_cloud(smoke.FHD_BATCH, smoke.FHD_POINTS, seed=39))]
    groups = {}
    for middle, cloud, (pts, valid) in runs:
        changes = {"middle": "sparse_columns"} if middle == "columns" else {}
        cfg = smoke.fhd_config(middle_norm="folded", **changes)
        net = VoxelNet(cfg, in_features=3, dtype=torch.bfloat16, device=dev,
                       generator=torch.Generator().manual_seed(0))
        pts, valid = pts.to(dev), valid.to(dev)
        with torch.inference_mode():
            vox = voxelize(pts, valid, cfg.grid, cfg.max_voxels, cfg.max_points_per_voxel)
            feats = net.encoder(vox["voxels"], vox["num_points"], vox["coords"])
            mid = net.middle
            active = ActiveSet(vox["coords"], vox["voxel_valid"], cfg.grid.grid_size)
            to_rows = mid.to_columns if middle == "columns" else mid.to_units
            with smoke.recorded(cs, "stencil_conv_batched") as calls:
                state = to_rows(feats, active)[::-1]
                for i in range(len(cfg.middle_features)):
                    state = mid.stage(i, *state)
            for (src, qids, src_ids, wc, nc), kwargs in calls.calls:
                kzp, n = wc.shape[1:]
                s16, w16 = src.to(torch.bfloat16), wc.to(torch.bfloat16)
                sides = []
                if both_take(cs, kzp, n, nc):
                    sides.append(("forward", kzp, n,
                                  lambda: cs._stencil_conv_cuda(s16, qids, src_ids, w16, nc)[0], 1e-5))
                rq, rids = kwargs.get("rev_qids"), kwargs.get("rev_src_ids")
                if rq is not None and both_take(cs, n, kzp, nc):
                    cot = torch.randn(src.shape[0], qids.shape[-1], nc * n, generator=g, device=dev)
                    cot[:, ::3] = 0
                    rq = rq.contiguous()
                    sides.append(("d_src", n, kzp,
                                  lambda: cs._stencil_dgrad_cuda(cot, rq, rids, w16, nc)[0], 2.0 ** -7))
                for side, k, width, fn, tol in sides:
                    rule = cs.stencil_mma_variant(k, width, nc, torch.float32 if side == "d_src" else
                                                  torch.bfloat16)["route"]
                    other = "wide" if rule == "unit" else "unit"
                    want = fn()
                    times = {rule: [], other: []}
                    for route in (rule, other, other, rule):
                        with tile(cs, route):
                            got = fn()
                            err = smoke.rel_diff(got, want)
                            if not err <= tol:
                                raise AssertionError(f"{middle} {side} k={k} n={width} nc={nc} on the {route} "
                                                     f"tile differs from the rule's by {err} (tol {tol})")
                            times[route].append(smoke.cuda_ms(fn, warmup=1, iters=5))
                    row = {"middle": middle, "cloud": cloud, "side": side, "k": k, "n": width, "nc": nc,
                           "vs": src.shape[1] if side == "forward" else qids.shape[-1],
                           "vq": qids.shape[-1] if side == "forward" else src.shape[1], "rule": rule,
                           "unit_ms": [round(t, 4) for t in times["unit"]],
                           "wide_ms": [round(t, 4) for t in times["wide"]], "card": card}
                    print(json.dumps(row), flush=True)
                    key = (middle, cloud, side, rule)
                    acc = groups.setdefault(key, {"launches": 0, "unit_ms": 0.0, "wide_ms": 0.0})
                    acc["launches"] += 1
                    acc["unit_ms"] += sum(times["unit"]) / 2
                    acc["wide_ms"] += sum(times["wide"]) / 2
            del vox, feats, state, calls
        del net
        torch.cuda.empty_cache()
    for (middle, cloud, side, rule), acc in groups.items():
        print(json.dumps({"middle": middle, "cloud": cloud, "side": side, "rule": rule,
                          "launches": acc["launches"], "unit_ms": round(acc["unit_ms"], 4),
                          "wide_ms": round(acc["wide_ms"], 4), "card": card}), flush=True)


if __name__ == "__main__":
    main()
