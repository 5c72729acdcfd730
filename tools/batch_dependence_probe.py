"""Where a train step's loss depends on the batch it runs in, on one card:
the unit-sparse SECOND of ``chip_smoke.fhd_config`` (bf16; float32 with and
without TF32) at the global batch 4 x 262,144 against the mean of its halves
and of its single samples (what two and four ranks compute), stage by stage
(voxelize, encoder, the middle's dense BEV, the RPN on equal input), and
``unet_seresnext101`` bf16 at 32 x 336² against its halves and quarters.
Prints a line each, with the card's name and power limit. Run from the root
of this repository:

    python3 tools/batch_dependence_probe.py
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "tools"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from data_parallel_families_phase import build  # noqa: E402


def rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def sparse(dtype, dev, card):
    from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet
    from lyft3d_tpu_torch.ops.voxelize import voxelize
    from lyft3d_tpu_torch.pipelines.second_train import make_second_loss_fn

    cfg = cs.fhd_config()
    net = VoxelNet(cfg, in_features=3, dtype=dtype, device=dev, generator=torch.Generator().manual_seed(0)).train()
    loss_fn = make_second_loss_fn(cfg, dev)
    pts, valid = cs.fhd_points(cs.FHD_BATCH, cs.FHD_POINTS, seed=38)
    batch = cs.to_dev({"points": pts, "points_valid": valid, **cs.gt_batch(cs.FHD_BATCH, seed=38)}, dev)
    halves = [{k: v[i:i + 2] for k, v in batch.items()} for i in (0, 2)]
    singles = [{k: v[i:i + 1] for k, v in batch.items()} for i in range(4)]
    with torch.no_grad():
        l4 = float(loss_fn(net, batch)[0])
        l2 = sum(float(loss_fn(net, h)[0]) for h in halves) / 2
        l1 = sum(float(loss_fn(net, s)[0]) for s in singles) / 4
        l4b = float(loss_fn(net, batch)[0])
        v4 = voxelize(batch["points"], batch["points_valid"], cfg.grid, cfg.max_voxels, cfg.max_points_per_voxel)
        v2 = voxelize(halves[0]["points"], halves[0]["points_valid"], cfg.grid, cfg.max_voxels,
                      cfg.max_points_per_voxel)
        vox_equal = all(torch.equal(v4[k][:2], v2[k]) for k in v4)
        f4 = net.encoder(v4["voxels"], v4["num_points"], v4["coords"])
        f2 = net.encoder(v2["voxels"], v2["num_points"], v2["coords"])
        d4 = net.dense_bev(f4, v4["coords"], v4["voxel_valid"])
        d2 = net.dense_bev(f2, v2["coords"], v2["voxel_valid"])
        r4 = net.rpn(d4)
        r2 = net.rpn(d4[:2].contiguous(memory_format=torch.channels_last))
    cs.log(f"probe sparse {dtype}: loss batch 4 {l4:.6f} (again {l4b:.6f}), mean of halves {l2:.6f} (rel "
           f"{abs(l2 - l4) / l4:.3g}), mean of singles {l1:.6f} (rel {abs(l1 - l4) / l4:.3g}); voxelize equal "
           f"{vox_equal}; encoder {rel(f4[:2], f2):.3g}; dense BEV of the middle {rel(d4[:2], d2):.3g}; RPN on equal "
           f"input: " + " ".join(f"{k} {rel(r4[k][:2], r2[k]):.3g}" for k in r4) + f" [{card}]")


def bev(dev, card):
    from lyft3d_tpu_torch.pipelines.bev_train import build_bev_model, make_bev_loss_fn

    cfg = cs.family_bev_config(False)
    model = build_bev_model(cfg, torch.bfloat16, dev).train()
    loss_fn = make_bev_loss_fn(cfg, dev)
    b = cs.bev_train_batch(32, 336, seed=38, dev=dev)
    with torch.no_grad():
        l32 = float(loss_fn(model, b)[0])
        l16 = sum(float(loss_fn(model, {k: v[i:i + 16] for k, v in b.items()})[0]) for i in (0, 16)) / 2
        l8 = sum(float(loss_fn(model, {k: v[i:i + 8] for k, v in b.items()})[0]) for i in range(0, 32, 8)) / 4
    cs.log(f"probe bev bf16 (no weighted-CE global normaliser across halves): loss 32 {l32:.6f}, halves "
           f"{l16:.6f} (rel {abs(l16 - l32) / l32:.3g}), quarters {l8:.6f} (rel {abs(l8 - l32) / l32:.3g}) [{card}]")


def main():
    card = cs.card_line()
    build()
    dev = torch.device("cuda", 0)
    for dtype in (torch.bfloat16, torch.float32):
        sparse(dtype, dev, card)
    torch.backends.cudnn.allow_tf32 = False
    sparse(torch.float32, dev, card + " TF32 off")
    torch.backends.cudnn.allow_tf32 = True
    bev(dev, card)


if __name__ == "__main__":
    main()
