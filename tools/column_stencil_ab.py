"""Times the dense-z column middle's path on the card in one tree of the repo,
so that two trees (a change and its parent) can be compared in one chip call.

For the uniform and the LiDAR-like cloud at 4 x 262,144 points, with the
FHD ``sparse_columns`` VoxelNet in bfloat16 (random weights from a seed):

- ``e2e_ms``: ``make_second_infer_fn`` on the cloud (folded norms);
- the sums over one pass of the middle's stencil launches, replayed from the
  recorded calls: ``forward_ms`` (twelve), ``d_src_ms`` and ``d_wc_ms``
  (nine each; ``d_src`` on the float32 cotangent, as ``StencilConv.backward``
  hands it over, every third row zero);
- ``step_ms``: the bfloat16 model's loss (``make_second_loss_fn``) forward and
  backward on the cloud (LayerNorm middle), without an optimizer.

CUDA events, the card's name and power limit on every line, one JSON line a
cloud. Usage, from the repo root on the card, e.g. against the parent commit
unpacked with ``git archive`` under ``build/parent``::

    python3 tools/column_stencil_ab.py build/parent
    python3 tools/column_stencil_ab.py .
"""

import json
import sys
from pathlib import Path


def main(tree):
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import chip_smoke as smoke
    from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet
    from lyft3d_tpu_torch.ops import column_sparse as cs
    from lyft3d_tpu_torch.ops.sparse_conv import ActiveSet
    from lyft3d_tpu_torch.ops.voxelize import voxelize
    from lyft3d_tpu_torch.pipelines.second import make_second_infer_fn
    from lyft3d_tpu_torch.pipelines.second_train import make_second_loss_fn

    if not torch.cuda.is_available():
        raise SystemExit("column_stencil_ab.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke.fhd_config(middle="sparse_columns", middle_norm="folded")
    net = VoxelNet(cfg, in_features=3, dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(0))
    infer = make_second_infer_fn(net, cfg)
    lcfg = smoke.fhd_config(middle="sparse_columns")
    lnet = VoxelNet(lcfg, in_features=3, dtype=torch.bfloat16, device=dev,
                    generator=torch.Generator().manual_seed(3)).train()
    loss_fn = make_second_loss_fn(lcfg, dev)
    keys = ("voxels", "num_points", "coords")
    grid_args = (cfg.grid, cfg.max_voxels, cfg.max_points_per_voxel)
    g = torch.Generator(device=dev).manual_seed(39)
    for cloud, (pts, valid) in (("uniform cloud", smoke.fhd_points(smoke.FHD_BATCH, smoke.FHD_POINTS, seed=39)),
                                ("lidar cloud", smoke.lidar_cloud(smoke.FHD_BATCH, smoke.FHD_POINTS, seed=39))):
        pts, valid = pts.to(dev), valid.to(dev)
        e2e = smoke.cuda_ms(lambda: infer(pts, valid))
        with torch.inference_mode():
            vox = voxelize(pts, valid, *grid_args)
            feats = net.encoder(*[vox[k] for k in keys])
            mid = net.middle
            with smoke.recorded(cs, "stencil_conv_batched") as calls:
                state = mid.to_columns(feats, ActiveSet(vox["coords"], vox["voxel_valid"], cfg.grid.grid_size))[::-1]
                for i in range(len(cfg.middle_features)):
                    state = mid.stage(i, *state)
        sums = dict.fromkeys(("forward_ms", "d_src_ms", "d_wc_ms"), 0.0)
        for (src, qids, src_ids, wc, nc), kwargs in calls.calls:
            s16, w16 = src.to(torch.bfloat16), wc.to(torch.bfloat16)
            sums["forward_ms"] += smoke.cuda_ms(lambda: cs.stencil_conv_batched(s16, qids, src_ids, w16, nc),
                                                warmup=1, iters=5)
            rq, rids = kwargs.get("rev_qids"), kwargs.get("rev_src_ids")
            if rq is None:
                continue
            kzp, n = wc.shape[1:]
            cot = torch.randn(src.shape[0], qids.shape[-1], nc * n, generator=g, device=dev)
            cot[:, ::3] = 0
            rq, wt16 = rq.contiguous(), w16.transpose(1, 2)
            sums["d_src_ms"] += smoke.cuda_ms(lambda: cs._stencil_conv_mma(cot, rq, rids, wt16, nc, True,
                                                                           torch.bfloat16), warmup=1, iters=5)
            sums["d_wc_ms"] += smoke.cuda_ms(lambda: cs._stencil_wgrad_cuda(s16, qids, src_ids, cot, nc, kzp, n),
                                             warmup=1, iters=5)
        batch = smoke.to_dev({"points": pts.cpu(), "points_valid": valid.cpu(),
                              **smoke.gt_batch(smoke.FHD_BATCH, seed=40)}, dev)

        def step():
            lnet.zero_grad(set_to_none=True)
            loss, _ = loss_fn(lnet, batch)
            loss.backward()

        step_ms = smoke.cuda_ms(step, warmup=1, iters=3)
        print(json.dumps({"tree": tree, "cloud": cloud, "e2e_ms": round(e2e, 4),
                          **{k: round(v, 4) for k, v in sums.items()}, "step_ms": round(step_ms, 4),
                          "stencil_calls": len(calls.calls), "card": card}), flush=True)
        del vox, feats, state, calls, batch
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
