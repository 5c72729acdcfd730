#!/usr/bin/env python3
"""Smoke run of the PyTorch port's inference paths on one CUDA card: BEV
segmentation and SECOND pillars.

    python3 chip_smoke.py

Phases, one line of numbers each:

1. device: requires CUDA (no CPU fallback) and prints the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build: compiles the port's CUDA kernels from ``lyft3d_tpu_torch/csrc`` into
   a clean ``build/`` directory, one ``nvcc`` per source, in parallel;
3. raster: the hand-written BEV raster kernel against its plain PyTorch
   version on the same card, at 336x336x3 with 8 x 65,536 and 32 x 65,536
   points (uniform in ±60 m, 10% invalid, some out of range, some on bin
   edges): ``torch.equal`` must hold; both are timed with CUDA events;
4. extraction: ``extract_detections_from_logits`` on the card against the
   CPU on blob logits (8 x 336x336x10): masks, counts and flags exactly
   equal, boxes, centroids and scores within 1e-5;
5. flagship: ``unet_resnet50`` (10 classes, folded norms, full width,
   weights from a seeded ``torch.Generator``). A float32 check at batch 1
   with TF32 off for convolutions and matmuls holds the card's logits to the
   CPU's. Then the main path, ``make_infer_fn`` (raster kernel → normalize →
   map concat → model in bfloat16 → extraction), at batch 32 x 65,536
   points: the kernel's launch count is reset before it and must be > 0
   after it; sweeps/s from CUDA events (2 warm-up, 10 timed iterations).
6. fill: the hand-written canvas-fill kernel (the pillar scatter) against
   its plain PyTorch version on the card at the pillars shape, batch 8 x
   25,000 rows of 64 channels → 496x496 rows, ascending unique ids with 10%
   invalid at the tail, in bfloat16 and float32: ``torch.equal`` must hold;
   duplicate ids (float32) must sum within 1e-6 of the summed magnitudes;
   both timed with CUDA events;
7. pillars: the SECOND ``VoxelNet`` of ``configs/second_lyft_9class.yaml``
   (spelled out in :func:`lyft9_config`; no yaml on the card's machine),
   weights from a seeded ``torch.Generator``. A float32 check at batch 1
   with TF32 off holds the card to the CPU: voxelize outputs equal, anchors
   bit-equal, box/cls/dir heads within 1e-3 of the logit scale. Then the
   main path, ``make_second_infer_fn`` (voxelize → encoder → fill kernel →
   RPN in bfloat16, heads in float32 → decode + NMS) at batch 8 x 262,144
   points: the fill kernel's launch count is reset before it and must be
   > 0 after it; samples/s from CUDA events (2 warm-up, 10 timed
   iterations), a stage split, and peak memory.

The last two lines are a JSON object describing each kernel and the JSON
result line. Any failure raises and exits non-zero without printing them.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_POINTS = 65536
BATCH = 32
SHAPE = (336, 336, 3)
RASTER_BATCHES = (8, BATCH)
TIMED_ITERS = 10
EXTRACT_TOL = 1e-5
BG_THRESHOLD = 80.0 / 255.0
# SECOND pillars (configs/second_lyft_9class.yaml): batch 8, data.max_points
# points of (x, y, z, time lag), max_voxels pillars of 64 channels on a
# 496x496 canvas.
SEC_BATCH = 8
SEC_POINTS = 262144
FILL_V, FILL_C, FILL_ROWS = 25000, 64, 496 * 496
FILL_DUP_REL = 1e-6
# (w, l, h), z centre, matched and unmatched thresholds of the 9 classes.
LYFT9_ANCHORS = (
    ((1.93, 4.76, 1.72), -1.07, 0.6, 0.45),    # car
    ((0.96, 2.35, 1.59), -1.29, 0.5, 0.3),     # motorcycle
    ((2.96, 12.34, 3.44), -0.36, 0.55, 0.4),   # bus
    ((0.63, 1.76, 1.44), -1.29, 0.5, 0.3),     # bicycle
    ((2.84, 10.24, 3.44), -0.30, 0.55, 0.4),   # truck
    ((0.77, 0.81, 1.78), -0.91, 0.5, 0.35),    # pedestrian
    ((2.79, 8.20, 3.23), -0.62, 0.55, 0.4),    # other_vehicle
    ((0.36, 0.73, 0.51), -1.60, 0.45, 0.3),    # animal
    ((2.45, 6.52, 2.39), -0.84, 0.55, 0.4),    # emergency_vehicle
)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[0].strip()


def cuda_ms(fn, warmup=2, iters=TIMED_ITERS):
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sweep_points(batch, n, seed):
    """Uniform sweeps in ±60 m (z in [-2.5, 1] m), 10% invalid, 2% beyond
    the grid, and 1% exactly on x bin edges (x = k·0.4 − 67.2)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    pts = torch.empty(batch, n, 3)
    pts[..., :2].uniform_(-60.0, 60.0, generator=g)
    pts[..., 2].uniform_(-2.5, 1.0, generator=g)
    far = torch.rand(batch, n, generator=g) < 0.02
    pts[..., 0] = torch.where(far, pts[..., 0] * 1.6, pts[..., 0])
    edges = (torch.arange(n // 100, dtype=torch.float64) % 337 * 0.4 - 67.2).float()
    pts[:, : n // 100, 0] = edges
    valid = torch.rand(batch, n, generator=g) >= 0.1
    return pts, valid


def blob_logits(batch, hw, n_classes, seed):
    """Background-dominated logits with 10-60 rotated rectangular blobs per
    sample, away from the foreground threshold by construction."""
    rng = np.random.RandomState(seed)
    logits = rng.uniform(-1.0, 0.5, (batch, hw, hw, n_classes)).astype(np.float32)
    logits[..., 0] += 5.0
    rr, cc = np.mgrid[0:hw, 0:hw].astype(np.float32)
    for b in range(batch):
        for _ in range(rng.randint(10, 60)):
            cy, cx = rng.uniform(0, hw, 2)
            half_l, half_w = rng.uniform(1.0, 9.0), rng.uniform(0.7, 3.5)
            a = rng.uniform(0, math.pi)
            u = (cc - cx) * math.cos(a) + (rr - cy) * math.sin(a)
            v = -(cc - cx) * math.sin(a) + (rr - cy) * math.cos(a)
            inside = (np.abs(u) <= half_l) & (np.abs(v) <= half_w)
            logits[b][inside, 0] -= 7.0
            logits[b][inside, rng.randint(1, n_classes)] += 5.0
    lf = logits.astype(np.float64)
    m = lf.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(lf - m).sum(-1, keepdims=True)))[..., 0]
    margin = np.abs(lf[..., 0] - lse - np.log1p(-BG_THRESHOLD)).min()
    if margin < 1e-4:
        raise RuntimeError(f"blob logits {margin:.2e} from the fg threshold")
    return logits


def check_detections(got, want, what):
    for k in ("box_valid", "detect", "counts"):
        if not torch_equal(got[k], want[k]):
            raise AssertionError(f"{what}: {k} differs")
    err = 0.0
    for k in ("boxes_px", "centroids", "scores"):
        e = float((got[k].cpu() - want[k].cpu()).abs().max())
        if not e <= EXTRACT_TOL:
            raise AssertionError(f"{what}: {k} differs by {e}")
        err = max(err, e)
    return err


def lyft9_config():
    """``configs/second_lyft_9class.yaml`` as the port's ``VoxelNetConfig``
    (a CPU test holds it to the yaml field by field)."""
    from lyft3d_tpu_torch.models.second.voxelnet import VoxelNetConfig
    from lyft3d_tpu_torch.ops.anchors import AnchorSpec
    from lyft3d_tpu_torch.ops.voxelize import VoxelGrid

    return VoxelNetConfig(
        grid=VoxelGrid(point_cloud_range=(-49.6, -49.6, -5.0, 49.6, 49.6, 3.0),
                       voxel_size=(0.2, 0.2, 8.0)),
        max_voxels=25000,
        max_points_per_voxel=16,
        encoder="pillars",
        middle="scatter",
        anchor_specs=tuple(AnchorSpec(size, z, m, u, class_id=i + 1)
                           for i, (size, z, m, u) in enumerate(LYFT9_ANCHORS)),
        rpn_up_strides=(0.25, 0.5, 1),
    )


def pillar_points(batch, n, seed):
    """Uniform (x, y) in ±49.6 m, z in [-3, 1] m, time lag in [0, 0.45] s;
    all valid."""
    import torch

    g = torch.Generator().manual_seed(seed)
    pts = torch.empty(batch, n, 4)
    pts[..., :2].uniform_(-49.6, 49.6, generator=g)
    pts[..., 2].uniform_(-3.0, 1.0, generator=g)
    pts[..., 3].uniform_(0.0, 0.45, generator=g)
    return pts, torch.ones(batch, n, dtype=torch.bool)


def fill_case(dtype, seed):
    """Ascending unique row ids per sample with the last 10% invalid."""
    import torch

    g = torch.Generator().manual_seed(seed)
    ids = torch.stack([torch.sort(torch.randperm(FILL_ROWS, generator=g)[:FILL_V]).values
                       for _ in range(SEC_BATCH)]).int()
    valid = (torch.arange(FILL_V) < FILL_V - FILL_V // 10).expand(SEC_BATCH, FILL_V).contiguous()
    feats = torch.randn(SEC_BATCH, FILL_V, FILL_C, generator=g).to(dtype)
    return feats, ids, valid


def torch_equal(a, b):
    import torch

    return torch.equal(a.cpu(), b.cpu())


def main():
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required")
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"count {torch.cuda.device_count()}")

    from lyft3d_tpu.data.bev_pipeline import BEVConfig
    from lyft3d_tpu_torch import _build
    from lyft3d_tpu_torch.models import build_model
    from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet
    from lyft3d_tpu_torch.ops import bev_raster, dense_fill
    from lyft3d_tpu_torch.ops.mask_to_boxes import extract_detections_from_logits
    from lyft3d_tpu_torch.ops.voxelize import voxelize
    from lyft3d_tpu_torch.pipelines.bev import make_bev_input, make_infer_fn
    from lyft3d_tpu_torch.models.second.voxelnet import voxelnet_predict
    from lyft3d_tpu_torch.pipelines.second import make_second_infer_fn

    def reset_counts():
        bev_raster.KERNEL_LAUNCHES = 0
        dense_fill.KERNEL_LAUNCHES = 0

    # 2. build
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda load: load(), [bev_raster._kernel_library, dense_fill._kernel_library]))
    log(f"build: bev_raster.cu dense_fill.cu -> {_build.BUILD_DIR} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")

    # 3. raster kernel against the plain version on the card
    raster = {}
    for b in RASTER_BATCHES:
        pts, valid = sweep_points(b, N_POINTS, seed=b)
        pts, valid = pts.to(dev), valid.to(dev)
        got = bev_raster.bev_rasterize(pts, valid, SHAPE)
        want = bev_raster.bev_rasterize_scatter(pts, valid, SHAPE)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"raster kernel differs from the plain version at B={b}")
        err = float((got - want).abs().max())
        k_ms = cuda_ms(lambda: bev_raster.bev_rasterize(pts, valid, SHAPE), warmup=3, iters=20)
        p_ms = cuda_ms(lambda: bev_raster.bev_rasterize_scatter(pts, valid, SHAPE), warmup=3, iters=20)
        raster[b] = (err, k_ms, p_ms)
        log(f"raster: B={b} N={N_POINTS} grid={SHAPE} torch.equal=True counted={int(got.sum())} "
            f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} [{card}]")

    # 4. extraction on the card against the CPU
    logits = torch.from_numpy(blob_logits(8, SHAPE[0], 10, seed=0))
    on_card = extract_detections_from_logits(logits.to(dev))
    on_cpu = extract_detections_from_logits(logits)
    torch.cuda.synchronize()
    err = check_detections(on_card, on_cpu, "extraction cuda vs cpu")
    log(f"extraction: B=8 336x336x10 components={int(on_cpu['box_valid'].sum())} "
        f"detections={int(on_cpu['detect'].sum())} equal masks/counts/flags, "
        f"max_abs_err={err:.3g} (tol {EXTRACT_TOL})")

    # 5a. flagship float32 check: card against CPU, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = BEVConfig()
    kw = {"n_classes": 10, "norm_type": "folded"}
    pts, valid = sweep_points(1, N_POINTS, seed=1)
    map_ch = torch.from_numpy(np.random.RandomState(1).rand(1, *SHAPE[:2]).astype(np.float32))
    ref_model = build_model("unet_resnet50", generator=torch.Generator().manual_seed(0), **kw).eval()
    card_model = build_model("unet_resnet50", generator=torch.Generator().manual_seed(0),
                             device=dev, **kw).eval()
    with torch.inference_mode():
        x_cpu = make_bev_input(pts, valid, map_ch, cfg)
        x_card = make_bev_input(pts.to(dev), valid.to(dev), map_ch.to(dev), cfg)
        if not torch.equal(x_card.cpu(), x_cpu):
            raise AssertionError("model input on the card differs from the CPU's")
        ref_logits, ref_aux = ref_model(x_cpu)
        card_logits, card_aux = card_model(x_card)
    scale = max(1.0, float(ref_logits.abs().max()))
    logit_err = float((card_logits.cpu() - ref_logits).abs().max())
    aux_err = float((card_aux.cpu() - ref_aux).abs().max())
    # float32 both sides, but cuDNN and oneDNN pick different convolution
    # algorithms (cuDNN may use Winograd or FFT), summing in other orders
    # over 50+ layers: held to 1e-3 of the logit scale.
    tol = 1e-3 * scale
    if not (logit_err <= tol and aux_err <= tol):
        raise AssertionError(f"float32 logits card vs cpu: {logit_err} / aux {aux_err} > {tol}")
    log(f"flagship check: unet_resnet50 folded f32 B=1, TF32 off, card vs cpu "
        f"max_abs_err logits={logit_err:.3g} aux={aux_err:.3g} (tol {tol:.3g}, scale {scale:.3g})")
    del ref_model, card_model
    torch.backends.cudnn.allow_tf32 = True

    # 5b. flagship main path at batch 32 in bfloat16
    model = build_model("unet_resnet50", generator=torch.Generator().manual_seed(0),
                        device=dev, dtype=torch.bfloat16, **kw)
    infer = make_infer_fn([model], cfg)
    pts, valid = sweep_points(BATCH, N_POINTS, seed=2)
    pts, valid = pts.to(dev), valid.to(dev)
    map_ch = torch.from_numpy(
        np.random.RandomState(2).rand(BATCH, *SHAPE[:2]).astype(np.float32)).to(dev)
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    e2e_ms = cuda_ms(lambda: infer(pts, valid, map_ch))
    det = infer(pts, valid, map_ch)
    torch.cuda.synchronize()
    launches = bev_raster.KERNEL_LAUNCHES
    if launches <= 0:
        raise AssertionError("the main path never launched the raster kernel")

    k = 64
    expect = {"boxes_px": (BATCH, k, 5), "box_valid": (BATCH, k), "counts": (BATCH, k),
              "centroids": (BATCH, k, 2), "scores": (BATCH, k, 9), "detect": (BATCH, k, 9)}
    for name, shape in expect.items():
        if tuple(det[name].shape) != shape:
            raise AssertionError(f"{name}: shape {tuple(det[name].shape)} != {shape}")
    for name in ("boxes_px", "centroids", "scores"):
        if not bool(torch.isfinite(det[name]).all()):
            raise AssertionError(f"{name} has non-finite values")
    if not bool(((det["scores"] >= 0) & (det["scores"] <= 1)).all()):
        raise AssertionError("scores outside [0, 1]")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # Stage split of the same path (each stage timed alone).
    with torch.inference_mode():
        x = make_bev_input(pts, valid, map_ch, cfg)
        lg = model(x)[0]
        stage_ms = {
            "input": cuda_ms(lambda: make_bev_input(pts, valid, map_ch, cfg)),
            "model": cuda_ms(lambda: model(x)),
            "extract": cuda_ms(lambda: extract_detections_from_logits(lg)),
        }
    log(f"flagship e2e: unet_resnet50 folded bf16 B={BATCH} N={N_POINTS} "
        f"sweeps_per_s={BATCH / (e2e_ms / 1e3):.2f} e2e_ms={e2e_ms:.3f} "
        f"stages_ms input={stage_ms['input']:.3f} model={stage_ms['model']:.3f} "
        f"extract={stage_ms['extract']:.3f} components={int(det['box_valid'].sum())} "
        f"peak_mem_gb={peak_gb:.2f} raster_launches={launches} [{card}]")
    del model, infer, pts, valid, map_ch, x, lg, det

    # 6. fill kernel against the plain version on the card
    fill = {}
    for dtype in (torch.bfloat16, torch.float32):
        feats, ids, fvalid = (a.to(dev) for a in fill_case(dtype, seed=3))
        got = dense_fill.fill_rows_by_id(feats, ids, fvalid, FILL_ROWS, assume_sorted=True)
        want = dense_fill.fill_rows_by_id_scatter(feats, ids, fvalid, FILL_ROWS)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fill kernel differs from the plain version in {dtype}")
        err = float((got.float() - want.float()).abs().max())
        k_ms = cuda_ms(lambda: dense_fill.fill_rows_by_id(feats, ids, fvalid, FILL_ROWS,
                                                          assume_sorted=True), warmup=3, iters=20)
        p_ms = cuda_ms(lambda: dense_fill.fill_rows_by_id_scatter(feats, ids, fvalid, FILL_ROWS),
                       warmup=3, iters=20)
        fill[dtype] = (err, k_ms, p_ms)
        log(f"fill: B={SEC_BATCH} V={FILL_V} C={FILL_C} rows={FILL_ROWS} {str(dtype)[6:]} "
            f"torch.equal=True kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} [{card}]")
    g = torch.Generator().manual_seed(4)
    dup = torch.sort(torch.randint(0, 50000, (SEC_BATCH, FILL_V), generator=g), dim=-1).values
    feats = torch.randn(SEC_BATCH, FILL_V, FILL_C, generator=g)
    ones = torch.ones(SEC_BATCH, FILL_V, dtype=torch.bool)
    got = dense_fill.fill_rows_by_id(feats.to(dev), dup.int().to(dev), ones.to(dev), 50000,
                                     assume_sorted=True).cpu().double()
    ref = dense_fill.fill_rows_by_id_scatter(feats.double(), dup, ones, 50000)
    mag = dense_fill.fill_rows_by_id_scatter(feats.double().abs(), dup, ones, 50000)
    rel = float(((got - ref).abs() / mag.clamp_min(1e-30)).max())
    if not rel <= FILL_DUP_REL:
        raise AssertionError(f"fill kernel duplicate sums off by {rel} of their magnitudes")
    log(f"fill: duplicates ({int((dup[:, 1:] == dup[:, :-1]).sum())} repeats) float32 "
        f"max_err/magnitude={rel:.3g} (tol {FILL_DUP_REL})")

    # 7a. pillars float32 check: card against CPU, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    vcfg = lyft9_config()
    pts, pvalid = pillar_points(1, SEC_POINTS, seed=5)
    ref_net = VoxelNet(vcfg, in_features=4, generator=torch.Generator().manual_seed(0)).eval()
    card_net = VoxelNet(vcfg, in_features=4, device=dev,
                        generator=torch.Generator().manual_seed(0)).eval()
    grid_args = (vcfg.grid, vcfg.max_voxels, vcfg.max_points_per_voxel)
    with torch.inference_mode():
        vox_cpu = voxelize(pts, pvalid, *grid_args)
        vox_card = voxelize(pts.to(dev), pvalid.to(dev), *grid_args)
        for k, v in vox_cpu.items():
            if not torch.equal(vox_card[k].cpu(), v):
                raise AssertionError(f"voxelize {k} on the card differs from the CPU's")
        keys = ("voxels", "num_points", "coords", "voxel_valid")
        ref_heads = ref_net(*[vox_cpu[k] for k in keys])
        card_heads = card_net(*[vox_card[k] for k in keys])
    for a_cpu, a_card in zip(vcfg.make_anchors(), vcfg.make_anchors(dev)):
        if not torch.equal(a_card.cpu(), a_cpu):
            raise AssertionError("anchors on the card differ from the CPU's")
    scale = max(1.0, max(float(h.abs().max()) for h in ref_heads.values()))
    head_err = {k: float((card_heads[k].cpu() - h).abs().max()) for k, h in ref_heads.items()}
    tol = 1e-3 * scale
    if not max(head_err.values()) <= tol:
        raise AssertionError(f"float32 heads card vs cpu: {head_err} > {tol}")
    kept = int(vox_cpu["voxel_valid"].sum())
    log(f"pillars check: VoxelNet lyft9 f32 B=1 N={SEC_POINTS}, TF32 off, card vs cpu: voxelize "
        f"equal ({kept} pillars kept), anchors bit-equal ({vcfg.make_anchors()[0].shape[0]}), "
        f"max_abs_err box={head_err['box']:.3g} cls={head_err['cls']:.3g} "
        f"dir={head_err['dir']:.3g} (tol {tol:.3g}, scale {scale:.3g})")
    del ref_net, card_net, vox_cpu, vox_card
    torch.backends.cudnn.allow_tf32 = True

    # 7b. pillars main path at batch 8 in bfloat16
    net = VoxelNet(vcfg, in_features=4, dtype=torch.bfloat16, device=dev,
                   generator=torch.Generator().manual_seed(0))
    infer = make_second_infer_fn(net, vcfg)
    pts, pvalid = (a.to(dev) for a in pillar_points(SEC_BATCH, SEC_POINTS, seed=6))
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    e2e_ms = cuda_ms(lambda: infer(pts, pvalid))
    det = infer(pts, pvalid)
    torch.cuda.synchronize()
    fill_launches = dense_fill.KERNEL_LAUNCHES
    if fill_launches <= 0:
        raise AssertionError("the pillars main path never launched the fill kernel")
    k = vcfg.nms_post
    expect = {"boxes": (SEC_BATCH, k, 7), "scores": (SEC_BATCH, k), "classes": (SEC_BATCH, k),
              "valid": (SEC_BATCH, k)}
    for name, shape in expect.items():
        if tuple(det[name].shape) != shape:
            raise AssertionError(f"{name}: shape {tuple(det[name].shape)} != {shape}")
    if not bool(torch.isfinite(det["boxes"]).all()):
        raise AssertionError("boxes have non-finite values")
    if not bool(((det["scores"] >= 0) & (det["scores"] <= 1)).all()):
        raise AssertionError("scores outside [0, 1]")
    cls = det["classes"][det["valid"]]
    if not bool(((cls >= 1) & (cls <= len(LYFT9_ANCHORS))).all()):
        raise AssertionError("classes outside 1..9")
    sec_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # Stage split of the same path (each stage timed alone).
    anchors, _, _, anchor_class = vcfg.make_anchors(dev)
    with torch.inference_mode():
        vox = voxelize(pts, pvalid, *grid_args)
        feats = net.encoder(vox["voxels"], vox["num_points"], vox["coords"])
        bev = net.scatter(feats, vox["coords"], vox["voxel_valid"])
        preds = net(*[vox[k] for k in ("voxels", "num_points", "coords", "voxel_valid")])
        occupied = int(voxelize(pts[:1], pvalid[:1], vcfg.grid, 10 ** 6, 1)["voxel_valid"].sum())
        sec_ms = {
            "voxelize": cuda_ms(lambda: voxelize(pts, pvalid, *grid_args)),
            "encoder": cuda_ms(lambda: net.encoder(vox["voxels"], vox["num_points"], vox["coords"])),
            "scatter": cuda_ms(lambda: net.scatter(feats, vox["coords"], vox["voxel_valid"])),
            "rpn": cuda_ms(lambda: net.rpn(bev)),
            "predict": cuda_ms(lambda: voxelnet_predict(preds, anchors, anchor_class, vcfg)),
        }
    log(f"pillars e2e: VoxelNet lyft9 bf16 B={SEC_BATCH} N={SEC_POINTS} "
        f"samples_per_s={SEC_BATCH / (e2e_ms / 1e3):.2f} e2e_ms={e2e_ms:.3f} stages_ms "
        + " ".join(f"{n}={v:.3f}" for n, v in sec_ms.items())
        + f" occupied_pillars_sample0={occupied} kept={vcfg.max_voxels} "
        f"detections={int(det['valid'].sum())} peak_mem_gb={sec_peak_gb:.2f} "
        f"fill_launches={fill_launches} [{card}]")

    err32, k_ms, p_ms = raster[BATCH]
    f_err = max(e for e, _, _ in fill.values())
    _, f_ms, f_plain_ms = fill[torch.bfloat16]
    print(json.dumps({"kernels": [{
        "name": "bev_raster",
        "route": "cuda",
        "source": "lyft3d_tpu_torch/csrc/bev_raster.cu",
        "replaces": "lyft3d_tpu/ops/bev_raster.py:146",
        "launches": launches,
        "max_abs_err": err32,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "dense_fill",
        "route": "cuda",
        "source": "lyft3d_tpu_torch/csrc/dense_fill.cu",
        "replaces": "lyft3d_tpu/ops/dense_fill.py:78",
        "launches": fill_launches,
        "max_abs_err": f_err,
        "ms": f_ms,
        "plain_ms": f_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
