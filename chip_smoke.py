#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the inference paths (BEV
segmentation with ``unet_resnet50`` and ``unet_seresnext101``, SECOND
pillars, PointRCNN, sparse SECOND at the FHD geometry), SECOND training
(pillars and both sparse middles), BEV training and PointRCNN training.

    python3 chip_smoke.py

Phases, one line of numbers each:

1. device: requires CUDA (no CPU fallback) and prints the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build: compiles the port's CUDA kernels from ``lyft3d_tpu_torch/csrc`` into
   a clean ``build/`` directory, one ``nvcc`` per source, in parallel;
3. raster: the hand-written BEV raster kernel (global atomics, launched in
   chunks of samples, each chunk's grid zeroed just before its kernel)
   against its plain PyTorch version on the same card, at 336x336x3 with 1,
   8, 16, 24 and 32 x 65,536 points, on a uniform sweep (±60 m, 10% invalid,
   some out of range, some on bin edges) and a LiDAR-like one
   (:func:`lidar_cloud`), and 8 x 65,536 into 1024x1024x3: the rule's chunk,
   one launch for the batch and, from 8 samples, two chunks, each
   ``torch.equal`` and timed with CUDA events alone and queued (the rule's
   evidence, one line a case); then the unbatched call, (N, 4) rows, points on every bin edge, a
   337x333x3 grid and a 1024x1024x3 grid, also in chunks of 1 and 2, and the
   rule's launch under PyTorch's sync debug mode;
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
   duplicate ids (float32, 64 and 5 channels) must sum within 1e-6 of the
   summed magnitudes;
   both timed with CUDA events, and the kernel's launch queued
   (:func:`queued_ms`) beside ``index_add_`` into zeros;
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

8. fps / ball / knn / roi: the four hand-written PointNet++ kernels against
   their plain PyTorch versions on the card at the largest shapes of the
   PointRCNN path (furthest-point sampling 4 x 16,384 → 4,096 and 400 x 512
   → 128; ball query 4 x 4,096 centres x 16,384 points at radii (0.1, 0.5),
   k (16, 32), again at radii (2, 4) where rows fill and stop early, and 400
   x 128 x 512 with k 64; 3-NN 4 x 16,384 x 4,096; RoI select 4 x 100 boxes
   x 16,384 points, k 512, extra width 1.0, at its three launch shapes on a
   uniform and a LiDAR-like cloud and at 4 x 512 boxes: the rule's evidence;
   and at :func:`roi_edge_checks`' shapes), with 5% invalid points,
   duplicated points, a far-away centre (an empty row), a box with more
   points than k and an empty box: indices and counts ``torch.equal``,
   distances within 1e-6; both timed with CUDA events. Ball query runs both
   its kernels (the scan and the cell grid) at every case, and again at
   :data:`BALL_EDGES` (points on cell faces, centres at ±1,000 m, 16 buckets
   a sample so that neighbouring cells share buckets, invalid points inside
   the radius, 3 and 4 radii, k = 64, 400 clouds), where the grid's cell keys
   kernel is held to its plain version too; the grid is timed as its table
   and its selection. Both ball-query routes and 3-NN run once under
   PyTorch's sync debug mode: none may make the host wait for the card. 3-NN runs every split (queries a thread, threads a
   query) at :data:`KNN_EDGES` (S and M no multiple of a block or a split,
   M = 1, 2, 3, duplicated known points). FPS runs a cluster of
   16 CTAs a cloud at 4 x 16,384 (timed beside one block a cloud) and one
   block a cloud for the 400 RoI clouds, and is also held to its plain
   version at :data:`FPS_EDGES` (ties across CTAs, a cloud without a valid
   point, fewer valid points than npoint, N no multiple of the cluster's
   span, N = 65,536, batch 1, more clusters than the card keeps resident);
9. pointrcnn check: the ``PointRCNN`` of ``lyft_pointrcnn_config("test")`` in
   float32 at batch 1 with TF32 off, card against CPU with the same seeded
   weights, stage by stage on the CPU's inputs: FPS indices and proposal
   sets equal, RPN outputs, RCNN heads and refined boxes within 1e-3 of
   their scale;
10. pointrcnn e2e: the main path, ``make_pointrcnn_infer_fn`` (SA pyramid with
    the FPS and ball-query kernels → FP with the 3-NN kernel → proposal layer
    → RoI pool with the RoI-select kernel → RCNN → decode + final NMS), in
    bfloat16 with folded norms at batch 4 x 16,384 points: the four launch
    counts are reset before it and must be 6, 6, 4 and 1 a call after it;
    output shapes, finite boxes, scores in [0, 1]; samples/s from CUDA events
    (2 warm-up, 10 timed iterations), a stage split, and peak memory; the
    path again with ball query held to the scan, interleaved with the rule's
    path six times. The six
    FPS, six ball-query and four 3-NN launches of one more call are recorded,
    and the six ball-query launches again on a LiDAR-like cloud
    (:func:`lidar_cloud`: dense near the sensor and on the ground, where rows
    fill), and the RoI-select launch on the call's own proposals, replayed
    after the stage split: each ``torch.equal`` to the
    plain version (3-NN distances within 1e-6 of scale) and timed, FPS in µs
    a dependent step; ball query on both kernels and 3-NN at every split,
    each also queued behind a sleep kernel (:func:`queued_ms`: the card's
    time when the host keeps ahead) and in host µs a call: the evidence of
    the two shape rules, one line each, with the rule's total a call.

10a. sparse kernel edges: the stencil kernel, its two backward sides and the
    rank gather (forward, ``df``, ``dW``) against their plain versions at the
    shapes a tiled tensor-core kernel gets wrong first (:data:`STENCIL_EDGES`,
    :data:`SUBM_EDGES`, :data:`SUBM_TABLES`; the rank gather's bfloat16
    forward also as its float32 sums, 1e-5; the reverse table it builds for
    ``df`` against ``reverse_ranks``, and its flag on a table that repeats an
    (offset, row) pair): query counts that are no multiple of the 128-query
    tile, tiles without a hit, every query hitting at all nine offsets, one
    hit in the whole launch, an empty sample, 65, 66, 68, 128 and 256 columns,
    128 and 256 lanes, one and two chunks, dense random weights and banded
    ones, 3 to 96 channels, tables without a hit, with one present neighbour
    and with the centre offset alone; bfloat16 (tensor cores) and float32
    (FMA), with the tolerances of phases 12 and 18;
11. sparse check: the sparse ``VoxelNet`` of
    ``configs/second_lyft_9class_sparse.yaml`` (spelled out in
    :func:`fhd_config`: 0.05 x 0.05 x 0.2 m voxels on a 1984 x 1984 x 40
    grid, 60,000 voxels, block filtering, z-slab unit middle) in float32 at
    batch 1 x 262,144 points with TF32 off, card against CPU with the same
    seeded weights, stage by stage on the CPU's inputs: voxelize outputs,
    unit ids and masks equal, unit features, dense BEV and heads within 1e-3
    of their scale;
12. sparse e2e: the main path of this model, ``make_second_infer_fn``
    (voxelize with block filter → mean encoder → units (fill kernel) → 3
    stages of 2 submanifold + 1 strided conv (stencil kernel) → dense BEV
    (fill kernel) → RPN → decode + NMS), in bfloat16 with folded middle norms
    at batch 4 x 262,144 points: the stencil and fill launch counts are reset
    before it and must be 9 and 2 a call after it; samples/s from CUDA events,
    a stage split, how far each capacity cap truncates, and peak memory. Every
    stencil and fill call of one forward pass is recorded and replayed:
    the stencil kernel against its plain version at the nine shapes (bfloat16
    and float32, 1e-5 of the output scale, the strided layers' mask channel
    equal), the fill kernel at its two new shapes (``torch.equal``; the
    launch queued beside ``index_add_``);
13. per-voxel e2e: the second sparse path, ``middle="sparse"``, same geometry
    and caps, bfloat16: the rank gather kernel's count must be 6 a call and
    the fill kernel's 1; samples/s and a stage split; the six recorded calls
    replayed against the plain version (1e-5 of scale in float32 and for the
    bfloat16 route's float32 sums, 2^-7 for its rounded output) and timed
    beside ``index_select`` + ``einsum``; the fill call replayed as in 12;
14. cross-check: with the same float32 weights, and a cloud and caps under
    which no stage truncates (asserted), both middles give the same dense BEV
    map within 1e-3 of its scale.

15. fill backward: the row-gather kernels behind ``fill_rows_by_id``'s
    gradient against their plain version, ``torch.equal``: the warp kernel
    (rows of a multiple of 16 bytes) and the lane kernel at every shape the
    rule gives the warp kernel, the lane kernel alone at the others: the
    pillars shape in bfloat16 and float32, the narrow unit shapes (4 and 5
    columns), :data:`FILL_BWD_EDGES` (V no multiple of a warp, V under a
    warp, an all-sentinel sample, duplicate ids, rows of 16, 48 and 256
    bytes, one row), unsorted ids through the public function; each kernel
    queued (:func:`queued_ms`) beside ``torch.index_select``, the rule's also
    on the host's clock and in host µs a call;
16. gradient check: one ``loss.backward()`` of ``make_second_loss_fn`` in
    float32 with TF32 off, card against CPU with the same seeded weights, for
    the 9-class pillars ``VoxelNet`` at batch 1 x 262,144 points and the FHD
    sparse ``VoxelNet`` (unit middle, then per-voxel middle) at batch 1 on a
    clustered cloud that fills no cap (asserted): loss within 1e-5 relative,
    every parameter gradient finite, not all zero and within 0.15 in the
    2-norm (ReLU sign changes under cuDNN's rounding rule out an element-wise
    bound at this size); then the kernel path alone, the CPU's BEV cotangent
    pushed through encoder, middle and fill on both devices: every parameter
    gradient within 2e-2 of its scale (floored at 1e-4 of the largest);
17. training steps at full width through ``make_second_loss_fn``,
    ``build_optimizer`` and the ``Trainer``'s step function, bfloat16 model
    with float32 heads and float32 master parameters: pillars at batch 8 x
    262,144 points and sparse FHD (``middle_norm="layer"``) at batch 4 with
    the unit middle and with the per-voxel middle, ``adam_onecycle`` with the
    yaml's hyper-parameters and 64 padded GT boxes a sample; and the
    bench-shaped sparse step (batch 2, ``adam(1e-3)``, four car boxes). 2
    warm-up + 10 timed steps on a fixed batch: step ms and samples/s from
    CUDA events, a stage split, peak memory, losses finite at every step and
    lower at the end; every kernel count is reset before the timed steps and
    read after them;
18. backward replay: every backward launch of one sparse training step is
    recorded with its cotangent and replayed, kernel against plain version
    (the plain forward differentiated by autograd, in float32 on the same
    values): the stencil's ``d_src`` (the forward kernel on the reverse
    queries) and ``d_wc`` at the nine launches, the rank gather's ``df``
    (the forward kernel on the reverse ranks; the step's five launches also
    as a total) and ``dW`` at the six, the fill's gather at its recorded
    shapes (the pillars step's launch too, every kernel that takes the rows,
    timed as in 15); 1e-5 of scale in float32 (5e-5 for the weight gradients, sums of
    up to 300,000 outer products whose atomics vary in order), 2^-7 where the
    result is rounded to bfloat16. The weight gradient of the stencil is
    timed beside cuBLAS (``torch.einsum``) on rows gathered beforehand, with
    and without the gather; the stencil's two are replayed once more on a
    clustered cloud that fills no cap (dense hits, few zero cotangent rows);
19. fit: a short ``Trainer.fit`` on the bench-shaped tensors that writes
    checkpoints into a temporary directory, resumes from them in a fresh
    trainer at the right step with equal parameters, and trains on.

20. seresnext101: ``unet_seresnext101`` (10 classes, folded norms, full
    width, seeded weights) in float32 with TF32 off at batch 1, card against
    CPU (logits within 1e-3 of their scale); then the BEV main path,
    ``make_infer_fn``, at batch 32 x 65,536 points in bfloat16 with the raster
    kernel's count reset before it (> 0 after it; these launches join the
    flagship's in the ``kernels`` line): e2e ms, sweeps/s, a stage split,
    peak memory; and the 32-group 3x3 convolutions of its four stages alone
    at batch 32, ``channels_last`` beside NCHW and beside the dense
    convolution of the same widths, with their bound;
21. BEV train steps: the functions ``train_bev`` runs (``build_bev_model``,
    ``make_bev_loss_fn``, ``make_bev_optimizer_fn``; the yaml's ``ranger``,
    lr 1e-3, clip 5, ``grad_accum`` 4, spelled out in
    :func:`bev_train_config`) on the ``Trainer``'s step function, for
    ``unet_resnet50`` and ``unet_seresnext101`` at microbatch 8 x 336 x 336 x
    6 and ``unet_seresnext101`` at the yaml's microbatch, 32, in bfloat16
    (float32 heads and masters), inputs from the raster kernel and targets
    from ``rasterize_boxes_bev`` on the card: 2 warm-up + 8 timed microsteps
    (two optimizer updates inside), microstep ms, samples/s, the forward+loss
    / backward / optimizer split, peak memory above what earlier phases hold,
    finite losses;
    then one update's microsteps under ``torch.profiler``: device ms a
    microstep, the busy share, and the ten aten ops with the most kernel
    time; and forward+loss+backward beside the same trunk without norm ops
    (``norm_type="folded"``), the norms' share of the step;
22. BEV train check: one train-mode step of ``unet_seresnext101`` with
    ``norm_type="batch"`` in float32, TF32 off, at 2 x 128 x 128 x 6, card
    against CPU: loss within 1e-4 relative, every parameter gradient finite,
    not all zero and within 0.15 in the 2-norm, running statistics within
    1e-3 of their scale; the same model in bfloat16 keeps float32 running
    statistics that move in a train-mode forward. Phases 20-22 print one
    JSON line each (a line per case), with the card's name and power limit.

23. PointRCNN RPN training at ``lyft_pointrcnn_config("train")`` in float32
    on a synthetic KITTI tree (:func:`kitti_training_tree`: 4 frames of
    20,000 points, 16 car boxes a frame holding 30% of them) read by the
    port's loader: ``train_pointrcnn_rpn`` (3 steps of batch 2 x 16,384
    points) with the PointNet++ kernel counts set to 0 before it and read
    after it; then ``make_rpn_step`` (``adam_onecycle``) on a fixed batch of
    2: 2 warm-up + 10 timed steps, the split labels / forward / loss /
    backward / optimizer, peak memory above what earlier phases hold, the
    launches of one step (recorded for 27);
24. the online RCNN: ``train_rcnn_online`` (2 steps of one frame) with the
    counts reset around it; then one frame's step (frozen RPN + proposals,
    RoI sampling + noise, ``roi_pool3d``, RCNN forward + loss, backward,
    ``adam``) on all 512 RoIs x 512 points: timed as in 23, split into those
    stages, peak memory, the sampled foreground;
25. the offline RCNN: ``cache_rcnn_samples`` over 2 frames, then one
    ``train_rcnn_offline`` step, counted, then both timed by CUDA events;
26. card against CPU, float32 with TF32 off, on a 4,096-point frame of the
    tree: one RPN step (loss within 1e-5, gradients and updated parameters
    within ``GRAD_NORM_TOL`` in the 2-norm), the RPN's and the RCNN's bin
    labels equal, ``proposal_target_layer`` and ``aug_rois_with_noise`` on
    512 RoIs around the GT boxes with the same draws: equal masks and choices
    where no IoU lies within 1e-4 of a threshold;
27. every FPS, ball-query, 3-NN and RoI-select launch of one RPN step and
    one online RCNN step replayed against its plain version and timed.
    Phases 23-27 print one JSON line each (a line a kernel in 27). The
    training paths' launches join the inference path's in the ``kernels``
    line.

The last two lines are a JSON object describing each kernel (its launches on
the main path, its error against the plain version, its time, the plain
version's, its bound and, where one PyTorch call computes the same function,
that call's time) and the JSON result line. Any failure raises and exits
non-zero without printing them.
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
RASTER_BATCHES = (1, 8, 16, 24, BATCH)
TIMED_ITERS = 10
SLEEP_CYCLES = 100_000_000  # ~50 ms of a spinning kernel at the H100's clock (queued_ms)
EXTRACT_TOL = 1e-5
BG_THRESHOLD = 80.0 / 255.0
# SECOND pillars (configs/second_lyft_9class.yaml): batch 8, data.max_points
# points of (x, y, z, time lag), max_voxels pillars of 64 channels on a
# 496x496 canvas.
SEC_BATCH = 8
SEC_POINTS = 262144
FILL_V, FILL_C, FILL_ROWS = 25000, 64, 496 * 496
FILL_DUP_REL = 1e-6
# PointRCNN (lyft_pointrcnn_config("test")): batch 4 x 16,384 points, 100
# proposals a sample, 512 points a RoI.
PRC_BATCH = 4
PRC_POINTS = 16384
PRC_ROIS = 100
PRC_ROI_POINTS = 512
# Sparse SECOND (configs/second_lyft_9class_sparse.yaml): batch 4 x 262,144
# points of (x, y, z).
FHD_BATCH = 4
FHD_POINTS = 262144
# The cross-check's cloud and stage caps: a uniform cloud grows ~2.25x in
# units with each strided layer, so few points and wide caps keep every stage
# whole.
CROSS_POINTS = 3000
CROSS_CAPS = (65536, 65536, 65536)
# Training: the yamls' optimizer block (both configs), 2 warm-up + 10 timed
# steps, 64 GT slots a sample.
ONECYCLE = dict(lr=0.003, total_steps=58650, weight_decay=0.01, clip_norm=10.0)
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
GT_SLOTS, GT_VALID = 64, 40
BENCH_TRAIN_BATCH = 2
# The gradient check's clustered cloud: few enough units that no cap fills.
GRAD_CLUSTERS, GRAD_POINTS = 32, 8192
# The clustered cloud of the backward replay: the same density a blob, more blobs.
CLUSTER_BLOBS, CLUSTER_POINTS = 96, 24576
# Tolerances of the card-vs-CPU gradient check (see grad_check): whole model
# in the 2-norm, kernel path element-wise.
GRAD_NORM_TOL, GRAD_PATH_TOL = 0.15, 2e-2
# A weight gradient sums up to 300,000 outer products in float32, the kernel's
# atomics in an order that varies from run to run (seen: up to 8.3e-6 of scale).
WGRAD_TOL = 5e-5
BF16_PEAK = 989e12  # dense bfloat16 tensor-core operations a second (H100 SXM data sheet)
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


def device_ms(fn, iters=5):
    """Mean milliseconds of device time a call of ``fn``: every kernel and
    copy ``torch.profiler`` sees, summed, without the gaps in which the card
    waits for the host (which ``cuda_ms`` counts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / iters / 1e3


def queued_ms(fn, iters=20):
    """Mean milliseconds a call of ``fn`` takes on the card when the host
    keeps ahead: the calls are queued behind a sleep kernel, and CUDA events
    time them back to back, without the gaps in which the card waits for the
    host (which ``cuda_ms`` counts). Raises if the host did not queue them
    all within the sleep."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    nap = torch.cuda.Event(enable_timing=True)
    nap.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queued = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if queued >= nap.elapsed_time(start):
        raise AssertionError(f"queued_ms: queuing took {queued:.2f} ms, longer than the "
                             f"{nap.elapsed_time(start):.2f} ms sleep")
    return start.elapsed_time(end) / iters


def without_host_sync(what, fn):
    """Runs ``fn`` with PyTorch's sync debug mode set to raise: a wrapper
    that makes the host wait for the card fails here."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as err:
        raise AssertionError(f"{what} synchronizes the host with the card: {err}") from err
    finally:
        torch.cuda.set_sync_debug_mode("default")


def host_us(fn, iters=20):
    """Mean microseconds of the host's clock a call of ``fn``, calls queued
    back to back without waiting for the card: what a launch costs a stage
    that follows the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


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


def fhd_config(**changes):
    """``configs/second_lyft_9class_sparse.yaml`` as the port's
    ``VoxelNetConfig``: the reference FHD geometry (0.05 x 0.05 x 0.2 m voxels
    on a 1984 x 1984 x 40 grid, one point a voxel, block filtering) with the
    z-slab unit middle (a CPU test holds it to the yaml field by field)."""
    import dataclasses

    from lyft3d_tpu_torch.models.second.voxelnet import VoxelNetConfig
    from lyft3d_tpu_torch.ops.anchors import AnchorSpec
    from lyft3d_tpu_torch.ops.voxelize import VoxelGrid

    cfg = VoxelNetConfig(
        grid=VoxelGrid(point_cloud_range=(-49.6, -49.6, -5.0, 49.6, 49.6, 3.0),
                       voxel_size=(0.05, 0.05, 0.2), block_filtering=True, block_factor=1,
                       block_size=8, height_threshold=0.2),
        max_voxels=60000,
        max_points_per_voxel=1,
        encoder="simple",
        middle="sparse_units",
        middle_features=(16, 32, 64),
        middle_max_voxels=(32768, 16384, 8192),
        middle_z_slab=8,
        middle_norm="layer",
        anchor_specs=tuple(AnchorSpec(size, z, m, u, class_id=i + 1)
                           for i, (size, z, m, u) in enumerate(LYFT9_ANCHORS)),
        rpn_up_strides=(1, 2, 4),
    )
    return dataclasses.replace(cfg, **changes)


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


def rcnn_cloud(batch, n, seed):
    """Uniform (x, y) in ±40 m, z in [-2, 1] m; the last 5% invalid; 1% of
    the points exact copies of earlier ones (tied distances)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    pts = torch.empty(batch, n, 3)
    pts[..., :2].uniform_(-40.0, 40.0, generator=g)
    pts[..., 2].uniform_(-2.0, 1.0, generator=g)
    dup = n // 100
    pts[:, n // 2: n // 2 + dup] = pts[:, :dup]
    valid = (torch.arange(n) < n - n // 20).expand(batch, n).contiguous()
    return pts, valid


def lidar_cloud(batch, n, seed):
    """A LiDAR-like sweep around a sensor at the origin, for the ball-query
    rule: 60% of the points on a ground plane (z = -1.7 m, 3 cm noise), 40% in
    32 objects a sample (Gaussian blobs of 0.6 x 0.6 x 0.4 m above the
    ground). Ranges are log-uniform, ground in [1.5, 40] m and object
    centres in [3, 40] m, so the density falls as 1 / range^2: the ground at
    2 m is ~400 times as dense as at 40 m, and most of a cloud lies near the
    sensor. The last 5% invalid."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def around(count, r_lo):
        rng = r_lo * (40.0 / r_lo) ** torch.rand(batch, count, generator=g)
        az = torch.rand(batch, count, generator=g) * (2 * math.pi)
        return rng * torch.cos(az), rng * torch.sin(az)

    n_ground = n * 3 // 5
    gx, gy = around(n_ground, 1.5)
    ground = torch.stack([gx, gy, -1.7 + 0.03 * torch.randn(batch, n_ground, generator=g)], -1)
    ox, oy = around(32, 3.0)
    centre = torch.stack([ox, oy, torch.full_like(ox, -1.0)], -1)
    which = torch.randint(0, 32, (batch, n - n_ground), generator=g)
    blobs = torch.gather(centre, 1, which[..., None].expand(-1, -1, 3))
    blobs = blobs + torch.randn(batch, n - n_ground, 3, generator=g) * torch.tensor([0.6, 0.6, 0.4])
    pts = torch.cat([ground, blobs], 1)
    pts = torch.gather(pts, 1, torch.argsort(torch.rand(batch, n, generator=g), 1)[..., None].expand(-1, -1, 3))
    valid = (torch.arange(n) < n - n // 20).expand(batch, n).contiguous()
    return pts.contiguous(), valid


def roi_clouds(batch, n, seed):
    """RoI-sized clouds in a box frame: ±3 x ±2 x ±1 m, the first ``count``
    points valid with ``count`` from 1 to ``n``."""
    import torch

    g = torch.Generator().manual_seed(seed)
    pts = (torch.rand(batch, n, 3, generator=g) - 0.5) * torch.tensor([6.0, 4.0, 2.0])
    count = torch.randint(1, n + 1, (batch, 1), generator=g)
    return pts, torch.arange(n)[None, :] < count


def roi_boxes(pts, r, seed):
    """``r`` car-sized boxes a sample centred on points of the cloud, with
    random yaw; the last but one 40 m wide (more points than any capacity),
    the last far away (empty)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    b, n, _ = pts.shape
    pick = torch.randint(0, n, (b, r), generator=g)
    centre = torch.gather(pts, 1, pick[..., None].expand(b, r, 3))
    size = torch.tensor([1.93, 4.76, 1.72]) * (0.8 + 0.4 * torch.rand(b, r, 3, generator=g))
    yaw = (torch.rand(b, r, 1, generator=g) * 2 - 1) * math.pi
    boxes = torch.cat([centre, size, yaw], dim=-1)
    boxes[:, -2, 3:5] = 40.0
    boxes[:, -1, :2] = 500.0
    return boxes


F32_PEAK = 67e12  # float32 operations a second outside the tensor cores (H100 SXM data sheet)
HBM_RATE = 3.35e12  # bytes a second


def bound(n_bytes, n_ops, peak=F32_PEAK):
    """The least milliseconds the card could take: bytes over the memory
    rate against operations over the peak rate; returns (ms, which)."""
    by_bytes, by_ops = n_bytes / HBM_RATE * 1e3, n_ops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def fill_bound(ids, num_rows, c, size, backward):
    """The bound (:func:`bound`) of the fill's kernel or, with ``backward``,
    of its backward's, from this run's masked (b, v) ids: the ids read once,
    the canvas (forward) or the rows (backward) written once, and a feature
    row (forward) or a distinct cotangent row (backward) read only for an id
    below ``num_rows``, since no kernel reads a masked row. Returns (ms,
    which, the share of ids below ``num_rows``)."""
    import torch

    b, v = ids.shape
    hit = (ids >= 0) & (ids < num_rows)
    n_hit = int(hit.sum())
    if backward:
        keys = (ids.long() + torch.arange(b, device=ids.device)[:, None] * num_rows)[hit]
        read, written = int(torch.unique(keys).numel()), b * v
    else:
        read, written = n_hit, b * num_rows
    return (*bound((read + written) * c * size + 4 * b * v, 0), n_hit / max(1, b * v))


def fhd_points(batch, n, seed):
    """Uniform (x, y) in ±49.6 m, z in [-3, 1] m; all valid."""
    import torch

    g = torch.Generator().manual_seed(seed)
    pts = torch.empty(batch, n, 3)
    pts[..., :2].uniform_(-49.6, 49.6, generator=g)
    pts[..., 2].uniform_(-3.0, 1.0, generator=g)
    return pts, torch.ones(batch, n, dtype=torch.bool)


class recorded:
    """Within the block, ``module.name`` also appends each call's positional
    arguments to ``self.calls``."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapper(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.orig(*args, **kwargs)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def rel_diff(got, want):
    """Largest absolute difference over the largest magnitude of ``want``."""
    return float((got.float() - want.float()).abs().max()) / max(1e-30, float(want.float().abs().max()))


def cols_to(cols, dev):
    import dataclasses

    return dataclasses.replace(cols, col_ids=cols.col_ids.to(dev), valid=cols.valid.to(dev),
                               mask=cols.mask.to(dev))


# (Cin, Cout, output cells a unit, strided) of the nine stencil launches of
# the FHD unit middle; a strided layer carries one more channel, the activity.
FHD_STENCIL_LAYERS = ((3, 16, 8, 0), (16, 16, 8, 0), (16, 16, 4, 1), (16, 32, 4, 0), (32, 32, 4, 0),
                      (32, 32, 2, 1), (32, 64, 2, 0), (64, 64, 2, 0), (64, 64, 1, 1))


# (batch, Vs, Vq, nc, kzp, N, hits) of the stencil edge checks; ``hits`` is the
# share of (offset, query) pairs that hit, "all", "one", or "holes": 128-query
# tiles without a hit and an empty last sample.
STENCIL_EDGES = (
    (2, 300, 300, 1, 128, 128, 0.3), (2, 300, 260, 2, 128, 68, 0.3), (1, 1000, 777, 1, 256, 128, 0.11),
    (2, 500, 500, 2, 256, 65, 0.5), (2, 333, 400, 1, 128, 66, 0.4), (1, 257, 129, 1, 128, 256, "all"),
    (2, 400, 400, 1, 256, 256, 0.2), (3, 640, 640, 1, 128, 128, "holes"), (2, 500, 500, 1, 256, 128, "one"),
    (2, 100, 90, 1, 30, 16, 0.5),
)
# (C, Cout) of the rank gather's edge checks: every width of the per-voxel
# middle (3 to 5 point features in, 16 to 64 channels) and two shapes that are
# no multiple of 16; and the tables checked besides the random one.
SUBM_EDGES = tuple((c, cout) for c in (3, 4, 5, 16, 32, 64) for cout in (16, 32, 64)) + ((20, 40), (96, 80))
SUBM_TABLES = ("no hit", "one row", "centre only")
# (what, batch, N, npoint) of the FPS edge checks: what the cluster kernel
# gets wrong first. The RCNN's one-block shapes are checked in phases 8 and 10.
FPS_EDGES = (
    ("ties across CTAs", 4, 16384, 1024), ("a cloud all invalid", 2, 16384, 300),
    ("fewer valid points than npoint", 2, 9000, 600), ("N no multiple of the cluster's span", 3, 12289, 700),
    ("N = 65,536", 1, 65536, 512), ("batch 1", 1, 16384, 1024), ("more clusters than fit at once", 40, 16384, 256),
)

# (what, batch, S, N, radii, k) of the ball-query edge checks, each run on the
# scan kernel and on the cell grid (default buckets, and 16 buckets a sample,
# where 27 neighbouring cells must share buckets): what a hashed grid gets
# wrong first.
BALL_EDGES = (
    ("points and centres on cell faces", 2, 300, 4000, (0.5, 1.0), (16, 32)),
    ("centres at +-1,000 m", 2, 300, 4000, (0.5, 1.0), (16, 32)),
    ("invalid points inside the radius", 2, 300, 4000, (1.0,), (32,)),
    ("3 radii", 2, 300, 4000, (0.3, 0.6, 1.2), (8, 16, 32)),
    ("4 radii", 2, 300, 4000, (0.2, 0.4, 0.8, 1.6), (8, 16, 32, 64)),
    ("k = 64", 2, 300, 4000, (2.0,), (64,)),
    ("a batch of 400 clouds", 400, 128, 512, (0.2, 0.4), (64, 64)),
)
# (what, batch, S, M) of the 3-NN edge checks, each at every split of
# csrc/knn.cu (queries a thread, threads a query).
KNN_EDGES = (
    ("S and M no multiple of a block or a split", 3, 1001, 999), ("M = 1", 2, 300, 1),
    ("M = 2", 2, 300, 2), ("M = 3", 2, 300, 3), ("duplicated known points (ties)", 2, 1500, 1200),
    ("M over three tiles", 2, 777, 2100),
)


def ball_edge_case(what, batch, s, n, radii, seed):
    """Centres, points, valid for one of :data:`BALL_EDGES`: a cloud of
    ``n`` points in ±5 x ±5 x ±1 m (denser than the path's, so that rows
    fill), centres on its first points."""
    import torch

    from lyft3d_tpu_torch.ops import pointnet2 as p2

    g = torch.Generator().manual_seed(seed)
    if what.startswith("a batch"):
        pts, valid = roi_clouds(batch, n, seed)
    else:
        pts = (torch.rand(batch, n, 3, generator=g) * 2 - 1) * torch.tensor([5.0, 5.0, 1.0])
        valid = torch.rand(batch, n, generator=g) >= 0.05
    if what.startswith("points and centres on cell faces"):
        # Coordinates at whole multiples of the cell's side, and one float32
        # step either side of them.
        side = 1.0 / p2._ball_cell_inverse(radii)
        face = torch.round(pts.double() / side) * side
        step = torch.randint(-1, 2, pts.shape, generator=g).float()
        face = face.float()
        face = torch.where(step > 0, torch.nextafter(face, face + 1), face)
        face = torch.where(step < 0, torch.nextafter(face, face - 1), face)
        pts = torch.where(torch.rand(batch, n, 1, generator=g) < 0.5, face, pts)
    elif what.startswith("centres at"):
        pts[0, :, 0] += 1000.0
        pts[1, :, 1] -= 1000.0
    elif what.startswith("invalid points"):
        valid[:, : s: 2] = False  # half the centres sit on invalid points
        valid[:, s:] = torch.rand(batch, n - s, generator=g) >= 0.3
    centers = pts[:, :s].clone()
    if what.startswith("centres at"):
        centers[:, -1] = torch.tensor([1000.0, 1000.0, 0.0])  # far from both clouds: an empty row
    return centers, pts, valid


def ball_edge_checks(dev, card):
    """:data:`BALL_EDGES` on both ball-query kernels: indices and counts
    ``torch.equal`` to the plain version."""
    import torch

    from lyft3d_tpu_torch.ops import pointnet2 as p2

    parts = []
    for i, (what, batch, s, n, radii, ks) in enumerate(BALL_EDGES):
        c, p, v = (a.to(dev) for a in ball_edge_case(what, batch, s, n, radii, seed=40 + i))
        want = p2.multi_radius_ball_query_dense(c, p, v, radii, ks)
        runs = {"scan": p2._ball_scan_cuda(c, p, v, radii, ks),
                "grid": p2._ball_grid_cuda(c, p, v, radii, ks),
                "grid, 16 buckets": p2._ball_grid_cuda(c, p, v, radii, ks, buckets=16)}
        for kernel, got in runs.items():
            for (g_idx, g_cnt), (w_idx, w_cnt) in zip(got, want):
                if not (torch.equal(g_idx, w_idx) and torch.equal(g_cnt, w_cnt)):
                    raise AssertionError(f"ball query edge {what!r} ({kernel}): kernel differs from "
                                         f"the plain version in {int((g_idx != w_idx).sum())} indices, "
                                         f"{int((g_cnt != w_cnt).sum())} counts")
        inv = p2._ball_cell_inverse(radii)
        for buckets in (p2._ball_buckets(n), 16):
            if not torch.equal(p2._ball_cell_keys_cuda(p, v, inv, buckets), p2.ball_cell_keys(p, v, inv, buckets)):
                raise AssertionError(f"ball query edge {what!r}: the cell keys kernel differs from its "
                                     f"plain version at {buckets} buckets a sample")
        counts = want[-1][1]
        parts.append(f"{what} (B={batch} S={s} N={n} r={radii} k={ks}; rule: "
                     f"{p2._ball_query_kernel(batch, s, n, max(radii))}; "
                     f"{int((counts == ks[-1]).sum())} full rows, {int((counts == 0).sum())} empty)")
    log(f"ball edges, scan, grid and grid at 16 buckets a sample, each torch.equal to the plain "
        f"version (the cell keys kernel too): {'; '.join(parts)} [{card}]")


def knn_edge_checks(dev, card):
    """:data:`KNN_EDGES` at every split of the 3-NN kernel: indices
    ``torch.equal`` to the plain version, distances within 1e-6 of scale."""
    import torch

    from lyft3d_tpu_torch.ops import pointnet2 as p2

    parts = []
    for i, (what, batch, s, m) in enumerate(KNN_EDGES):
        g = torch.Generator().manual_seed(60 + i)
        known = (torch.rand(batch, m, 3, generator=g) * 2 - 1) * 4.0
        kvalid = torch.rand(batch, m, generator=g) >= 0.1
        kvalid[:, 0] = True
        unknown = (torch.rand(batch, s, 3, generator=g) * 2 - 1) * 4.0
        if what.startswith("duplicated"):
            known[:, m // 2: m // 2 + 300] = known[:, :300]
            known[:, m - 100:] = known[:, 300:400]
            kvalid[:, m // 2: m // 2 + 300] = kvalid[:, :300]
            unknown[:, :400] = known[:, :400]  # queries on known points: distance 0 and ties
        known, kvalid, unknown = known.to(dev), kvalid.to(dev), unknown.to(dev)
        w_d, w_idx = p2.three_nn_dense(unknown, known, kvalid)
        for shape in p2.KNN_SHAPES:
            g_d, g_idx = p2._three_nn_cuda(unknown, known, kvalid, shape)
            err = float((g_d - w_d).abs().max())
            if not torch.equal(g_idx, w_idx) or not err <= 1e-6 * max(1.0, float(w_d.abs().max())):
                raise AssertionError(f"three_nn edge {what!r} at (Q, P) = {shape}: "
                                     f"{int((g_idx != w_idx).sum())} indices differ, distances by {err}")
        parts.append(f"{what} (B={batch} S={s} M={m}; rule {p2._knn_launch_shape(batch * s, m)})")
    log(f"knn edges at (Q, P) in {list(p2.KNN_SHAPES)}, indices torch.equal, distances within 1e-6 "
        f"of scale: {'; '.join(parts)} [{card}]")



def fps_edge_cloud(what, batch, n, seed):
    """:func:`rcnn_cloud` (1% exact copies half a cloud apart), with copies of
    64 points of CTA 0's share in every other CTA's share ("ties"), one
    cloud without a valid point, or 400 valid points in all."""
    pts, valid = rcnn_cloud(batch, n, seed)
    if what.startswith("ties"):
        share = n // 16
        for r in range(1, 16):
            pts[:, r * share + 5: r * share + 69] = pts[:, 10:74]
    elif what.startswith("a cloud all invalid"):
        valid[0] = False
    elif what.startswith("fewer valid"):
        valid[:] = False
        valid[:, :: n // 400] = True
    return pts, valid


def subm_edge_table(kind, b, v, seed):
    """A ``(b, 27, v)`` rank table in which each offset reads each source row
    at most once (every ``subm_neighbors`` table does, and the reverse-rank
    ``df`` needs it): 20% of the off-centre neighbours present, the centre
    offset everywhere, the last sample empty; or no hit at all, one present
    neighbour in the whole table, or the centre offset alone."""
    import torch

    g = torch.Generator().manual_seed(seed)
    if kind == "no hit":
        return torch.full((b, 27, v), -1, dtype=torch.int32)
    perm = torch.argsort(torch.rand(b, 27, v, generator=g), dim=-1)
    ranks = torch.where(torch.rand(b, 27, v, generator=g) < 0.2, perm, -1).int()
    ranks[:, 13] = torch.arange(v)
    ranks[-1] = -1
    if kind == "centre only":
        ranks[:, :13] = -1
        ranks[:, 14:] = -1
    elif kind == "one row":
        ranks[:] = -1
        ranks[0, 5, 17] = 3
    return ranks.contiguous()


def stencil_edge_case(b, vs, vq, nc, kzp, n, hits, seed, dev):
    """Sources, ids, queries with their reverse queries, weights (banded for
    odd seeds: 60% of the 16-lane blocks zero) and a cotangent with every
    third row zero. At every offset the queries read distinct rows, so the
    reverse queries exist."""
    import torch

    g = torch.Generator().manual_seed(seed)
    span = 4 * max(vs, vq) + 16
    src_ids = torch.stack([torch.sort(torch.randperm(span, generator=g)[:vs]).values for _ in range(b)]).int()
    q_ids = torch.stack([torch.sort(torch.randperm(span, generator=g)[:vq]).values for _ in range(b)]).int()
    qids = torch.full((b, 9, vq), -1, dtype=torch.int32)
    rev = torch.full((b, 9, vs), -1, dtype=torch.int32)
    for bi in range(b):
        for j in range(9):
            target = torch.randperm(max(vs, vq), generator=g)[:vq]
            if hits == "all":
                keep = target < vs
            elif hits == "one":
                keep = torch.zeros(vq, dtype=torch.bool)
                keep[vq // 3] = (bi, j) == (b - 1, 7)
            elif hits == "holes":
                keep = (torch.rand(vq, generator=g) < 0.3) & ((torch.arange(vq) // 128) % 2 == 0) & (bi < b - 1)
            else:
                keep = torch.rand(vq, generator=g) < hits
            keep &= target < vs
            # A miss is −1 or an id no source row has.
            miss = torch.where(torch.rand(vq, generator=g) < 0.5, -1, span + 5).int()
            qids[bi, j] = torch.where(keep, src_ids[bi][target.clamp(max=vs - 1)], miss)
            rev[bi, j, target[keep]] = q_ids[bi][keep]
    src = torch.randn(b, vs, nc * kzp, generator=g)
    wc = torch.randn(9, kzp, n, generator=g) * 0.3
    if seed % 2:
        wc = wc * (torch.rand(9, -(-kzp // 16), 1, generator=g) < 0.4).repeat_interleave(16, dim=1)[:, :kzp]
    cot = torch.randn(b, vq, nc * n, generator=g)
    cot[:, ::3] = 0
    return tuple(t.to(dev) for t in (src, src_ids, q_ids, qids.contiguous(), rev.contiguous(), wc, cot))


def stencil_edge_checks(dev):
    """Phase 10a for the stencil: forward, ``d_src`` and ``d_wc`` of every
    :data:`STENCIL_EDGES` case against the plain versions, in bfloat16 and in
    float32. Returns the largest error over its tolerance."""
    import torch

    from lyft3d_tpu_torch.ops import column_sparse as cs

    worst = 0.0

    def hold(what, got, want, tol):
        nonlocal worst
        scale = float(want.float().abs().max())
        err = rel_diff(got, want) if scale > 0 else float(got.float().abs().max())
        worst = max(worst, err / tol)
        if not err <= tol:
            raise AssertionError(f"sparse kernel edges: {what} differs from the plain version by "
                                 f"{err} of its scale (tol {tol})")

    for i, (b, vs, vq, nc, kzp, n, hits) in enumerate(STENCIL_EDGES):
        src, src_ids, q_ids, qids, rev, wc, cot = stencil_edge_case(b, vs, vq, nc, kzp, n, hits, 600 + i, dev)
        what = f"B={b} Vs={vs} Vq={vq} nc={nc} kzp={kzp} N={n} hits={hits}"
        for dtype in (torch.bfloat16, torch.float32):
            s_ = src.to(dtype).requires_grad_(True)
            w_ = wc.to(dtype).requires_grad_(True)
            out = cs.stencil_conv_batched(s_, qids, src_ids, w_, nc, rev_qids=rev, rev_src_ids=q_ids)
            s32 = s_.detach().float().requires_grad_(True)
            w32 = w_.detach().float().requires_grad_(True)
            want = cs.stencil_conv_ref(s32, qids, src_ids, w32, nc)
            hold(f"forward {what} {dtype}", out.detach(), want.detach(), 1e-5)
            if hits == "one" and int((out.detach().abs().sum(-1) > 0).sum()) != 1:
                raise AssertionError(f"sparse kernel edges: one hit must write one non-zero row ({what})")
            got_s, = torch.autograd.grad(out, (s_,), cot)
            want_s, want_w = torch.autograd.grad(want, (s32, w32), cot)
            hold(f"d_src {what} {dtype}", got_s, want_s, 1e-5 if dtype == torch.float32 else 2.0 ** -7)
            if dev.type == "cuda":  # before it is rounded to the weights' type
                got_w = cs._stencil_wgrad_cuda(s_.detach(), qids, src_ids, cot, nc, kzp, n)
            else:
                got_w = cs.stencil_conv_bwd_ref(s32.detach(), qids, src_ids, w32.detach(), nc, cot)[1]
            hold(f"d_wc {what} {dtype}", got_w, want_w, WGRAD_TOL)
    return worst


def subm_edge_checks(dev):
    """Phase 10a for the rank gather: forward, ``df`` and ``dW`` at every
    :data:`SUBM_EDGES` shape (3 samples of 2,000 rows, the last sample empty,
    every fourth cotangent row zero) and at the :data:`SUBM_TABLES` tables,
    against the plain versions: bfloat16 (tensor cores; the forward's float32
    sums before they are rounded, 1e-5) and float32 (FMA). Returns the
    largest error over its tolerance."""
    import torch

    from lyft3d_tpu_torch.ops import subm_conv_kernel as sk

    worst = 0.0

    def hold(what, got, want, tol):
        nonlocal worst
        scale = float(want.float().abs().max())
        err = rel_diff(got, want) if scale > 0 else float(got.float().abs().max())
        worst = max(worst, err / tol)
        if not err <= tol:
            raise AssertionError(f"sparse kernel edges: rank gather {what} differs from the plain version by "
                                 f"{err} of its scale (tol {tol})")

    b, v = 3, 2000
    cases = [(c, cout, "random") for c, cout in SUBM_EDGES] + [(16, 32, kind) for kind in SUBM_TABLES]
    for c, cout, kind in cases:
        g = torch.Generator().manual_seed(100 * c + cout)
        ranks = subm_edge_table(kind, b, v, seed=100 * c + cout).to(dev)
        f = torch.randn(b, v, c, generator=g).to(dev)
        w = (torch.randn(27, c, cout, generator=g) * 0.3).to(dev)
        cot = torch.randn(b, v, cout, generator=g)
        cot[:, ::4] = 0
        cot = cot.to(dev)
        what = f"{c}->{cout} {kind}"
        for dtype in (torch.bfloat16, torch.float32):
            f_ = f.to(dtype).requires_grad_(True)
            w_ = w.to(dtype).requires_grad_(True)
            out = sk.subm_conv(f_, ranks, w_)
            f32 = f_.detach().float().requires_grad_(True)
            w32 = w_.detach().float().requires_grad_(True)
            want = sk.subm_conv_ref(f32, ranks, w32)
            if dtype == torch.bfloat16:
                sums = sk._subm_conv_cuda(f_.detach(), ranks, w_.detach(), out_dtype=torch.float32)
                hold(f"forward sums {what} {dtype}", sums, want.detach(), 1e-5)
                hold(f"forward {what} {dtype}", out.detach(), want.detach(), 2.0 ** -7)
            else:
                hold(f"forward {what} {dtype}", out.detach(), want.detach(), 1e-5)
            if kind == "one row" and int((out.detach().abs().sum(-1) > 0).sum()) != 1:
                raise AssertionError("sparse kernel edges: one present neighbour must write one non-zero row")
            got = torch.autograd.grad(out, (f_, w_), cot.to(dtype))
            want_g = torch.autograd.grad(want, (f32, w32), cot.to(dtype).float())
            tols = (1e-5, WGRAD_TOL) if dtype == torch.float32 else (2.0 ** -7, 2.0 ** -7)
            for name, a, bb, tol in zip(("df", "dW"), got, want_g, tols):
                hold(f"{name} {what} {dtype}", a, bb, tol)
    return worst


def subm_contract_flag(dev):
    """The feature gradient's launch flags a table that reads an (offset, row)
    pair twice, and only such a table. The flag is read straight from the
    launch function: the wrapper asserts on it on the card, which would end
    this process."""
    import ctypes

    import torch

    from lyft3d_tpu_torch.ops import subm_conv_kernel as sk

    launch = sk._kernel_library()
    flags = []
    for repeat in (False, True):
        ranks = subm_edge_table("random", 2, 1000, seed=5).to(dev)
        if repeat:
            ranks[0, 4, 7] = ranks[0, 4, 9] = 3
        g = torch.randn(2, 1000, 16, device=dev)
        w = torch.randn(27, 16, 16, device=dev)
        out = torch.empty(2, 1000, 16, device=dev)
        rev = torch.empty(2, 27, 1000, dtype=torch.int32, device=dev)
        bad = torch.full((1,), 7, dtype=torch.int32, device=dev)
        ptrs = [ctypes.c_void_p(None if t is None else t.data_ptr())
                for t in (g, ranks, w, out, None, None, None, rev, bad)]
        err = launch(*ptrs, 2, 1000, 1000, 27, 16, 16, 0, 0, 0, 0, 0,
                     ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"subm_conv_launch failed with CUDA error {err}")
        flags.append(int(bad[0]))
        if not repeat and not torch.equal(rev, sk.reverse_ranks(ranks, 1000)):
            raise AssertionError("the reverse table built on the card differs from reverse_ranks")
    if flags != [0, 1]:
        raise AssertionError(f"the feature gradient's contract flag reads {flags} for a table without "
                             "and with a repeated pair, expected [0, 1]")


def sparse_kernel_edges(dev, card):
    """Phase 10a."""
    t0 = time.perf_counter()
    stencil = stencil_edge_checks(dev)
    subm = subm_edge_checks(dev)
    subm_contract_flag(dev)
    log(f"sparse kernel edges: {len(STENCIL_EDGES)} stencil cases (forward, d_src, d_wc) and "
        f"{len(SUBM_EDGES) + len(SUBM_TABLES)} rank gather cases (forward, df, dW; tables: random, "
        f"{', '.join(SUBM_TABLES)}), bfloat16 and float32, all within tolerance "
        f"(largest error / tolerance: stencil {stencil:.3g}, rank gather {subm:.3g}; tol 1e-5 float32 and "
        f"bfloat16 forward sums, 2^-7 rounded to bfloat16, weight gradients {WGRAD_TOL}); the reverse table "
        f"built on the card equals reverse_ranks and a repeated (offset, row) pair raises its flag "
        f"in {time.perf_counter() - t0:.1f} s [{card}]")


def stencil_replay(calls, card):
    """The recorded stencil calls of one forward pass, kernel against plain
    version, in the recorded dtype and in float32. Returns the ``kernels``
    record of the slowest launch (with the largest absolute error of all
    eighteen comparisons) and the per-call sums."""
    import torch

    from lyft3d_tpu_torch.ops import column_sparse as cs

    assert len(calls) == len(FHD_STENCIL_LAYERS), len(calls)
    rows, worst = [], 0.0
    for (args, _), (cin, cout, z_out, strided) in zip(calls, FHD_STENCIL_LAYERS):
        src, qids, src_ids, wc, nc = args
        b, vs, width = src.shape
        vq, (kzp, n) = qids.shape[-1], wc.shape[1:]
        assert n == z_out * (cout + strided) and nc == 1, (n, z_out, cout, nc)
        hits = int((cs.stencil_positions_ref(qids, src_ids) >= 0).sum())
        errs = {}
        for dtype in (src.dtype, torch.float32):
            s_, w_ = src.to(dtype), wc.to(dtype)
            got = cs.stencil_conv_batched(s_, qids, src_ids, w_, nc)
            torch.cuda.synchronize()
            want = cs.stencil_conv_ref(s_, qids, src_ids, w_, nc)
            errs[dtype] = rel_diff(got, want)
            worst = max(worst, float((got - want).abs().max()))
            if not errs[dtype] <= 1e-5:
                raise AssertionError(f"stencil kernel {vs}->{vq} {kzp}x{n} {dtype}: differs from "
                                     f"the plain version by {errs[dtype]} of its scale")
            if strided:  # window counts of ones: exact in any order
                mask_cols = torch.arange(z_out, device=got.device) * (cout + 1) + cout
                if not torch.equal(got[..., mask_cols], want[..., mask_cols]):
                    raise AssertionError(f"stencil kernel {vs}->{vq}: the mask channel differs")
            del got, want, s_, w_
        k_ms = cuda_ms(lambda: cs.stencil_conv_batched(src, qids, src_ids, wc, nc), warmup=1, iters=5)
        p_ms = cuda_ms(lambda: cs.stencil_conv_ref(src, qids, src_ids, wc, nc), warmup=1, iters=2)
        size = src.element_size()
        io = (b * vs * width + 9 * kzp * n) * size + (b * 9 * vq + b * vs) * 4 + b * vq * n * 4
        # A hit at one BEV offset is 3 z taps into every output cell of the unit.
        ops = hits * 2 * 3 * z_out * cin * cout
        peak = BF16_PEAK if src.dtype == torch.bfloat16 else F32_PEAK
        b_ms, b_by = bound(io, ops, peak)
        rows.append(dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"stencil: B={b} Vs={vs} Vq={vq} kzp={kzp} N={n} ({cin}->{cout}, {z_out} cells) "
            f"{str(src.dtype)[6:]} hits={hits} of {b * 9 * vq} max_err/scale "
            + " ".join(f"{str(d)[6:]}={e:.3g}" for d, e in errs.items())
            + f" (tol 1e-5) kernel_ms={k_ms:.4f} plain_ms={p_ms:.3f} bound_ms={b_ms:.5f} ({b_by}) "
            f"[{card}]")
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms")}
    log(f"stencil: nine launches of one call: kernel_ms={total['ms']:.3f} "
        f"plain_ms={total['plain_ms']:.3f} bound_ms={total['bound_ms']:.4f} [{card}]")
    slowest = max(rows, key=lambda r: r["ms"])
    return dict(slowest, max_abs_err=worst), total


def subm_replay(calls, card):
    """The recorded rank gather calls of one forward pass, kernel against
    plain version and the library pair ``index_select`` + ``einsum``. Returns
    the ``kernels`` record of the slowest launch (with the largest absolute
    error of the float32 comparisons) and the per-call sums."""
    import torch

    from lyft3d_tpu_torch.ops import subm_conv_kernel as sk

    assert len(calls) == 6, len(calls)
    rows, worst, devs = [], 0.0, []
    for args, _ in calls:
        f_sorted, ranks, w = args
        b, v, c = f_sorted.shape
        k, q = ranks.shape[1:]
        cout = w.shape[-1]
        hits = int((ranks >= 0).sum())
        errs = {}
        for dtype in (f_sorted.dtype, torch.float32):
            f_, w_ = f_sorted.to(dtype), w.to(dtype)
            got = sk.subm_conv(f_, ranks, w_)
            torch.cuda.synchronize()
            want = sk.subm_conv_ref(f_, ranks, w_)
            if dtype == torch.bfloat16:
                # The tensor cores' float32 sums before they are rounded: the
                # products are exact, so they differ from the plain sums by order.
                sums = sk._subm_conv_cuda(f_, ranks, w_, out_dtype=torch.float32)
                errs["sums"] = rel_diff(sums, sk.subm_conv_ref(f_.float(), ranks, w_.float()))
                if not errs["sums"] <= 1e-5:
                    raise AssertionError(f"rank gather kernel {b}x{v} {c}->{cout}: its float32 sums differ from "
                                         f"the plain version by {errs['sums']} of their scale")
                del sums
            # The output is rounded to the working type on both sides: in
            # bfloat16 a sum that differs in its last float32 bits may round
            # to the neighbouring value, one part in 256.
            tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
            errs[dtype] = rel_diff(got, want)
            if dtype == torch.float32:
                worst = max(worst, float((got - want).abs().max()))
            if not errs[dtype] <= tol:
                raise AssertionError(f"rank gather kernel {b}x{v} {c}->{cout} {dtype}: differs from "
                                     f"the plain version by {errs[dtype]} of its scale")
            del got, want, f_, w_
        k_ms = cuda_ms(lambda: sk.subm_conv(f_sorted, ranks, w), warmup=1, iters=5)
        dev_ms = device_ms(lambda: sk.subm_conv(f_sorted, ranks, w))
        p_ms = cuda_ms(lambda: sk.subm_conv_ref(f_sorted, ranks, w), warmup=1, iters=2)
        # The library pair: rows by index (absent neighbours point at an
        # appended zero row), then one contraction.
        table = torch.cat([f_sorted, f_sorted.new_zeros(b, 1, c)], dim=1).reshape(-1, c)
        base = torch.arange(b, device=ranks.device)[:, None, None] * (v + 1)
        index = (torch.where(ranks >= 0, ranks.long(), v) + base).reshape(-1)
        wk = w.to(f_sorted.dtype)

        def library():
            rows_ = torch.index_select(table, 0, index).view(b, k, q, c)
            return torch.einsum("bkvc,kcd->bvd", rows_, wk)

        if not rel_diff(library(), sk.subm_conv_ref(f_sorted, ranks, w)) <= 2.0 ** -6:
            raise AssertionError("index_select + einsum differs from the plain version")
        l_ms = cuda_ms(library, warmup=1, iters=5)
        size = f_sorted.element_size()
        io = (b * v * c + k * c * cout + b * q * cout) * size + b * k * q * 4
        peak = BF16_PEAK if f_sorted.dtype == torch.bfloat16 else F32_PEAK
        b_ms, b_by = bound(io, hits * 2 * c * cout, peak)
        rows.append(dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms))
        devs.append(dev_ms)
        log(f"subm: B={b} V={v} {c}->{cout} {str(f_sorted.dtype)[6:]} present={hits} of {b * k * q} "
            "max_err/scale " + " ".join(f"{str(d).replace('torch.', '')}={e:.3g}" for d, e in errs.items())
            + f" (tol 1e-5 float32 and bfloat16 sums, 2^-7 bfloat16 outputs) kernel_ms={k_ms:.4f} "
            f"(device {dev_ms:.4f}) plain_ms={p_ms:.3f} "
            f"index_select_einsum_ms={l_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) [{card}]")
        del table, index
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    log(f"subm: six launches of one call: kernel_ms={total['ms']:.3f} (device {sum(devs):.3f}) "
        f"plain_ms={total['plain_ms']:.3f} "
        f"index_select_einsum_ms={total['library_ms']:.3f} bound_ms={total['bound_ms']:.4f} [{card}]")
    slowest = max(rows, key=lambda r: r["ms"])
    return dict(slowest, max_abs_err=worst), total


def fill_queued(feats, ids, valid, num_rows, assume_sorted):
    """The fill's kernel launch and ``index_add_`` on the same rows, each
    queued (:func:`queued_ms`), on ids prepared as ``fill_rows_by_id``
    prepares them for its kernel. Returns (kernel ms, index_add_ ms)."""
    import torch

    from lyft3d_tpu_torch.ops import dense_fill

    ids = dense_fill._masked_ids(ids, valid, num_rows)
    if not assume_sorted:
        ids, order = torch.sort(ids, dim=-1, stable=True)
        feats = torch.gather(feats, -2, order[..., None].expand(feats.shape))
    b, v, c = feats.shape
    k_ms = queued_ms(lambda: dense_fill._fill_cuda(feats, ids, num_rows))
    # index_add_ into zeros with one dump row per sample (ids prepared).
    flat = (ids.long() + torch.arange(b, device=feats.device)[:, None] * (num_rows + 1)).reshape(-1)
    rows2d = feats.reshape(-1, c)
    l_ms = queued_ms(lambda: torch.zeros(b * (num_rows + 1), c, dtype=feats.dtype,
                                         device=feats.device).index_add_(0, flat, rows2d))
    return k_ms, l_ms


def fill_duplicates_check(dev):
    """Phase 6's duplicate ids: float32 sums of repeated ids on the card
    within :data:`FILL_DUP_REL` of their magnitudes against a float64 sum, at
    the pillars width (16-byte accesses) and at 5 channels (4-byte accesses,
    four run heads a thread loaded before its stores)."""
    import torch

    from lyft3d_tpu_torch.ops import dense_fill

    g = torch.Generator().manual_seed(4)
    for c in (FILL_C, 5):
        dup = torch.sort(torch.randint(0, 50000, (SEC_BATCH, FILL_V), generator=g), dim=-1).values
        feats = torch.randn(SEC_BATCH, FILL_V, c, generator=g)
        ones = torch.ones(SEC_BATCH, FILL_V, dtype=torch.bool)
        got = dense_fill.fill_rows_by_id(feats.to(dev), dup.int().to(dev), ones.to(dev), 50000,
                                         assume_sorted=True).cpu().double()
        ref = dense_fill.fill_rows_by_id_scatter(feats.double(), dup, ones, 50000)
        mag = dense_fill.fill_rows_by_id_scatter(feats.double().abs(), dup, ones, 50000)
        rel = float(((got - ref).abs() / mag.clamp_min(1e-30)).max())
        if not rel <= FILL_DUP_REL:
            raise AssertionError(f"fill kernel duplicate sums off by {rel} of their magnitudes (C={c})")
        log(f"fill: duplicates ({int((dup[:, 1:] == dup[:, :-1]).sum())} repeats) float32 C={c} "
            f"max_err/magnitude={rel:.3g} (tol {FILL_DUP_REL})")


def fill_replay(calls, card, what):
    """The recorded fill calls of one forward pass: kernel ``torch.equal`` to
    the plain version, both timed; the kernel launch queued beside
    ``index_add_``."""
    import torch

    from lyft3d_tpu_torch.ops import dense_fill

    for args, kwargs in calls:
        feats, ids, valid, num_rows = args
        got = dense_fill.fill_rows_by_id(feats, ids, valid, num_rows, **kwargs)
        torch.cuda.synchronize()
        want = dense_fill.fill_rows_by_id_scatter(feats, ids, valid, num_rows)
        if not torch.equal(got, want):
            raise AssertionError(f"fill kernel differs from the plain version at {tuple(feats.shape)} "
                                 f"-> {num_rows} rows ({what})")
        k_ms = cuda_ms(lambda: dense_fill.fill_rows_by_id(feats, ids, valid, num_rows, **kwargs),
                       warmup=2, iters=10)
        p_ms = cuda_ms(lambda: dense_fill.fill_rows_by_id_scatter(feats, ids, valid, num_rows),
                       warmup=2, iters=10)
        q_ms, l_ms = fill_queued(feats, ids, valid, num_rows, bool(kwargs.get("assume_sorted")))
        b, v, c = feats.shape
        b_ms, b_by, share = fill_bound(dense_fill._masked_ids(ids, valid, num_rows), num_rows, c,
                                       feats.element_size(), backward=False)
        log(f"fill ({what}): B={b} V={v} C={c} rows={num_rows} {str(feats.dtype)[6:]} "
            f"ids_below_rows={share:.4f} sorted_by_caller={bool(kwargs.get('assume_sorted'))} "
            f"torch.equal=True wrapper_ms={k_ms:.4f} queued_ms kernel={q_ms:.4f} index_add_={l_ms:.4f} "
            f"plain_ms={p_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) [{card}]")


def sparse_phases(dev, card):
    """Phases 11 to 14: the sparse SECOND paths at the FHD geometry. Returns
    the ``kernels`` records of the stencil and rank gather kernels and the
    fill kernel's launches in the main path."""
    import dataclasses

    import torch

    from lyft3d_tpu_torch.models.second import middle as middle_mod
    from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet, voxelnet_predict
    from lyft3d_tpu_torch.ops import column_sparse as cs
    from lyft3d_tpu_torch.ops import dense_fill
    from lyft3d_tpu_torch.ops import subm_conv_kernel as sk
    from lyft3d_tpu_torch.ops.sparse_conv import ActiveSet
    from lyft3d_tpu_torch.ops.voxelize import voxelize
    from lyft3d_tpu_torch.pipelines.second import make_second_infer_fn

    keys = ("voxels", "num_points", "coords", "voxel_valid")

    def active_of(cfg, vox):
        return ActiveSet(vox["coords"], vox["voxel_valid"], cfg.grid.grid_size)

    def same(a, b, what):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"sparse check: {what} on the card differs from the CPU's")

    # 11. float32 check, stage by stage on the CPU's inputs, TF32 off.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = fhd_config()
    grid_args = (cfg.grid, cfg.max_voxels, cfg.max_points_per_voxel)
    pts, pvalid = fhd_points(1, FHD_POINTS, seed=12)
    ref_net = VoxelNet(cfg, in_features=3, generator=torch.Generator().manual_seed(0)).eval()
    card_net = VoxelNet(cfg, in_features=3, device=dev,
                        generator=torch.Generator().manual_seed(0)).eval()
    errs = {}
    with torch.inference_mode():
        vox = voxelize(pts, pvalid, *grid_args)
        vox_card = voxelize(pts.to(dev), pvalid.to(dev), *grid_args)
        for k, v in vox.items():
            same(vox_card[k], v, f"voxelize {k}")
        feats = ref_net.encoder(*[vox[k] for k in keys[:3]])
        same(card_net.encoder(*[vox_card[k] for k in keys[:3]]), feats, "encoder output")
        cols, x = ref_net.middle.to_units(feats, active_of(cfg, vox))
        ccols, cx = card_net.middle.to_units(feats.to(dev), active_of(cfg, vox_card))
        same(ccols.col_ids, cols.col_ids, "unit ids")
        same(ccols.mask, cols.mask, "unit masks")
        same(cx, x, "unit features")
        units = [int(cols.valid.sum())]
        for i in range(len(cfg.middle_features)):
            nx_, ncols = ref_net.middle.stage(i, x, cols)
            cxn, ccols = card_net.middle.stage(i, x.to(dev), cols_to(cols, dev))
            same(ccols.col_ids, ncols.col_ids, f"stage {i} unit ids")
            same(ccols.mask, ncols.mask, f"stage {i} unit masks")
            errs[f"stage{i}"] = rel_diff(cxn.cpu(), nx_)
            x, cols = nx_, ncols
            units.append(int(cols.valid.sum()))
        bev = ref_net.middle.to_dense(x, cols)
        errs["bev"] = rel_diff(card_net.middle.to_dense(x.to(dev), cols_to(cols, dev)).cpu(), bev)
        ref_heads = ref_net.rpn(bev.permute(0, 3, 1, 2))
        card_heads = card_net.rpn(bev.to(dev).permute(0, 3, 1, 2))
        errs.update({k: rel_diff(card_heads[k].cpu(), h) for k, h in ref_heads.items()})
    if not max(errs.values()) <= 1e-3:
        raise AssertionError(f"float32 sparse VoxelNet card vs cpu: {errs} > 1e-3 of their scale")
    log(f"sparse check: VoxelNet FHD sparse_units f32 B=1 N={FHD_POINTS}, TF32 off, card vs cpu, "
        f"stage by stage: voxelize equal ({int(vox['voxel_valid'].sum())} voxels kept), unit ids, "
        f"masks and placed features equal, units per stage {units} "
        f"(caps {(cfg.max_voxels + cfg.max_voxels // 4,) + cfg.middle_max_voxels}), max_err/scale "
        + " ".join(f"{k}={v:.3g}" for k, v in errs.items()) + " (tol 1e-3)")
    del ref_net, card_net, vox, vox_card, x, cols, ccols, cx, cxn, bev, ref_heads, card_heads
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()

    def run_path(cfg, name, counts):
        """Drive ``make_second_infer_fn`` for ``cfg``; returns what the phase logs."""
        net = VoxelNet(cfg, in_features=3, dtype=torch.bfloat16, device=dev,
                       generator=torch.Generator().manual_seed(0))
        infer = make_second_infer_fn(net, cfg)
        pts, pvalid = (a.to(dev) for a in fhd_points(FHD_BATCH, FHD_POINTS, seed=13))
        torch.cuda.reset_peak_memory_stats()
        cs.KERNEL_LAUNCHES = sk.KERNEL_LAUNCHES = dense_fill.KERNEL_LAUNCHES = 0
        e2e_ms = cuda_ms(lambda: infer(pts, pvalid))
        det = infer(pts, pvalid)
        torch.cuda.synchronize()
        calls = 2 + TIMED_ITERS + 1
        launches = {"stencil_conv": cs.KERNEL_LAUNCHES, "subm_conv": sk.KERNEL_LAUNCHES,
                    "dense_fill": dense_fill.KERNEL_LAUNCHES}
        for kernel, n in counts.items():
            if launches[kernel] <= 0:
                raise AssertionError(f"the {name} path never launched the {kernel} kernel")
            if launches[kernel] != n * calls:
                raise AssertionError(f"{name}: {launches[kernel]} {kernel} launches in {calls} "
                                     f"calls, expected {n} a call")
        k = cfg.nms_post
        expect = {"boxes": (FHD_BATCH, k, 7), "scores": (FHD_BATCH, k), "classes": (FHD_BATCH, k),
                  "valid": (FHD_BATCH, k)}
        for key, shape in expect.items():
            if tuple(det[key].shape) != shape:
                raise AssertionError(f"{name} {key}: shape {tuple(det[key].shape)} != {shape}")
        if not bool(torch.isfinite(det["boxes"]).all()):
            raise AssertionError(f"{name}: boxes have non-finite values")
        if not bool(((det["scores"] >= 0) & (det["scores"] <= 1)).all()):
            raise AssertionError(f"{name}: scores outside [0, 1]")
        cls = det["classes"][det["valid"]]
        if not bool(((cls >= 1) & (cls <= len(LYFT9_ANCHORS))).all()):
            raise AssertionError(f"{name}: classes outside 1..9")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        return net, pts, pvalid, e2e_ms, det, launches, peak_gb

    # 12. main path: the unit middle, folded norms, bfloat16, batch 4.
    cfg = fhd_config(middle_norm="folded")
    per_call = {"stencil_conv": 9, "dense_fill": 2}
    net, pts, pvalid, e2e_ms, det, launches, peak_gb = run_path(cfg, "sparse", per_call)
    anchors, _, _, anchor_class = cfg.make_anchors(dev)
    mid = net.middle
    with torch.inference_mode():
        vox = voxelize(pts, pvalid, *grid_args)
        feats = net.encoder(*[vox[k] for k in keys[:3]])
        with recorded(cs, "stencil_conv_batched") as stencil_calls, \
                recorded(cs, "fill_rows_by_id") as fill_calls:
            states = [mid.to_units(feats, active_of(cfg, vox))[::-1]]
            for i in range(len(cfg.middle_features)):
                states.append(mid.stage(i, *states[-1]))
            bev = mid.to_dense(*states[-1]).permute(0, 3, 1, 2)
        preds = net.rpn(bev)
        preds = {"box": preds["box"].reshape(FHD_BATCH, -1, cfg.box_code_size),
                 "cls": preds["cls"].reshape(FHD_BATCH, -1, cfg.num_classes),
                 "dir": preds["dir"].reshape(FHD_BATCH, -1, 2)}
        occupied = int(voxelize(pts[:1], pvalid[:1], cfg.grid, 10 ** 6, 1)["voxel_valid"].sum())
        stage_ms = {
            "voxelize": cuda_ms(lambda: voxelize(pts, pvalid, *grid_args)),
            "units_from_voxels": cuda_ms(lambda: mid.to_units(feats, active_of(cfg, vox))),
        }
        for i in range(len(cfg.middle_features)):
            stage_ms[f"stage{i}"] = cuda_ms(lambda: mid.stage(i, *states[i]))
        stage_ms["dense"] = cuda_ms(lambda: mid.to_dense(*states[-1]))
        stage_ms["rpn"] = cuda_ms(lambda: net.rpn(bev))
        stage_ms["predict"] = cuda_ms(lambda: voxelnet_predict(preds, anchors, anchor_class, cfg))
        units = [int(c.valid[0].sum()) for _, c in states]
        active_cells = [int(c.mask[0].sum()) for _, c in states]
    caps = (cfg.max_voxels + cfg.max_voxels // 4,) + cfg.middle_max_voxels
    log(f"sparse e2e: VoxelNet FHD sparse_units folded bf16 B={FHD_BATCH} N={FHD_POINTS} "
        f"samples_per_s={FHD_BATCH / (e2e_ms / 1e3):.2f} e2e_ms={e2e_ms:.3f} stages_ms "
        + " ".join(f"{n}={v:.3f}" for n, v in stage_ms.items())
        + f" occupied_voxels_after_filter_sample0={occupied} kept={int(vox['voxel_valid'][0].sum())} "
        f"units_sample0={units} caps={caps} active_cells_sample0={active_cells} "
        f"detections={int(det['valid'].sum())} peak_mem_gb={peak_gb:.2f} "
        f"launches_per_call={per_call} [{card}]")
    with torch.inference_mode():
        stencil_record, _ = stencil_replay(stencil_calls.calls, card)
        fill_replay(fill_calls.calls, card, "sparse path")
    main_launches = launches
    del net, mid, states, bev, preds, vox, feats, det, stencil_calls, fill_calls
    torch.cuda.empty_cache()

    # 13. second path: the per-voxel middle, bfloat16, batch 4.
    cfg2 = fhd_config(middle="sparse")
    per_call2 = {"subm_conv": 6, "dense_fill": 1}
    net, pts, pvalid, e2e2_ms, det, launches2, peak2_gb = run_path(cfg2, "per-voxel", per_call2)
    mid = net.middle
    with torch.inference_mode():
        vox = voxelize(pts, pvalid, *grid_args)
        feats = net.encoder(*[vox[k] for k in keys[:3]])
        with recorded(middle_mod, "subm_conv") as subm_calls:
            states = [(feats, active_of(cfg2, vox))]
            for i in range(len(cfg2.middle_features)):
                states.append(mid.stage(i, *states[-1]))
        with recorded(middle_mod, "fill_rows_by_id") as fill_calls:
            bev = middle_mod.sparse_to_dense_bev(*states[-1]).permute(0, 3, 1, 2)
        stage2_ms = {}
        for i in range(len(cfg2.middle_features)):
            stage2_ms[f"stage{i}"] = cuda_ms(lambda: mid.stage(i, *states[i]))
        stage2_ms["dense"] = cuda_ms(lambda: middle_mod.sparse_to_dense_bev(*states[-1]))
        stage2_ms["rpn"] = cuda_ms(lambda: net.rpn(bev))
        voxels = [int(a.valid[0].sum()) for _, a in states]
    log(f"per-voxel e2e: VoxelNet FHD sparse (per-voxel middle) bf16 B={FHD_BATCH} N={FHD_POINTS} "
        f"samples_per_s={FHD_BATCH / (e2e2_ms / 1e3):.2f} e2e_ms={e2e2_ms:.3f} stages_ms "
        + " ".join(f"{n}={v:.3f}" for n, v in stage2_ms.items())
        + f" (voxelize and predict as in the sparse path) voxels_sample0={voxels} "
        f"caps={(cfg2.max_voxels,) + cfg2.middle_max_voxels} detections={int(det['valid'].sum())} "
        f"peak_mem_gb={peak2_gb:.2f} launches_per_call={per_call2} [{card}]")
    with torch.inference_mode():
        subm_record, _ = subm_replay(subm_calls.calls, card)
        fill_replay(fill_calls.calls, card, "per-voxel path")
    del net, mid, states, bev, vox, feats, det, subm_calls, fill_calls
    torch.cuda.empty_cache()

    # 14. both middles on a cloud that no cap truncates, float32, TF32 off.
    torch.backends.cudnn.allow_tf32 = False
    open_grid = fhd_config().grid._replace(block_filtering=False)
    cfg_u = fhd_config(grid=open_grid, middle_max_voxels=CROSS_CAPS)
    cfg_v = fhd_config(grid=open_grid, middle_max_voxels=CROSS_CAPS, middle="sparse")
    grid_args = (cfg_u.grid, cfg_u.max_voxels, cfg_u.max_points_per_voxel)
    net_u = VoxelNet(cfg_u, in_features=3, device=dev, generator=torch.Generator().manual_seed(1)).eval()
    net_v = VoxelNet(cfg_v, in_features=3, device=dev, generator=torch.Generator().manual_seed(2)).eval()
    net_v.load_state_dict(net_u.state_dict())
    pts, pvalid = (a.to(dev) for a in fhd_points(2, CROSS_POINTS, seed=14))
    with torch.inference_mode():
        vox = voxelize(pts, pvalid, *grid_args)
        feats = net_u.encoder(*[vox[k] for k in keys[:3]])
        cols, x = net_u.middle.to_units(feats, active_of(cfg_u, vox))
        counts = [int(vox["voxel_valid"].sum(-1).max()), int(cols.valid.sum(-1).max())]
        for i, max_out in enumerate(cfg_u.middle_max_voxels):
            if 4 * int(cols.valid.sum(-1).max()) > max(2 * max_out, 3 * cols.col_ids.shape[-1]):
                raise AssertionError("cross-check: the parent list of a strided layer may overflow")
            x, cols = net_u.middle.stage(i, x, cols)
            counts.append(int(cols.valid.sum(-1).max()))
        limits = (cfg_u.max_voxels, cfg_u.max_voxels + cfg_u.max_voxels // 4) + cfg_u.middle_max_voxels
        if not all(c < cap for c, cap in zip(counts, limits)):
            raise AssertionError(f"cross-check: a cap truncates: {counts} against {limits}")
        bev_u = net_u.middle.to_dense(x, cols)
        bev_v, active = net_v.middle(feats, active_of(cfg_v, vox))
        if not int(active.valid.sum(-1).max()) < cfg_v.middle_max_voxels[-1]:
            raise AssertionError("cross-check: the per-voxel middle's last cap truncates")
    err = rel_diff(bev_u, bev_v)
    if not err <= 1e-3:
        raise AssertionError(f"cross-check: the two middles' dense BEV differ by {err} of their scale")
    log(f"cross-check: f32 B=2 N={CROSS_POINTS}, TF32 off, same weights, no cap truncates (voxels, units and "
        f"stage outputs {counts} under {limits}): unit middle vs per-voxel middle dense BEV "
        f"{tuple(bev_u.shape)} max_err/scale={err:.3g} (tol 1e-3), "
        f"{int((bev_u != 0).any(-1).sum())} occupied BEV cells")
    torch.backends.cudnn.allow_tf32 = True
    del net_u, net_v
    torch.cuda.empty_cache()
    return stencil_record, subm_record, main_launches, launches2


def raster_edge_points(batch, seed):
    """Points exactly on the x, y and z bin edges of the 336 x 336 x 3 grid
    and one float32 step to either side, some invalid."""
    k = np.arange(0, 337, dtype=np.float64)
    xs = (k * 0.4 - 67.2).astype(np.float32)
    zs = (np.arange(0, 4) * 1.5 - 2.0).astype(np.float32)
    xs = np.concatenate([xs, np.nextafter(xs, -np.inf), np.nextafter(xs, np.inf)])
    zs = np.concatenate([zs, np.nextafter(zs, -np.inf), np.nextafter(zs, np.inf)])
    rng = np.random.RandomState(seed)
    pts = np.stack([np.stack([rng.permutation(xs), rng.permutation(xs), rng.choice(zs, xs.size)], -1)
                    for _ in range(batch)]).astype(np.float32)
    return pts, rng.rand(batch, xs.size) >= 0.05


def raster_phase(dev, card):
    """Phase 3: the raster kernel against the plain version on the card: at
    every batch of :data:`RASTER_BATCHES` on the uniform sweep and a
    LiDAR-like one, and at 8 samples of a 1024x1024x3 grid, the rule's
    chunk, one launch for the whole batch and, from 8 samples, two chunks:
    the rule's evidence. Then the unbatched
    call, (N, 4) rows, bin-edge points, an odd grid and a large one, each in
    chunks of 1 and 2 samples too, and a call under PyTorch's sync debug
    mode. Returns
    the batch-32 record of the rule's launch for the ``kernels`` line, with
    its time on the LiDAR-like sweep beside the uniform one."""
    import torch

    from lyft3d_tpu_torch.ops import bev_raster as br

    vox, z_off = br.DEFAULT_VOXEL_SIZE, br.DEFAULT_Z_OFFSET

    def check(got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"raster {what}: the kernel differs from the plain version in "
                                 f"{int((got != want).sum())} cells")

    def run(pts, valid, shape, chunk):
        return br._bev_rasterize_cuda(pts, valid, shape, vox, z_off, chunk=chunk)

    record, lidar_ms = {}, None
    for cloud in ("uniform", "lidar"):
        # The flagship's grid at every batch, and a grid the points barely reach.
        for b, shape in [(b, SHAPE) for b in RASTER_BATCHES] + [(8, (1024, 1024, 3))]:
            pts, valid = sweep_points(b, N_POINTS, seed=b) if cloud == "uniform" \
                else lidar_cloud(b, N_POINTS, seed=30 + b)
            pts, valid = pts.to(dev), valid.to(dev)
            want = br.bev_rasterize_scatter(pts, valid, shape)
            check(br.bev_rasterize(pts, valid, shape), want, f"B={b} {shape} {cloud}, the rule's chunk")
            rule = br._raster_chunk(b, N_POINTS, shape)
            times = {}
            for chunk in sorted({rule, b} | ({-(-b // 2)} if b >= 8 else set()), reverse=True):
                check(run(pts, valid, shape, chunk), want, f"B={b} {shape} {cloud} in chunks of {chunk}")
                times[chunk] = (cuda_ms(lambda: run(pts, valid, shape, chunk), warmup=3, iters=20),
                                queued_ms(lambda: run(pts, valid, shape, chunk)))
            log(f"raster rule evidence: B={b} N={N_POINTS} grid={shape} {cloud} cloud rule_chunk={rule} "
                f"torch.equal=True ms (queued) by chunk "
                + " ".join(f"{k}={v[0]:.4f} ({v[1]:.4f})" for k, v in times.items()) + f" [{card}]")
            if shape != SHAPE:
                del pts, valid, want
                continue
            if b == BATCH and cloud == "lidar":
                lidar_ms = cuda_ms(lambda: br.bev_rasterize(pts, valid, SHAPE), warmup=3, iters=20)
            if cloud == "uniform" and b == BATCH:
                k_ms = cuda_ms(lambda: br.bev_rasterize(pts, valid, SHAPE), warmup=3, iters=20)
                p_ms = cuda_ms(lambda: br.bev_rasterize_scatter(pts, valid, SHAPE), warmup=3, iters=20)
                # The one library call that counts the same cells: bincount of
                # the flat voxel index (computed beforehand; dropped points in
                # a dump cell).
                row, col, ch, inb = br.voxel_indices(pts, SHAPE, vox, z_off)
                ncell = SHAPE[0] * SHAPE[1] * SHAPE[2]
                flat = torch.arange(b, device=dev)[:, None] * ncell + (row.long() * SHAPE[1] + col) * SHAPE[2] + ch
                flat = torch.where(inb & valid, flat, b * ncell).reshape(-1)
                counted = torch.bincount(flat, minlength=b * ncell + 1)[:-1].reshape(b, *SHAPE)
                if not torch.equal(counted.float(), want):
                    raise AssertionError(f"bincount differs from the plain raster at B={b}")
                l_ms = cuda_ms(lambda: torch.bincount(flat, minlength=b * ncell + 1), warmup=3, iters=20)
                # Points and mask read once, the grid written once; ~10 operations a point.
                b_ms, b_by = bound(b * N_POINTS * 13 + b * ncell * 4, b * N_POINTS * 10)
                record = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                              library_ms=l_ms)
                log(f"raster: B={b} N={N_POINTS} grid={SHAPE} rule_chunk={rule} "
                    f"torch.equal=True counted={int(want.sum())} kernel_ms={k_ms:.4f} "
                    f"plain_ms={p_ms:.4f} bincount_ms={l_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) [{card}]")
                without_host_sync("bev_rasterize", lambda: br.bev_rasterize(pts, valid, SHAPE))
                del row, col, ch, inb, flat, counted
            del pts, valid, want
    record["lidar_ms"] = lidar_ms
    log(f"raster: B={BATCH} LiDAR-like sweep kernel_ms={lidar_ms:.4f} (uniform {record['ms']:.4f}) [{card}]")

    # The unbatched call, (N, 4) rows, bin edges, an odd grid and a large
    # one, through the rule and in chunks of 1 and 2 samples.
    pts, valid = (a.to(dev) for a in sweep_points(2, N_POINTS, seed=40))
    wide = torch.cat([pts, torch.full_like(pts[..., :1], 9.0)], -1).contiguous()
    epts, evalid = (torch.from_numpy(a).to(dev) for a in raster_edge_points(2, seed=41))
    cases = [("unbatched", pts[0].contiguous(), valid[0].contiguous(), SHAPE),
             ("(N, 4) rows", wide, valid, SHAPE),
             ("bin edges", epts, evalid, SHAPE),
             ("337x333x3", pts, valid, (337, 333, 3)),
             ("1024x1024x3", pts, valid, (1024, 1024, 3))]
    for what, p, v, shape in cases:
        want = br.bev_rasterize_scatter(p, v, shape)
        check(br.bev_rasterize(p, v, shape), want, f"{what}, the rule's chunk")
        for chunk in (1, 2):
            check(run(p, v, shape, chunk), want, f"{what} in chunks of {chunk}")
    log("raster edges: torch.equal=True on " + ", ".join(c[0] for c in cases)
        + f", each by the rule and in chunks of 1 and 2 [{card}]")
    return record


def select_kernels_phase(dev, card):
    """Phase 8: the four PointNet++ kernels against their plain versions on
    the card at the largest shapes of the PointRCNN path. Returns one record
    per kernel for the ``kernels`` line (``launches`` filled in later)."""
    import torch

    from lyft3d_tpu_torch.ops import pointnet2 as p2

    def same(got, want, what):
        if not torch.equal(got, want):
            diff = int((got != want).sum())
            raise AssertionError(f"{what}: kernel differs from the plain version in {diff} places")

    records = {}
    pts, valid = (a.to(dev) for a in rcnn_cloud(PRC_BATCH, PRC_POINTS, seed=7))
    n_valid = int(valid[0].sum())

    # B5 furthest-point sampling: RPN stage 0, and the RCNN's RoI clouds.
    npoint = PRC_POINTS // 4
    sel = p2.fps(pts, valid, npoint)
    same(sel, p2.furthest_point_sample(pts, valid, npoint), "fps 16384->4096")
    k_ms = cuda_ms(lambda: p2.fps(pts, valid, npoint), warmup=1, iters=5)
    p_ms = cuda_ms(lambda: p2.furthest_point_sample(pts, valid, npoint), warmup=0, iters=1)
    rpts, rvalid = (a.to(dev) for a in roi_clouds(PRC_BATCH * PRC_ROIS, PRC_ROI_POINTS, seed=8))
    rsel = p2.fps(rpts, rvalid, 128)
    same(rsel, p2.furthest_point_sample(rpts, rvalid, 128), "fps 400 x 512->128")
    small_ms = cuda_ms(lambda: p2.fps(rpts, rvalid, 128), warmup=1, iters=5)
    small_plain_ms = cuda_ms(lambda: p2.furthest_point_sample(rpts, rvalid, 128), warmup=0, iters=1)
    # 3 subtractions, 3 products, 2 sums, a min and a compare per point and step.
    b_ms, b_by = bound(PRC_BATCH * (PRC_POINTS * 13 + npoint * 4),
                       PRC_BATCH * (npoint - 1) * PRC_POINTS * 10)
    records["fps"] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    # The one-block kernel at the same shape, for the record of what the cluster gains.
    one_block = (1, *p2._fps_launch_shape(p2.FPS_SMS, PRC_POINTS)[1:])
    ob = torch.empty_like(sel)

    def fps_one_block():
        err = p2._fps_library()(p2._ptr(pts), p2._ptr(valid), p2._ptr(ob), PRC_BATCH, PRC_POINTS, npoint,
                                *one_block, 0 if dev.index is None else dev.index, p2._stream(pts))
        p2._raise_on(err, "fps (one block a cloud)")

    fps_one_block()
    same(ob, sel, "fps one block a cloud 16384->4096")
    ob_ms = cuda_ms(fps_one_block, warmup=1, iters=5)
    log(f"fps: B={PRC_BATCH} {PRC_POINTS}->{npoint} ({n_valid} valid) launch shape (CTAs, threads, slots) "
        f"{p2._fps_launch_shape(PRC_BATCH, PRC_POINTS)} torch.equal=True kernel_ms={k_ms:.4f} "
        f"({k_ms * 1e3 / (npoint - 1):.3f} us a step; one block a cloud {one_block}: {ob_ms:.4f} ms, "
        f"{ob_ms * 1e3 / (npoint - 1):.3f} us a step) plain_ms={p_ms:.3f} bound_ms={b_ms:.4f} ({b_by}) | "
        f"B={PRC_BATCH * PRC_ROIS} {PRC_ROI_POINTS}->128 {p2._fps_launch_shape(PRC_BATCH * PRC_ROIS, PRC_ROI_POINTS)} "
        f"torch.equal=True kernel_ms={small_ms:.4f} plain_ms={small_plain_ms:.3f} [{card}]")
    # The rule's evidence: one block a cloud against clusters of 8 and 16 CTAs
    # at the four cloud sizes of the SA levels (npoint = N / 4).
    rule = []
    for n in (PRC_POINTS, PRC_POINTS // 2, PRC_POINTS // 4, PRC_POINTS // 16):
        p_, v_ = pts[:, :n].contiguous(), valid[:, :n].contiguous()
        k = n // 4
        want = p2.furthest_point_sample(p_, v_, k)
        shapes = [(1, *p2._fps_launch_shape(p2.FPS_SMS, n)[1:])]
        for ctas in (8, 16):
            slots = 1
            while ctas * p2.FPS_CLUSTER_THREADS * slots < n:
                slots *= 2
            shapes.append((ctas, p2.FPS_CLUSTER_THREADS, slots))
        parts = []
        for shape in shapes:
            got = torch.empty_like(want)

            def run(shape=shape, got=got):
                err = p2._fps_library()(p2._ptr(p_), p2._ptr(v_), p2._ptr(got), PRC_BATCH, n, k, *shape,
                                        0 if dev.index is None else dev.index, p2._stream(p_))
                p2._raise_on(err, f"fps {shape}")

            run()
            same(got, want, f"fps {n}->{k} at {shape}")
            parts.append(f"{shape[0]} CTA(s) {cuda_ms(run, warmup=1, iters=3) * 1e3 / (k - 1):.3f}")
        rule.append(f"N={n}: " + ", ".join(parts) + f" (rule: {p2._fps_launch_shape(PRC_BATCH, n)[0]})")
    log(f"fps rule, B={PRC_BATCH}, us a step, each torch.equal to the plain version: {'; '.join(rule)} [{card}]")
    for i, (what, b, n, k) in enumerate(FPS_EDGES):
        ep, ev = (a.to(dev) for a in fps_edge_cloud(what, b, n, seed=20 + i))
        same(p2.fps(ep, ev, k), p2.furthest_point_sample(ep, ev, k), f"fps edge: {what}")
    ctas, _, slots = p2._fps_launch_shape(40, PRC_POINTS)
    log(f"fps edges: {'; '.join(f'{w} (B={b} {n}->{k}, {p2._fps_launch_shape(b, n)})' for w, b, n, k in FPS_EDGES)}: "
        f"all torch.equal to the plain version; the card keeps "
        f"{p2.fps_max_active_clusters(ctas, slots, dev)} clusters of {ctas} CTAs resident at once [{card}]")

    # B6 ball query: stage 0 (no radius fills: full scans), the same cloud at
    # the stage-3 radii (most rows fill and stop early), and the RoI clouds.
    centers = p2.group_points(pts, sel[:, :, None])[:, :, 0].contiguous()
    centers[:, -1] = 500.0  # an empty row
    cvalid = torch.gather(valid, 1, sel.long())

    def ball_case(c, p, v, radii, ks, what):
        want = p2.multi_radius_ball_query_dense(c, p, v, radii, ks)
        n = p.shape[1]
        scanned = torch.zeros(c.shape[:2], dtype=torch.int64, device=dev)
        # The rule's pick through the public wrapper, and both kernels.
        for kernel, got in (("wrapper", p2.multi_radius_ball_query(c, p, v, radii, ks)),
                            ("scan", p2._ball_scan_cuda(c, p, v, radii, ks)),
                            ("grid", p2._ball_grid_cuda(c, p, v, radii, ks))):
            for (g_idx, g_cnt), (w_idx, w_cnt) in zip(got, want):
                same(g_idx, w_idx, f"ball query {what} indices ({kernel})")
                same(g_cnt, w_cnt, f"ball query {what} counts ({kernel})")
        for (w_idx, w_cnt), k in zip(want, ks):
            # A row that fills stops after its k-th hit; the others read the whole cloud.
            scanned = torch.maximum(scanned, torch.where(w_cnt >= k, w_idx[..., -1].long() + 1, n))
        full = sum(int((cnt >= k).sum()) for (_, cnt), k in zip(want, ks))
        return int(scanned.sum()), full

    radii0, ks0 = (0.1, 0.5), (16, 32)
    pairs0, full0 = ball_case(centers, pts, valid, radii0, ks0, "stage 0")
    without_host_sync("ball query (cell grid)", lambda: p2._ball_grid_cuda(centers, pts, valid, radii0, ks0))
    without_host_sync("ball query (scan)", lambda: p2._ball_scan_cuda(centers, pts, valid, radii0, ks0))
    if int(p2.multi_radius_ball_query(centers, pts, valid, radii0, ks0)[1][1][:, -1].max()) != 0:
        raise AssertionError("ball query: the far-away centre found neighbours")
    pairs3, full3 = ball_case(centers, pts, valid, (2.0, 4.0), ks0, "radii (2, 4)")
    if full3 == 0:
        raise AssertionError("ball query: no row filled at radii (2, 4)")
    rc = p2.group_points(rpts, rsel[:, :, None])[:, :, 0].contiguous()
    ball_case(rc, rpts, rvalid, (0.2,), (64,), "400 x 128 x 512")
    ball_case(rc, rpts, rvalid, (1.5,), (64,), "400 x 128 x 512 radius 1.5")
    ball_edge_checks(dev, card)
    s = centers.shape[1]
    rule0 = p2._ball_query_kernel(PRC_BATCH, s, PRC_POINTS, max(radii0))
    k_ms = cuda_ms(lambda: p2.multi_radius_ball_query(centers, pts, valid, radii0, ks0),
                   warmup=2, iters=20)
    scan_ms = cuda_ms(lambda: p2._ball_scan_cuda(centers, pts, valid, radii0, ks0), warmup=2, iters=20)
    table_ms, select_ms = ball_grid_parts(centers, pts, valid, radii0, ks0)
    p_ms = cuda_ms(lambda: p2.multi_radius_ball_query_dense(centers, pts, valid, radii0, ks0),
                   warmup=1, iters=3)
    early_ms = cuda_ms(lambda: p2.multi_radius_ball_query(centers, pts, valid, (2.0, 4.0), ks0),
                       warmup=2, iters=20)
    small_ms = cuda_ms(lambda: p2.multi_radius_ball_query(rc, rpts, rvalid, (0.2,), (64,)),
                       warmup=2, iters=20)
    io = PRC_BATCH * (PRC_POINTS * 13 + s * 12 + s * (sum(ks0) + len(ks0)) * 4)
    # The grid's work: a distance and its compares (10 operations) for each
    # (centre, valid point) pair inside the largest radius. The scan's: 3
    # subtractions, 3 products, 2 sums and one compare per radius for each
    # scanned pair.
    inside0 = inside_pairs(centers, pts, valid, max(p2._squared_radii(radii0)))
    b_ms, b_by = bound(io, inside0 * 10)
    scan_b_ms, scan_b_by = bound(io, pairs0 * (8 + len(ks0)))
    records["ball_query"] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                 bound_by=b_by)
    log(f"ball: B={PRC_BATCH} S={s} N={PRC_POINTS} radii={radii0} k={ks0} torch.equal=True "
        f"(wrapper, scan and grid) rule={rule0} kernel_ms={k_ms:.4f} (grid: table {table_ms:.4f} + "
        f"selection {select_ms:.4f}; scan {scan_ms:.4f}) plain_ms={p_ms:.3f} bound_ms={b_ms:.5f} "
        f"({b_by}; {inside0} pairs inside the largest radius) scan_bound_ms={scan_b_ms:.4f} ({scan_b_by}; "
        f"scanned_pairs={pairs0}) filled_rows={full0} | radii=(2.0, 4.0) scanned_pairs={pairs3} "
        f"filled_rows={full3} kernel_ms={early_ms:.4f} | B={PRC_BATCH * PRC_ROIS} S=128 N=512 "
        f"r=0.2 k=64 rule={p2._ball_query_kernel(PRC_BATCH * PRC_ROIS, 128, 512, 0.2)} "
        f"kernel_ms={small_ms:.4f} [{card}]")

    # B7 three nearest neighbours: FP stage 0 (16,384 unknown, 4,096 known),
    # with one duplicated known point and the far-away one.
    known = centers.clone()
    known[:, 1] = known[:, 0]
    kvalid = cvalid.clone()
    kvalid[:, 1] = kvalid[:, 0]
    g_d, g_idx = p2.three_nn(pts, known, kvalid)
    w_d, w_idx = p2.three_nn_dense(pts, known, kvalid)
    same(g_idx, w_idx, "three_nn indices")
    knn_err = float((g_d - w_d).abs().max())
    if not knn_err <= 1e-6 * max(1.0, float(w_d.abs().max())):
        raise AssertionError(f"three_nn distances differ by {knn_err}")
    few = torch.zeros_like(kvalid)
    few[:, 5] = True
    f_d, f_idx = p2.three_nn(pts[:, :1024], known, few)
    w_d, w_idx = p2.three_nn_dense(pts[:, :1024], known, few)
    same(f_idx, w_idx, "three_nn with one valid known point")
    if not torch.equal(f_d, w_d):
        raise AssertionError("three_nn miss distances differ")
    del w_d, w_idx
    knn_edge_checks(dev, card)
    without_host_sync("three_nn", lambda: p2.three_nn(pts, known, kvalid))
    k_ms = cuda_ms(lambda: p2.three_nn(pts, known, kvalid), warmup=2, iters=20)
    p_ms = cuda_ms(lambda: p2.three_nn_dense(pts, known, kvalid), warmup=1, iters=3)
    pairs = PRC_POINTS * int(kvalid.sum())
    b_ms, b_by = bound(PRC_BATCH * (PRC_POINTS * 12 + s * 13 + PRC_POINTS * 24), pairs * 9)
    records["knn"] = dict(max_abs_err=knn_err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by)
    log(f"knn: B={PRC_BATCH} S={PRC_POINTS} M={s} (Q, P)={p2._knn_launch_shape(PRC_BATCH * PRC_POINTS, s)} "
        f"indices torch.equal=True dist_max_abs_err={knn_err:.3g} (tol 1e-6 of scale) pairs={pairs} "
        f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.3f} bound_ms={b_ms:.4f} ({b_by}) [{card}]")

    # B8 RoI select: 100 boxes a sample, k 512, extra width 1.0.
    boxes = roi_boxes(pts.cpu(), PRC_ROIS, seed=9).to(dev)
    g_idx, g_cnt = p2.roi_inside_select(pts, valid, boxes, PRC_ROI_POINTS, 1.0)
    w_idx, w_cnt = p2.roi_inside_select_dense(pts, valid, boxes, PRC_ROI_POINTS, 1.0)
    same(g_idx, w_idx, "roi select indices")
    same(g_cnt, w_cnt, "roi select counts")
    if int(w_cnt[:, -1].max()) != 0 or int(w_cnt[:, -2].min()) != PRC_ROI_POINTS:
        raise AssertionError("roi select: the empty box or the full box is not as built")
    scanned = int(torch.where(w_cnt >= PRC_ROI_POINTS, w_idx[..., -1].long() + 1, PRC_POINTS).sum())
    del w_idx
    roi_edge_checks(dev, card)
    without_host_sync("roi_inside_select", lambda: p2.roi_inside_select(pts, valid, boxes, PRC_ROI_POINTS, 1.0))
    k_ms = cuda_ms(lambda: p2.roi_inside_select(pts, valid, boxes, PRC_ROI_POINTS, 1.0),
                   warmup=2, iters=20)
    p_ms = cuda_ms(lambda: p2.roi_inside_select_dense(pts, valid, boxes, PRC_ROI_POINTS, 1.0),
                   warmup=1, iters=3)
    io = PRC_BATCH * (PRC_POINTS * 13 + PRC_ROIS * (32 + (PRC_ROI_POINTS + 1) * 4))
    # 3 subtractions, 4 products, 2 sums, 3 absolute values and 3 compares per
    # pair a serial scan in index order tests (up to the k-th hit).
    b_ms, b_by = bound(io, scanned * 15)
    records["roi_select"] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                 bound_by=b_by)
    log(f"roi: B={PRC_BATCH} R={PRC_ROIS} N={PRC_POINTS} k={PRC_ROI_POINTS} extra=1.0 "
        f"shape={p2._roi_launch_shape(PRC_BATCH * PRC_ROIS)} "
        f"torch.equal=True mean_count={float(w_cnt.float().mean()):.1f} scanned_pairs={scanned} "
        f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.3f} bound_ms={b_ms:.4f} ({b_by}) [{card}]")
    # The launch shapes at the PointRCNN call's boxes, on the uniform and a
    # LiDAR-like cloud, and at the RCNN training shape (512 boxes a sample).
    lpts, lvalid = (a.to(dev) for a in lidar_cloud(PRC_BATCH, PRC_POINTS, seed=13))
    lboxes = roi_boxes(lpts.cpu(), PRC_ROIS, seed=14).to(dev)
    wide = roi_boxes(pts.cpu(), 512, seed=15).to(dev)
    for what, (c_pts, c_valid, c_boxes) in (("uniform", (pts, valid, boxes)),
                                            ("LiDAR-like", (lpts, lvalid, lboxes)),
                                            ("uniform, 512 boxes a sample", (pts, valid, wide))):
        roi_shapes_line(what, c_pts, c_valid, c_boxes, PRC_ROI_POINTS, 1.0, card)
    del lpts, lvalid, lboxes, wide
    return records


def roi_edge_cloud(n, seed, far_from=None):
    """Two clouds of ``n`` points uniform in ±10 x ±10 x ±2 m, 5% invalid;
    with ``far_from`` (T threads), cloud 0 is all 1 km away but for the
    points that make box 0's k-th hit (k = 100) the last point of the first
    segment of 32 T points, and cloud 1's that make it the last point."""
    import torch

    g = torch.Generator().manual_seed(seed)
    pts = (torch.rand(2, n, 3, generator=g) * 2 - 1) * torch.tensor([10.0, 10.0, 2.0])
    valid = torch.rand(2, n, generator=g) >= 0.05
    if far_from is not None:
        seg = 32 * far_from
        pts[..., 0] += 1000.0
        valid[:] = True
        for b, last in ((0, seg - 1), (1, n - 1)):
            pick = torch.randperm(last, generator=g)[:99]
            inside = torch.cat([pick, torch.tensor([last])])
            if b == 0:  # hits after the k-th too
                inside = torch.cat([inside, seg + torch.randperm(n - seg, generator=g)[:50]])
            pts[b, inside] = (torch.rand(len(inside), 3, generator=g) - 0.5) * 0.5
    return pts.contiguous(), valid


def roi_edge_boxes(pts, r, seed):
    """``r`` boxes a cloud: a 2 m box at the origin, car-sized ones on points
    of the cloud, a 30 m one and an empty one."""
    import torch

    boxes = roi_boxes(pts, r, seed)
    boxes[:, 0] = torch.tensor([0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.3])
    boxes[:, -2, 3:5] = 30.0
    return boxes


def roi_edge_checks(dev, card):
    """B8 at the shapes a segment walk gets wrong first, at every launch
    shape of :data:`ROI_SHAPES` and through the rule: N no multiple of 32 or
    of a segment, k = 1, k > N, the k-th hit the last point of a segment and
    of the cloud, a cloud without a valid point, R no multiple of G."""
    import torch

    from lyft3d_tpu_torch.ops import pointnet2 as p2

    cases = []
    for what, n, r, k, seed in (("N=1000 R=7 k=64", 1000, 7, 64, 50),
                                ("N=8193 R=9 k=512", 8193, 9, 512, 51),
                                ("k=1", 5000, 6, 1, 52), ("k>N", 300, 5, 512, 53),
                                ("no valid point", 2000, 6, 32, 54)):
        pts, valid = roi_edge_cloud(n, seed)
        if what == "no valid point":
            valid[:] = False
        cases.append((what, pts, valid, roi_edge_boxes(pts, r, seed), k))
    for threads in sorted({t for _, t in p2.ROI_SHAPES}):
        n = 32 * threads + 997
        pts, valid = roi_edge_cloud(n, 55 + threads, far_from=threads)
        cases.append((f"k-th hit at the end of a {32 * threads}-point segment and of N={n}",
                      pts, valid, roi_edge_boxes(pts, 3, 56), 100))
    checks = 0
    for what, pts, valid, boxes, k in cases:
        pts, valid, boxes = pts.to(dev), valid.to(dev), boxes.to(dev)
        params = p2._box_params(boxes, 0.5)
        want = p2.roi_inside_select_dense(pts, valid, boxes, k, 0.5)
        if "end of" in what and int(want[1][0, 0]) != k:
            raise AssertionError(f"roi edge {what}: box 0 holds {int(want[1][0, 0])} points, not {k}")
        for shape in (None, *p2.ROI_SHAPES):
            got = (p2.roi_inside_select(pts, valid, boxes, k, 0.5) if shape is None
                   else p2._roi_select_cuda(params, pts, valid, k, shape))
            for g, w, part in zip(got, want, ("indices", "counts")):
                if not torch.equal(g, w):
                    raise AssertionError(f"roi edge {what} shape {shape}: {part} differ from the plain "
                                         f"version in {int((g != w).sum())} places")
            checks += 1
    log(f"roi edges: {len(cases)} cases x (rule + {len(p2.ROI_SHAPES)} launch shapes) = {checks} "
        f"launches torch.equal=True ({'; '.join(c[0] for c in cases)}) [{card}]")


def roi_shapes_line(what, pts, valid, boxes, k, extra, card):
    """B8 at every launch shape of :data:`ROI_SHAPES` on one input: each
    ``torch.equal`` to the plain version, timed alone and queued (the rule's
    evidence, one line)."""
    import torch

    from lyft3d_tpu_torch.ops import pointnet2 as p2

    params = p2._box_params(boxes, extra)
    want = p2._roi_inside_select_dense(params, pts, valid, k)
    times = {}
    for shape in p2.ROI_SHAPES:
        got = p2._roi_select_cuda(params, pts, valid, k, shape)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"roi select {what} at (G, T) = {shape} differs from the plain version")
        times[shape] = (cuda_ms(lambda: p2._roi_select_cuda(params, pts, valid, k, shape), warmup=2, iters=20),
                        queued_ms(lambda: p2._roi_select_cuda(params, pts, valid, k, shape)))
    b, r = boxes.shape[:2]
    log(f"roi rule evidence: {what} B={b} R={r} N={pts.shape[1]} k={k} "
        f"rule={p2._roi_launch_shape(b * r)} full_boxes={int((want[1] >= k).sum())} "
        f"torch.equal=True ms (queued) (G, T): "
        + " ".join(f"{g}x{t}={v[0]:.4f} ({v[1]:.4f})" for (g, t), v in times.items()) + f" [{card}]")


def roi_replay(calls, card):
    """The RoI-select launch of one PointRCNN call, replayed: ``torch.equal``
    to the plain version and timed, alone and queued."""
    import torch

    from lyft3d_tpu_torch.ops import pointnet2 as p2

    for args, kwargs in calls:
        pts, valid, boxes, k, extra = args
        got = p2.roi_inside_select(*args, **kwargs)
        want = p2.roi_inside_select_dense(*args, **kwargs)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError("roi select replay of the PointRCNN call differs from the plain version")
        k_ms = cuda_ms(lambda: p2.roi_inside_select(*args, **kwargs), warmup=2, iters=20)
        q_ms = queued_ms(lambda: p2.roi_inside_select(*args, **kwargs))
        log(f"roi replay: the PointRCNN call's proposals B={boxes.shape[0]} R={boxes.shape[1]} "
            f"N={pts.shape[1]} k={k} extra={extra} shape={p2._roi_launch_shape(boxes.numel() // 7)} "
            f"torch.equal=True mean_count={float(want[1].float().mean()):.1f} "
            f"kernel_ms={k_ms:.4f} queued_ms={q_ms:.4f} [{card}]")


def fps_replay(calls, card):
    """Phase 10: the six FPS launches of one PointRCNN call, recorded, kernel
    ``torch.equal`` to the plain version and timed. Returns their total ms."""
    import torch

    from lyft3d_tpu_torch.ops import pointnet2 as p2

    assert len(calls) == 6, len(calls)
    parts, total = [], 0.0
    for args, _ in calls:
        pts, valid, npoint = args
        if not torch.equal(p2.fps(pts, valid, npoint), p2.furthest_point_sample(pts, valid, npoint)):
            raise AssertionError(f"fps kernel differs from the plain version at {tuple(pts.shape)} -> {npoint}")
        ms = cuda_ms(lambda: p2.fps(pts, valid, npoint), warmup=1, iters=5)
        total += ms
        b, n = pts.shape[:2]
        parts.append(f"B={b} {n}->{npoint} {p2._fps_launch_shape(b, n)} {ms:.4f} ms "
                     f"({ms * 1e3 / max(1, npoint - 1):.3f} us a step)")
    log(f"fps: six launches of one PointRCNN call, each torch.equal to the plain version: {'; '.join(parts)}; "
        f"total kernel_ms={total:.3f} [{card}]")
    return total


def ball_grid_parts(c, p, v, radii, ks):
    """Milliseconds of the grid route's two parts at one shape, as the
    wrapper runs them: the cell table (``_ball_grid_table``: the keys kernel
    and the stable sort) and the selection (``_ball_grid_select``: the bucket
    starts and the merge) on a table built once. The keys kernel is also held
    to its plain version (``torch.equal``)."""
    import torch

    from lyft3d_tpu_torch.ops import pointnet2 as p2

    table = p2._ball_grid_table(p, v, radii)
    inv, buckets = table[2], table[3]
    if not torch.equal(p2._ball_cell_keys_cuda(p, v, inv, buckets), p2.ball_cell_keys(p, v, inv, buckets)):
        raise AssertionError("ball query: the cell keys kernel differs from its plain version")
    table_ms = cuda_ms(lambda: p2._ball_grid_table(p, v, radii), warmup=2, iters=20)
    return table_ms, cuda_ms(lambda: p2._ball_grid_select(c, p, table, radii, ks), warmup=2, iters=20)


def inside_pairs(c, p, v, r2):
    """(centre, valid point) pairs with d2 < r2, counted in chunks of centres."""
    from lyft3d_tpu_torch.ops import pointnet2 as p2

    total = 0
    for i in range(0, c.shape[1], 512):
        total += int(((p2._sq_dist(c[:, i: i + 512], p) < r2) & v[:, None, :]).sum())
    return total


def ball_replay(calls, card, cloud):
    """Phase 10: the six ball-query launches of one PointRCNN call on
    ``cloud``, recorded and replayed on both kernels, each ``torch.equal`` to
    the plain version and timed (CUDA events, device time, host µs a call),
    with the rows in which every radius fills (where the scan stops early):
    the rule's evidence on one line. Returns the rule's and the scan's total
    ms a call."""
    import torch

    from lyft3d_tpu_torch.ops import pointnet2 as p2

    assert len(calls) == 6, len(calls)
    parts, total, scan_total = [], 0.0, 0.0
    for args, _ in calls:
        c, p, v, radii, ks = args
        want = p2.multi_radius_ball_query_dense(c, p, v, radii, ks)
        ms = {}
        for kernel, fn in (("scan", p2._ball_scan_cuda), ("grid", p2._ball_grid_cuda)):
            for (g_idx, g_cnt), (w_idx, w_cnt) in zip(fn(c, p, v, radii, ks), want):
                if not (torch.equal(g_idx, w_idx) and torch.equal(g_cnt, w_cnt)):
                    raise AssertionError(f"ball query ({kernel}) differs from the plain version at "
                                         f"{tuple(c.shape)} x {tuple(p.shape)} r={radii} ({cloud})")
            ms[kernel] = cuda_ms(lambda: fn(c, p, v, radii, ks), warmup=2, iters=20)
            ms[kernel + " queued"] = queued_ms(lambda: fn(c, p, v, radii, ks))
            ms[kernel + " host"] = host_us(lambda: fn(c, p, v, radii, ks))
        b, n, _ = p.shape
        rule = p2._ball_query_kernel(b, c.shape[1], n, max(radii))
        total += ms[rule]
        scan_total += ms["scan"]
        full = torch.stack([cnt >= k for (_, cnt), k in zip(want, ks)]).all(0)
        inside = inside_pairs(c, p, v, max(p2._squared_radii(radii)))
        parts.append(f"B={b} S={c.shape[1]} N={n} r={tuple(radii)} k={tuple(ks)} pairs={b * c.shape[1] * n} "
                     f"inside={inside} full_rows={int(full.sum())}/{full.numel()}: "
                     + ", ".join(f"{k} {ms[k]:.4f} (queued {ms[k + ' queued']:.4f}, host {ms[k + ' host']:.1f} us)"
                                 for k in ("scan", "grid"))
                     + f" ms (rule: {rule})")
    log(f"ball rule evidence, {cloud}, the six launches of one PointRCNN call, both kernels torch.equal "
        f"to the plain version: {'; '.join(parts)}; total kernel_ms={total:.4f} (scan alone "
        f"{scan_total:.4f}) [{card}]")
    return total, scan_total


def knn_replay(calls, card):
    """Phase 10: the four 3-NN launches of one PointRCNN call, recorded and
    replayed at every split (Q, P): indices ``torch.equal`` and distances
    within 1e-6 of scale of the plain version, each timed: the rule's evidence
    on one line. Returns the rule's total ms a call."""
    import torch

    from lyft3d_tpu_torch.ops import pointnet2 as p2

    assert len(calls) == 4, len(calls)
    parts, total = [], 0.0
    for args, _ in calls:
        u, k, kv = args
        w_d, w_idx = p2.three_nn_dense(u, k, kv)
        times, dev_times = {}, {}
        for shape in p2.KNN_SHAPES:
            g_d, g_idx = p2._three_nn_cuda(u, k, kv, shape)
            err = float((g_d - w_d).abs().max())
            if not torch.equal(g_idx, w_idx) or not err <= 1e-6 * max(1.0, float(w_d.abs().max())):
                raise AssertionError(f"three_nn at {shape} differs from the plain version at "
                                     f"{tuple(u.shape)} <- {tuple(k.shape)}")
            times[shape] = cuda_ms(lambda: p2._three_nn_cuda(u, k, kv, shape), warmup=2, iters=20)
            dev_times[shape] = queued_ms(lambda: p2._three_nn_cuda(u, k, kv, shape))
        rule = p2._knn_launch_shape(u.shape[0] * u.shape[1], k.shape[1])
        rule_host = host_us(lambda: p2._three_nn_cuda(u, k, kv, rule))
        b, s, _ = u.shape
        total += times[rule]
        best = min(dev_times, key=dev_times.get)
        parts.append(f"B={b} S={s} M={k.shape[1]}: "
                     + ", ".join(f"{q}x{p_} {t:.4f} ({dev_times[q, p_]:.4f})" for (q, p_), t in times.items())
                     + f" (rule {rule[0]}x{rule[1]}, host {rule_host:.1f} us a call; least queued time "
                     f"{best[0]}x{best[1]})")
    log(f"knn rule evidence, ms (queued ms) of the four launches of one PointRCNN call at (Q queries a "
        f"thread) x (P threads a query), each torch.equal to the plain version: {'; '.join(parts)}; "
        f"total kernel_ms={total:.4f} [{card}]")
    return total

def gt_batch(batch, seed):
    """``GT_SLOTS`` padded GT boxes a sample, the first ``GT_VALID`` valid, of
    mixed classes with their class's anchor size (±10%), inside the range."""
    import torch

    rng = np.random.RandomState(seed)
    boxes = np.zeros((batch, GT_SLOTS, 7), np.float32)
    classes = np.zeros((batch, GT_SLOTS), np.int32)
    for b in range(batch):
        for i in range(GT_VALID):
            c = rng.randint(1, len(LYFT9_ANCHORS) + 1)
            size, z, _, _ = LYFT9_ANCHORS[c - 1]
            boxes[b, i] = (*rng.uniform(-45.0, 45.0, 2), z + rng.uniform(-0.2, 0.2),
                           *(np.array(size) * rng.uniform(0.9, 1.1, 3)), rng.uniform(-math.pi, math.pi))
            classes[b, i] = c
    valid = np.broadcast_to(np.arange(GT_SLOTS) < GT_VALID, (batch, GT_SLOTS)).copy()
    return {"gt_boxes": torch.from_numpy(boxes), "gt_classes": torch.from_numpy(classes),
            "gt_valid": torch.from_numpy(valid)}


def bench_gt(batch):
    """Four identical car boxes a sample, all valid (the JAX bench's sparse
    train step)."""
    import torch

    box = torch.tensor([5.0, 5.0, -1.0, 2.0, 4.5, 1.6, 0.3])
    return {"gt_boxes": box.expand(batch, 4, 7).contiguous(),
            "gt_classes": torch.ones(batch, 4, dtype=torch.int32),
            "gt_valid": torch.ones(batch, 4, dtype=torch.bool)}


def clustered_points(batch, n, clusters, seed):
    """``n`` points in ``clusters`` blobs (0.25 m spread in x and y, z in
    [-2.5, 0.5] m) with centres uniform in ±45 m: a few thousand units, which
    stay under every cap of the FHD config through the strided stages."""
    import torch

    g = torch.Generator().manual_seed(seed)
    centres = (torch.rand(batch, clusters, 2, generator=g) * 2 - 1) * 45.0
    which = torch.randint(0, clusters, (batch, n), generator=g)
    xy = torch.gather(centres, 1, which[..., None].expand(batch, n, 2))
    xy = xy + torch.randn(batch, n, 2, generator=g) * 0.25
    z = torch.rand(batch, n, 1, generator=g) * 3.0 - 2.5
    return torch.cat([xy, z], dim=-1), torch.ones(batch, n, dtype=torch.bool)


def to_dev(batch, dev):
    return {k: v.to(dev) for k, v in batch.items()}


TRAIN_COUNTERS = ("dense_fill", "dense_fill_bwd", "stencil_conv", "stencil_dgrad", "stencil_wgrad",
                  "subm_conv", "subm_dgrad", "subm_wgrad")


def train_counts(reset=False):
    """The eight launch counts of the training path; ``reset`` zeroes them."""
    from lyft3d_tpu_torch.ops import column_sparse as cs
    from lyft3d_tpu_torch.ops import dense_fill as df
    from lyft3d_tpu_torch.ops import subm_conv_kernel as sk

    if reset:
        df.KERNEL_LAUNCHES = df.BWD_KERNEL_LAUNCHES = 0
        cs.KERNEL_LAUNCHES = cs.DGRAD_KERNEL_LAUNCHES = cs.WGRAD_KERNEL_LAUNCHES = 0
        sk.KERNEL_LAUNCHES = sk.DGRAD_KERNEL_LAUNCHES = sk.WGRAD_KERNEL_LAUNCHES = 0
    return dict(zip(TRAIN_COUNTERS, (
        df.KERNEL_LAUNCHES, df.BWD_KERNEL_LAUNCHES, cs.KERNEL_LAUNCHES, cs.DGRAD_KERNEL_LAUNCHES,
        cs.WGRAD_KERNEL_LAUNCHES, sk.KERNEL_LAUNCHES, sk.DGRAD_KERNEL_LAUNCHES, sk.WGRAD_KERNEL_LAUNCHES)))


def fill_bwd_shape(grad, ids, rows, card, what):
    """One shape of the fill's backward (phases 15 and 18): every kernel that
    takes its rows ``torch.equal`` to the plain gather and timed queued
    (:func:`queued_ms`), beside ``torch.index_select``; the rule's kernel also
    on the host's clock and in host µs a call. Returns the shape's numbers,
    the rule's kernel queued as ``ms``."""
    import torch

    from lyft3d_tpu_torch.ops import dense_fill

    b, v = ids.shape
    c = grad.shape[-1]
    want = dense_fill.fill_rows_by_id_bwd_ref(grad, ids, rows)
    rule = dense_fill._fill_bwd_kernel(c, grad.dtype)
    kernels = dense_fill.FILL_BWD_KERNELS if rule != "lanes" else ("lanes",)
    queued = {}
    for kernel in kernels:
        got = dense_fill._fill_bwd_cuda(grad, ids, rows, kernel=kernel)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fill backward kernel {kernel} differs from the plain version at "
                                 f"{(b, v, c)} <- {rows} rows {grad.dtype} ({what})")
        queued[kernel] = queued_ms(lambda: dense_fill._fill_bwd_cuda(grad, ids, rows, kernel=kernel))
    host_ms = cuda_ms(lambda: dense_fill._fill_bwd_cuda(grad, ids, rows), warmup=3, iters=20)
    call_us = host_us(lambda: dense_fill._fill_bwd_cuda(grad, ids, rows))
    p_ms = cuda_ms(lambda: dense_fill.fill_rows_by_id_bwd_ref(grad, ids, rows), warmup=2, iters=10)
    # The one library call that gathers the same rows: index_select from the
    # cotangent with one zero row appended per sample (prepared).
    padded = torch.cat([grad, grad.new_zeros(b, 1, c)], dim=1).reshape(-1, c)
    flat = (ids.long().clamp(0, rows) + torch.arange(b, device=grad.device)[:, None] * (rows + 1)).reshape(-1)
    if not torch.equal(torch.index_select(padded, 0, flat).view(b, v, c), want):
        raise AssertionError("index_select differs from the plain fill backward")
    l_ms = queued_ms(lambda: torch.index_select(padded, 0, flat))
    del padded, flat
    b_ms, b_by, share = fill_bound(ids, rows, c, grad.element_size(), backward=True)
    log(f"fill backward ({what}): B={b} V={v} C={c} rows={rows} {str(grad.dtype)[6:]} "
        f"ids_below_rows={share:.4f} rule={rule} "
        f"torch.equal=True queued_ms " + " ".join(f"{k}={t:.4f}" for k, t in queued.items())
        + f" index_select={l_ms:.4f} | {rule}: host_clock_ms={host_ms:.4f} host_us={call_us:.1f} | "
        f"plain_ms={p_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) [{card}]")
    return dict(max_abs_err=0.0, ms=queued[rule], plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=l_ms)


def fill_bwd_ids(b, v, rows, g):
    """(b, v) int32 row ids: ascending unique canvas rows, the last 10% the
    sentinel ``rows`` (a masked tail)."""
    import torch

    ids = torch.stack([torch.sort(torch.randperm(rows, generator=g)[:v]).values for _ in range(b)])
    ids[:, v - v // 10:] = rows
    return ids.int()


# (what, B, V, C, rows, dtype) of the fill backward's edge checks: what a gather
# in tiles of 32 rows gets wrong first. Row ids are drawn in ``fill_backward_phase``.
FILL_BWD_EDGES = (
    ("V no multiple of a warp", 3, 1001, 64, 20000, "bfloat16"),
    ("V under a warp", 2, 20, 64, 1000, "bfloat16"),
    ("an all-sentinel sample", 3, 700, 64, 5000, "bfloat16"),
    ("duplicate ids", 2, 4000, 64, 300, "bfloat16"),
    ("float32 rows of 256 B", 2, 3000, 64, 20000, "float32"),
    ("rows of 16 B", 2, 3000, 8, 20000, "bfloat16"),
    ("rows of 16 B", 2, 3001, 4, 20000, "float32"),
    ("rows of 48 B", 2, 999, 24, 4000, "bfloat16"),
    ("one row", 1, 1, 64, 10, "bfloat16"),
)


def fill_backward_phase(dev, card):
    """Phase 15. Returns the ``kernels`` record of the fill's backward kernel
    (``launches`` filled in later)."""
    import torch

    from lyft3d_tpu_torch.ops import dense_fill

    g = torch.Generator().manual_seed(21)
    cases = [(SEC_BATCH, FILL_V, FILL_C, FILL_ROWS, torch.bfloat16),
             (SEC_BATCH, FILL_V, FILL_C, FILL_ROWS, torch.float32),
             (FHD_BATCH, 60000, 4, 600000, torch.bfloat16),
             (FHD_BATCH, 60000, 5, 600000, torch.float32)]
    records = []
    for b, v, c, rows, dtype in cases:
        ids = fill_bwd_ids(b, v, rows, g).to(dev)
        grad = torch.randn(b, rows, c, generator=g).to(dtype).to(dev)
        records.append(fill_bwd_shape(grad, ids, rows, card, "phase 15"))
        if bool(dense_fill._fill_bwd_cuda(grad, ids, rows)[:, v - v // 10:].any()):
            raise AssertionError("fill backward: a masked row received a gradient")
    # Edge shapes, every kernel that takes the rows.
    for what, b, v, c, rows, dtype in FILL_BWD_EDGES:
        dtype = getattr(torch, dtype)
        if what == "duplicate ids":
            ids = torch.randint(0, rows + 1, (b, v), generator=g).int()
        else:
            ids = fill_bwd_ids(b, v, rows, g)
        if what == "an all-sentinel sample":
            ids[1] = rows
        ids = ids.to(dev)
        grad = torch.randn(b, rows, c, generator=g).to(dtype).to(dev)
        want = dense_fill.fill_rows_by_id_bwd_ref(grad, ids, rows)
        rule = dense_fill._fill_bwd_kernel(c, dtype)
        kernels = dense_fill.FILL_BWD_KERNELS if rule != "lanes" else ("lanes",)
        for kernel in kernels:
            got = dense_fill._fill_bwd_cuda(grad, ids, rows, kernel=kernel)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"fill backward kernel {kernel} differs from the plain version: "
                                     f"{what} {(b, v, c)} <- {rows} rows {dtype}")
        log(f"fill backward edge: {what} B={b} V={v} C={c} rows={rows} {str(dtype)[6:]} rule={rule} "
            f"torch.equal=True ({', '.join(kernels)})")
    # Unsorted ids with repeats through the public function: the Function on
    # the card against autograd of the plain scatter.
    ids = torch.randint(0, 50000, (SEC_BATCH, FILL_V), generator=g).to(dev)
    valid = (torch.rand(SEC_BATCH, FILL_V, generator=g) < 0.9).to(dev)
    cot = torch.randn(SEC_BATCH, 50000, FILL_C, generator=g).to(dev)
    feats = torch.randn(SEC_BATCH, FILL_V, FILL_C, generator=g).to(dev)
    f1, f2 = feats.clone().requires_grad_(True), feats.clone().requires_grad_(True)
    before = dense_fill.BWD_KERNEL_LAUNCHES
    dense_fill.fill_rows_by_id(f1, ids, valid, 50000).backward(cot)
    dense_fill.fill_rows_by_id_scatter(f2, ids, valid, 50000).backward(cot)
    if dense_fill.BWD_KERNEL_LAUNCHES != before + 1:
        raise AssertionError("fill backward: the gradient on the card did not launch the kernel")
    if not torch.equal(f1.grad, f2.grad):
        raise AssertionError("fill backward: unsorted duplicate ids differ from autograd of the scatter")
    repeats = int((torch.sort(ids, -1).values.diff(dim=-1) == 0).sum())
    log(f"fill backward: unsorted ids with {repeats} repeats, 10% invalid, float32, through "
        f"fill_rows_by_id: torch.equal to autograd of the plain scatter")
    return records[0]  # the pillars shape in bfloat16


def grad_check(name, cfg, in_features, batch, dev, caps_check=None):
    """Phase 16 for one model, in float32, card against CPU, in two parts.

    Whole model: one ``loss.backward()`` on each device. The loss agrees to
    1e-5; the gradients cannot agree element by element at this size, because
    cuDNN and the CPU's convolutions round differently (about 1e-5 of scale in
    the RPN's activations) and a few dozen of its millions of ReLU inputs
    change sign, each moving a bias gradient by a fraction of a percent (seen:
    1.4e-2 for pillars, 5.5e-2 for the FHD models, the same for both middles).
    They are held to ``GRAD_NORM_TOL`` in the 2-norm of each parameter's
    gradient, finite and not all zero.

    Kernel path: the CPU's cotangent of the dense BEV map is pushed back
    through the encoder, the middle and the fill, where the hand-written
    backward kernels run, on both devices from the same inputs: every
    parameter gradient there within ``GRAD_PATH_TOL`` of its scale (floored at
    1e-4 of the largest). Sign changes remain inside the middle's own
    LayerNorm + ReLU layers (seen: 1.1e-6 per-voxel, 7.9e-4 pillars, 8.8e-3
    unit middle at batch 1); the strict gate on the kernels is the replay
    phase, kernel against plain backward on one device and the same values.
    Returns what the phase logs."""
    import torch

    from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet
    from lyft3d_tpu_torch.ops.voxelize import voxelize
    from lyft3d_tpu_torch.pipelines.second_train import make_second_loss_fn

    def grads_of(net):
        return {k: p.grad.detach().cpu() for k, p in net.named_parameters() if p.grad is not None}

    whole, path, bev_cot = [], [], None
    for device, b in ((torch.device("cpu"), batch), (dev, to_dev(batch, dev))):
        net = VoxelNet(cfg, in_features=in_features, device=device,
                       generator=torch.Generator().manual_seed(0)).train()
        if caps_check is not None and device.type == "cpu":
            caps_check(net, b)
        seen = []

        def keep_bev(module, inputs):
            inputs[0].retain_grad()
            seen.append(inputs[0])

        hook = net.rpn.register_forward_pre_hook(keep_bev)
        loss, metrics = make_second_loss_fn(cfg, device)(net, b)
        loss.backward()
        hook.remove()
        whole.append((float(loss.detach()), float(metrics["num_pos"]), grads_of(net)))
        if bev_cot is None:
            bev_cot = seen[0].grad.detach().clone()  # the CPU's, for both devices
        del loss, seen
        net.zero_grad(set_to_none=True)
        with torch.no_grad():
            vox = voxelize(b["points"], b["points_valid"], cfg.grid, cfg.max_voxels, cfg.max_points_per_voxel)
        feats = net.encoder(vox["voxels"], vox["num_points"], vox["coords"])
        net.dense_bev(feats, vox["coords"], vox["voxel_valid"]).backward(bev_cot.to(device))
        path.append(grads_of(net))
        del net, vox, feats
    (l_cpu, pos, g_cpu), (l_card, _, g_card) = whole
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    if not loss_err <= 1e-5:
        raise AssertionError(f"{name} gradient check: loss {l_card} on the card, {l_cpu} on the CPU")
    norm_worst, max_worst = (0.0, ""), (0.0, "")
    for k, want in g_cpu.items():
        got = g_card[k]
        scale = float(want.abs().max())
        if not (bool(torch.isfinite(got).all()) and scale > 0 and float(got.abs().max()) > 0):
            raise AssertionError(f"{name} gradient check: gradient of {k} is all zero or not finite")
        norm_worst = max(norm_worst, (float((got - want).norm() / want.norm()), k))
        max_worst = max(max_worst, (float((got - want).abs().max()) / scale, k))
    if not norm_worst[0] <= GRAD_NORM_TOL:
        raise AssertionError(f"{name} gradient check: gradient of {norm_worst[1]} differs by "
                             f"{norm_worst[0]} in the 2-norm")
    p_cpu, p_card = path
    if not p_cpu or set(p_cpu) != set(p_card):
        raise AssertionError(f"{name} gradient check: the kernel path has no parameter gradients")
    top = max(float(v.abs().max()) for v in p_cpu.values())
    path_worst = (0.0, "")
    for k, want in p_cpu.items():
        scale = float(want.abs().max())
        if not (bool(torch.isfinite(p_card[k]).all()) and scale > 0):
            raise AssertionError(f"{name} gradient check: kernel-path gradient of {k} is zero or not finite")
        path_worst = max(path_worst, (float((p_card[k] - want).abs().max()) / max(scale, 1e-4 * top), k))
    if not path_worst[0] <= GRAD_PATH_TOL:
        raise AssertionError(f"{name} gradient check: kernel-path gradient of {path_worst[1]} differs by "
                             f"{path_worst[0]} of its scale")
    return (f"{name}: loss {l_card:.6f} vs {l_cpu:.6f} (rel {loss_err:.2g}, tol 1e-5), positives "
            f"{pos:.0f}; whole model, {len(g_cpu)} parameter gradients finite and non-zero, worst "
            f"2-norm error {norm_worst[0]:.3g} at {norm_worst[1]} (tol {GRAD_NORM_TOL}; worst max_err/scale "
            f"{max_worst[0]:.3g} at {max_worst[1]}: ReLU sign changes under cuDNN's rounding); kernel "
            f"path (the CPU's BEV cotangent through encoder, middle and fill), {len(p_cpu)} parameter "
            f"gradients, worst max_err/scale={path_worst[0]:.3g} at {path_worst[1]} (tol {GRAD_PATH_TOL})")


def gradient_check_phase(dev, card):
    """Phase 16."""
    import torch

    from lyft3d_tpu_torch.ops.sparse_conv import ActiveSet
    from lyft3d_tpu_torch.ops.voxelize import voxelize

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pts, pvalid = pillar_points(1, SEC_POINTS, seed=22)
    batch = {"points": pts, "points_valid": pvalid, **gt_batch(1, seed=23)}
    log("gradient check (f32, TF32 off, card vs cpu, B=1): "
        + grad_check(f"pillars lyft9 N={SEC_POINTS}", lyft9_config(), 4, batch, dev))

    pts, pvalid = clustered_points(1, GRAD_POINTS, GRAD_CLUSTERS, seed=24)
    gts = gt_batch(1, seed=25)
    # Half of the boxes sit on a cluster, so that positives see features.
    centres = pts[0, :: GRAD_POINTS // (GT_VALID // 2)][: GT_VALID // 2, :2]
    gts["gt_boxes"][0, : GT_VALID // 2, :2] = centres
    batch = {"points": pts, "points_valid": pvalid, **gts}
    seen = {}

    def no_cap_fills(net, b):
        cfg = net.config
        with torch.no_grad():
            vox = voxelize(b["points"], b["points_valid"], cfg.grid, cfg.max_voxels, 1)
            active = ActiveSet(vox["coords"], vox["voxel_valid"], cfg.grid.grid_size)
            feats = net.encoder(vox["voxels"], vox["num_points"], vox["coords"])
            counts = [int(vox["voxel_valid"].sum())]
            if cfg.middle == "sparse_units":
                cols, x = net.middle.to_units(feats, active)
                counts.append(int(cols.valid.sum()))
                limits = (cfg.max_voxels, cfg.max_voxels + cfg.max_voxels // 4) + cfg.middle_max_voxels
                for i in range(len(cfg.middle_features)):
                    x, cols = net.middle.stage(i, x, cols)
                    counts.append(int(cols.valid.sum()))
            else:
                limits = (cfg.max_voxels,) + cfg.middle_max_voxels
                x = feats
                for i in range(len(cfg.middle_features)):
                    x, active = net.middle.stage(i, x, active)
                    counts.append(int(active.valid.sum()))
        if not all(0 < c < cap for c, cap in zip(counts, limits)):
            raise AssertionError(f"gradient check: a cap fills or a stage is empty: {counts} against {limits}")
        seen[cfg.middle] = (counts, limits)

    for middle in ("sparse_units", "sparse"):
        line = grad_check(f"FHD {middle} N={GRAD_POINTS} in {GRAD_CLUSTERS} clusters",
                          fhd_config(middle=middle), 3, batch, dev, caps_check=no_cap_fills)
        counts, limits = seen[middle]
        log(f"gradient check (f32, TF32 off, card vs cpu, B=1): {line}; no cap fills: "
            f"{counts} under {limits}")
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()


def train_run(name, cfg, in_features, batch, optimizer_fn, optimizer_name, dev, card, expect_kernels):
    """Phase 17 for one configuration: 2 warm-up + 10 timed steps of the
    ``Trainer``'s step function on a fixed batch. Returns (launch counts of
    the timed steps, step ms, the trained state, its trainer)."""
    import tempfile

    import torch

    from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet, voxelnet_loss
    from lyft3d_tpu_torch.ops.voxelize import voxelize
    from lyft3d_tpu_torch.pipelines.second_train import make_second_loss_fn, make_second_targets_fn
    from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig, TrainState

    net = VoxelNet(cfg, in_features=in_features, dtype=torch.bfloat16, device=dev,
                   generator=torch.Generator().manual_seed(0))
    bsz = batch["points"].shape[0]
    tmp = tempfile.TemporaryDirectory()
    trainer = Trainer(net, optimizer_fn, make_second_loss_fn(cfg, dev),
                      TrainerConfig(model_dir=tmp.name, total_steps=10 ** 6))
    state = TrainState(net, optimizer_fn)
    masters = sum(1 for p, m in zip(state.params, state.masters) if m is not p)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, metrics = trainer.step_fn(state, batch)
        losses.append(metrics["loss"])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    train_counts(reset=True)
    start.record()
    for _ in range(TRAIN_STEPS):
        state, metrics = trainer.step_fn(state, batch)
        losses.append(metrics["loss"])
    end.record()
    torch.cuda.synchronize()
    counts = train_counts()
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(l) for l in losses]
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"{name}: a training loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall on the fixed batch: {losses}")
    for kernel in expect_kernels:
        if counts[kernel] <= 0:
            raise AssertionError(f"the {name} training path never launched the {kernel} kernel")
        if counts[kernel] % TRAIN_STEPS:
            raise AssertionError(f"{name}: {counts[kernel]} {kernel} launches in {TRAIN_STEPS} steps")
    stray = {k: n for k, n in counts.items() if n and k not in expect_kernels}
    if stray:
        raise AssertionError(f"{name}: launches of kernels not on this path: {stray}")

    # Stage split: the same step with CUDA events between its stages (it goes
    # on training), and the voxelizer alone.
    targets_fn = make_second_targets_fn(cfg, dev)
    keys = ("voxels", "num_points", "coords", "voxel_valid")
    names = ("voxelize+targets", "forward", "loss", "backward", "optimizer")
    sums = dict.fromkeys(names, 0.0)
    net.train()
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        vox, tgts = targets_fn(batch)
        ev[1].record()
        preds = net(*[vox[k] for k in keys])
        ev[2].record()
        loss, _ = voxelnet_loss(preds, tgts, cfg)
        ev[3].record()
        for p in state.params:
            p.grad = None
        loss.backward()
        ev[4].record()
        state.push_grads()
        state.optimizer.step()
        state.pull_params()
        ev[5].record()
        torch.cuda.synchronize()
        for i, stage in enumerate(names):
            sums[stage] += ev[i].elapsed_time(ev[i + 1]) / 5
    vox_ms = cuda_ms(lambda: voxelize(batch["points"], batch["points_valid"], cfg.grid,
                                      cfg.max_voxels, cfg.max_points_per_voxel), iters=5)
    stages = {"voxelize": vox_ms, "targets": max(0.0, sums["voxelize+targets"] - vox_ms),
              **{k: sums[k] for k in names[1:]}}
    per_step = {k: n // TRAIN_STEPS for k, n in counts.items() if n}
    log(f"train {name}: VoxelNet bf16 (f32 heads, {masters} f32 master parameters of "
        f"{len(state.params)}) B={bsz} N={batch['points'].shape[1]} GT={batch['gt_boxes'].shape[1]} "
        f"{optimizer_name} step_ms={step_ms:.3f} samples_per_s={bsz / (step_ms / 1e3):.2f} stages_ms "
        + " ".join(f"{k}={v:.3f}" for k, v in stages.items())
        + f" loss step0={losses[0]:.4f} step{len(losses) - 1}={losses[-1]:.4f} "
        f"(all {len(losses)} finite) peak_mem_gb={peak_gb:.2f} launches_per_step={per_step} [{card}]")
    tmp.cleanup()
    del vox, tgts, preds, loss
    return counts, step_ms, state, trainer


def retained_grad_ms(out, wrt, cot):
    """Milliseconds of autograd's backward from ``out`` to ``wrt`` alone (the
    graph is kept, the forward is not repeated)."""
    import torch

    return cuda_ms(lambda: torch.autograd.grad(out, wrt, cot, retain_graph=True), warmup=1, iters=3)


def stencil_backward_replay(fwd_calls, wgrad_calls, card, cloud="uniform cloud"):
    """Phase 18 for the stencil: the nine recorded forward calls with the
    cotangents of the backward pass (recorded in reverse order). Returns the
    ``kernels`` records of ``d_src`` and ``d_wc`` (slowest launch, largest
    float32 error) and the sums over a step."""
    import torch

    from lyft3d_tpu_torch.ops import column_sparse as cs

    assert len(fwd_calls) == len(wgrad_calls) == len(FHD_STENCIL_LAYERS), (len(fwd_calls), len(wgrad_calls))
    rows = {"dgrad": [], "wgrad": []}
    worst = {"dgrad": 0.0, "wgrad": 0.0}
    for (args, kwargs), (wargs, _), (cin, cout, z_out, strided) in zip(
            fwd_calls, reversed(wgrad_calls), FHD_STENCIL_LAYERS):
        src, qids, src_ids, wc, nc = args
        rq, rids = kwargs["rev_qids"].contiguous(), kwargs["rev_src_ids"]
        cot = wargs[3]
        b, vs, _ = src.shape
        vq, (kzp, n) = qids.shape[-1], wc.shape[1:]
        assert tuple(cot.shape) == (b, vq, nc * n) and cot.dtype == torch.float32
        s32 = src.detach().float().requires_grad_(True)
        w32 = wc.detach().float().requires_grad_(True)
        out = cs.stencil_conv_ref(s32, qids, src_ids, w32, nc)
        want_s, want_w = torch.autograd.grad(out, (s32, w32), cot, retain_graph=True)
        rows_read = int((want_s.detach().abs().sum(-1) > 0).sum())  # source rows some query read
        errs = {}
        for dtype in (src.dtype, torch.float32):
            s_, w_ = src.detach().to(dtype), wc.detach().to(dtype)
            got_s = cs._stencil_conv_cuda(cot.to(dtype), rq, rids, w_.transpose(1, 2).contiguous(), nc,
                                          dgrad=True, out_dtype=dtype)
            got_w = cs._stencil_wgrad_cuda(s_, qids, src_ids, cot, nc, kzp, n)
            torch.cuda.synchronize()
            tol_s = 1e-5 if dtype == torch.float32 else 2.0 ** -7
            errs[dtype] = (rel_diff(got_s, want_s), rel_diff(got_w, want_w))
            if dtype == torch.float32:
                worst["dgrad"] = max(worst["dgrad"], float((got_s - want_s).abs().max()))
                worst["wgrad"] = max(worst["wgrad"], float((got_w - want_w).abs().max()))
            if not (errs[dtype][0] <= tol_s and errs[dtype][1] <= WGRAD_TOL):
                raise AssertionError(f"stencil backward {vs}->{vq} {kzp}x{n} {dtype}: d_src, d_wc differ "
                                     f"from the plain backward by {errs[dtype]} of their scale")
            del got_s, got_w
        s_, w_t = src.detach(), wc.detach().to(src.dtype).transpose(1, 2).contiguous()
        g_rows = cot.to(src.dtype)
        d_ms = cuda_ms(lambda: cs._stencil_conv_cuda(g_rows, rq, rids, w_t, nc, dgrad=True,
                                                     out_dtype=src.dtype), warmup=1, iters=5)
        w_ms = cuda_ms(lambda: cs._stencil_wgrad_cuda(s_, qids, src_ids, cot, nc, kzp, n), warmup=1, iters=5)
        zero_rows = int((cot.abs().amax(-1) == 0).sum())
        pd_ms = retained_grad_ms(out, (s32,), cot)
        pw_ms = retained_grad_ms(out, (w32,), cot)
        size = src.element_size()
        pos = cs.stencil_positions_ref(qids, src_ids).long().reshape(b, -1)
        pairs = int((pos >= 0).sum())
        # The library yardstick of d_wc: the rows gathered beforehand, then one
        # cuBLAS contraction (torch.einsum) in the source's type, which rounds
        # the float32 cotangent once (the kernel keeps 16 bits of it).
        s_flat, cot_w = src.detach(), cot.to(src.dtype)

        def gather_rows():
            picked = torch.gather(s_flat, 1, pos.clamp(min=0)[..., None].expand(-1, -1, s_flat.shape[-1]))
            return (picked * (pos >= 0)[..., None].to(picked.dtype)).view(b, 9, vq, nc, kzp)

        def contract(picked):
            return torch.einsum("bjvck,bvcn->jkn", picked, cot_w.view(b, vq, nc, n))

        picked = gather_rows()
        lib_err = rel_diff(contract(picked), want_w)
        if not lib_err <= 2.0 ** -6:
            raise AssertionError(f"gather + einsum differs from the plain weight gradient by {lib_err}")
        le_ms = cuda_ms(lambda: contract(picked), warmup=1, iters=3)
        del picked
        lg_ms = cuda_ms(lambda: contract(gather_rows()), warmup=1, iters=3)
        del pos
        ops = pairs * 2 * 3 * z_out * cin * cout
        peak = BF16_PEAK if src.dtype == torch.bfloat16 else F32_PEAK
        ids_bytes = (b * 9 * vq + b * 9 * vs + b * vs + b * vq) * 4
        d_b = bound((b * vq * n + 9 * kzp * n) * size + ids_bytes + b * vs * kzp * size, ops, peak)
        w_b = bound(b * vs * kzp * size + b * vq * n * 4 + ids_bytes + 9 * kzp * n * 4, ops, peak)
        rows["dgrad"].append(dict(ms=d_ms, plain_ms=pd_ms, bound_ms=d_b[0], bound_by=d_b[1]))
        rows["wgrad"].append(dict(ms=w_ms, plain_ms=pw_ms, bound_ms=w_b[0], bound_by=w_b[1],
                                  library_ms=lg_ms, einsum_ms=le_ms))
        log(f"stencil backward ({cloud}): B={b} Vs={vs} Vq={vq} kzp={kzp} N={n} ({cin}->{cout}) {str(src.dtype)[6:]} "
            f"hit_pairs={pairs} rows_read={rows_read} zero_cotangent_rows={zero_rows} of {b * vq} "
            f"max_err/scale (d_src, d_wc) "
            + " ".join(f"{str(d)[6:]}=({e[0]:.3g}, {e[1]:.3g})" for d, e in errs.items())
            + f" (tol d_src 1e-5, 2^-7 rounded to bfloat16; d_wc {WGRAD_TOL}) d_src_ms={d_ms:.4f} (plain {pd_ms:.3f}, "
            f"bound {d_b[0]:.5f} {d_b[1]}) d_wc_ms={w_ms:.4f} (plain {pw_ms:.3f}, gather + einsum "
            f"{lg_ms:.3f}, einsum on gathered rows {le_ms:.3f}, bound {w_b[0]:.5f} {w_b[1]}) [{card}]")
        del out, s32, w32, want_s, want_w
    records = {}
    for k in rows:
        total = {m: sum(r[m] for r in rows[k]) for m in ("ms", "plain_ms", "bound_ms")}
        library = ""
        if k == "wgrad":
            library = (f" gather_einsum_ms={sum(r['library_ms'] for r in rows[k]):.3f} "
                       f"einsum_on_gathered_rows_ms={sum(r['einsum_ms'] for r in rows[k]):.3f}")
        log(f"stencil backward ({cloud}): nine {k} launches: kernel_ms={total['ms']:.3f} "
            f"plain_ms={total['plain_ms']:.3f}{library} bound_ms={total['bound_ms']:.4f} [{card}]")
        slowest = dict(max(rows[k], key=lambda r: r["ms"]), max_abs_err=worst[k])
        slowest.pop("einsum_ms", None)
        records[k] = slowest
    return records


def subm_backward_replay(fwd_calls, bwd_calls, card):
    """Phase 18 for the rank gather: the six recorded forward calls with the
    cotangents of the backward pass (recorded in reverse order), the kernels
    against the plain backward and beside autograd of ``index_select`` +
    ``einsum``. Returns the ``kernels`` records of ``df`` and ``dW``."""
    import torch

    from lyft3d_tpu_torch.ops import subm_conv_kernel as sk

    assert len(fwd_calls) == len(bwd_calls) == 6, (len(fwd_calls), len(bwd_calls))
    rows = {"dgrad": [], "wgrad": []}
    worst = {"dgrad": 0.0, "wgrad": 0.0}
    stepped = []  # whether the step itself asked for df at this layer (the first layer's input has no gradient)
    d_dev = []  # df's device time at each layer
    for (args, _), (bargs, _) in zip(fwd_calls, reversed(bwd_calls)):
        f_sorted, ranks, w = args
        cot = bargs[3]
        stepped.append(bool(bargs[4]))
        b, v, c = f_sorted.shape
        k, q = ranks.shape[1:]
        cout = w.shape[-1]
        present = int(((ranks >= 0) & (ranks < v)).sum())
        f32 = f_sorted.detach().float().requires_grad_(True)
        w32 = w.detach().float().requires_grad_(True)
        out = sk.subm_conv_ref(f32, ranks, w32)
        want_f, want_w = torch.autograd.grad(out, (f32, w32), cot.float(), retain_graph=True)
        errs = {}
        for dtype in (f_sorted.dtype, torch.float32):
            got_f, got_w = sk._subm_conv_bwd_cuda(f_sorted.detach().to(dtype), ranks, w.detach().to(dtype),
                                                  cot.to(dtype), True, True)
            torch.cuda.synchronize()
            tol_f, tol_w = (1e-5, WGRAD_TOL) if dtype == torch.float32 else (2.0 ** -7, 2.0 ** -7)
            errs[dtype] = (rel_diff(got_f, want_f), rel_diff(got_w, want_w))
            if dtype == torch.float32:
                worst["dgrad"] = max(worst["dgrad"], float((got_f - want_f).abs().max()))
                worst["wgrad"] = max(worst["wgrad"], float((got_w - want_w).abs().max()))
            if not (errs[dtype][0] <= tol_f and errs[dtype][1] <= tol_w):
                raise AssertionError(f"rank gather backward {b}x{v} {c}->{cout} {dtype}: df, dW differ from "
                                     f"the plain backward by {errs[dtype]} of their scale")
            del got_f, got_w
        f_, w_ = f_sorted.detach(), w.detach().to(f_sorted.dtype)
        d_ms = cuda_ms(lambda: sk._subm_conv_bwd_cuda(f_, ranks, w_, cot, True, False), warmup=1, iters=5)
        d_dev.append(device_ms(lambda: sk._subm_conv_bwd_cuda(f_, ranks, w_, cot, True, False)))
        w_ms = cuda_ms(lambda: sk._subm_conv_bwd_cuda(f_, ranks, w_, cot, False, True), warmup=1, iters=5)
        zero_rows = int((cot.abs().amax(-1) == 0).sum())
        pd_ms = retained_grad_ms(out, (f32,), cot.float())
        pw_ms = retained_grad_ms(out, (w32,), cot.float())
        # The library pair differentiated by autograd (index_add_ and matmuls).
        table = torch.cat([f_, f_.new_zeros(b, 1, c)], dim=1).reshape(-1, c).requires_grad_(True)
        base = torch.arange(b, device=ranks.device)[:, None, None] * (v + 1)
        index = (torch.where((ranks >= 0) & (ranks < v), ranks.long(), v) + base).reshape(-1)
        wk = w_.clone().requires_grad_(True)
        lib_out = torch.einsum("bkvc,kcd->bvd", torch.index_select(table, 0, index).view(b, k, q, c), wk)
        ld_ms = retained_grad_ms(lib_out, (table,), cot)
        lw_ms = retained_grad_ms(lib_out, (wk,), cot)
        del table, index, lib_out
        size = f_sorted.element_size()
        ops = present * 2 * c * cout
        peak = BF16_PEAK if f_sorted.dtype == torch.bfloat16 else F32_PEAK
        d_b = bound((b * q * cout + k * c * cout + b * v * c) * size + b * k * q * 4, ops, peak)
        w_b = bound((b * v * c + b * q * cout) * size + b * k * q * 4 + k * c * cout * 4, ops, peak)
        rows["dgrad"].append(dict(ms=d_ms, plain_ms=pd_ms, bound_ms=d_b[0], bound_by=d_b[1], library_ms=ld_ms))
        rows["wgrad"].append(dict(ms=w_ms, plain_ms=pw_ms, bound_ms=w_b[0], bound_by=w_b[1], library_ms=lw_ms))
        log(f"subm backward: B={b} V={v} {c}->{cout} {str(f_sorted.dtype)[6:]} present={present} of "
            f"{b * k * q} zero_cotangent_rows={zero_rows} of {b * q} max_err/scale (df, dW) "
            + " ".join(f"{str(d)[6:]}=({e[0]:.3g}, {e[1]:.3g})" for d, e in errs.items())
            + f" (tol float32 df 1e-5, dW {WGRAD_TOL}; 2^-7 bfloat16 outputs) df_ms={d_ms:.4f} (device "
            f"{d_dev[-1]:.4f}, plain {pd_ms:.3f}, "
            f"index_select_einsum backward {ld_ms:.3f}, bound {d_b[0]:.5f} {d_b[1]}) dW_ms={w_ms:.4f} "
            f"(plain {pw_ms:.3f}, library {lw_ms:.3f}, "
            f"bound {w_b[0]:.5f} {w_b[1]}) [{card}]")
        del out, f32, w32, want_f, want_w
    df_step = sum(r["ms"] for r, asked in zip(rows["dgrad"], stepped) if asked)
    df_dev = sum(d for d, asked in zip(d_dev, stepped) if asked)
    log(f"subm backward: the {sum(stepped)} df launches of one step (the forward kernel on the reverse ranks, "
        f"the reverse table built in the same call): kernel_ms={df_step:.3f} (device {df_dev:.3f}) [{card}]")
    records = {}
    for kk in rows:
        total = {m: sum(r[m] for r in rows[kk]) for m in ("ms", "plain_ms", "bound_ms", "library_ms")}
        log(f"subm backward: six {kk} launches: kernel_ms={total['ms']:.3f} plain_ms={total['plain_ms']:.3f} "
            f"index_select_einsum_backward_ms={total['library_ms']:.3f} bound_ms={total['bound_ms']:.4f} "
            f"[{card}]")
        records[kk] = dict(max(rows[kk], key=lambda r: r["ms"]), max_abs_err=worst[kk])
    return records


def fill_backward_replay(calls, card, what):
    """Phase 18 for the fill: its recorded backward launches, every kernel
    that takes the rows ``torch.equal`` to the plain gather and timed."""
    for (grad, ids, num_rows), _ in calls:
        fill_bwd_shape(grad, ids, num_rows, card, what)


def training_phases(dev, card):
    """Phases 15 to 19. Returns the ``kernels`` records of the five backward
    kernels and the launch counts of the four training runs."""
    import tempfile

    import torch

    from lyft3d_tpu_torch.models.second import middle as middle_mod
    from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet
    from lyft3d_tpu_torch.ops import column_sparse as cs
    from lyft3d_tpu_torch.ops import dense_fill
    from lyft3d_tpu_torch.ops import subm_conv_kernel as sk
    from lyft3d_tpu_torch.pipelines.second_train import make_second_loss_fn
    from lyft3d_tpu_torch.train import checkpoint as ckpt
    from lyft3d_tpu_torch.train.optim import build_optimizer
    from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig

    fill_bwd_record = fill_backward_phase(dev, card)
    gradient_check_phase(dev, card)

    def onecycle(params):
        return build_optimizer(params, "adam_onecycle", ONECYCLE["lr"], total_steps=ONECYCLE["total_steps"],
                               weight_decay=ONECYCLE["weight_decay"], clip_norm=ONECYCLE["clip_norm"])

    def adam(params):
        return build_optimizer(params, "adam", 1e-3)

    onecycle_name = ("adam_onecycle(lr 0.003, 58,650 steps, weight decay 0.01; build_optimizer hands it "
                     "no clip, as in the JAX package)")
    counts = {}
    # 17a. pillars, batch 8.
    pts, pvalid = pillar_points(SEC_BATCH, SEC_POINTS, seed=26)
    batch = to_dev({"points": pts, "points_valid": pvalid, **gt_batch(SEC_BATCH, seed=27)}, dev)
    counts["pillars"], _, state, trainer = train_run(
        "pillars lyft9", lyft9_config(), 4, batch, onecycle, onecycle_name, dev, card,
        ("dense_fill", "dense_fill_bwd"))
    with recorded(dense_fill, "_fill_bwd_cuda") as fill_bwds:
        trainer.step_fn(state, batch)
    fill_backward_replay(fill_bwds.calls, card, "pillars training step")
    del state, trainer, batch, fill_bwds
    torch.cuda.empty_cache()

    # 17b. sparse FHD, unit middle, batch 4; then one more step recorded for the replay.
    pts, pvalid = fhd_points(FHD_BATCH, FHD_POINTS, seed=28)
    batch = to_dev({"points": pts, "points_valid": pvalid, **gt_batch(FHD_BATCH, seed=29)}, dev)
    unit_kernels = ("dense_fill", "dense_fill_bwd", "stencil_conv", "stencil_dgrad", "stencil_wgrad")
    counts["sparse_units"], _, state, trainer = train_run(
        "sparse FHD sparse_units", fhd_config(), 3, batch, onecycle, onecycle_name, dev, card, unit_kernels)
    with recorded(cs, "stencil_conv_batched") as fwd, recorded(cs, "_stencil_wgrad_cuda") as wgrads, \
            recorded(dense_fill, "_fill_bwd_cuda") as fill_bwds:
        trainer.step_fn(state, batch)
    stencil_records = stencil_backward_replay(fwd.calls, wgrads.calls, card)
    fill_backward_replay(fill_bwds.calls, card, "sparse_units training step")
    # The same replay on a clustered cloud that fills no cap: hits are dense
    # and nearly every cotangent row of a valid unit is non-zero there.
    pts, pvalid = clustered_points(FHD_BATCH, CLUSTER_POINTS, CLUSTER_BLOBS, seed=31)
    cbatch = to_dev({"points": pts, "points_valid": pvalid, **gt_batch(FHD_BATCH, seed=29)}, dev)
    with recorded(cs, "stencil_conv_batched") as fwd, recorded(cs, "_stencil_wgrad_cuda") as wgrads:
        trainer.step_fn(state, cbatch)
    stencil_backward_replay(fwd.calls, wgrads.calls, card, cloud="clustered cloud")
    del state, trainer, fwd, wgrads, fill_bwds, cbatch
    torch.cuda.empty_cache()

    # 17c. sparse FHD, per-voxel middle, batch 4; one more step recorded.
    voxel_kernels = ("dense_fill", "dense_fill_bwd", "subm_conv", "subm_dgrad", "subm_wgrad")
    counts["sparse"], _, state, trainer = train_run(
        "sparse FHD sparse (per-voxel)", fhd_config(middle="sparse"), 3, batch, onecycle, onecycle_name,
        dev, card, voxel_kernels)
    with recorded(middle_mod, "subm_conv") as fwd, recorded(sk, "_subm_conv_bwd_cuda") as bwds, \
            recorded(dense_fill, "_fill_bwd_cuda") as fill_bwds:
        trainer.step_fn(state, batch)
    subm_records = subm_backward_replay(fwd.calls, bwds.calls, card)
    fill_backward_replay(fill_bwds.calls, card, "per-voxel training step")
    del state, trainer, fwd, bwds, fill_bwds, batch
    torch.cuda.empty_cache()

    # 17d. the bench-shaped sparse step: batch 2, adam(1e-3), four car boxes.
    pts, pvalid = fhd_points(BENCH_TRAIN_BATCH, FHD_POINTS, seed=30)
    batch = to_dev({"points": pts, "points_valid": pvalid, **bench_gt(BENCH_TRAIN_BATCH)}, dev)
    counts["bench"], _, state, trainer = train_run(
        "sparse FHD sparse_units, bench shape", fhd_config(), 3, batch, adam, "adam(1e-3)", dev, card,
        unit_kernels)
    del state, trainer
    torch.cuda.empty_cache()

    # 19. Trainer.fit with checkpoints, resume in a fresh trainer, train on.
    cfg = fhd_config()
    with tempfile.TemporaryDirectory() as model_dir:
        def make(seed, total):
            net = VoxelNet(cfg, in_features=3, dtype=torch.bfloat16, device=dev,
                           generator=torch.Generator().manual_seed(seed))
            return Trainer(net, adam, make_second_loss_fn(cfg, dev),
                           TrainerConfig(model_dir=model_dir, total_steps=total, log_every=1,
                                         eval_every=0, ckpt_every=2))

        def feed():
            while True:
                yield batch

        first = make(0, 3)
        state = first.fit(first.init_or_resume(), feed())
        saved = [p.name for p in ckpt.list_checkpoints(model_dir)]
        if state.step != 3 or ckpt.latest_checkpoint(model_dir).name != "model-3.ckpt":
            raise AssertionError(f"fit: step {state.step}, checkpoints {saved}")
        second = make(1, 4)  # another initialisation: everything must come from the checkpoint
        resumed = second.init_or_resume()
        if resumed.step != 3:
            raise AssertionError(f"fit: resumed at step {resumed.step}, expected 3")
        for (k, a), bb in zip(resumed.module.state_dict().items(), state.module.state_dict().values()):
            if not torch.equal(a, bb):
                raise AssertionError(f"fit: {k} differs after the checkpoint round trip")
        for a, bb in zip(resumed.masters, state.masters):
            if not torch.equal(a, bb):
                raise AssertionError("fit: a master parameter differs after the checkpoint round trip")
        if resumed.optimizer.param_groups[0]["count"] != 3:
            raise AssertionError("fit: the optimizer's step count was not restored")
        resumed = second.fit(resumed, feed())
        losses = [h["train.loss"] for h in second.log.reload_history()]
        if resumed.step != 4 or not all(math.isfinite(l) for l in losses):
            raise AssertionError(f"fit: step {resumed.step} after resuming, losses {losses}")
        log(f"fit: Trainer.fit on the bench-shaped batch, 3 steps, checkpoints {saved}; a fresh trainer "
            f"resumed at step 3 with equal parameters, masters and optimizer count, trained to step "
            f"{resumed.step}; logged losses {' '.join(f'{l:.4f}' for l in losses)}")
    del first, second, state, resumed, batch
    torch.cuda.empty_cache()
    return fill_bwd_record, stencil_records, subm_records, counts


# BEV training (configs/bev_seresnext101_map.yaml, whose batch_size is the
# microbatch, 32; also cut to 8): 2 warm-up + 8 timed microsteps, so that two
# of the yaml's grad_accum-4 optimizer updates fall inside the timed ones; the
# card-vs-CPU step at a size the CPU runs in seconds.
BEV_TRAIN_BATCH, BEV_YAML_BATCH, BEV_WARMUP, BEV_STEPS = 8, 32, 2, 8
BEV_CHECK_BATCH, BEV_CHECK_HW = 2, 128
BEV_GT_BOXES = 40


def bev_train_config(model, **changes):
    """The ``BEVExperiment`` of ``configs/bev_seresnext101_map.yaml`` (no yaml
    on the card's machine; a CPU test holds this to the file) with ``model``,
    at microbatch :data:`BEV_TRAIN_BATCH`."""
    from lyft3d_tpu_torch.config import BEVExperiment, DataConfig, OptimizerConfig

    opt = OptimizerConfig(name="ranger", lr=0.001, weight_decay=0.0, clip_norm=5.0, grad_accum=4,
                          schedule="one_cycle", total_steps=20000)
    kw = dict(model=model, n_classes=10, bev_shape=(336, 336, 3), voxel_size=(0.4, 0.4, 1.5),
              z_offset=-2.0, box_scale=0.8, with_map=True, batch_size=BEV_TRAIN_BATCH,
              class_weights=(0.2,) + (1.0,) * 9, size_weight=336.0, optimizer=opt,
              data=DataConfig(num_sweeps=1, seed=42), model_dir="runs/bev_seresnext101_map")
    kw.update(changes)
    return BEVExperiment(**kw)


def bev_train_batch(batch, hw, seed, dev):
    """A BEV training batch on the card: the model input of uniform sweeps
    (raster kernel → normalize → map concat) at ``hw`` × ``hw``, and targets
    filled from :data:`BEV_GT_BOXES` rotated boxes a sample of classes 1-9 by
    ``rasterize_boxes_bev``."""
    import torch

    from lyft3d_tpu_torch.data.bev_pipeline import BEVConfig
    from lyft3d_tpu_torch.ops.bev_raster import rasterize_boxes_bev
    from lyft3d_tpu_torch.pipelines.bev import make_bev_input

    cfg = BEVConfig(shape=(hw, hw, 3))
    pts, valid = sweep_points(batch, N_POINTS, seed)
    rng = np.random.RandomState(seed)
    map_ch = torch.from_numpy(rng.rand(batch, hw, hw).astype(np.float32)).to(dev)
    with torch.no_grad():
        image = make_bev_input(pts.to(dev), valid.to(dev), map_ch, cfg)
    local = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]], np.float32)
    labels = []
    for _ in range(batch):
        size = rng.uniform(0.02, 0.08, (BEV_GT_BOXES, 2)) * hw * np.array([1.0, 2.2])
        yaw = rng.uniform(-np.pi, np.pi, BEV_GT_BOXES)
        rot = np.stack([np.stack([np.cos(yaw), -np.sin(yaw)], -1), np.stack([np.sin(yaw), np.cos(yaw)], -1)], 1)
        corners = np.einsum("bkj,bij->bki", local[None] * size[:, None], rot) + rng.uniform(0, hw, (BEV_GT_BOXES, 1, 2))
        classes = rng.randint(1, 10, BEV_GT_BOXES)
        labels.append(rasterize_boxes_bev(torch.from_numpy(corners.astype(np.float32)).to(dev),
                                          torch.from_numpy(classes).to(dev),
                                          torch.ones(BEV_GT_BOXES, dtype=torch.bool, device=dev), (hw, hw)))
    return {"image": image, "label": torch.stack(labels)}


def phase_json(phase, card, **numbers):
    log(json.dumps({"phase": phase, **numbers, "card": card}))


def seresnext_inference_phase(dev, card):
    """Phase 20: ``unet_seresnext101`` (10 classes, folded norms, full width,
    seeded weights) on the BEV main path. A float32 check at batch 1 with TF32
    off holds the card's logits to the CPU's (1e-3 of their scale); then
    ``make_infer_fn`` at batch 32 × 65,536 points in bfloat16 with the raster
    kernel's count reset before it, and the grouped 3x3 convolutions of the
    four stages timed alone. Returns the raster launches of the main path."""
    import torch

    from lyft3d_tpu_torch.data.bev_pipeline import BEVConfig
    from lyft3d_tpu_torch.models import build_model
    from lyft3d_tpu_torch.ops import bev_raster
    from lyft3d_tpu_torch.ops.mask_to_boxes import extract_detections_from_logits
    from lyft3d_tpu_torch.pipelines.bev import make_bev_input, make_infer_fn

    name, kw, cfg = "unet_seresnext101", {"n_classes": 10, "norm_type": "folded"}, BEVConfig()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pts, valid = sweep_points(1, N_POINTS, seed=40)
    map_ch = torch.from_numpy(np.random.RandomState(40).rand(1, *SHAPE[:2]).astype(np.float32))
    ref_model = build_model(name, generator=torch.Generator().manual_seed(0), **kw).eval()
    card_model = build_model(name, generator=torch.Generator().manual_seed(0), device=dev, **kw).eval()
    with torch.inference_mode():
        x_cpu = make_bev_input(pts, valid, map_ch, cfg)
        ref_logits, ref_aux = ref_model(x_cpu)
        card_logits, card_aux = card_model(x_cpu.to(dev))
    scale = max(1.0, float(ref_logits.abs().max()))
    errs = (float((card_logits.cpu() - ref_logits).abs().max()), float((card_aux.cpu() - ref_aux).abs().max()))
    if not max(errs) <= 1e-3 * scale:
        raise AssertionError(f"{name} float32 card vs cpu: logits {errs[0]} aux {errs[1]} > {1e-3 * scale}")
    phase_json("seresnext101 check", card, model=name, dtype="float32", batch=1, tf32=False,
               max_abs_err_logits=errs[0], max_abs_err_aux=errs[1], tol=1e-3 * scale)
    del ref_model, card_model
    torch.backends.cudnn.allow_tf32 = True

    model = build_model(name, generator=torch.Generator().manual_seed(0), device=dev, dtype=torch.bfloat16, **kw)
    infer = make_infer_fn([model], cfg)
    pts, valid = (a.to(dev) for a in sweep_points(BATCH, N_POINTS, seed=41))
    map_ch = torch.from_numpy(np.random.RandomState(41).rand(BATCH, *SHAPE[:2]).astype(np.float32)).to(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bev_raster.KERNEL_LAUNCHES = 0
    e2e_ms = cuda_ms(lambda: infer(pts, valid, map_ch))
    det = infer(pts, valid, map_ch)
    torch.cuda.synchronize()
    launches = bev_raster.KERNEL_LAUNCHES
    if launches <= 0:
        raise AssertionError("the unet_seresnext101 main path never launched the raster kernel")
    for k, shape in {"boxes_px": (BATCH, 64, 5), "scores": (BATCH, 64, 9)}.items():
        if tuple(det[k].shape) != shape or not bool(torch.isfinite(det[k]).all()):
            raise AssertionError(f"{name} {k}: shape {tuple(det[k].shape)} or non-finite values")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.inference_mode():
        x = make_bev_input(pts, valid, map_ch, cfg)
        lg = model(x)[0]
        stage_ms = {
            "input": cuda_ms(lambda: make_bev_input(pts, valid, map_ch, cfg)),
            "model": cuda_ms(lambda: model(x)),
            "backbone": cuda_ms(lambda: model.backbone(x.permute(0, 3, 1, 2).to(torch.bfloat16))),
            "extract": cuda_ms(lambda: extract_detections_from_logits(lg)),
        }
    phase_json("seresnext101 e2e", card, model=name, norm="folded", dtype="bfloat16", batch=BATCH,
               points=N_POINTS, e2e_ms=e2e_ms, sweeps_per_s=BATCH / (e2e_ms / 1e3), stages_ms=stage_ms,
               components=int(det["box_valid"].sum()), peak_mem_gb=peak_gb, raster_launches=launches)
    del model, infer, det, x, lg

    # The grouped 3x3 convolutions (32 groups) of the four stages at batch 32,
    # channels_last as the model runs them, beside the same convolution on
    # NCHW tensors and the dense convolution of the same widths (32x the
    # operations); bound: bytes of input, output and weights once, or the
    # grouped convolution's operations at the bf16 peak.
    for c, hw in ((128, 84), (256, 42), (512, 21), (1024, 11)):
        xin = torch.randn(BATCH, c, hw, hw, device=dev, dtype=torch.bfloat16)
        w = torch.randn(c, c // 32, 3, 3, device=dev, dtype=torch.bfloat16) * 0.1
        wd = torch.randn(c, c, 3, 3, device=dev, dtype=torch.bfloat16) * 0.02
        xcl, wcl, wdcl = (t.to(memory_format=torch.channels_last) for t in (xin, w, wd))
        conv = torch.nn.functional.conv2d
        times = {
            "grouped_channels_last": cuda_ms(lambda: conv(xcl, wcl, padding=1, groups=32), iters=20),
            "grouped_nchw": cuda_ms(lambda: conv(xin, w, padding=1, groups=32), iters=20),
            "dense_channels_last": cuda_ms(lambda: conv(xcl, wdcl, padding=1), iters=20),
        }
        ops = 2 * BATCH * hw * hw * c * 9 * (c // 32)
        b_ms, b_by = bound(2 * (2 * xin.numel() + w.numel()), ops, BF16_PEAK)
        phase_json("grouped conv", card, shape=[BATCH, c, hw, hw], groups=32, channels_a_group=c // 32,
                   dtype="bfloat16", ms=times, bound_ms=b_ms, bound_by=b_by,
                   bound_share_channels_last=b_ms / times["grouped_channels_last"])
    torch.cuda.empty_cache()
    return launches


def bev_train_step_run(name, microbatch, dev, card):
    """Phase 21 for one model: the functions ``train_bev`` runs, on the
    ``Trainer``'s step function, at ``microbatch`` × 336 × 336 × 6 in bfloat16
    (float32 heads and masters) with the yaml's optimizer block. Peak memory
    is reported above what was allocated before the model was built (earlier
    phases' tensors) and in all."""
    import tempfile

    import torch

    from lyft3d_tpu_torch.pipelines.bev_train import build_bev_model, make_bev_loss_fn, make_bev_optimizer_fn
    from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig, TrainState

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    cfg = bev_train_config(name, batch_size=microbatch)
    model = build_bev_model(cfg, torch.bfloat16, dev)
    optimizer_fn, loss_fn = make_bev_optimizer_fn(cfg), make_bev_loss_fn(cfg, dev)
    batch = bev_train_batch(microbatch, SHAPE[0], seed=42, dev=dev)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(model, optimizer_fn, loss_fn, TrainerConfig(model_dir=tmp, total_steps=10 ** 6))
        state = TrainState(model, optimizer_fn)
        losses = []
        for _ in range(BEV_WARMUP):
            state, metrics = trainer.step_fn(state, batch)
            losses.append(metrics["loss"])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        updates0 = state.optimizer.param_groups[0]["count"]
        start.record()
        for _ in range(BEV_STEPS):
            state, metrics = trainer.step_fn(state, batch)
            losses.append(metrics["loss"])
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / BEV_STEPS
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        updates = state.optimizer.param_groups[0]["count"] - updates0
    losses = [float(l) for l in losses]
    if not all(math.isfinite(l) for l in losses) or updates != BEV_STEPS // cfg.optimizer.grad_accum:
        raise AssertionError(f"BEV train {name}: losses {losses}, {updates} optimizer updates")
    # Stage split: the same microstep with CUDA events between its stages.
    names = ("forward+loss", "backward", "optimizer")
    sums = dict.fromkeys(names, 0.0)
    model.train()
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        loss, _ = loss_fn(model, batch)
        ev[1].record()
        for p in state.params:
            p.grad = None
        loss.backward()
        ev[2].record()
        state.push_grads()
        state.optimizer.step()
        state.pull_params()
        ev[3].record()
        torch.cuda.synchronize()
        for i, stage in enumerate(names):
            sums[stage] += ev[i].elapsed_time(ev[i + 1]) / 4
    # Where the device time goes: one optimizer update's microsteps under the
    # profiler: the kernels' time (the busy share of the unprofiled
    # microstep) and the aten ops that launched the most of it.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    accum = cfg.optimizer.grad_accum
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(accum):
            state, _ = trainer.step_fn(state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA) / accum / 1e3
    ops = sorted(((e.self_device_time_total / accum / 1e3, e.key) for e in events
                  if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
                  and e.self_device_time_total > 0), reverse=True)
    # The norms' share: forward+loss+backward of the same trunk without a
    # norm op (``norm_type="folded"``: conv with bias), same weights' shapes.
    bare = build_bev_model(bev_train_config(name, batch_size=microbatch, model_kwargs={"norm_type": "folded"}),
                           torch.bfloat16, dev)

    def fwd_bwd(m):
        loss_fn(m, batch)[0].backward()

    fwd_bwd_ms = {"group": cuda_ms(lambda: fwd_bwd(model), warmup=1, iters=4),
                  "folded": cuda_ms(lambda: fwd_bwd(bare), warmup=1, iters=4)}
    del bare
    masters = sum(1 for p, m in zip(state.params, state.masters) if m is not p)
    phase_json("bev train step", card, model=name, norm="group", dtype="bfloat16", microbatch=microbatch,
               input=[microbatch, SHAPE[0], SHAPE[1], 6], optimizer="ranger lr 0.001 clip_norm 5 grad_accum 4",
               microstep_ms=step_ms, samples_per_s=microbatch / (step_ms / 1e3),
               optimizer_updates_timed=updates, stages_ms=sums, device_ms_per_microstep=device_ms,
               busy_share=device_ms / step_ms, top_aten_ops_device_ms={k: ms for ms, k in ops[:10]},
               forward_backward_ms_by_norm=fwd_bwd_ms,
               peak_mem_gb=peak_gb - base_gb, peak_mem_gb_with_earlier_phases=peak_gb,
               float32_masters=masters, parameters=len(state.params), loss_first=losses[0],
               loss_last=losses[-1], all_finite=True)
    del model, state, trainer, batch, loss
    torch.cuda.empty_cache()


def bev_train_check_phase(dev, card):
    """Phase 22: one train-mode step of ``unet_seresnext101`` with
    ``norm_type="batch"`` in float32 (TF32 off), card against CPU, at batch
    2 × 128 × 128 × 6: loss within 1e-4 relative, every parameter gradient
    finite and within ``GRAD_NORM_TOL`` in the 2-norm, running statistics
    within 1e-3 of their scale; and the running buffers of the same model in
    bfloat16 stay float32 through a train-mode step."""
    import torch

    from lyft3d_tpu_torch.models.layers import BatchNorm
    from lyft3d_tpu_torch.pipelines.bev_train import build_bev_model, make_bev_loss_fn

    cfg = bev_train_config("unet_seresnext101", model_kwargs={"norm_type": "batch"})
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = bev_train_batch(BEV_CHECK_BATCH, BEV_CHECK_HW, seed=43, dev=dev)
    runs = []
    for device in (torch.device("cpu"), dev):
        model = build_bev_model(cfg, torch.float32, device).train()
        loss, _ = make_bev_loss_fn(cfg, device)(model, {k: v.to(device) for k, v in batch.items()})
        loss.backward()
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        stats = {k: b.detach().cpu() for k, b in model.named_buffers() if k.endswith(("running_mean", "running_var"))}
        runs.append((float(loss.detach()), grads, stats))
        del model, loss
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    (l_cpu, g_cpu, s_cpu), (l_card, g_card, s_card) = runs
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    if not loss_err <= 1e-4:
        raise AssertionError(f"BEV train check: loss {l_card} on the card, {l_cpu} on the CPU")
    worst = (0.0, "")
    for k, want in g_cpu.items():
        got = g_card[k]
        if not (bool(torch.isfinite(got).all()) and float(want.norm()) > 0):
            raise AssertionError(f"BEV train check: gradient of {k} is all zero or not finite")
        worst = max(worst, (float((got - want).norm() / want.norm()), k))
    if not worst[0] <= GRAD_NORM_TOL:
        raise AssertionError(f"BEV train check: gradient of {worst[1]} differs by {worst[0]} in the 2-norm")
    stat_worst = (0.0, "")
    for k, want in s_cpu.items():
        stat_worst = max(stat_worst, (float((s_card[k] - want).abs().max()) / max(float(want.abs().max()), 1e-6), k))
    if not stat_worst[0] <= 1e-3:
        raise AssertionError(f"BEV train check: running statistic {stat_worst[1]} differs by {stat_worst[0]}")
    model = build_bev_model(cfg, torch.bfloat16, dev).train()
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    before = [m.running_var.clone() for m in norms]
    with torch.no_grad():
        model(batch["image"])
    moved = sum(int((m.running_var != b).sum()) for m, b in zip(norms, before))
    if not (all(m.running_mean.dtype == m.running_var.dtype == torch.float32 for m in norms) and moved):
        raise AssertionError("BEV train check: running statistics of the bfloat16 model are not float32 or did not move")
    phase_json("bev train check", card, model="unet_seresnext101", norm="batch", dtype="float32", tf32=False,
               input=[BEV_CHECK_BATCH, BEV_CHECK_HW, BEV_CHECK_HW, 6], loss_card=l_card, loss_cpu=l_cpu,
               loss_rel_err=loss_err, gradients=len(g_cpu), worst_grad_2norm_err=worst[0],
               worst_grad_at=worst[1], grad_tol=GRAD_NORM_TOL, running_stats=len(s_cpu),
               worst_stat_err_of_scale=stat_worst[0], stat_tol=1e-3, batch_norms=len(norms),
               bf16_model_running_stats_float32=True, bf16_running_vars_moved=moved)
    del model
    torch.cuda.empty_cache()


# PointRCNN training (phases 23-26): lyft_pointrcnn_config("train") in
# float32, the CLI's defaults (RPN batch 2, RCNN batch 1, adam_onecycle lr
# 2e-3 over 100 steps, adam 1e-3), on frames of a synthetic KITTI tree with
# car boxes that hold points; the card-vs-CPU check on a smaller cloud.
PRC_TRAIN_BATCH = 2
PRC_TRAIN_FRAMES = 4
PRC_FRAME_POINTS = 20000
PRC_TRAIN_CARS = 16
PRC_CHECK_POINTS = 4096
PRC_CHECK_ROIS = 128
PRC_KERNELS = ("fps", "ball_query", "knn", "roi_select")


def kitti_training_tree(root, frames, n, cars, seed, spread=40.0, inside=0.3):
    """A KITTI tree (``velodyne/``, ``calib/``, ``label_2/``) of ``frames``
    frames written with the port's KITTI writers: ``cars`` car boxes a frame
    (the Lyft car size ±10%, centres in ±``spread`` m, random yaw), the share
    ``inside`` of the ``n`` points inside the boxes (within 95% of each half
    extent) and the rest uniform in ±1.5·``spread`` m, z in [-2.5, 1] m."""
    from pathlib import Path

    from lyft3d_tpu_torch.data.kitti import Object3d, box_lidar_to_camera, default_calibration, write_label_file

    rng = np.random.RandomState(seed)
    root = Path(root)
    for sub in ("velodyne", "calib", "label_2"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    calib = default_calibration()
    for f in range(frames):
        boxes = np.column_stack([rng.uniform(-spread, spread, (cars, 2)), rng.uniform(-1.2, -0.6, cars),
                                 np.array([1.93, 4.76, 1.72]) * rng.uniform(0.9, 1.1, (cars, 3)),
                                 rng.uniform(-math.pi, math.pi, cars)])
        held_n = int(inside * n)
        b = boxes[rng.randint(0, cars, held_n)]
        local = (rng.rand(held_n, 3) - 0.5) * 0.95 * b[:, [4, 3, 5]]  # along l, w, h
        c, s = np.cos(b[:, 6]), np.sin(b[:, 6])
        held = np.column_stack([c * local[:, 0] - s * local[:, 1] + b[:, 0],
                                s * local[:, 0] + c * local[:, 1] + b[:, 1], local[:, 2] + b[:, 2]])
        rest = np.column_stack([rng.uniform(-1.5 * spread, 1.5 * spread, (n - held_n, 2)),
                                rng.uniform(-2.5, 1.0, n - held_n)])
        pts = np.concatenate([held, rest])[rng.permutation(n)]
        np.column_stack([pts, np.zeros(n)]).astype(np.float32).tofile(root / "velodyne" / f"{f:06d}.bin")
        calib.to_file(root / "calib" / f"{f:06d}.txt")
        objs = []
        for box in boxes:
            pos, ry = box_lidar_to_camera(box, calib)
            objs.append(Object3d(cls_type="car", truncation=0.0, occlusion=0, alpha=0.0,
                                 box2d=np.array([0.0, 0.0, 50.0, 50.0]), h=float(box[5]), w=float(box[3]),
                                 l=float(box[4]), pos=pos, ry=ry))
        write_label_file(root / "label_2" / f"{f:06d}.txt", objs)
    return root


def prc_counts():
    from lyft3d_tpu_torch.ops import pointnet2 as p2

    return dict(p2.KERNEL_LAUNCHES)


def prc_reset():
    from lyft3d_tpu_torch.ops import pointnet2 as p2

    for name in p2.KERNEL_LAUNCHES:
        p2.KERNEL_LAUNCHES[name] = 0


def prc_path(what, fn, expect):
    """Runs ``fn`` (a training entry point) with the four PointNet++ kernel
    counts set to 0 just before and read just after; fails unless every
    kernel in ``expect`` launched and no other. Returns (its result, the
    counts, host seconds)."""
    import torch

    torch.cuda.synchronize()
    prc_reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = prc_counts()
    for name in PRC_KERNELS:
        if (counts[name] > 0) != (name in expect):
            raise AssertionError(f"{what}: {counts[name]} launches of the {name} kernel (expected "
                                 f"{'some' if name in expect else 'none'})")
    return out, counts, seconds


def prc_batch(loader, stems, dev):
    import torch

    return {k: torch.from_numpy(v).to(dev) for k, v in loader.batch(stems).items()}


def stage_events(stages, repeats=5):
    """Mean milliseconds of each stage over ``repeats`` runs of ``stages`` (a
    list of (name, fn); each fn may use what the previous ones returned
    through the shared dict it is given), timed by CUDA events between the
    stages of one run."""
    import torch

    sums = {name: 0.0 for name, _ in stages}
    for _ in range(repeats):
        shared = {}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        ev[0].record()
        for i, (_, fn) in enumerate(stages):
            fn(shared)
            ev[i + 1].record()
        torch.cuda.synchronize()
        for i, (name, _) in enumerate(stages):
            sums[name] += ev[i].elapsed_time(ev[i + 1]) / repeats
    return sums


def timed_steps(step, warmup=TRAIN_WARMUP, iters=TRAIN_STEPS):
    """(mean step ms by CUDA events over ``iters`` steps after ``warmup``,
    every step's loss)."""
    import torch

    losses = [step() for _ in range(warmup)]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    losses += [step() for _ in range(iters)]
    end.record()
    torch.cuda.synchronize()
    losses = [float(l) for l in losses]
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"a training loss is not finite: {losses}")
    return start.elapsed_time(end) / iters, losses


def rpn_train_phase(cfg, loader, dev, card):
    """Phase 23: the RPN trainer through ``train_pointrcnn_rpn`` (3 steps of
    batch 2, the launch counts of the path), then ``make_rpn_step`` on a
    fixed batch: 2 warm-up + 10 timed steps, the stage split, peak memory,
    and the kernel launches of one step recorded for the replay. Returns
    (the trained RPN, the path's counts, the recorded calls)."""
    import torch

    from lyft3d_tpu_torch.models.pointrcnn import modules as prc_modules
    from lyft3d_tpu_torch.models.pointrcnn.net import PointRCNN_RPN, rpn_loss, rpn_point_labels
    from lyft3d_tpu_torch.pipelines import pointrcnn_train as prt
    from lyft3d_tpu_torch.train.optim import build_optimizer

    (rpn, entry_losses), path, entry_s = prc_path(
        "train_pointrcnn_rpn", lambda: prt.train_pointrcnn_rpn(loader, cfg, steps=3, batch_size=PRC_TRAIN_BATCH,
                                                               num_workers=2, device=dev),
        ("fps", "ball_query", "knn"))
    model = PointRCNN_RPN(cfg, device=dev, generator=torch.Generator().manual_seed(0)).train()
    optimizer = build_optimizer(list(model.parameters()), "adam_onecycle", 2e-3, total_steps=100)
    step = prt.make_rpn_step(model, cfg, optimizer)
    batch = prc_batch(loader, loader.stems[:PRC_TRAIN_BATCH], dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    step_ms, losses = timed_steps(lambda: step(batch)[0])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    xyz, gt = batch["points"], batch["gt_boxes"]

    def labels(sh):
        sh["labels"] = rpn_point_labels(xyz, gt, batch["gt_valid"])

    def forward(sh):
        optimizer.zero_grad(set_to_none=True)
        sh["out"] = model(xyz, xyz.new_zeros((*xyz.shape[:2], 1)), batch["points_valid"])

    def loss(sh):
        sh["loss"] = rpn_loss(sh["out"], xyz, *sh["labels"], gt, cfg)[0].mean()

    stages = stage_events([("labels", labels), ("forward", forward), ("loss", loss),
                           ("backward", lambda sh: sh["loss"].backward()),
                           ("optimizer", lambda sh: optimizer.step())])
    with recorded(prc_modules, "fps") as fps_calls, \
            recorded(prc_modules, "multi_radius_ball_query") as ball_calls, \
            recorded(prc_modules, "three_nn") as knn_calls:
        prc_reset()
        step(batch)
        torch.cuda.synchronize()
        per_step = prc_counts()
    fg = int((rpn_point_labels(xyz, gt, batch["gt_valid"])[0] == 1).sum())
    phase_json("pointrcnn rpn train step", card, config='lyft_pointrcnn_config("train")', dtype="float32",
               tf32=torch.backends.cuda.matmul.allow_tf32, batch=PRC_TRAIN_BATCH, points=int(xyz.shape[1]), gt_slots=int(gt.shape[1]),
               gt_valid=int(batch["gt_valid"].sum()), foreground_points=fg,
               optimizer="adam_onecycle lr 2e-3 total_steps 100", step_ms=step_ms,
               samples_per_s=PRC_TRAIN_BATCH / (step_ms / 1e3), stages_ms=stages,
               loss_first=losses[0], loss_last=losses[-1], losses_finite=len(losses),
               peak_mem_gb=peak_gb, launches_per_step=per_step,
               entry_point=dict(fn="train_pointrcnn_rpn", steps=3, host_s=entry_s, launches=path,
                                losses=entry_losses))
    del model, optimizer, step, batch
    return rpn, path, {"fps": fps_calls.calls, "ball_query": ball_calls.calls, "knn": knn_calls.calls}


def rcnn_online_phase(cfg, rpn, loader, dev, card):
    """Phase 24: the online RCNN through ``train_rcnn_online`` (2 steps of
    one frame, the path's launch counts), then one frame's step on the
    trained RPN: 2 warm-up + 10 timed steps, the stage split, peak memory,
    the RoIs' foreground and kept counts, and the kernel launches of one step
    recorded for the replay. Returns (the path's counts, the recorded
    calls)."""
    import torch

    from lyft3d_tpu_torch.models.pointrcnn import modules as prc_modules
    from lyft3d_tpu_torch.models.pointrcnn.net import (
        PointRCNN_RCNN,
        aug_rois_with_noise,
        draw_roi_noise,
        draw_target_priorities,
        gather_boxes,
        proposal_layer,
        proposal_target_layer,
        rcnn_loss,
    )
    from lyft3d_tpu_torch.ops import pointnet2 as p2
    from lyft3d_tpu_torch.pipelines import pointrcnn_train as prt
    from lyft3d_tpu_torch.train.optim import build_optimizer

    _, path, entry_s = prc_path(
        "train_rcnn_online", lambda: prt.train_rcnn_online(rpn, loader, cfg, steps=2, num_workers=2, device=dev),
        PRC_KERNELS)
    model = PointRCNN_RCNN(cfg, 3 + cfg.fp_width, device=dev, generator=torch.Generator().manual_seed(0)).train()
    optimizer = build_optimizer(list(model.parameters()), "adam", 1e-3)
    stage1 = prt.make_rcnn_stage1(rpn, cfg)
    batch = prc_batch(loader, loader.stems[:1], dev)
    generator = torch.Generator().manual_seed(0)
    shape = (1, cfg.num_proposals)
    inputs = (batch["points"], batch["points_valid"], batch["gt_boxes"], batch["gt_valid"])

    def step():
        roi_points, counts, rois, targets = stage1(
            *inputs, draw_target_priorities(shape, generator, dev),
            draw_roi_noise(shape, cfg.roi_fg_aug_times, generator, dev))
        return prt.rcnn_step(model, optimizer, roi_points, counts, rois, targets, batch["gt_boxes"], cfg)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    step_ms, losses = timed_steps(step)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    xyz, valid, gt, gt_valid = inputs

    def proposals(sh):
        with torch.no_grad():
            out = rpn(xyz, xyz.new_zeros((*xyz.shape[:2], 1)), valid)
            sh["out"], sh["props"] = out, proposal_layer(xyz, out["cls"], out["reg"], valid, cfg)

    def targets(sh):
        with torch.no_grad():
            tg = proposal_target_layer(sh["props"]["rois"], sh["props"]["roi_valid"], gt, gt_valid, cfg,
                                       draw_target_priorities(shape, generator, dev))
            sh["targets"] = tg
            sh["rois"] = aug_rois_with_noise(sh["props"]["rois"], draw_roi_noise(shape, cfg.roi_fg_aug_times,
                                                                                 generator, dev),
                                             gt_of_rois=gather_boxes(gt, tg["assigned_gt"]), fg=tg["fg"],
                                             pos_iou=cfg.fg_iou)

    def pool(sh):
        with torch.no_grad():
            sh["pts"], sh["counts"] = prt.rcnn_inputs(xyz, sh["out"]["point_features"], valid, sh["rois"], cfg)

    def forward_loss(sh):
        optimizer.zero_grad(set_to_none=True)
        sh["loss"] = rcnn_loss(model(sh["pts"], sh["counts"]), sh["rois"], sh["targets"], gt, cfg)[0].mean()

    shared = {}
    for fn in (proposals, targets, pool):
        fn(shared)
    tg = shared["targets"]
    stages = stage_events([("rpn_and_proposals", proposals), ("targets_and_noise", targets),
                           ("roi_pool", pool), ("rcnn_forward_loss", forward_loss),
                           ("backward", lambda sh: sh["loss"].backward()),
                           ("optimizer", lambda sh: optimizer.step())])
    with recorded(prc_modules, "fps") as fps_calls, \
            recorded(prc_modules, "multi_radius_ball_query") as ball_calls, \
            recorded(prc_modules, "three_nn") as knn_calls, \
            recorded(p2, "roi_inside_select") as roi_calls:
        prc_reset()
        step()
        torch.cuda.synchronize()
        per_step = prc_counts()
    phase_json("pointrcnn rcnn online step", card, config='lyft_pointrcnn_config("train")', dtype="float32",
               tf32=torch.backends.cuda.matmul.allow_tf32, batch=1, points=int(xyz.shape[1]), rois=cfg.num_proposals, roi_points=cfg.roi_points,
               valid_proposals=int(shared["props"]["roi_valid"].sum()), sampled_fg=int(tg["fg"].sum()),
               kept=int(tg["keep"].sum()), empty_rois=int((shared["counts"] == 0).sum()),
               optimizer="adam lr 1e-3", step_ms=step_ms, samples_per_s=1 / (step_ms / 1e3), stages_ms=stages,
               loss_first=losses[0], loss_last=losses[-1], losses_finite=len(losses), peak_mem_gb=peak_gb,
               launches_per_step=per_step,
               entry_point=dict(fn="train_rcnn_online", steps=2, host_s=entry_s, launches=path))
    del model, optimizer, shared, batch
    torch.cuda.empty_cache()
    return path, {"fps": fps_calls.calls, "ball_query": ball_calls.calls, "knn": knn_calls.calls,
                  "roi_select": roi_calls.calls}


def rcnn_offline_phase(cfg, rpn, loader, dev, card):
    """Phase 25: ``cache_rcnn_samples`` over 2 frames, then one
    ``train_rcnn_offline`` step, through the entry points (the path's launch
    counts), then both again timed by CUDA events. Returns the path's
    counts."""
    import torch

    from lyft3d_tpu_torch.pipelines import pointrcnn_train as prt

    stems = loader.stems[:2]
    cache, cache_counts, _ = prc_path("cache_rcnn_samples", lambda: prt.cache_rcnn_samples(rpn, loader, cfg, stems),
                                      ("fps", "ball_query", "knn"))
    (_, losses), step_counts, _ = prc_path(
        "train_rcnn_offline", lambda: prt.train_rcnn_offline(cache, cfg, steps=1, device=dev),
        ("fps", "ball_query", "roi_select"))
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    start.record()
    cache = prt.cache_rcnn_samples(rpn, loader, cfg, stems)
    mid.record()
    _, timed = prt.train_rcnn_offline(cache, cfg, steps=1, device=dev)
    end.record()
    torch.cuda.synchronize()
    if not all(math.isfinite(l) for l in losses + timed):
        raise AssertionError(f"offline RCNN losses are not finite: {losses + timed}")
    path = {k: cache_counts[k] + step_counts[k] for k in PRC_KERNELS}
    phase_json("pointrcnn rcnn offline", card, config='lyft_pointrcnn_config("train")', dtype="float32",
               frames=len(stems), cache_ms=start.elapsed_time(mid), offline_step_ms=mid.elapsed_time(end),
               valid_proposals=[int(c["roi_valid"].sum()) for c in cache], loss=timed[0],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9 - base_gb,
               launches=dict(cache=cache_counts, offline_step=step_counts))
    return path


def near_threshold(iou, thresholds, margin=1e-4):
    """Where an IoU lies within ``margin`` of one of ``thresholds``."""
    return (iou[..., None] - iou.new_tensor(thresholds)).abs().amin(-1) <= margin


def pointrcnn_train_check_phase(cfg, root, dev, card):
    """Phase 26: card against CPU, float32 with TF32 off, the same seeded
    weights and inputs on both: one ``make_rpn_step`` on a frame of
    ``PRC_CHECK_POINTS`` points, 80% of them in 4 cars within ±8 m (dense
    enough that the 0.1 m balls of SA stage 0 hold neighbours), read from a
    tree of its own in ``root`` (loss within 1e-5 relative; every gradient
    finite and within ``GRAD_NORM_TOL`` in the 2-norm, or zero on both;
    every updated parameter within ``GRAD_NORM_TOL`` of how far it moved, in
    the 2-norm); the RPN's bin
    labels of that frame equal; ``proposal_target_layer`` and
    ``aug_rois_with_noise`` on ``num_proposals`` RoIs around the frame's GT
    boxes with the same draws: equal masks, assigned boxes and chosen
    candidates where no IoU lies within 1e-4 of a threshold (RoIs whose IoU
    does are left out of the sampling on both devices, and rows with such a
    candidate out of the comparison), IoUs within 1e-4; and the RCNN's bin
    labels of the sampled RoIs equal."""
    import torch

    from lyft3d_tpu_torch.models.pointrcnn.net import (
        PointRCNN_RPN,
        aug_rois_with_noise,
        draw_roi_noise,
        draw_target_priorities,
        gather_boxes,
        proposal_target_layer,
        rpn_point_labels,
    )
    from lyft3d_tpu_torch.ops.bin_coder import encode_bin_targets
    from lyft3d_tpu_torch.ops.rotated_iou import rotated_iou_3d, rotated_iou_3d_paired
    from lyft3d_tpu_torch.pipelines import pointrcnn_train as prt
    from lyft3d_tpu_torch.pipelines.pointrcnn import KittiLoaderConfig, KittiPointRCNNLoader
    from lyft3d_tpu_torch.train.optim import build_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    root = kitti_training_tree(root, 1, PRC_CHECK_POINTS, 4, seed=21, spread=8.0, inside=0.8)
    loader = KittiPointRCNNLoader(root, KittiLoaderConfig(num_points=PRC_CHECK_POINTS), seed=1)
    frame = {k: torch.from_numpy(v) for k, v in loader.batch(loader.stems[:1]).items()}
    runs = []
    for device in (torch.device("cpu"), dev):
        model = PointRCNN_RPN(cfg, device=device, generator=torch.Generator().manual_seed(3)).train()
        start = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
        optimizer = build_optimizer(list(model.parameters()), "adam_onecycle", 2e-3, total_steps=100)
        loss, _ = prt.make_rpn_step(model, cfg, optimizer)({k: v.to(device) for k, v in frame.items()})
        runs.append((float(loss), {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
                     {k: p.detach().cpu() for k, p in model.named_parameters()}, start))
        del model, optimizer
    (l_cpu, g_cpu, p_cpu, p0), (l_card, g_card, p_card, _) = runs
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    if not loss_err <= 1e-5:
        raise AssertionError(f"PointRCNN train check: RPN loss {l_card} on the card, {l_cpu} on the CPU")
    grad_worst, param_worst, zero = (0.0, ""), (0.0, ""), 0
    for k, want in g_cpu.items():
        got = g_card[k]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"PointRCNN train check: gradient of {k} is not finite")
        if float(want.norm()) == 0:
            if float(got.norm()) != 0:
                raise AssertionError(f"PointRCNN train check: gradient of {k} is zero on the CPU, not on the card")
            zero += 1
            continue
        grad_worst = max(grad_worst, (float((got - want).norm() / want.norm()), k))
        moved = float((p_cpu[k] - p0[k]).norm())
        param_worst = max(param_worst, (float((p_card[k] - p_cpu[k]).norm()) / max(moved, 1e-12), k))
    if not (grad_worst[0] <= GRAD_NORM_TOL and param_worst[0] <= GRAD_NORM_TOL):
        raise AssertionError(f"PointRCNN train check: gradient of {grad_worst[1]} differs by {grad_worst[0]}, "
                             f"parameter {param_worst[1]} by {param_worst[0]} of its move, in the 2-norm")

    # Bin labels of the RPN's foreground targets.
    def rpn_bins(device):
        xyz, gt = frame["points"].to(device), frame["gt_boxes"].to(device)
        labels, assigned = rpn_point_labels(xyz, gt, frame["gt_valid"].to(device))
        return labels.cpu(), {k: v.cpu() for k, v in encode_bin_targets(
            xyz, gather_boxes(gt, assigned), cfg.rpn_coder).items()}

    (lab_cpu, rpn_cpu), (lab_card, rpn_card) = rpn_bins(torch.device("cpu")), rpn_bins(dev)
    if not torch.equal(lab_cpu, lab_card):
        raise AssertionError("PointRCNN train check: RPN point labels differ between the card and the CPU")
    fg = lab_cpu == 1
    res_err = 0.0
    for k, want in rpn_cpu.items():
        if k.endswith("_bin"):
            if not torch.equal(rpn_card[k][fg], want[fg]):
                raise AssertionError(f"PointRCNN train check: RPN {k} labels differ between the card and the CPU")
        else:
            res_err = max(res_err, float((rpn_card[k][fg] - want[fg]).abs().max()))

    # RoI sampling and RoI noise on RoIs around the GT boxes, same draws.
    rng = np.random.RandomState(5)
    gt, gt_valid = frame["gt_boxes"], frame["gt_valid"]
    held = gt[0][gt_valid[0]].numpy()
    r = cfg.num_proposals
    around = np.repeat(held, -(-(r - r // 8) // len(held)), 0)[: r - r // 8]
    scale = rng.uniform(0.0, 1.0, (len(around), 1)) * np.array([[0.8, 0.8, 0.3, 0.25, 0.25, 0.25, 0.6]])
    around = around + rng.uniform(-1, 1, around.shape) * scale * np.array([[1, 1, 1, 0, 0, 0, 1]])
    around[:, 3:6] *= 1 + rng.uniform(-1, 1, (len(around), 3)) * scale[:, 3:6]
    apart = np.column_stack([rng.uniform(-40, 40, (r // 8, 2)), np.full(r // 8, -1.0),
                             np.tile([1.93, 4.76, 1.72], (r // 8, 1)), rng.uniform(-3, 3, r // 8)])
    rois = torch.from_numpy(np.concatenate([around, apart]).astype(np.float32))[None]
    iou = rotated_iou_3d(rois, gt).masked_fill(~gt_valid[:, None, :], -1.0).amax(-1)
    roi_valid = ~near_threshold(iou, (cfg.fg_iou, cfg.bg_iou, cfg.bg_iou_lo))
    generator = torch.Generator().manual_seed(6)
    priorities = draw_target_priorities((1, r), generator)
    noise = draw_roi_noise((1, r), cfg.roi_fg_aug_times, generator)
    outs = []
    for device in (torch.device("cpu"), dev):
        def on(x):
            return x.to(device)
        tg = proposal_target_layer(on(rois), on(roi_valid), on(gt), on(gt_valid), cfg, [on(p) for p in priorities])
        gt_of = gather_boxes(on(gt), tg["assigned_gt"])
        noisy = aug_rois_with_noise(on(rois), {k: on(v) for k, v in noise.items()}, gt_of_rois=gt_of,
                                    fg=tg["fg"], pos_iou=cfg.fg_iou)
        cand_iou = rotated_iou_3d_paired(
            torch.cat([on(rois)[..., None, :3] + on(noise["loc"]),
                       torch.clamp(on(rois)[..., None, 3:6] * (1 + on(noise["size"])), min=0.1),
                       on(rois)[..., None, 6:] + on(noise["yaw"])[..., None]], -1), gt_of[..., None, :])
        outs.append(({k: v.cpu() for k, v in tg.items()}, noisy.cpu(), cand_iou.cpu()))
    (tg_cpu, noisy_cpu, cand_cpu), (tg_card, noisy_card, _) = outs
    for k in ("fg", "keep"):
        if not torch.equal(tg_card[k], tg_cpu[k]):
            raise AssertionError(f"PointRCNN train check: target {k} masks differ between the card and the CPU")
    ok = roi_valid
    if not torch.equal(tg_card["assigned_gt"][ok], tg_cpu["assigned_gt"][ok]):
        raise AssertionError("PointRCNN train check: assigned GT boxes differ between the card and the CPU")
    iou_err = float((tg_card["max_iou"] - tg_cpu["max_iou"]).abs().max())
    if not iou_err <= 1e-4:
        raise AssertionError(f"PointRCNN train check: IoUs differ by {iou_err} between the card and the CPU")
    clear = ~near_threshold(cand_cpu, (cfg.fg_iou,)).any(-1)
    if not torch.equal(noisy_card[clear], noisy_cpu[clear]):
        raise AssertionError("PointRCNN train check: RoI noise chose other candidates on the card than on the CPU")

    # Bin labels of the RCNN's canonical targets of the sampled RoIs.
    def rcnn_bins(device):
        rel_rois = noisy_cpu.to(device)
        gts = gather_boxes(gt.to(device), tg_cpu["assigned_gt"].to(device))
        rel = gts[..., :3] - rel_rois[..., :3]
        c, s = torch.cos(-rel_rois[..., 6]), torch.sin(-rel_rois[..., 6])
        canon = torch.cat([torch.stack([c * rel[..., 0] - s * rel[..., 1], s * rel[..., 0] + c * rel[..., 1],
                                        rel[..., 2]], -1), gts[..., 3:6], (gts[..., 6] - rel_rois[..., 6])[..., None]], -1)
        return {k: v.cpu() for k, v in encode_bin_targets(torch.zeros_like(rel_rois[..., :3]), canon,
                                                          cfg.rcnn_coder).items()}

    rcnn_cpu, rcnn_card = rcnn_bins(torch.device("cpu")), rcnn_bins(dev)
    sampled = tg_cpu["fg"]
    for k in ("x_bin", "y_bin", "head_bin"):
        if not torch.equal(rcnn_card[k][sampled], rcnn_cpu[k][sampled]):
            raise AssertionError(f"PointRCNN train check: RCNN {k} labels differ between the card and the CPU")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    phase_json("pointrcnn train check", card, config='lyft_pointrcnn_config("train")', dtype="float32",
               tf32=False, points=PRC_CHECK_POINTS, loss_card=l_card, loss_cpu=l_cpu, loss_rel_err=loss_err,
               loss_tol=1e-5, gradients=len(g_cpu), zero_gradients=zero, worst_grad_2norm_err=grad_worst[0],
               worst_grad_at=grad_worst[1], worst_param_err_of_move=param_worst[0],
               worst_param_at=param_worst[1], tol=GRAD_NORM_TOL, rpn_foreground_points=int(fg.sum()),
               rpn_bin_labels_equal=True, rpn_residual_max_abs_err=res_err, rois=r,
               rois_left_out_near_threshold=int((~roi_valid).sum()), sampled_fg=int(sampled.sum()),
               kept=int(tg_cpu["keep"].sum()), target_masks_equal=True, max_iou_abs_err=iou_err,
               noise_rows_compared=int(clear.sum()), noise_rows_moved=int((noisy_cpu != rois).any(-1).sum()),
               noise_choices_equal=True, rcnn_bin_labels_equal=True)


def training_replay(calls, card):
    """Phase 27: every FPS, ball-query, 3-NN and RoI-select launch recorded
    in one RPN step and one online RCNN step, replayed: each equal to its
    plain version (indices and counts ``torch.equal``, 3-NN distances within
    1e-6 of scale) and timed with CUDA events, the plain version beside it
    (FPS's plain version is checked, not timed: thousands of dependent
    launches). One JSON line a kernel. Returns each kernel's total ms a
    step."""
    import torch

    from lyft3d_tpu_torch.ops import pointnet2 as p2

    def fps(args):
        pts, valid, npoint = args
        if not torch.equal(p2.fps(pts, valid, npoint), p2.furthest_point_sample(pts, valid, npoint)):
            raise AssertionError(f"fps replay differs from the plain version at {tuple(pts.shape)} -> {npoint}")
        return f"{tuple(pts.shape[:2])}->{npoint}", cuda_ms(lambda: p2.fps(*args), warmup=1, iters=5), None

    def ball(args):
        c, p, v, radii, ks = args
        want = p2.multi_radius_ball_query_dense(*args)
        for (g_idx, g_cnt), (w_idx, w_cnt) in zip(p2.multi_radius_ball_query(*args), want):
            if not (torch.equal(g_idx, w_idx) and torch.equal(g_cnt, w_cnt)):
                raise AssertionError(f"ball query replay differs from the plain version at {tuple(c.shape)}")
        rule = p2._ball_query_kernel(p.shape[0], c.shape[1], p.shape[1], max(radii))
        return (f"{tuple(c.shape[:2])}x{p.shape[1]} r={tuple(radii)} k={tuple(ks)} {rule}",
                cuda_ms(lambda: p2.multi_radius_ball_query(*args), iters=10),
                cuda_ms(lambda: p2.multi_radius_ball_query_dense(*args), warmup=1, iters=3))

    def knn(args):
        w_d, w_idx = p2.three_nn_dense(*args)
        g_d, g_idx = p2.three_nn(*args)
        if not (torch.equal(g_idx, w_idx) and float((g_d - w_d).abs().max()) <= 1e-6 * max(1.0, float(w_d.abs().max()))):
            raise AssertionError(f"three_nn replay differs from the plain version at {tuple(args[0].shape)}")
        return (f"{tuple(args[0].shape[:2])}<-{args[1].shape[1]}", cuda_ms(lambda: p2.three_nn(*args), iters=10),
                cuda_ms(lambda: p2.three_nn_dense(*args), warmup=1, iters=3))

    def roi(args):
        got, want = p2.roi_inside_select(*args), p2.roi_inside_select_dense(*args)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError("roi select replay differs from the plain version")
        return (f"{tuple(args[2].shape[:2])} boxes x {args[0].shape[1]} k={args[3]}",
                cuda_ms(lambda: p2.roi_inside_select(*args), iters=10),
                cuda_ms(lambda: p2.roi_inside_select_dense(*args), warmup=1, iters=3))

    totals = {}
    for name, check in (("fps", fps), ("ball_query", ball), ("knn", knn), ("roi_select", roi)):
        rows = []
        for step, recorded_calls in calls.items():
            for args, _ in recorded_calls.get(name, ()):
                shape, k_ms, p_ms = check(args)
                rows.append({"step": step, "shape": shape, "kernel_ms": k_ms, "plain_ms": p_ms})
        totals[name] = {step: sum(r["kernel_ms"] for r in rows if r["step"] == step) for step in calls}
        phase_json(f"pointrcnn training replay: {name}", card, launches=rows, equal_to_plain=True,
                   kernel_ms_per_step=totals[name])
    return totals


def pointrcnn_training_phases(dev, card):
    """Phases 23-27 on a synthetic KITTI tree in a temporary directory.
    Returns each PointNet++ kernel's launches over the three training paths
    (``train_pointrcnn_rpn``, ``train_rcnn_online``, ``cache_rcnn_samples``
    with ``train_rcnn_offline``), each run with the counts set to 0 just
    before it."""
    import tempfile

    import torch

    from lyft3d_tpu_torch.models.pointrcnn.net import lyft_pointrcnn_config
    from lyft3d_tpu_torch.pipelines.pointrcnn import KittiLoaderConfig, KittiPointRCNNLoader

    cfg = lyft_pointrcnn_config("train")
    with tempfile.TemporaryDirectory() as tmp:
        root = kitti_training_tree(tmp, PRC_TRAIN_FRAMES, PRC_FRAME_POINTS, PRC_TRAIN_CARS, seed=20)
        loader = KittiPointRCNNLoader(root, KittiLoaderConfig(num_points=PRC_POINTS), seed=0)
        rpn, rpn_path, rpn_calls = rpn_train_phase(cfg, loader, dev, card)
        online_path, online_calls = rcnn_online_phase(cfg, rpn, loader, dev, card)
        offline_path = rcnn_offline_phase(cfg, rpn, loader, dev, card)
        pointrcnn_train_check_phase(cfg, f"{tmp}/check", dev, card)
    training_replay({"rpn step": rpn_calls, "rcnn online step": online_calls}, card)
    del rpn, rpn_calls, online_calls
    torch.cuda.empty_cache()
    return {k: rpn_path[k] + online_path[k] + offline_path[k] for k in PRC_KERNELS}


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

    from lyft3d_tpu_torch.data.bev_pipeline import BEVConfig
    from lyft3d_tpu_torch import _build
    from lyft3d_tpu_torch.models import build_model
    from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet
    from lyft3d_tpu_torch.models.pointrcnn import modules as prc_modules
    from lyft3d_tpu_torch.models.pointrcnn.net import (
        PointRCNN,
        canonical_transform,
        lyft_pointrcnn_config,
        proposal_layer,
    )
    from lyft3d_tpu_torch.ops import bev_raster, column_sparse, dense_fill, subm_conv_kernel
    from lyft3d_tpu_torch.ops import pointnet2 as p2
    from lyft3d_tpu_torch.ops.bin_coder import decode_refined_boxes
    from lyft3d_tpu_torch.ops.mask_to_boxes import extract_detections_from_logits
    from lyft3d_tpu_torch.ops.voxelize import voxelize
    from lyft3d_tpu_torch.pipelines.bev import make_bev_input, make_infer_fn
    from lyft3d_tpu_torch.models.second.voxelnet import voxelnet_predict
    from lyft3d_tpu_torch.pipelines.pointrcnn import make_pointrcnn_infer_fn
    from lyft3d_tpu_torch.pipelines.second import make_second_infer_fn

    def reset_counts():
        bev_raster.KERNEL_LAUNCHES = 0
        dense_fill.KERNEL_LAUNCHES = 0
        for name in p2.KERNEL_LAUNCHES:
            p2.KERNEL_LAUNCHES[name] = 0

    # 2. build
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    loaders = [bev_raster._kernel_library, dense_fill._kernel_library, p2._fps_library,
               p2._ball_query_library, p2._knn_library, p2._roi_select_library,
               column_sparse._kernel_library, subm_conv_kernel._kernel_library]
    with ThreadPoolExecutor(len(loaders)) as pool:
        list(pool.map(lambda load: load(), loaders))
    log(f"build: bev_raster.cu dense_fill.cu fps.cu ball_query.cu knn.cu roi_select.cu "
        f"stencil_conv.cu subm_conv.cu (with conv_mma.cuh, wgrad_tile.cuh, mma.cuh) -> "
        f"{_build.BUILD_DIR} in {time.perf_counter() - t0:.2f} s "
        f"(one nvcc each, in parallel: nvcc {' '.join(_build.NVCC_FLAGS)})")

    # 3. the raster kernel against the plain version on the card
    raster = raster_phase(dev, card)

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
        # The one library call that fills the same canvas: index_add_ into
        # zeros (ids prepared beforehand; one dump row per sample).
        base = torch.arange(SEC_BATCH, device=dev)[:, None] * (FILL_ROWS + 1)
        flat_ids = (base + torch.where(fvalid, ids.long(), FILL_ROWS)).reshape(-1)
        rows2d = feats.reshape(-1, FILL_C)
        l_ms = cuda_ms(lambda: torch.zeros(SEC_BATCH * (FILL_ROWS + 1), FILL_C, dtype=dtype,
                                           device=dev).index_add_(0, flat_ids, rows2d),
                       warmup=3, iters=20)
        q_ms, ql_ms = fill_queued(feats, ids, fvalid, FILL_ROWS, True)
        b_ms, b_by, share = fill_bound(dense_fill._masked_ids(ids, fvalid, FILL_ROWS), FILL_ROWS, FILL_C,
                                       feats.element_size(), backward=False)
        # The kernels line: the launch and index_add_ on the card's time (queued).
        fill[dtype] = dict(max_abs_err=err, ms=q_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=ql_ms)
        log(f"fill: B={SEC_BATCH} V={FILL_V} C={FILL_C} rows={FILL_ROWS} {str(dtype)[6:]} "
            f"ids_below_rows={share:.4f} torch.equal=True kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
            f"index_add_ms={l_ms:.4f} queued_ms kernel={q_ms:.4f} index_add_={ql_ms:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}) [{card}]")
    fill_duplicates_check(dev)

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

    del net, infer, pts, pvalid, vox, feats, bev, preds, det
    torch.cuda.empty_cache()

    # 8. the four PointNet++ kernels against their plain versions
    select = select_kernels_phase(dev, card)
    torch.cuda.empty_cache()

    # 9. PointRCNN float32 check, stage by stage: card against CPU, TF32 off.
    # Each stage gets the CPU's inputs on both devices, so that a rounding
    # difference in one stage cannot reorder the discrete choices of the next.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pcfg = lyft_pointrcnn_config("test")
    pts, pvalid = rcnn_cloud(1, PRC_POINTS, seed=10)
    ref_net = PointRCNN(pcfg, norm="folded", generator=torch.Generator().manual_seed(0)).eval()
    card_net = PointRCNN(pcfg, norm="folded", device=dev,
                         generator=torch.Generator().manual_seed(0)).eval()

    def rel_err(got, want):
        return float((got.cpu() - want).abs().max()) / max(1.0, float(want.abs().max()))

    def on_card(x):
        return x.to(dev)

    with torch.inference_mode():
        zeros = pts.new_zeros(1, PRC_POINTS, 1)
        if not torch.equal(p2.fps(on_card(pts), on_card(pvalid), pcfg.sa_npoints[0]).cpu(),
                           p2.fps(pts, pvalid, pcfg.sa_npoints[0])):
            raise AssertionError("FPS indices on the card differ from the CPU's")
        ref_rpn = ref_net.rpn(pts, zeros, pvalid)
        card_rpn = card_net.rpn(on_card(pts), on_card(zeros), on_card(pvalid))
        rpn_err = {k: rel_err(card_rpn[k], v) for k, v in ref_rpn.items()}
        ref_props = proposal_layer(pts, ref_rpn["cls"], ref_rpn["reg"], pvalid, pcfg)
        card_props = proposal_layer(on_card(pts), on_card(ref_rpn["cls"]), on_card(ref_rpn["reg"]),
                                    on_card(pvalid), pcfg)
        if not torch.equal(card_props["roi_valid"].cpu(), ref_props["roi_valid"]):
            raise AssertionError("proposal sets on the card differ from the CPU's")
        prop_err = max(rel_err(card_props[k], ref_props[k]) for k in ("rois", "roi_scores"))
        rois = ref_props["rois"]

        def second_stage(net, xyz, feats, valid, rois):
            pooled, counts, empty = p2.roi_pool3d(xyz, feats, valid, rois, pcfg.roi_points,
                                                  pcfg.roi_extra_width)
            canon = canonical_transform(pooled[..., :3], rois)
            out = net.rcnn(torch.cat([canon, pooled[..., 3:]], dim=-1), counts)
            return counts, out["cls"], out["reg"], decode_refined_boxes(rois, out["reg"],
                                                                         pcfg.rcnn_coder)

        ref_2 = second_stage(ref_net, pts, ref_rpn["point_features"], pvalid, rois)
        card_2 = second_stage(card_net, on_card(pts), on_card(ref_rpn["point_features"]),
                              on_card(pvalid), on_card(rois))
        if not torch.equal(card_2[0].cpu(), ref_2[0]):
            raise AssertionError("RoI point counts on the card differ from the CPU's")
        rcnn_err = [rel_err(a, b) for a, b in zip(card_2[1:], ref_2[1:])]
    worst = max(*rpn_err.values(), prop_err, *rcnn_err)
    if not worst <= 1e-3:
        raise AssertionError(f"float32 PointRCNN card vs cpu: rpn {rpn_err} proposals {prop_err} "
                             f"rcnn cls/reg/refined {rcnn_err} > 1e-3 of their scale")
    log(f"pointrcnn check: PointRCNN lyft test preset f32 B=1 N={PRC_POINTS}, TF32 off, card vs cpu, "
        f"stage by stage: FPS indices equal, proposal sets equal "
        f"({int(ref_props['roi_valid'].sum())} of {pcfg.num_proposals} valid, "
        f"{int((ref_2[0] == 0).sum())} empty RoIs), max_err/scale point_features="
        f"{rpn_err['point_features']:.3g} rpn_cls={rpn_err['cls']:.3g} rpn_reg={rpn_err['reg']:.3g} "
        f"rois={prop_err:.3g} rcnn_cls={rcnn_err[0]:.3g} rcnn_reg={rcnn_err[1]:.3g} "
        f"refined={rcnn_err[2]:.3g} (tol 1e-3)")
    del ref_net, card_net, ref_rpn, card_rpn, ref_2, card_2
    torch.backends.cudnn.allow_tf32 = True

    # 10. PointRCNN main path at batch 4 in bfloat16
    pnet = PointRCNN(pcfg, norm="folded", dtype=torch.bfloat16, device=dev,
                     generator=torch.Generator().manual_seed(0))
    infer = make_pointrcnn_infer_fn(pnet, pcfg)
    pts, pvalid = (a.to(dev) for a in rcnn_cloud(PRC_BATCH, PRC_POINTS, seed=11))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    e2e_ms = cuda_ms(lambda: infer(pts, pvalid))
    boxes, scores = infer(pts, pvalid)
    torch.cuda.synchronize()
    calls = 2 + TIMED_ITERS + 1
    prc_launches = dict(p2.KERNEL_LAUNCHES)
    per_call = {"fps": 6, "ball_query": 6, "knn": 4, "roi_select": 1}
    for name, n in per_call.items():
        if prc_launches[name] <= 0:
            raise AssertionError(f"the PointRCNN main path never launched the {name} kernel")
        if prc_launches[name] != n * calls:
            raise AssertionError(f"{name}: {prc_launches[name]} launches in {calls} calls, "
                                 f"expected {n} a call")
    if tuple(boxes.shape) != (PRC_BATCH, PRC_ROIS, 7) or tuple(scores.shape) != (PRC_BATCH, PRC_ROIS):
        raise AssertionError(f"PointRCNN outputs {tuple(boxes.shape)} {tuple(scores.shape)}")
    if not bool(torch.isfinite(boxes).all()):
        raise AssertionError("refined boxes have non-finite values")
    if not bool(((scores >= 0) & (scores <= 1)).all()):
        raise AssertionError("PointRCNN scores outside [0, 1]")
    prc_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # The cell grid's effect end to end in this process: the path as the rule
    # runs it against the same path with ball query held to the scan,
    # interleaved six times, each first in turn (the six launches' numbers
    # are in the replay).
    rule_fn, e2e_ab = p2._ball_query_kernel, {"rule": [], "scan alone": []}
    for turn in range(6):
        for name in sorted(e2e_ab, reverse=bool(turn % 2)):
            p2._ball_query_kernel = rule_fn if name == "rule" else (lambda *args: "scan")
            try:
                e2e_ab[name].append(cuda_ms(lambda: infer(pts, pvalid)))
            finally:
                p2._ball_query_kernel = rule_fn
    log("pointrcnn e2e, ball query by the rule against the scan alone, interleaved in this process: "
        + "; ".join(f"{name} " + ", ".join(f"{v:.3f}" for v in vals) + f" ms (median {np.median(vals):.3f})"
                    for name, vals in e2e_ab.items()) + f" [{card}]")
    with recorded(prc_modules, "fps") as fps_calls, \
            recorded(prc_modules, "multi_radius_ball_query") as ball_calls, \
            recorded(prc_modules, "three_nn") as knn_calls, \
            recorded(p2, "roi_inside_select") as roi_calls:
        infer(pts, pvalid)
    # The same six ball-query launches on a LiDAR-like cloud (dense near the
    # sensor and on the ground), the other side of the property the grid's
    # gain rests on.
    lpts, lvalid = (a.to(dev) for a in lidar_cloud(PRC_BATCH, PRC_POINTS, seed=12))
    with recorded(prc_modules, "multi_radius_ball_query") as lidar_calls:
        infer(lpts, lvalid)
    del lpts, lvalid

    # Stage split of the same path (each stage timed alone).
    with torch.inference_mode():
        zeros = pts.new_zeros(PRC_BATCH, PRC_POINTS, 1)
        backbone = pnet.rpn.backbone

        def run_sa():
            stack = [(pts, zeros, pvalid)]
            for sa in backbone.sa:
                stack.append(sa(*stack[-1]))
            return stack

        stack = run_sa()

        def run_fp():
            up = stack[-1][1]
            for fp, i in zip(backbone.fp, range(len(stack) - 1, 0, -1)):
                up = fp(stack[i - 1][0], stack[i - 1][1], stack[i][0], up, stack[i][2])
            return up

        rpn_out = pnet.rpn(pts, zeros, pvalid)
        props = proposal_layer(pts, rpn_out["cls"], rpn_out["reg"], pvalid, pcfg)

        def run_pool():
            pooled, counts, _ = p2.roi_pool3d(pts, rpn_out["point_features"], pvalid, props["rois"],
                                              pcfg.roi_points, pcfg.roi_extra_width)
            canon = canonical_transform(pooled[..., :3], props["rois"])
            return torch.cat([canon, pooled[..., 3:]], dim=-1), counts

        roi_pts, counts = run_pool()
        prc_ms = {
            "sa": cuda_ms(run_sa, iters=5),
            "fp": cuda_ms(run_fp, iters=5),
            "rpn_total": cuda_ms(lambda: pnet.rpn(pts, zeros, pvalid), iters=5),
            "proposals": cuda_ms(lambda: proposal_layer(pts, rpn_out["cls"], rpn_out["reg"],
                                                        pvalid, pcfg), iters=5),
            "roi_pool": cuda_ms(run_pool, iters=5),
            "rcnn": cuda_ms(lambda: pnet.rcnn(roi_pts, counts), iters=5),
        }
    prc_ms["decode_nms"] = max(0.0, e2e_ms - prc_ms["rpn_total"] - prc_ms["proposals"]
                               - prc_ms["roi_pool"] - prc_ms["rcnn"])
    log(f"pointrcnn e2e: PointRCNN lyft test preset folded bf16 B={PRC_BATCH} N={PRC_POINTS} "
        f"samples_per_s={PRC_BATCH / (e2e_ms / 1e3):.2f} e2e_ms={e2e_ms:.3f} stages_ms "
        + " ".join(f"{n}={v:.3f}" for n, v in prc_ms.items())
        + f" (decode_nms is the remainder) valid_proposals={int(props['roi_valid'].sum())} "
        f"empty_rois={int((counts == 0).sum())} kept={int((scores > 0).sum())} "
        f"peak_mem_gb={prc_peak_gb:.2f} launches_per_call={per_call} [{card}]")
    # The recorded launches, replayed after the stage split.
    fps_replay(fps_calls.calls, card)
    ball_replay(ball_calls.calls, card, "uniform cloud")
    ball_replay(lidar_calls.calls, card, "LiDAR-like cloud")
    knn_replay(knn_calls.calls, card)
    roi_replay(roi_calls.calls, card)
    del fps_calls, ball_calls, knn_calls, lidar_calls, roi_calls

    del pnet, infer, pts, pvalid, boxes, scores, stack, rpn_out, props, roi_pts, counts
    torch.cuda.empty_cache()

    # 10a. the sparse kernels at their edge shapes
    sparse_kernel_edges(dev, card)

    # 11-14. sparse SECOND at the FHD geometry
    stencil_record, subm_record, sparse_launches, voxel_launches = sparse_phases(dev, card)

    # 15-19. SECOND training: backward kernels, gradient checks, training steps, fit
    fill_bwd_record, stencil_bwd, subm_bwd, train_launches = training_phases(dev, card)

    # 20. unet_seresnext101 on the BEV main path (the raster kernel's second path)
    launches += seresnext_inference_phase(dev, card)

    # 21-22. BEV training: full-width train steps, then card against CPU
    for name, microbatch in (("unet_resnet50", BEV_TRAIN_BATCH), ("unet_seresnext101", BEV_TRAIN_BATCH),
                             ("unet_seresnext101", BEV_YAML_BATCH)):
        bev_train_step_run(name, microbatch, dev, card)
    bev_train_check_phase(dev, card)

    # 23-27. PointRCNN training: the RPN, the online and offline RCNN, card
    # against CPU, and the kernels' launches replayed at the training shapes
    prc_train = pointrcnn_training_phases(dev, card)

    def trained(kernel):
        """Launches of ``kernel`` over the timed steps of the four training runs."""
        return sum(c[kernel] for c in train_launches.values())

    def record(name, replaces, launches, numbers, library_ms=None, source=None):
        return {"name": name, "route": "cuda",
                "source": f"lyft3d_tpu_torch/csrc/{source or name}.cu",
                "replaces": replaces, "launches": launches,
                **{"library_ms": library_ms, **numbers}}

    sel = "lyft3d_tpu/ops/select_kernel.py"
    fill_numbers = dict(fill[torch.bfloat16],
                        max_abs_err=max(f["max_abs_err"] for f in fill.values()))
    print(json.dumps({"kernels": [
        # Launched by two paths: the flagship and the unet_seresnext101 row.
        record("bev_raster", "lyft3d_tpu/ops/bev_raster.py:146", launches, raster),
        # Launched by three paths: pillars, sparse (2 a call) and per-voxel (1 a call).
        record("dense_fill", "lyft3d_tpu/ops/dense_fill.py:78",
               fill_launches + sparse_launches["dense_fill"] + voxel_launches["dense_fill"],
               fill_numbers),
        # Launched by two paths: PointRCNN inference and training (the three
        # trainers' entry points).
        record("fps", "lyft3d_tpu/ops/pointnet2.py:112", prc_launches["fps"] + prc_train["fps"], select["fps"]),
        record("ball_query", f"{sel}:94", prc_launches["ball_query"] + prc_train["ball_query"],
               select["ball_query"]),
        record("knn", f"{sel}:115", prc_launches["knn"] + prc_train["knn"], select["knn"]),
        record("roi_select", f"{sel}:127", prc_launches["roi_select"] + prc_train["roi_select"],
               select["roi_select"]),
        record("stencil_conv", "lyft3d_tpu/ops/column_sparse.py:507",
               sparse_launches["stencil_conv"], stencil_record),
        record("subm_conv", "lyft3d_tpu/ops/subm_conv_kernel.py:42",
               voxel_launches["subm_conv"], subm_record),
        # The backward sides, launched by the training paths (10 timed steps each
        # of pillars, unit middle, per-voxel middle and the bench-shaped step).
        record("dense_fill_bwd", "lyft3d_tpu/ops/dense_fill.py:153", trained("dense_fill_bwd"),
               fill_bwd_record, source="dense_fill"),
        # d_src is the forward stencil kernel launched on the reverse queries,
        # as the JAX backward launches its Pallas kernel a second time.
        record("stencil_dgrad", "lyft3d_tpu/ops/column_sparse.py:773", trained("stencil_dgrad"),
               stencil_bwd["dgrad"], source="stencil_conv"),
        record("stencil_wgrad", "lyft3d_tpu/ops/column_sparse.py:777", trained("stencil_wgrad"),
               stencil_bwd["wgrad"], source="stencil_conv"),
        # df is the forward rank gather kernel launched on the reverse ranks,
        # as d_src is the forward stencil on the reverse queries.
        record("subm_dgrad", "lyft3d_tpu/ops/subm_conv_kernel.py:106", trained("subm_dgrad"),
               subm_bwd["dgrad"], source="subm_conv"),
        record("subm_wgrad", "lyft3d_tpu/ops/subm_conv_kernel.py:106", trained("subm_wgrad"),
               subm_bwd["wgrad"], source="subm_conv"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
