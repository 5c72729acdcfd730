"""lyft3d_tpu_torch — the PyTorch / CUDA port of ``lyft3d_tpu`` for NVIDIA Hopper.

The JAX package ``lyft3d_tpu`` stays the reference; this package mirrors its
module layout and public names so each module's counterpart is easy to find:

    core      — quaternion, geometry and box math (numpy, host side)
    config    — the experiment dataclasses, yaml IO, dotted overrides
    data      — Lyft JSON-table DB, point clouds, map masks, the BEV sample
                generator, KITTI calibration / labels / export, training
                augmentation and GT-database sampling, prefetchers, the
                synthetic dataset writer (numpy)
    eval      — official Lyft mAP, numpy rotated IoU, submission CSV,
                KITTI-style AP and recall (numpy)
    ops       — BEV raster, canvas fill, the four PointNet++ selections
                (furthest-point sampling, ball query, 3-NN, RoI select), the
                unit stencil conv and the rank gather conv: hand-written CUDA
                kernels + plain torch versions, the fill and the two convs
                with hand-written backward kernels behind autograd Functions;
                connected components, mask → rotated boxes, voxelize, anchors
                and target assignment, box ops, rotated IoU, NMS, the
                bin-based box decoder
    models    — ConvNormAct / ASPP / UpBlock / LayerNorm / BatchNorm, the
                ResNet, SE-ResNeXt, EfficientNet, DPN, WideResNet-38,
                Xception and Inception encoders, LyftUNet, ReferenceUNet,
                DeepLabV3Plus, EfficientNetUNet, BatchNorm folding;
                second/: PillarFeatureNet, VoxelFeatureExtractor,
                SimpleVoxel, the sparse middles, RPN, VoxelNet,
                voxelnet_loss, voxelnet_predict;
                pointrcnn/: SharedMLP, the SA and FP modules, the RPN,
                proposal layer, RCNN and the joint PointRCNN
    train     — losses, optimizers and schedules (optax's formulas), the
                step-loop Trainer with float32 master parameters, the
                checkpoint registry, metric logs, precision/recall and
                accuracy counters
    utils     — the flax ↔ torch weight bridge, the torch-checkpoint
                importer (torch to torch), profiler helpers, BEV and
                camera debug images, a progress bar
    serve     — the viewer's JSON-over-HTTP backend and its page
    native    — the host runtime: threaded lidar reads, SE(3) transforms,
                a host BEV raster (C++ built by g++ at first use; numpy
                fallbacks)
    pipelines — BEV inference (lidar → raster → UNet → boxes → world
                records), SECOND inference (points → voxelize → VoxelNet →
                NMS → world records) with its host-side sample loader,
                SECOND training (targets → loss → Trainer), and PointRCNN
                inference and evaluation over a KITTI-layout dataset
    cli       — the JAX package's 13 subcommands (``synth-data`` …
                ``import-weights``), each device command with ``--device``

The package stands alone: it imports nothing of ``lyft3d_tpu`` and keeps its
own copies of the host-side numpy modules. Nothing here imports ``jax``,
``flax`` or ``optax``; CUDA kernels are compiled from ``csrc/`` at first use
(``_build``).
"""

__version__ = "0.1.0"
