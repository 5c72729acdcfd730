"""lyft3d_tpu_torch — the PyTorch / CUDA port of ``lyft3d_tpu`` for NVIDIA Hopper.

The JAX package ``lyft3d_tpu`` stays the reference; this package mirrors its
module layout and public names so each module's counterpart is easy to find:

    core      — quaternion, geometry and box math (numpy, host side)
    data      — Lyft JSON-table DB, point clouds, map masks, the BEV sample
                generator, KITTI calibration / labels / export (numpy)
    eval      — official Lyft mAP, numpy rotated IoU, submission CSV,
                KITTI-style AP and recall (numpy)
    ops       — BEV raster, canvas fill and the four PointNet++ selections
                (furthest-point sampling, ball query, 3-NN, RoI select):
                hand-written CUDA kernels + plain torch versions; connected
                components, mask → rotated boxes, voxelize, anchors, box ops,
                rotated IoU, NMS, the bin-based box decoder
    models    — ConvNormAct / ASPP / UpBlock / LayerNorm, the ResNet
                encoders, LyftUNet, ReferenceUNet, BatchNorm folding;
                second/: PillarFeatureNet, RPN, VoxelNet, voxelnet_predict;
                pointrcnn/: SharedMLP, the SA and FP modules, the RPN,
                proposal layer, RCNN and the joint PointRCNN
    utils     — the flax → torch weight bridge
    pipelines — BEV inference (lidar → raster → UNet → boxes → world
                records), SECOND pillars inference (points → voxelize →
                VoxelNet → NMS → world records) with its host-side sample
                loader, and PointRCNN inference and evaluation over a
                KITTI-layout dataset
    cli       — the ``infer-bev`` command

The package stands alone: it imports nothing of ``lyft3d_tpu`` and keeps its
own copies of the host-side numpy modules. Nothing here imports ``jax``,
``flax`` or ``optax``; CUDA kernels are compiled from ``csrc/`` at first use
(``_build``).
"""

__version__ = "0.1.0"
