"""lyft3d_tpu_torch — the PyTorch / CUDA port of ``lyft3d_tpu`` for NVIDIA Hopper.

The JAX package ``lyft3d_tpu`` stays the reference; this package mirrors its
module layout and public names so each module's counterpart is easy to find:

    ops       — BEV raster and canvas fill (hand-written CUDA kernels + plain
                torch versions), connected components, mask → rotated boxes,
                voxelize, anchors, box ops, rotated IoU, NMS
    models    — ConvNormAct / ASPP / UpBlock / LayerNorm, the ResNet
                encoders, LyftUNet, ReferenceUNet, BatchNorm folding;
                second/: PillarFeatureNet, RPN, VoxelNet, voxelnet_predict
    utils     — the flax → torch weight bridge
    pipelines — BEV inference (lidar → raster → UNet → boxes → world
                records) and SECOND pillars inference (points → voxelize →
                VoxelNet → NMS → world records)
    cli       — the ``infer-bev`` command

Host-side code that imports no JAX (``lyft3d_tpu.data``, ``.core``, ``.eval``)
is reused by import, not copied. Nothing here imports ``jax``, ``flax`` or
``optax``; CUDA kernels are compiled from ``csrc/`` at first use (``_build``).
"""

__version__ = "0.1.0"
