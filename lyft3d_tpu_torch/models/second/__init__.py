"""SECOND / VoxelNet detector (port of ``lyft3d_tpu/models/second``):
the pillar encoder, the BEV scatter, the RPN, and predict."""
