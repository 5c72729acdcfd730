"""Evaluation: official Lyft mAP, KITTI-style AP, submission CSV IO."""
