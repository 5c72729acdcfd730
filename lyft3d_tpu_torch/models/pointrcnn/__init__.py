"""PointRCNN: PointNet++ RPN → proposals → RCNN refinement (port of
``lyft3d_tpu/models/pointrcnn``)."""
