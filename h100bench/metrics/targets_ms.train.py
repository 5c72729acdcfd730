"""Milliseconds a step spends making its targets (``voxelize`` and
``assign_targets`` as the training pipeline calls them): the wall time of
their spans over the traced window's steps."""


def read(run):
    t = run.trace
    if t is None or not t.span_count.get("assign_targets"):
        return None
    return (t.span_wall_s.get("voxelize", 0.0) + t.span_wall_s["assign_targets"]) / run.traced_calls * 1e3
