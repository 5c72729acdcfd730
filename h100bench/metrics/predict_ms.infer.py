"""Milliseconds a batch spends in predict (decode, rotated IoU, greedy NMS):
the wall time of the ``predict`` spans over the traced window's calls."""


def read(run):
    t = run.trace
    if t is None or not t.span_count.get("predict"):
        return None
    return t.span_wall_s["predict"] / run.traced_calls * 1e3
