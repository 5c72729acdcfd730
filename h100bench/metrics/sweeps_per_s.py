"""Sweeps whose detections reached the host in the window, over its seconds
(host clock)."""


def read(run):
    return run.items / run.window_s if run.calls and run.window_s > 0 else None
