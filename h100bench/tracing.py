"""Spans around the calls into the program's layers, and the reduction of a
``torch.profiler`` trace to what the per-layer metrics read.

Spans are ``record_function`` ranges opened from the benchmark's own code
(module hooks and wrappers of names a pipeline calls) and only in a traced
run. The reduction reads the profiler's Chrome trace: every kernel, copy and
fill on the device is tied through its correlation id to the host call that
launched it, and that call to the spans open on its thread at the time.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "h100bench.window"


class Spans:
    """Install and remove the spans of one traced run."""

    def __init__(self):
        self._undo: List[Callable[[], None]] = []

    def module(self, name: str, module: torch.nn.Module):
        """A span ``<name>.forward`` around each forward of ``module``."""
        stack = []

        def pre(mod, args):
            rf = torch.profiler.record_function(name + ".forward")
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, out):
            stack.pop().__exit__(None, None, None)

        handles = [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
        self._undo.append(lambda: [h.remove() for h in handles])

    def backward(self, name: str, module: torch.nn.Module, output_of: Callable):
        """A span ``<name>.backward`` from the gradient of ``module``'s output
        (``output_of(out)`` picks the tensor) reaching it to the last
        gradient of its parameters, on the thread that runs the backward."""
        params = [p for p in module.parameters() if p.requires_grad]
        open_ = []

        def on_out_grad(grad):
            rf = torch.profiler.record_function(name + ".backward")
            rf.__enter__()
            open_.append(rf)
            return grad

        def post(mod, args, out):
            t = output_of(out)
            if torch.is_grad_enabled() and t.requires_grad:
                t.register_hook(on_out_grad)

        def done(grads):
            while open_:
                open_.pop().__exit__(None, None, None)

        h1 = module.register_forward_hook(post)
        h2 = torch.autograd.graph.register_multi_grad_hook(params, done)
        self._undo.append(lambda: (h1.remove(), h2.remove()))

    def wrap(self, namespace, attr: str, name: str):
        """A span ``name`` around every call of ``namespace.attr``."""
        fn = getattr(namespace, attr)

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        setattr(namespace, attr, wrapped)
        self._undo.append(lambda: setattr(namespace, attr, fn))

    def remove(self):
        while self._undo:
            self._undo.pop()()


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    span_device_s: Dict[str, float] = field(default_factory=dict)
    span_wall_s: Dict[str, float] = field(default_factory=dict)
    span_count: Dict[str, int] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def profile():
    """The profiler of a traced window (host and device activity)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, span_names) -> TraceSummary:
    """Reduce the profiler's trace of a window opened with ``WINDOW``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    events = events["traceEvents"] if isinstance(events, dict) else events
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") in ("user_annotation", "cpu_op")]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    main = (win[0]["pid"], win[0]["tid"])

    device = [e for e in xs if e.get("cat") in DEVICE_CATS and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    spans = collections.defaultdict(list)  # (pid, tid, name) -> spans, by start
    for e in xs:
        if e.get("cat") == "user_annotation" and e["name"] in span_names:
            spans[(e["pid"], e["tid"], e["name"])].append(e)
    s = TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=0.0)
    index = collections.defaultdict(list)  # (pid, tid) -> [(name, starts, spans)]
    for (pid, tid, name), lst in spans.items():
        lst.sort(key=lambda e: e["ts"])
        index[(pid, tid)].append((name, [e["ts"] for e in lst], lst))
        s.span_wall_s[name] = s.span_wall_s.get(name, 0.0) + sum(e["dur"] for e in lst) * 1e-6
        s.span_count[name] = s.span_count.get(name, 0) + len(lst)
    by_op = collections.Counter()
    for e in device:
        dur = e["dur"] * 1e-6
        by_op[e["name"]] += dur
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        t = launch["ts"]
        for name, starts, lst in index.get((launch["pid"], launch["tid"]), ()):
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= lst[i]["ts"] + lst[i]["dur"]:
                s.span_device_s[name] = s.span_device_s.get(name, 0.0) + dur
    busy = _merge((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in device)
    s.busy_s = sum(e - b for b, e in busy) * 1e-6
    s.device_ops = by_op.most_common(10)
    s.idle_gaps = _idle_by_host_call(xs, main, w0, w1, busy)
    return s


def _innermost_at(host, points):
    """For each of the ascending ``points``, the innermost of one thread's
    ``host`` calls open there (calls of one thread nest, so a sweep with a
    stack finds it), or ``None``."""
    host = sorted(host, key=lambda e: (e["ts"], -e["dur"]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host[i]["ts"] <= t:
            e = host[i]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
            stack.pop()
        out.append(stack[-1]["name"] if stack else None)
    return out


def _idle_by_host_call(xs, main, w0, w1, busy):
    """Idle device time between ``busy`` intervals, by what the host was
    doing at each gap's middle: the innermost call open on the main thread,
    else on another thread (the backward's, in training)."""
    by_thread = collections.defaultdict(list)
    for e in xs:
        if e.get("cat") in ("cpu_op", "user_annotation") and e["name"] != WINDOW:
            by_thread[(e["pid"], e["tid"])].append(e)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    mids = [(a + b) / 2 for a, b in gaps]
    labels = _innermost_at(by_thread.pop(main, []), mids)
    for events in by_thread.values():
        other = _innermost_at(events, mids)
        labels = [lab if lab is not None or o is None else "another thread: " + o for lab, o in zip(labels, other)]
    idle = collections.Counter()
    for (a, b), lab in zip(gaps, labels):
        idle[lab or "(no host call)"] += (b - a) * 1e-6
    return idle.most_common(10)
