#!/usr/bin/env python3
"""Stage readings of the program's own spans in one traced run of a cell.

The port opens a ``lyft3d.<stage>`` range at each layer boundary while a
profiler runs (``lyft3d_tpu_torch/utils/profiler.py::span``). :func:`reduce`
reads them from the profiler's Chrome trace of a window opened with
``tracing.WINDOW``: for each span name its wall seconds and count, the device
seconds and the launches of the kernels, copies and fills launched while one
was open on the launching thread, the seconds of that thread's CUDA runtime
and driver calls (launches, copies, synchronisations) made while one was open
(where the host waited for the card, these hold the wait), and the device's
idle seconds while one was open on the window's thread (at each idle gap's
middle, nested spans included). A launch, a call or a gap counts once under
each name open there.

    python3 h100bench/stages.py --workload <cell> --seed <n> [--seconds 30] [--out file.jsonl]

runs the cell as ``run.py --trace 1`` does and prints one JSON line: the
traced window's calls and seconds, five readings a call (NMS steps, the
rotated IoU's device ms, the optimizer's ms, the targets' idle ms and
launches; ``null`` where the span is absent), each span's totals a call, the
per-layer metrics of ``BENCHMARK.json`` from the same run, and ``correct``.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from h100bench import harness, tracing  # noqa: E402

PREFIX = "lyft3d."


@dataclass
class Stages:
    window_s: float
    busy_s: float
    wall_s: Dict[str, float] = field(default_factory=dict)
    count: Dict[str, int] = field(default_factory=dict)
    device_s: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    idle_s: Dict[str, float] = field(default_factory=dict)
    runtime_s: Dict[str, float] = field(default_factory=dict)


def chrome_events(prof) -> list:
    """The events of the profiler's Chrome trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    return events["traceEvents"] if isinstance(events, dict) else events


class Replay:
    """A profiler stand-in that exports the given events again."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _is_open(union, t) -> bool:
    starts, ends = union
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


def reduce(events) -> Stages:
    """The ``lyft3d.*`` spans of a trace of a window opened with
    ``tracing.WINDOW``."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == tracing.WINDOW and e.get("cat") in ("user_annotation", "cpu_op")]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    main = (win[0]["pid"], win[0]["tid"])
    device = [e for e in xs if e.get("cat") in tracing.DEVICE_CATS and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    runtime = [e for e in xs if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    launches = {e["args"]["correlation"]: e for e in runtime if "correlation" in e.get("args", {})}
    spans = collections.defaultdict(lambda: collections.defaultdict(list))  # (pid, tid) -> name -> [(start, end)]
    st = Stages(window_s=(w1 - w0) * 1e-6, busy_s=0.0)
    for e in xs:
        if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX):
            spans[(e["pid"], e["tid"])][e["name"]].append((e["ts"], e["ts"] + e["dur"]))
            st.wall_s[e["name"]] = st.wall_s.get(e["name"], 0.0) + e["dur"] * 1e-6
            st.count[e["name"]] = st.count.get(e["name"], 0) + 1
    # Each name's spans on a thread as disjoint intervals, (starts, ends): a
    # point inside nested spans of one name counts once.
    unions = {thread: {name: tuple(zip(*tracing._merge(ivs))) for name, ivs in by_name.items()}
              for thread, by_name in spans.items()}
    for e in device:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        for name, union in unions.get((launch["pid"], launch["tid"]), {}).items():
            if _is_open(union, launch["ts"]):
                st.device_s[name] = st.device_s.get(name, 0.0) + e["dur"] * 1e-6
                st.launches[name] = st.launches.get(name, 0) + 1
    for e in runtime:
        for name, union in unions.get((e["pid"], e["tid"]), {}).items():
            if _is_open(union, e["ts"]):
                st.runtime_s[name] = st.runtime_s.get(name, 0.0) + e["dur"] * 1e-6
    busy = tracing._merge((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in device)
    st.busy_s = sum(b - a for a, b in busy) * 1e-6
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            for name, union in unions.get(main, {}).items():
                if _is_open(union, (a + b) / 2):
                    st.idle_s[name] = st.idle_s.get(name, 0.0) + (b - a) * 1e-6
    return st


def readings(st: Stages, calls: int) -> Dict[str, Optional[float]]:
    """The five stage readings a call; ``None`` where the span is absent."""
    def per_call(values, name, scale=1.0):
        return values.get(name, 0) / calls * scale if st.count.get(name) and calls else None

    return {
        "nms_steps": per_call(st.count, "lyft3d.nms.step"),
        "rotated_iou_ms": per_call(st.device_s, "lyft3d.rotated_iou", 1e3),
        "optimizer_ms": per_call(st.wall_s, "lyft3d.optimizer", 1e3),
        "targets_idle_ms": per_call(st.idle_s, "lyft3d.targets", 1e3),
        "targets_launches": per_call(st.launches, "lyft3d.targets"),
    }


def traced_run(run: harness.RunContext, seconds: float, started: float):
    """``harness.drive`` with a trace, keeping the stages of its trace:
    ``(checks, record, stages)``."""
    kept = {}
    summarize = tracing.summarize

    def keeping(prof, span_names):
        events = chrome_events(prof)
        kept["stages"] = reduce(events)
        return summarize(Replay(events), span_names)

    tracing.summarize = keeping
    try:
        checks, record, _ = harness.drive(run, seconds, started, trace=True)
    finally:
        tracing.summarize = summarize
    return checks, record, kept["stages"]


def main(argv=None, device=None, out=None, base: Path = harness.HERE, started: Optional[float] = None) -> int:
    """One traced run; returns the exit code. ``device``: ``None`` for the
    card (exit 2 without one), or a ``torch.device`` (the CPU tests)."""
    started = time.perf_counter() if started is None else started
    out = out or sys.stdout
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--manifest", default=str(base.parent / "BENCHMARK.json"))
    p.add_argument("--out", default=None, help="also append the line to this file")
    args = p.parse_args(argv)

    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("needs a CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    manifest = harness.load_json(Path(args.manifest))
    run = harness.context(manifest, args.workload, args.seed, device, base=base)
    checks, record, st = traced_run(run, args.seconds, started)
    calls = record.traced_calls
    metrics = {m["name"]: harness.load_module(base / "metrics" / f"{m['name']}.py").read(record)
               for m in harness.metrics_for(manifest, args.workload, "per_layer")}
    on_card = device.type == "cuda"
    line = {
        "cell": args.workload, "seed": args.seed, "correct": all(c.ok for c in checks),
        "device": torch.cuda.get_device_name(device) if on_card else device.type,
        "power_limit_w": harness.power_limit() if on_card else None,
        "traced_calls": calls, "traced_window_s": st.window_s,
        "calls_per_s": calls / st.window_s if st.window_s > 0 else None,
        "device_idle_pct": 100.0 * (1.0 - st.busy_s / st.window_s) if st.window_s > 0 else None,
        "readings": readings(st, calls), "metrics": metrics,
        "by_span": {name: {"count": st.count[name] / calls, "wall_ms": st.wall_s[name] / calls * 1e3,
                           "device_ms": st.device_s.get(name, 0.0) / calls * 1e3,
                           "launches": st.launches.get(name, 0) / calls,
                           "idle_ms": st.idle_s.get(name, 0.0) / calls * 1e3,
                           "runtime_ms": st.runtime_s.get(name, 0.0) / calls * 1e3}
                    for name in sorted(st.count)} if calls else {},
    }
    text = json.dumps(line)
    print(text, file=out, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(started=STARTED))
