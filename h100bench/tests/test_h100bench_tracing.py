"""The reduction of a profiler trace, on hand-written Chrome traces: what
``tracing.summarize`` gives the per-layer metrics (unchanged by the
program's own ``lyft3d.*`` spans in the trace), and the stage readings
``stages.reduce`` takes from those spans: wall, count, device time,
launches and runtime calls by the calling thread's open spans (nested,
another thread, a launch outside every span), idle time by the spans open
on the window's thread. Then ``stages.py`` end to end on the small cells on
the CPU."""

from __future__ import annotations

import io
import json

import pytest

from conftest import run_cell  # noqa: F401  (puts the checkout on the path)
from h100bench import stages, tracing

MAIN, OTHER = 1, 2


def span(name, ts, end, tid=MAIN, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": end - ts}


def launch(corr, ts, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": tid, "ts": ts,
            "dur": 2, "args": {"correlation": corr}}


def device(name, corr, ts, end, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": end - ts,
            "args": {"correlation": corr}}


# A training step in µs: the window 0-1000; the step (and a nested step, as
# an outer caller's span of the same name would be), targets holding the
# benchmark's assign_targets wrapper and the program's span inside it, the
# optimizer; the backward's span on another thread.
PROGRAM = [
    span("lyft3d.step", 10, 910), span("lyft3d.step", 150, 170), span("lyft3d.targets", 20, 395),
    span("lyft3d.assign_targets", 110, 380), span("lyft3d.optimizer", 700, 900),
    span("lyft3d.backward", 450, 650, tid=OTHER),
]
TRAIN = [
    span(tracing.WINDOW, 0, 1000), span("assign_targets", 100, 385), span("aten::cat", 120, 140, cat="cpu_op"),
    launch(1, 30), device("K1", 1, 40, 60),
    launch(2, 160), device("K2", 2, 200, 300),
    launch(3, 5), device("M", 3, 6, 10, cat="gpu_memcpy"),  # outside every span
    launch(4, 500, tid=OTHER), device("K3", 4, 500, 650),
    launch(5, 720), device("K1", 5, 720, 750),
    launch(6, 950), device("K4", 6, 990, 1040),  # crosses the window's end
    launch(7, 960), device("K5", 7, 1100, 1110),  # after it
    launch(8, 970),  # a synchronise: no device work
] + PROGRAM

# An inference batch: the rotated IoU's launch, NMS's three steps.
INFER = [
    span(tracing.WINDOW, 0, 100), span("predict", 0, 90), span("lyft3d.predict", 1, 89),
    span("lyft3d.rotated_iou", 10, 30), launch(1, 15), device("sort", 1, 20, 60),
    span("lyft3d.nms", 40, 80), span("lyft3d.nms.step", 40, 50), span("lyft3d.nms.step", 50, 60),
    span("lyft3d.nms.step", 60, 70),
]


def us(x):
    return pytest.approx(x * 1e-6, abs=1e-12)


def test_summarize_reads_the_benchmarks_spans_as_before():
    s = tracing.summarize(stages.Replay(TRAIN), ("assign_targets",))
    assert s.window_s == us(1000) and s.busy_s == us(4 + 20 + 100 + 150 + 30 + 10)
    assert s.span_wall_s == {"assign_targets": us(285)} and s.span_count == {"assign_targets": 1}
    assert s.span_device_s == {"assign_targets": us(100)}
    assert dict(s.device_ops) == {"K3": us(150), "K2": us(100), "K1": us(50), "K4": us(50), "M": us(4)}
    # The program's spans are host calls too: the innermost open at a gap's
    # middle names the gap.
    assert dict(s.idle_gaps) == {"lyft3d.step": us(270), "lyft3d.optimizer": us(240), "aten::cat": us(140),
                                 "lyft3d.targets": us(30), "(no host call)": us(6)}
    without = tracing.summarize(stages.Replay([e for e in TRAIN if e not in PROGRAM]), ("assign_targets",))
    for name in ("window_s", "busy_s", "span_wall_s", "span_count", "span_device_s", "device_ops"):
        assert getattr(without, name) == getattr(s, name), name


def test_stages_by_span():
    st = stages.reduce(TRAIN)
    assert st.window_s == us(1000) and st.busy_s == us(314)
    assert st.count == {"lyft3d.step": 2, "lyft3d.targets": 1, "lyft3d.assign_targets": 1,
                        "lyft3d.optimizer": 1, "lyft3d.backward": 1}
    assert st.wall_s == {"lyft3d.step": us(920), "lyft3d.targets": us(375), "lyft3d.assign_targets": us(270),
                         "lyft3d.optimizer": us(200), "lyft3d.backward": us(200)}
    # K2 launches inside both steps and counts once; M and K4 launch outside
    # every span; K5 runs after the window.
    assert st.device_s == {"lyft3d.step": us(150), "lyft3d.targets": us(120), "lyft3d.assign_targets": us(100),
                           "lyft3d.optimizer": us(30), "lyft3d.backward": us(150)}
    assert st.launches == {"lyft3d.step": 3, "lyft3d.targets": 2, "lyft3d.assign_targets": 1,
                           "lyft3d.optimizer": 1, "lyft3d.backward": 1}
    # Every runtime call takes 2 µs; the synchronise at 970 lies outside every span.
    assert st.runtime_s == {"lyft3d.step": us(6), "lyft3d.targets": us(4), "lyft3d.assign_targets": us(2),
                            "lyft3d.optimizer": us(2), "lyft3d.backward": us(2)}
    # Gaps 0-6, 10-40, 60-200, 300-500, 650-720, 750-990; the backward's
    # thread is not the window's.
    assert st.idle_s == {"lyft3d.step": us(30 + 140 + 200 + 70 + 240), "lyft3d.targets": us(170),
                         "lyft3d.assign_targets": us(140), "lyft3d.optimizer": us(240)}


def test_readings_a_call_and_none_where_the_span_is_absent():
    train = stages.readings(stages.reduce(TRAIN), calls=2)
    assert train == {"nms_steps": None, "rotated_iou_ms": None, "optimizer_ms": pytest.approx(0.1),
                     "targets_idle_ms": pytest.approx(0.085), "targets_launches": 1.0}
    infer = stages.readings(stages.reduce(INFER), calls=1)
    assert infer == {"nms_steps": 3.0, "rotated_iou_ms": pytest.approx(0.04), "optimizer_ms": None,
                     "targets_idle_ms": None, "targets_launches": None}


def test_a_trace_without_a_window_is_refused():
    with pytest.raises(RuntimeError, match="no window"):
        stages.reduce([e for e in INFER if e["name"] != tracing.WINDOW])


@pytest.mark.parametrize("cell", ["tiny_pillars_infer", "tiny_pillars_train"])
def test_stages_runs_a_cell(bench_copy, cell):
    import torch

    out = io.StringIO()
    rc = stages.main(["--workload", cell, "--seed", "11", "--seconds", "0.2",
                      "--manifest", str(bench_copy.parent / "BENCHMARK.json")],
                     device=torch.device("cpu"), out=out, base=bench_copy)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] and line["traced_calls"] >= 1 and line["calls_per_s"] > 0
    r = line["readings"]
    if cell.endswith("infer"):
        assert r["nms_steps"] >= 1 and r["rotated_iou_ms"] == 0.0  # no device on the CPU
        assert r["optimizer_ms"] is None and r["targets_launches"] is None
        assert {"lyft3d.infer", "lyft3d.predict", "lyft3d.to_host"} <= set(line["by_span"])
        assert line["metrics"]["predict_ms.infer"] > 0
    else:
        assert r["optimizer_ms"] > 0 and r["targets_launches"] == 0 and r["targets_idle_ms"] is not None
        assert r["nms_steps"] is None
        assert line["by_span"]["lyft3d.step"]["count"] == 1.0
        assert line["metrics"]["targets_ms.train"] > 0
