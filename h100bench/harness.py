"""The benchmark's driver: one run of one cell.

Everything that belongs to a configuration, a traffic mix, a cell or a
metric is found by its name in ``BENCHMARK.json``:

- ``h100bench/configs/<config>.json``: the configuration as run (its
  ``family`` names the code that builds it);
- ``h100bench/traffic/<traffic>.json``: the mix's parameters (its
  ``generator`` names ``h100bench/generators/<generator>.py``);
- ``h100bench/workloads/<cell>.json``: the entry (``infer`` or ``train``),
  the calls the comparison samples and the comparison's limits;
- ``h100bench/families/<family>.py``: ``ENTRIES[entry]`` builds and drives
  the program and compares it with the plain reference;
- ``h100bench/metrics/<metric>.py``: ``read(run)`` gives the metric's value,
  or ``None`` where the run has nothing to read.

A run builds the cell (set-up), drives its entry for ``--seconds`` (the
window), reads the device's memory peak, frees the program's state and then
compares what the window produced with the reference. With ``--trace 1``
the window runs under ``torch.profiler`` with the spans of
:mod:`h100bench.tracing` and the result holds the per-layer metrics.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lyft3d_tpu")
# A traced run traces its window's first seconds (the profiler's export and
# its reduction take several times as long as what they cover).
TRACE_SECONDS = 10.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark by its file (names may hold dots)."""
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(f"h100bench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_generator(name: str, base: Path = HERE):
    return load_module(base / "generators" / f"{name}.py")


@dataclass
class Check:
    """One compared number and its limit (a run is correct where each is at
    most its limit)."""

    name: str
    value: float
    limit: float
    note: str = ""

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


@dataclass
class RunContext:
    """What a run is given: the cell's files, the seed, the device."""

    cell: str
    config: dict
    traffic: dict
    workload: dict
    seed: int
    device: Any
    fault: Optional[str] = None
    base: Path = HERE  # the benchmark's directory, where the cell's files lie


@dataclass
class RunRecord:
    """What the metric readers read."""

    cell: str
    setup_s: float
    calls: List[tuple] = field(default_factory=list)  # (start, end, items) on the host clock
    window_s: float = 0.0
    trace: Any = None  # tracing.TraceSummary of a traced window
    traced_calls: int = 0  # the calls inside it
    work: Dict[str, float] = field(default_factory=dict)  # the family's counts over the window
    details: Dict[str, Any] = field(default_factory=dict)  # the comparison's readings behind its numbers

    @property
    def items(self) -> int:
        return sum(c[2] for c in self.calls)


def cell_spec(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def metrics_for(manifest: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those that list it, or list no cells."""
    return [m for m in manifest[section] if cell in m.get("workloads", [cell])]


def context(manifest: dict, cell: str, seed: int, device, fault=None, base: Path = HERE) -> RunContext:
    spec = cell_spec(manifest, cell)
    config = load_json(base / "configs" / f"{spec['config']}.json")
    traffic = load_json(base / "traffic" / f"{spec['traffic']}.json")
    workload = load_json(base / "workloads" / f"{cell}.json")
    return RunContext(cell, config, traffic, workload, seed, device, fault, base)


def build(run: RunContext):
    family = load_module(run.base / "families" / f"{run.config['family']}.py")
    return family, family.ENTRIES[run.workload["entry"]](run)


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that the port's runs may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=10)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def window(cell, seconds: float, record: RunRecord, traced: Optional[Callable] = None):
    """Drive the entry until ``seconds`` have passed and it has made the calls
    its comparison samples; the window ends when the last call and the
    device's queue have finished. ``traced``: a context (the profiler's) that
    covers the window's first ``TRACE_SECONDS``, closed after a synchronise."""
    t0 = time.perf_counter()
    tracing = traced() if traced is not None else None
    if tracing is not None:
        tracing.__enter__()
    i = 0
    while True:
        ts = time.perf_counter()
        n = cell.call(i)
        te = time.perf_counter()
        record.calls.append((ts, te, n))
        i += 1
        if tracing is not None and te - t0 >= min(seconds, TRACE_SECONDS):
            cell.drain()
            tracing.__exit__(None, None, None)
            tracing, record.traced_calls = None, i
        if te - t0 >= seconds and i >= getattr(cell, "min_calls", 1):
            break
    cell.drain()
    record.window_s = time.perf_counter() - t0
    if tracing is not None:
        tracing.__exit__(None, None, None)
        record.traced_calls = i


@contextlib.contextmanager
def float32_exact():
    """float32 matrix products and convolutions without TF32 (the reference's
    precision); the program runs with PyTorch's defaults."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def drive(run: RunContext, seconds: float, started: float, trace: bool = False, quant=None):
    """Build and set up the cell, drive its window (none for the control,
    ``quant``: the reference one precision step down in the program's
    place), read the device's memory peak, free the program's state and
    compare with the reference. Returns ``(checks, record, peak bytes)``;
    the record holds the traced window's summary and work with ``trace``."""
    import torch

    on_card = run.device.type == "cuda"
    family, cell = build(run)
    cell.setup()
    if on_card:
        torch.cuda.synchronize()
    record = RunRecord(cell=run.cell, setup_s=time.perf_counter() - started)
    prof = None
    if trace:
        from h100bench import tracing

        spans = tracing.Spans()
        cell.install_spans(spans)
        prof = tracing.profile()

        @contextlib.contextmanager
        def traced():
            with prof, torch.profiler.record_function(tracing.WINDOW):
                yield

        window(cell, seconds, record, traced)
        spans.remove()
    elif quant is None:
        window(cell, seconds, record)
    peak = torch.cuda.max_memory_allocated(run.device) if on_card else 0
    if trace:
        record.trace = tracing.summarize(prof, cell.span_names)
        del prof
    cell.release()
    with float32_exact():
        checks = cell.check(len(record.calls), quant=quant)
        record.details = getattr(cell, "details", {})
        if trace:
            record.work = family.work(cell, record.traced_calls)
    return checks, record, peak


def _cache_dirs():
    """Kernel and build caches at fixed paths inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "h100bench" / sub)


def main(argv=None, started: Optional[float] = None, device=None, out=None, base: Path = HERE) -> int:
    """One run; returns the exit code. ``device``: ``None`` for the card (the
    run refuses without enough of them), or a ``torch.device`` to run on
    without looking for one (the CPU tests). ``base``: the directory of the
    cell's files (a copy of this one, in the tests)."""
    started = time.perf_counter() if started is None else started
    out = out or sys.stdout
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None, help="plant a fault in the timed path (tests of the comparison)")
    p.add_argument("--manifest", default=str(base.parent / "BENCHMARK.json"))
    args = p.parse_args(argv)
    _cache_dirs()

    import torch

    manifest = load_json(Path(args.manifest))
    spec = cell_spec(manifest, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
            print(f"the cell needs {spec['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    on_card = device.type == "cuda"

    run = context(manifest, args.workload, args.seed, device, args.fault, base)
    checks, record, peak = drive(run, args.seconds, started, trace=bool(args.trace))
    calls = len(record.calls)

    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in metrics_for(manifest, args.workload, section):
        value = load_module(base / "metrics" / f"{m['name']}.py").read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    bad = forbidden_loaded()
    if bad:
        print(f"the run's process holds modules it may not load: {', '.join(bad)}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    if on_card:
        dev["power_limit_w"] = power_limit()
    result = {"correct": all(c.ok for c in checks), "attempted": calls, "failed": 0, "metrics": metrics,
              "device": dev}
    if args.trace:
        t = record.trace
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = {"device_ops": [[n, s] for n, s in t.device_ops],
                               "idle_gaps": [[n, s] for n, s in t.idle_gaps]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}; {c.note}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
