#!/usr/bin/env python3
"""Readings that set the limits of the comparison: the numbers a cell
compares, over many seeds, for the program, for the control (the plain
reference put in the program's place one precision step down: float8 e4m3
operands in the trunk, bfloat16 in the heads), for a witness (the reference
in the program's own precision) and for the program with a planted fault.
All seeds of one cell run in one process.

    python3 h100bench/readings.py --workload <cell> --seeds 1 2 3 [--control-seeds 1 2 3]
        [--witness-seeds 1 2] [--fault <name> --fault-seeds 1 2 3] [--seconds 2] [--out file.jsonl]

Prints one JSON line a reading. The benchmark's own runs never run this.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from h100bench import harness  # noqa: E402
from h100bench.reference.second import fake_bf16, fake_fp8  # noqa: E402

CONTROL = (fake_fp8, fake_bf16)
# The reference in the program's own precision (bfloat16 trunk, float32
# heads): a witness of what that precision alone reads.
WITNESS = (fake_bf16, lambda x: x)


def reading(manifest, cell, seed, seconds, kind, fault=None):
    import torch

    run = harness.context(manifest, cell, seed, torch.device("cuda", 0), fault)
    checks, record, peak = harness.drive(run, seconds, time.perf_counter(),
                                         quant={"control": CONTROL, "witness": WITNESS}.get(kind))
    out = {"cell": cell, "seed": seed, "kind": kind, "fault": fault, "calls": len(record.calls),
           "setup_s": record.setup_s, "peak_bytes": peak, "numbers": {x.name: x.value for x in checks}, "details": record.details}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    jobs = [(s, "program", None) for s in args.seeds] + [(s, "control", None) for s in args.control_seeds]
    jobs += [(s, "witness", None) for s in args.witness_seeds]
    jobs += [(s, "fault", f) for f in args.fault for s in args.fault_seeds]
    sink = open(args.out, "a") if args.out else None
    for seed, kind, fault in jobs:
        r = reading(manifest, args.workload, seed, args.seconds, kind, fault)
        line = json.dumps(r)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
