"""The plain reference against the port's path on the CPU at small grids
(the port's own plain versions run there), and the comparison that decides
``correct``: the control (the reference one precision step down, in the
program's place) and each planted fault of the timed path come out not
correct."""

from __future__ import annotations

import time

import pytest

from conftest import run_cell
from h100bench import harness
from h100bench.reference.second import fake_bf16, fake_fp8

INFER = ["tiny_pillars_infer", "tiny_units_infer"]
TRAIN = ["tiny_pillars_train", "tiny_units_train"]


@pytest.mark.parametrize("cell", INFER + TRAIN)
def test_port_agrees_with_the_reference(bench_copy, cell):
    rc, result = run_cell(bench_copy, cell, seconds=0.1)
    assert rc == 0 and result["correct"], result
    checks = {k: v["value"] for k, v in result["checks"].items()}
    if cell in INFER:
        assert checks["maps_gap"] < 1e-4 and checks["detection_mismatches"] == 0
    else:  # float32 on both sides: Adam's first steps amplify round-off only in leaves of tiny gradient
        assert checks["grad_gap"] < 1e-2 and checks["step_gap"] < 5e-2


@pytest.mark.parametrize("cell", INFER + TRAIN)
def test_the_control_is_not_correct(bench_copy, cell):
    import torch

    manifest = harness.load_json(bench_copy.parent / "BENCHMARK.json")
    run = harness.context(manifest, cell, 11, torch.device("cpu"), None, bench_copy)
    checks, _, _ = harness.drive(run, 0.0, time.perf_counter(), quant=(fake_fp8, fake_bf16))
    assert not all(x.ok for x in checks), [(x.name, x.value, x.limit) for x in checks]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in INFER for f in ("half_batch", "altered_answer")]
                         + [(c, f) for c in TRAIN for f in ("half_batch", "half_loss", "unchanged_state")])
def test_a_fault_in_the_timed_path_is_not_correct(bench_copy, cell, fault):
    rc, result = run_cell(bench_copy, cell, seconds=0.1, fault=fault)
    assert rc == 0 and result["correct"] is False, result
