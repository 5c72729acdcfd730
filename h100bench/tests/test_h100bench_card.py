"""On the card, at each cell's own size: the program's runs are correct on
fresh seeds, the control (the reference one precision step down, in the
program's place) and the planted faults are not. Each needs a card and
skips inside the test where there is none.

    python3 -m pytest h100bench/tests -m cuda -q
"""

from __future__ import annotations

import json

import pytest

from conftest import BENCH
from h100bench import harness
from h100bench.reference.second import fake_bf16, fake_fp8

CELLS = [w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]
FAULTS = {"infer": ("half_batch", "altered_answer"), "train": ("half_batch", "half_loss", "unchanged_state")}


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _checks(cell, seed, fault=None, control=False, seconds=2.0):
    import time

    import torch

    manifest = harness.load_json(BENCH.parent / "BENCHMARK.json")
    run = harness.context(manifest, cell, seed, _card(), fault)
    checks, _, _ = harness.drive(run, seconds, time.perf_counter(), quant=(fake_fp8, fake_bf16) if control else None)
    torch.cuda.empty_cache()
    return checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_control_and_faults_on_the_card(cell):
    entry = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())["entry"]
    program = _checks(cell, 4100000001)
    assert all(x.ok for x in program), [(x.name, x.value, x.limit) for x in program]
    control = _checks(cell, 4100000002, control=True)
    assert not all(x.ok for x in control), [(x.name, x.value, x.limit) for x in control]
    for fault in FAULTS[entry]:
        got = _checks(cell, 4100000003, fault=fault)
        assert not all(x.ok for x in got), (fault, [(x.name, x.value, x.limit) for x in got])
