"""What the benchmark's processes load: no module of JAX, of flax or of the
JAX package (``lyft3d_tpu``), compared by whole top-level names (the port's
``lyft3d_tpu_torch`` begins with the JAX package's name); the plain
reference also nothing of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "lyft3d_tpu"}


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=BENCH.parent, timeout=900, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import sys
sys.path.insert(0, {str(BENCH / 'tests')!r})
import shutil
from pathlib import Path
import conftest
base = Path({str(tmp_path)!r}) / "h100bench"
shutil.copytree(conftest.BENCH, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
shutil.copy(conftest.BENCH.parent / "BENCHMARK.json", base.parent / "BENCHMARK.json")
conftest.small_files(base)
rc, result = conftest.run_cell(base, "tiny_units_train", seconds=0.1)
assert rc == 0 and result["correct"], result
"""
    loaded = _loaded_after(code)
    assert "lyft3d_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_the_reference_loads_neither_jax_nor_the_port():
    loaded = _loaded_after("import h100bench.reference.second")
    assert not loaded & (FORBIDDEN | {"lyft3d_tpu_torch"})


def test_the_reference_sources_import_neither():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"lyft3d_tpu_torch"}, (path.name, n)


def test_the_harness_refuses_without_a_card_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        return  # on the card the harness runs; the refusal is for machines without one
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", "pillars_infer_lidar", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=BENCH.parent,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
