"""Nothing of the benchmark imports JAX or the JAX package, the reference
imports nothing of the program, and a run without a card refuses."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from portbench.registry import ROOT
from portbench.run import BANNED, banned_modules


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in ROOT.rglob("*.py"):
        assert not banned_modules(_imports(path)), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "kgcn_tpu_torch" not in tops, path
        assert tops <= {"__future__", "contextlib", "math", "typing", "numpy", "torch",
                        "portbench"}, (path, tops)


def test_whole_top_level_names():
    assert banned_modules(["kgcn_tpu_torch.models.kg", "jaxtyping", "numpy"]) == []
    assert banned_modules(["kgcn_tpu.ops", "jax.numpy", "flax"]) == ["flax", "jax", "kgcn_tpu"]
    assert set(BANNED) >= {"jax", "jaxlib", "flax", "kgcn_tpu"}


def _python(code, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import json, sys, time
sys.path.insert(0, {str(ROOT / 'tests')!r})
from pathlib import Path
from conftest import write_tiny
from portbench import bench
from portbench.run import banned_modules
reg = write_tiny(Path({str(tmp_path)!r}))
for cell in ("rxn-tiny", "kg-tiny-bfloat16"):
    bench.run_cell(cell, 5, 0.2, False, "cpu", time.perf_counter(), registry=reg,
                   log=lambda m: None)
print(json.dumps(banned_modules(sys.modules)))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "rxn-b128-druglike", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT.parent, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
