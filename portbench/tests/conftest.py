"""Test set-up of the benchmark's own tests (``python -m pytest
portbench/tests``): the ``card`` marker for tests that need a CUDA card
(they skip elsewhere; the decision is made in the ``card`` fixture, never
while a module is imported), and ``tiny``, a registry whose cells are the
benchmark's configurations cut to a size the CPU runs in seconds."""
from __future__ import annotations

import json
import shutil

import pytest

from portbench.registry import ROOT, Registry

# set from the tiny cells' readings on the CPU (three seeds a cell): the
# program reads loss1 0, grad_median ≤ 2e-7 and delta_median ≤ 2e-6; the
# TF32 control reads loss1 ≥ 3.7e-6 and grad_median ≥ 4.8e-5
LIMITS = {"loss1": 1e-6, "grad_median": 1e-5, "delta_median": 1e-3}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def write_tiny(root):
    """Tiny copies of the configurations and one cell each, beside copies
    of the families and metrics: a Registry over ``root``."""
    for sub in ("families", "metrics"):
        shutil.copytree(ROOT / sub, root / sub)
    (root / "configs").mkdir()
    (root / "cells").mkdir()
    rx = json.loads((ROOT / "configs" / "rxn-sparsegcn.json").read_text())
    rx["program"].update(num_classes=60, batch_size=8, out_dims=[16, 16], dense_dim=16)
    (root / "configs" / "rxn-tiny.json").write_text(json.dumps(rx))
    kg = json.loads((ROOT / "configs" / "kg-distmult-gcn.json").read_text())
    kg["program"].update(embedding_dim=8, label_batch_size=64)
    kg["data"].update(entities=300, triples=900, relation_triples=[5, 3, 2])
    (root / "configs" / "kg-tiny.json").write_text(json.dumps(kg))
    cells = {"rxn-tiny": {"config": "rxn-tiny", "traffic": "tiny", "chips": 1,
                          "mix": {"graphs": 64, "min_atoms": 6, "max_atoms": 30},
                          "settings": {}, "limits": LIMITS}}
    for payload in ("bfloat16", "float32"):
        cells[f"kg-tiny-{payload}"] = {
            "config": "kg-tiny", "traffic": payload, "chips": 1,
            "mix": {"pair_mode": "both"}, "settings": {"tiled_compute_dtype": payload},
            "limits": LIMITS}
    for name, cell in cells.items():
        (root / "cells" / f"{name}.json").write_text(json.dumps(cell))
    return Registry(root)


@pytest.fixture
def tiny(tmp_path):
    import torch

    torch.set_num_threads(2)
    return write_tiny(tmp_path)
