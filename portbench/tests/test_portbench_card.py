"""On the card (skipped elsewhere): a short run of a cell comes out correct,
and at the cell's own size the program's first epoch passes the cell's
limits while the TF32 control and the planted faults fail them."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import calibrate, check
from portbench.registry import ROOT, Registry

pytestmark = pytest.mark.card


def test_a_short_run_is_correct(card):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "rxn-b128-druglike", "--seed", "4242", "--seconds", "2",
                          "--trace", "0"], cwd=ROOT.parent, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", ["rxn-b128-druglike", "kg-wn18rr-bf16"])
def test_control_and_faults_fail_at_the_cells_size(card, cell):
    limits = Registry().cell(cell)["limits"]
    r = calibrate.readings(cell, 8080, card)
    assert r["rows_ok"] and check.verdict(r["program"], limits), r["program"]
    for kind in ("control", "half_batch", "state_unchanged"):
        assert not check.verdict(r[kind], limits), (kind, r[kind])
