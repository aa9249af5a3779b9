"""The registry finds every configuration, cell, family and metric by the
names ``BENCHMARK.json`` gives, and a cell added as files alone runs."""
from __future__ import annotations

import json
import math

import pytest

from portbench import bench, check
from portbench.registry import ROOT, Registry

BENCHMARK = json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def test_benchmark_names_resolve():
    reg = Registry()
    for c in BENCHMARK["configs"]:
        assert reg.config(c["name"])["family"]
        assert (ROOT.parent / c["file"]) == ROOT / "configs" / f"{c['name']}.json"
        reg.family(reg.config(c["name"])["family"]).Workload
    for w in BENCHMARK["workloads"]:
        cell = reg.cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert cell["limits"] and set(cell["limits"]) <= set(check.NUMBERS)
    used = set()
    for m in BENCHMARK["per_layer"]:
        mod = reg.metric(m["name"])
        assert mod.UNIT == m["unit"] and callable(mod.read)
        used.add(mod.__file__)
    # every reader is some metric's, and each names the rate it moves
    assert used == {str(p) for p in (ROOT / "metrics").glob("*.py")}
    assert reg.per_layer() == {m["name"]: m["moves"] for m in BENCHMARK["per_layer"]}
    assert reg.metric("idle_share.kg") is reg.metric("idle_share.rxn")


def test_unknown_names_refused():
    reg = Registry()
    with pytest.raises(KeyError):
        reg.cell("no-such-cell")
    with pytest.raises(ValueError):
        reg.config("../configs/rxn-sparsegcn")


@pytest.mark.parametrize("cell", ["rxn-tiny", "kg-tiny-float32", "kg-tiny-bfloat16"])
def test_a_cell_added_as_files_runs(tiny, cell):
    import time

    r = bench.run_cell(cell, 2**31 + 12345, 0.5, False, "cpu", time.perf_counter(),
                       registry=tiny, log=lambda msg: None)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    rate = "graphs_per_s" if cell.startswith("rxn") else "triples_per_s"
    assert set(r["metrics"]) == {rate, "peak_mem_gib", "setup_s"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for k, m in r["metrics"].items() if k != "peak_mem_gib")
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
