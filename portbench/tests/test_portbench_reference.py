"""The plain reference against the port at tiny sizes on the CPU, its
control (the reference in TF32 in the program's place), and runs with the
timed path broken underneath, which the comparison has to fail."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import bench, check
from portbench.reference import common
from portbench.reference.common import full_float32

CELLS = ["rxn-tiny", "kg-tiny-float32", "kg-tiny-bfloat16"]


def _first(reg, cell_name, seed):
    cell = reg.cell(cell_name)
    config = reg.config(cell["config"])
    wl = reg.family(config["family"]).Workload(config, cell, seed, "cpu")
    wl.build()
    return wl, bench.first_epoch(wl)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(tiny, cell):
    for seed in (0, 2**31 + 7):
        wl, first = _first(tiny, cell, seed)
        assert not wl.check_rows(first["rows"])
        with full_float32():
            ref = wl.reference(first["rows"])
            control = wl.reference(first["rows"], precision="tf32")
        got, ctl = check.numbers(first, ref), check.numbers(control, ref)
        assert check.verdict(got, tiny.cell(cell)["limits"]), got
        # float32 against float32 reads orders of magnitude below TF32
        assert got["grad_median"] < 1e-6 and ctl["grad_median"] > 100 * got["grad_median"], (got, ctl)
        assert not check.verdict(ctl, tiny.cell(cell)["limits"]), ctl


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0 - 2**-12, 2**-20])
    want = torch.tensor([1.0, 1.0, 1.0 + 2**-9, -3.0, 2**-20])
    assert torch.equal(common.round_tf32(x), want)


def test_bf16_payload_gradient_rounds_dy():
    """The bf16 aggregation's input gradient rounds dy's rows before the
    sum (the port's dx pass), not the summed gradient."""
    x = torch.randn(4, 3, requires_grad=True)
    row, col = torch.tensor([0, 1, 1]), torch.tensor([2, 2, 3])
    w = torch.tensor([0.5, 1.0, 0.25])
    dy = torch.randn(2, 3, dtype=torch.float64).float()
    common.aggregate(x, row, col, w, 2, "bfloat16").backward(dy)
    want = torch.zeros(4, 3).index_add_(0, col, common.round_bf16(dy)[row]
                                        * common.round_bf16(w)[:, None])
    assert torch.equal(x.grad, want)


def _broken_run(reg, cell, monkeypatch, fault):
    from kgcn_tpu_torch.runtime import optim
    from kgcn_tpu_torch.runtime.train import Trainer

    if fault == "state unchanged":
        real = optim.make_optimizer

        def frozen(config, *a, **k):
            tx = real(config, *a, **k)
            return optim.Transform(
                tx.init, lambda g, s, p: ({k: torch.zeros_like(v) for k, v in g.items()}, s),
                width=tx.width, table=tx.table, advance=tx.advance,
                update_row=lambda g, s, p, row: ({k: torch.zeros_like(v)
                                                  for k, v in g.items()}, s))
        monkeypatch.setattr("kgcn_tpu_torch.runtime.train.make_optimizer", frozen)
    else:  # half of the batch left out, the mean taken over the rest
        apply = Trainer.apply

        def halved(self, params, stats, batch, **kw):
            if batch.label_valid is not None:
                lv = batch.label_valid.clone()
                lv[:, lv.shape[1] // 2:] = 0
                batch = batch.replace(label_valid=lv)
            else:
                pm = batch.pad_mask.clone()
                pm[pm.shape[0] // 2:] = 0
                batch = batch.replace(pad_mask=pm)
            return apply(self, params, stats, batch, **kw)
        monkeypatch.setattr(Trainer, "apply", halved)
    return bench.run_cell(cell, 31337, 0.2, False, "cpu", time.perf_counter(),
                          registry=reg, log=lambda msg: None)


@pytest.mark.parametrize("fault", ["state unchanged", "half batch"])
@pytest.mark.parametrize("cell", ["rxn-tiny", "kg-tiny-bfloat16"])
def test_a_broken_step_is_not_correct(tiny, cell, fault, monkeypatch):
    r = _broken_run(tiny, cell, monkeypatch, fault)
    assert r["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"] for c in r["checks"].values())
