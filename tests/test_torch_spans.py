"""The port's spans (``runtime/spans.py``) in a ``torch.profiler`` trace, on
the CPU, where the runners run eagerly: a resident training epoch, a
scanned (KG) epoch and a resident evaluation through ``Trainer`` each hold
their per-epoch spans once and in order, the replay span holds the steps'
work, the number of spans does not grow with the steps of an epoch, and a
recording profiler changes no parameter's bits."""
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {"task": "classification", "normalize_adj_flag": True, "learning_rate": 0.01,
       "dropout_rate": 0.0}
TRAIN = ["kgcn.data.epoch_inputs", "kgcn.train.table", "kgcn.train.load",
         "kgcn.train.replay", "kgcn.train.unload", "kgcn.train.read_back"]
EVAL = ["kgcn.data.epoch_inputs", "kgcn.eval.load", "kgcn.eval.replay",
        "kgcn.eval.read_back"]
# a step's products and backward: they run only inside the replay span
STEP_WORK = ("autograd::engine::evaluate_function", "aten::mm", "aten::bmm",
             "aten::matmul")


def _trainer(model, info, cfg):
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.train import Trainer

    return Trainer(build_model(model, info, cfg), cfg, info, device="cpu")


def _ring(n_graphs, batch_size=10):
    """A trainer and a resident batcher over ``n_graphs`` ring graphs."""
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset
    from kgcn_tpu_torch.runtime.backend import Backend
    from kgcn_tpu_torch.runtime.resident import ResidentBatcher

    ds, info = build_dataset(make_ring_dataset(num_pairs=n_graphs // 2, num_nodes=6,
                                               seed=0), CFG)
    rb = ResidentBatcher(ds, info, batch_size, seed=3, backend=Backend("dense"))
    return _trainer("gcn", info, CFG), rb


def _kg():
    """A trainer and a scanned KG batcher (50 entities, 4 label slices)."""
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.data.synthetic import make_kg_dataset
    from kgcn_tpu_torch.models.kg import KGBatcher
    from kgcn_tpu_torch.runtime.backend import resolve
    from kgcn_tpu_torch.runtime.config import default_config

    cfg = default_config()
    with open(os.path.join(REPO, "example_config", "kg.json")) as f:
        cfg.update(json.load(f))
    data = make_kg_dataset(num_entities=50, num_relations=2, seed=0)
    ds, info = build_dataset(data, cfg)
    kb = KGBatcher(ds, info, label_batch_size=16, seed=0,
                   backend=resolve(cfg, info, log=False))
    return _trainer("kg_distmult", info, cfg), kb


def _profiled(fn):
    """``fn()``'s result and the (name, start ns, end ns) of every host
    event the profiler recorded while it ran, in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name(), int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()))
              for e in prof.profiler.kineto_results.events()]
    return out, sorted(events, key=lambda e: e[1])


def _spans(events):
    return [e for e in events if e[0].startswith("kgcn.")]


def _assert_in_order(events, names):
    """``events``' spans are ``names`` once each, one after another, and
    the step's work lies inside the replay span and nowhere else."""
    spans = _spans(events)
    assert [s[0] for s in spans] == names
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))
    replay = next(s for s in spans if s[0].endswith(".replay"))
    work = [e for e in events if e[0].startswith(STEP_WORK)]
    assert work and all(replay[1] <= e[1] and e[2] <= replay[2] for e in work)


def _epoch(trainer, batcher):
    state = trainer.init_state(0)
    return lambda: trainer.run_epoch(state, batcher, epoch=1)[0]


@pytest.mark.parametrize("data", ["resident", "scanned"])
def test_a_training_epoch_holds_its_spans_in_order(data):
    trainer, batcher = _ring(40) if data == "resident" else _kg()
    _epoch(trainer, batcher)()  # the runner made, its libraries loaded
    _, events = _profiled(_epoch(trainer, batcher))
    _assert_in_order(events, TRAIN)


def test_a_resident_evaluation_holds_its_spans_in_order():
    trainer, rb = _ring(40)
    state = trainer.init_state(0)
    trainer.evaluate(state, rb)
    _, events = _profiled(lambda: trainer.evaluate(state, rb))
    _assert_in_order(events, EVAL)


def test_no_span_runs_once_a_step():
    """Epochs of 2 and of 8 steps hold the same spans."""
    counts = []
    for n_graphs, steps in ((20, 2), (80, 8)):
        trainer, rb = _ring(n_graphs)
        _epoch(trainer, rb)()
        (_, _, metrics, _), events = _profiled(
            lambda: trainer.run_epoch(trainer.init_state(0), rb, epoch=1))
        assert len(metrics) == steps
        counts.append(len(_spans(events)))
    assert counts == [len(TRAIN)] * 2


@pytest.mark.parametrize("data", ["resident", "scanned"])
def test_a_recording_profiler_changes_no_bit(data):
    """The same first epoch (a trainer and a batcher each, made alike, as
    a KG batcher draws its negatives anew each epoch) without and with a
    recording profiler."""
    make = (lambda: _ring(40)) if data == "resident" else _kg
    plain = _epoch(*make())()
    traced, events = _profiled(_epoch(*make()))
    assert _spans(events)
    assert plain.params.keys() == traced.params.keys()
    for k in plain.params:
        assert torch.equal(plain.params[k], traced.params[k]), k
