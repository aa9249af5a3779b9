"""The port's tools against kgcn_tpu's (CPU):

* ``tools/hpo``: ``optimize`` and ``optimize_parallel`` over a seeded NumPy
  objective give histories bitwise equal to ``kgcn_tpu.tools.hpo``'s;
* ``cli.opt --cpu`` (the port's trainer in process) on a 6-node ring
  dataset, 4 trials: the 3 random bootstrap points are ``kgcn_tpu``'s, and
  ``kgcn_tpu``'s ``GPOptimizer`` fed the port's 3 values suggests the
  port's 4th point; the output files carry ``kgcn_tpu``'s keys; the
  config's ``"param"`` reaches ``info.param``;
* ``tools/nas``: ``SearchedGCN`` on weights carried over from the flax
  model (each activation, with and without BN, 0 and 2 dense layers):
  predictions and cost within 1e-5, eval and train mode; ``search`` on
  the CPU proposes ``kgcn_tpu``'s candidates and scores them finitely;
* ``runtime/timing.slope_time`` on a fake clock gives the exact slope, as
  ``kgcn_tpu``'s does.
"""
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.data.synthetic import make_ring_dataset

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
DOMAIN = [
    {"name": "learning_rate", "type": "continuous", "domain": [1e-4, 3e-2]},
    {"name": "batch_size", "type": "discrete", "domain": [8, 16, 32], "data_type": "int"},
    {"name": "dropout_rate", "type": "continuous", "domain": [0.0, 0.5]},
]


def _objective(params):
    """A seeded bumpy NumPy function of the params, inf at one corner (the
    GP clamps non-finite values)."""
    lr, bs, dr = params["learning_rate"], params["batch_size"], params["dropout_rate"]
    if dr > 0.45:
        return float("inf")
    return float(np.sin(40 * lr) + 0.01 * bs + (dr - 0.2) ** 2 + np.cos(7 * lr * bs))


def test_optimize_histories_equal_kgcn_tpu():
    from kgcn_tpu.tools import hpo as jhpo
    from kgcn_tpu_torch.tools import hpo

    for seed in (0, 7):
        got = hpo.optimize(_objective, hpo.Domain(DOMAIN), max_iter=9, seed=seed,
                           log=lambda s: None)
        want = jhpo.optimize(_objective, jhpo.Domain(DOMAIN), max_iter=9, seed=seed,
                             log=lambda s: None)
        assert got == want


def test_optimize_parallel_histories_equal_kgcn_tpu():
    from kgcn_tpu.tools import hpo as jhpo
    from kgcn_tpu_torch.tools import hpo

    def batch(ps):
        return [_objective(p) for p in ps]

    got = hpo.optimize_parallel(batch, hpo.Domain(DOMAIN), max_iter=10, batch=3,
                                seed=5, log=lambda s: None)
    want = jhpo.optimize_parallel(batch, jhpo.Domain(DOMAIN), max_iter=10, batch=3,
                                  seed=5, log=lambda s: None)
    assert got == want


def _ring_config(tmp_path):
    data = make_ring_dataset(num_pairs=30, num_nodes=6, seed=0)
    with open(tmp_path / "ring6.jbl", "wb") as f:
        pickle.dump(data, f)
    with open(os.path.join(REPO, "example_config", "synth.json")) as f:
        cfg = json.load(f)
    cfg.update(dataset=str(tmp_path / "ring6.jbl"), epoch=1, save_interval=0,
               model_path=str(tmp_path / "model"), save_model_path=str(tmp_path / "model"),
               plot_path=str(tmp_path / "result"))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    dom = tmp_path / "domain.json"
    dom.write_text(json.dumps(DOMAIN[:2]))
    return str(path), str(dom)


def test_cli_opt_follows_kgcn_tpu(tmp_path, monkeypatch):
    from kgcn_tpu.cli import main as jmain
    from kgcn_tpu.cli.opt import main as jopt
    from kgcn_tpu.tools.hpo import Domain, GPOptimizer
    from kgcn_tpu_torch.cli import main as tmain
    from kgcn_tpu_torch.cli.opt import main as topt

    cfg, dom = _ring_config(tmp_path)
    seen = []
    prepare = tmain._prepare

    def spy(config, *a, **k):
        out = prepare(config, *a, **k)
        seen.append(out[1].param)
        return out

    monkeypatch.setattr(tmain, "_prepare", spy)
    monkeypatch.chdir(tmp_path)
    topt(["--config", cfg, "--domain", dom, "--max-itr", "4", "--seed", "11",
          "--output-dir", str(tmp_path / "port"), "--cpu", "--parallel-trials", "2"])
    hist = json.loads((tmp_path / "port" / "history.json").read_text())
    assert [h["iteration"] for h in hist] == [0, 1, 2, 3]
    assert all(np.isfinite(h["value"]) for h in hist)
    assert seen and all(p == h["params"] for p, h in zip(seen, hist))

    domain = Domain(json.loads(open(dom).read()))
    opt = GPOptimizer(domain, seed=11)
    for h in hist[:3]:
        u = opt.suggest()
        assert domain.decode(u) == h["params"]
        opt.observe(u, h["value"])
    assert domain.decode(opt.suggest()) == hist[3]["params"]

    # kgcn_tpu's own files, its trials stubbed: the same keys
    monkeypatch.setattr(jmain, "cmd_train", lambda config: {"validation_cost": 1.0})
    jopt(["--config", cfg, "--domain", dom, "--max-itr", "4", "--seed", "11",
          "--output-dir", str(tmp_path / "jax"), "--cpu"])
    for name in ("best_param.json", "best_config.json", "history.json"):
        a = json.loads((tmp_path / "port" / name).read_text())
        b = json.loads((tmp_path / "jax" / name).read_text())
        if isinstance(a, list):
            assert [sorted(x) for x in a] == [sorted(x) for x in b]
        else:
            assert sorted(a) == sorted(b)
    best = json.loads((tmp_path / "port" / "best_param.json").read_text())
    assert best == min(hist, key=lambda h: h["value"])["params"]


def test_a_failing_trial_scores_inf(tmp_path, capsys):
    from kgcn_tpu_torch.cli.opt import run_trial

    cfg, _ = _ring_config(tmp_path)
    config = json.loads(open(cfg).read())
    config["model.py"] = "no_such_model"
    assert run_trial(config, {"learning_rate": 0.01}, "cpu") == float("inf")
    assert "trial failed" in capsys.readouterr().out


ARCHS = [(1, 16, 0, 0, 0), (2, 32, 1, 1, 2), (3, 50, 2, 0, 2), (2, 16, 2, 1, 0),
         (4, 64, 1, 0, 1)]


@pytest.mark.parametrize("arch", ARCHS)
def test_searched_gcn_matches_flax(arch):
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu.data import build_dataset as j_build
    from kgcn_tpu.tools.nas import SearchedGCN as JSearched
    from kgcn_tpu_torch.convert import params_from_jax
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.tools.nas import NAS_DOMAIN, build_from_params

    data = make_ring_dataset(num_pairs=8, num_nodes=6, seed=2)
    jds, jinfo = j_build(dict(data), {})
    ds, info = build_dataset(dict(data), {})
    jbatch = JBatcher(jds, jinfo, 8).make_batch(np.arange(8))
    batch = Batcher(ds, info, 8).make_batch(np.arange(8))
    jmodel = JSearched(channels=jinfo.adj_channel_num, label_dim=2, arch=arch)
    variables = jmodel.init(jax.random.PRNGKey(sum(arch)), jbatch)
    stats = variables.get("batch_stats", {})
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32) * 0.3 + 0.1,
        jax.device_get(stats))
    names = [d["name"] for d in NAS_DOMAIN]
    params = dict(zip(names, list(arch) + [0.01]))
    model = build_from_params(params, info)
    tree = params_from_jax(jax.device_get(variables["params"]), stats, model)
    model.load_state_dict({**tree["params"], **tree["batch_stats"]})
    for train in (False, True):
        jv = {"params": variables["params"], **({"batch_stats": stats} if stats else {})}
        if train and stats:
            jout, _ = jmodel.apply(jv, jbatch, train=True, mutable=["batch_stats"])
        else:
            jout = jmodel.apply(jv, jbatch, train=train)
        with torch.no_grad():
            out = model(batch, train=train)
        np.testing.assert_allclose(out.prediction.numpy(), np.asarray(jout.prediction), **TOL)
        np.testing.assert_allclose(float(out.cost_opt), float(jout.cost_opt), **TOL)
        np.testing.assert_allclose(float(out.cost_sum), float(jout.cost_sum), **TOL)


def test_nas_search_on_the_cpu():
    from kgcn_tpu.tools.hpo import Domain as JDomain
    from kgcn_tpu.tools.hpo import GPOptimizer
    from kgcn_tpu_torch.data.dataset import build_dataset, split_dataset
    from kgcn_tpu_torch.tools import nas

    data = make_ring_dataset(num_pairs=16, num_nodes=6, seed=3)
    ds, info = build_dataset(dict(data), {})
    train, valid, _, _ = split_dataset(ds, 0.25, seed=0)
    best, value, hist = nas.search(train, valid, info, {"epoch": 1, "batch_size": 8},
                                   max_iter=3, seed=4, log=lambda s: None,
                                   parallel=2, device="cpu")
    assert len(hist) == 3 and all(np.isfinite(h["value"]) for h in hist)
    assert value == min(h["value"] for h in hist) and best in [h["params"] for h in hist]
    opt = GPOptimizer(JDomain(nas.NAS_DOMAIN), seed=4)
    assert [h["params"] for h in hist] == [JDomain(nas.NAS_DOMAIN).decode(opt.suggest())
                                           for _ in range(3)]


def test_slope_time_on_a_fake_clock(monkeypatch):
    """``looped(x, n)`` advances a fake ``perf_counter`` by a fixed cost
    plus ``n`` steps (dyadic numbers, so every sum is exact): the slope is
    the step, here and in ``kgcn_tpu``."""
    import time

    from kgcn_tpu.runtime import timing as jtiming
    from kgcn_tpu_torch.runtime import timing

    step, fixed = 2.0 ** -13, 2.0 ** -8
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])

    def looped(x, n):
        clock[0] += fixed + n * step
        return x + n

    assert timing.slope_time(looped, (torch.zeros(3),), 64) == step
    assert jtiming.slope_time(looped, (np.zeros(3),), 64) == step
    monkeypatch.undo()
    calls = []
    timing.force((torch.arange(4.0).reshape(2, 2), None))
    assert timing.chain_time(lambda x: calls.append(1) or x * 1.0, torch.ones(4), iters=8) > 0
    assert calls


def test_captures_share_one_stream(monkeypatch):
    """Every capture on a device runs on one side stream (cuBLAS keeps a
    workspace for each stream it has run on, for the life of the process:
    a stream a capture grew the device memory of a search trial after
    trial)."""
    from kgcn_tpu_torch.runtime import runner

    made = []

    class Stream:
        def __init__(self, device):
            made.append(device)

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(runner, "_CAPTURE_STREAMS", {})
    a = runner.capture_stream(torch.device("cuda:0"))
    b = runner.capture_stream(torch.device("cuda:0"))
    c = runner.capture_stream(torch.device("cuda:1"))
    assert a is b and a is not c and made == [torch.device("cuda:0"), torch.device("cuda:1")]
