"""The port's device trial pool (kgcn_tpu_torch/tools/parallel_trials.py)
and its wiring into ``cli.opt --parallel-trials`` and ``tools/nas.search``,
on the CPU (the pool takes a device list; the CPU twice here, the card
twice in chip_smoke.py's phase 19).

* two trials at once give each trial's objective bitwise equal to the same
  trial run alone, and to the sequential objective (``cli.opt.run_trial``:
  ``cmd_train`` in process, the validation cost of the restored best
  epoch);
* ``cli.opt --parallel-trials 2 --trial-devices cpu,cpu``: two rounds of two
  trials, each value bitwise equal to ``run_trial`` of its parameters, the
  proposals ``kgcn_tpu``'s batch acquisition's (``optimize_parallel``);
* NAS with ``parallel=2`` scores its candidates in rounds of two.
"""
import json

import numpy as np
import pytest
import torch

from test_torch_tools import _ring_config

torch.set_num_threads(1)

PARAMS = [{"learning_rate": 0.01, "batch_size": 16}, {"learning_rate": 0.003, "batch_size": 8}]


@pytest.fixture
def base(tmp_path):
    from kgcn_tpu_torch.runtime.config import load_config

    cfg, dom = _ring_config(tmp_path)
    config = load_config(cfg)
    config.update(epoch=2, validation_data_rate=0.2, patience=0)
    return config, cfg, dom


def _pool(config, devices):
    from kgcn_tpu_torch.cli.main import _prepare
    from kgcn_tpu_torch.tools.parallel_trials import DeviceTrialPool

    ds, info, backend = _prepare(config)
    return DeviceTrialPool(config, ds, info, devices=devices, backend=backend)


def test_trials_at_once_equal_each_trial_alone(base):
    from kgcn_tpu_torch.cli.opt import run_trial

    config, _, _ = base
    together = _pool(config, ["cpu", "cpu"]).run_batch(PARAMS, log=lambda s: None)
    alone = [_pool(config, ["cpu"]).run_batch([p], log=lambda s: None)[0] for p in PARAMS]
    assert together == alone and np.isfinite(together).all()
    assert together == [run_trial(config, p, "cpu") for p in PARAMS]


def test_pool_refuses_more_trials_than_devices(base):
    config, _, _ = base
    with pytest.raises(ValueError, match="3 trials for 2 devices"):
        _pool(config, ["cpu", "cpu"]).run_batch(PARAMS + PARAMS[:1])


def test_cli_opt_parallel_trials(base, tmp_path, capsys):
    from kgcn_tpu.tools.hpo import Domain as JDomain
    from kgcn_tpu.tools.hpo import optimize_parallel as j_optimize_parallel
    from kgcn_tpu_torch.cli.opt import main as topt
    from kgcn_tpu_torch.cli.opt import run_trial

    config, cfg, dom = base
    with open(cfg, "w") as f:
        json.dump(config, f)
    topt(["--config", cfg, "--domain", dom, "--max-itr", "4", "--seed", "5",
          "--output-dir", str(tmp_path / "out"), "--cpu", "--parallel-trials", "2",
          "--trial-devices", "cpu,cpu"])
    assert "[opt] 2 trials per round, one per device" in capsys.readouterr().out
    hist = json.loads((tmp_path / "out" / "history.json").read_text())
    assert [h["iteration"] for h in hist] == [0, 1, 2, 3]
    for h in hist:
        assert h["value"] == run_trial(config, h["params"], "cpu")
    # kgcn_tpu's batch acquisition fed the same values proposes the same points
    values = iter([h["value"] for h in hist])
    want = j_optimize_parallel(lambda ps: [next(values) for _ in ps],
                               JDomain(json.loads(open(dom).read())), max_iter=4, batch=2,
                               seed=5, log=lambda s: None)[2]
    assert [h["params"] for h in hist] == [w["params"] for w in want]


def test_cli_opt_one_device_is_sequential(base, tmp_path, capsys):
    from kgcn_tpu_torch.cli.opt import maybe_pool

    config, _, _ = base
    assert maybe_pool(config, 2, ["cpu"]) is None
    assert "single device — sequential trials" in capsys.readouterr().out
    assert maybe_pool(config, 1, ["cpu", "cpu"]) is None
    assert maybe_pool(dict(config, device_resident=False), 2, ["cpu", "cpu"]) is None
    assert "not device-resident" in capsys.readouterr().out
    assert maybe_pool(config, 2, ["cpu", "cpu"]) is not None


def test_nas_parallel_candidates(tmp_path):
    from kgcn_tpu_torch.data.dataset import build_dataset, split_dataset
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset
    from kgcn_tpu_torch.tools import nas

    ds, info = build_dataset(make_ring_dataset(num_pairs=20, num_nodes=6, seed=0),
                             {"normalize_adj_flag": True})
    train, valid, _, _ = split_dataset(ds, 0.25, seed=0)
    logs = []
    best, value, hist = nas.search(train, valid, info, {"epoch": 1, "batch_size": 8},
                                   max_iter=2, parallel=2, device="cpu",
                                   devices=["cpu", "cpu"], log=logs.append)
    assert "[nas] 2 candidates per round, one per device" in logs
    assert len(hist) == 2 and all(np.isfinite(h["value"]) for h in hist)
    assert value == min(h["value"] for h in hist)
