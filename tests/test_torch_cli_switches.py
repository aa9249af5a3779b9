"""The switches of ``kgcn_tpu``'s ``main()`` in the port's ``cli.main``
(``kgcn_tpu/cli/main.py:681-716``), each shown to take effect on the CPU:
``--save-config``, ``--profile`` (and the ``profile`` / ``profile_dir``
keys), ``debug_nan`` and ``deterministic``."""
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(tmp, **over):
    with open(os.path.join(REPO, "example_config", "gat.json")) as f:
        cfg = json.load(f)
    cfg.update({"dataset": os.path.join(REPO, cfg["dataset"]), "epoch": 1,
                "save_model_path": str(tmp / "model")}, **over)
    path = tmp / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_save_config_writes_the_merged_config(tmp_path):
    from kgcn_tpu.runtime.config import load_config as j_load
    from kgcn_tpu_torch.cli.main import main as t_main

    path = _config(tmp_path)
    t_main(["train", "--config", path, "--cpu", "--epoch", "1", "--seed", "7",
            "--save-config", str(tmp_path / "saved.json")])
    with open(tmp_path / "saved.json") as f:
        saved = json.load(f)
    assert saved["seed"] == 7 and saved["epoch"] == 1
    assert saved["dataset"].endswith("synthetic.jbl")
    # the same keys and values kgcn_tpu's load_config merges
    assert saved == json.loads(json.dumps(j_load(path, {"epoch": 1, "seed": 7}),
                                          default=str))


@pytest.mark.parametrize("how", ["flag", "keys"])
def test_profile_writes_a_trace(tmp_path, capsys, how):
    from kgcn_tpu_torch.cli.main import main as t_main

    prof_dir = tmp_path / "trace"
    if how == "flag":
        path, argv = _config(tmp_path, profile_dir=str(prof_dir)), ["--profile"]
    else:
        path, argv = _config(tmp_path, profile=True, profile_dir=str(prof_dir)), []
    t_main(["train", "--config", path, "--cpu"] + argv)
    out = capsys.readouterr().out
    assert f"[PROFILE] tracing to {prof_dir}" in out
    assert f"[PROFILE] trace written to {prof_dir}" in out
    with open(prof_dir / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)


def test_profile_trace_holds_the_runner_spans(tmp_path):
    """A resident fit's ``--profile`` trace holds the port's per-epoch
    spans (``runtime/spans.py``)."""
    from kgcn_tpu_torch.cli.main import main as t_main

    prof_dir = tmp_path / "trace"
    path = _config(tmp_path, profile_dir=str(prof_dir), device_resident=True)
    t_main(["train", "--config", path, "--cpu", "--profile"])
    with open(prof_dir / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"kgcn.data.epoch_inputs", "kgcn.train.replay", "kgcn.train.read_back",
            "kgcn.eval.replay"} <= names


def test_debug_nan_stops_at_the_first_non_finite_step(tmp_path, capsys):
    """A learning rate that blows the weights up: without ``debug_nan`` the
    fit runs its epoch and aborts on the non-finite cost; with it the first
    non-finite cost or gradient raises ``FloatingPointError``, on the
    streaming loop and on the resident runner alike."""
    from kgcn_tpu_torch.cli.main import main as t_main

    over = dict(learning_rate=1e30, optimizer="sgd", epoch=2, validation_data_rate=0.0)
    t_main(["train", "--config", _config(tmp_path, **over), "--cpu"])
    assert "[abort] non-finite training cost" in capsys.readouterr().out
    for resident in (False, True):
        path = _config(tmp_path, debug_nan=True, device_resident=resident, **over)
        with pytest.raises(FloatingPointError, match="debug_nan: non-finite"):
            t_main(["train", "--config", path, "--cpu"])


def test_debug_nan_turns_the_capture_off():
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.train import Trainer

    _, info = build_dataset(make_ring_dataset(num_pairs=4, num_nodes=6, seed=0), {})
    trainer = Trainer(build_model("gin", info, {}), {"debug_nan": True}, info, device="cpu")
    assert trainer.debug_nan and not trainer.capture
    g = {"w": torch.tensor([1.0, np.inf])}
    with pytest.raises(FloatingPointError, match="gradient of w"):
        trainer.check_finite(torch.tensor(1.0), g)
    with pytest.raises(FloatingPointError, match="cost"):
        trainer.check_finite(torch.tensor(np.nan), {"w": torch.zeros(2)})


def test_deterministic_turns_on_deterministic_algorithms(tmp_path, monkeypatch):
    from kgcn_tpu_torch.cli.main import main as t_main

    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)  # restored after
    assert not torch.are_deterministic_algorithms_enabled()
    try:
        t_main(["train", "--config", _config(tmp_path, deterministic=True), "--cpu"])
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == ":4096:8"
    finally:
        torch.use_deterministic_algorithms(False)
