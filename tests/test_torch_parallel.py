"""The port's launcher, mesh and data-parallel trainer (kgcn_tpu_torch/
parallel/launch.py, mesh.py, dp.py) against the JAX package, on the CPU.

The port runs as gloo ranks (D = 2 and 4, every scenario of a world size in
one launch, tests/torch_parallel_worker.py); the JAX package runs here on
the same number of its virtual devices (tests/conftest.py), from the same
weights (``params_from_jax``), data and batches.  Tolerances: one step's
cost and metrics and the parameters after 3 SGD steps, 1e-5; an epoch's
cost and parameters (5 and 3 steps), 1e-5; the evaluated predictions and
cost, 1e-5; the resident epoch against the streaming one (the same steps,
the optimizer's numbers from a table), 1e-6; a bf16 step's cost, 2e-2
relative (tests/test_torch_precision.py's bound for bf16 against JAX);
the shard-mode epoch (each rank its own slice of the data) against the
same local batches stacked on kgcn_tpu's devices, 1e-5; the resumed
epoch against the continued one, bitwise."""
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.convert import params_from_jax
from kgcn_tpu_torch.parallel import mesh as pmesh
from test_torch_tiled import jax_backend
from torch_parallel_worker import launch_scenarios

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
SAME = dict(rtol=1e-6, atol=1e-6)
BF16_RTOL = 2e-2
WORLDS = (2, 4)
RING = dict(num_pairs=13, seed=0)  # 26 ring graphs of 10 nodes
B = 3                               # graphs a rank a step
VALID_ROWS = list(range(13))        # 13 graphs: the last step leaves ranks empty
INGEST_RING = dict(num_pairs=23, seed=0)  # 46 ring graphs: slices uneven over D
DROPOUT = 0.2                       # the resume's dropout (the config's default)


def _cfg(**over):
    from kgcn_tpu.runtime.config import default_config

    cfg = default_config()
    cfg.update({"model.py": "gcn", "task": "classification", "batch_size": B,
                "learning_rate": 0.1, "optimizer": "sgd", "dropout_rate": 0.0,
                "normalize_adj_flag": True, "shuffle_data": True, "seed": 0,
                "spmm_backend": "dense"})
    cfg.update(over)
    return cfg


def _steps(D):
    """Three global steps' rows, the last one partial (D·B - 4 short)."""
    n = 26
    return [list(range(0, D * B)), list(range(D * B, 2 * D * B)),
            list(range(n - (D * B - 4), n))]


def _jax_side(D):
    """kgcn_tpu's DPTrainer on D virtual devices: the initial tree, three
    steps, an epoch, an evaluation and a bf16 step."""
    from kgcn_tpu.data import Batcher, build_dataset
    from kgcn_tpu.data.synthetic import make_ring_dataset
    from kgcn_tpu.models.registry import build_model
    from kgcn_tpu.parallel.dp import DPTrainer, ShardedBatcher
    from kgcn_tpu.parallel.mesh import make_mesh

    cfg = _cfg()
    out = {}
    with jax_backend("dense"):
        ds, info = build_dataset(make_ring_dataset(**RING), cfg)
        mesh = make_mesh({"data": D})

        def trainer(c=cfg):
            return DPTrainer(build_model("gcn", info, c), c, info, mesh=mesh)

        sb = ShardedBatcher(Batcher(ds, info, B, seed=0), D)
        tr = trainer()
        state0 = tr.init_state(sb.make_batch(np.arange(D * B)), seed=0)
        out["tree"] = params_from_jax(jax.device_get(state0.params),
                                      jax.device_get(state0.batch_stats))
        state, costs, metrics = state0, [], []
        for idx in _steps(D):
            state, c, m = tr.train_step(state, sb.make_batch(np.asarray(idx)))
            costs.append(float(c))
            metrics.append(jax.device_get(m))
        out["step_costs"], out["step_metrics"] = costs, metrics
        out["step"] = params_from_jax(jax.device_get(state.params),
                                      jax.device_get(state.batch_stats))
        tr = trainer()
        state = tr.init_state(sb.make_batch(np.arange(D * B)), seed=0)
        state, cost, _, _ = tr.run_epoch(state, sb, shuffle=True, epoch=0)
        out["epoch_cost"] = float(cost)
        out["epoch"] = params_from_jax(jax.device_get(state.params),
                                       jax.device_get(state.batch_stats))
        vsb = ShardedBatcher(Batcher(ds.subset(np.asarray(VALID_ROWS)), info, B), D)
        out["eval"] = tr.evaluate(state, vsb, "v_")
        bcfg = _cfg(precision="bfloat16")
        tr = trainer(bcfg)
        state = tr.init_state(sb.make_batch(np.arange(D * B)), seed=0)
        state, c, _ = tr.train_step(state, sb.make_batch(np.asarray(_steps(D)[0])))
        out["bf16_cost"] = float(c)
    return out


def _jax_ingest(D):
    """kgcn_tpu's DPTrainer on D virtual devices fed what D processes of
    one device each feed its mesh in shard mode: step s stacks each
    process p's local batch (rows of ``shard_for_host(ds, p, D)`` in the
    order of ``Batcher(seed=p)``; an empty chunk is padded as
    ``GlobalShardedBatcher._padded_local_batch``), for one epoch."""
    import dataclasses

    import jax.numpy as jnp

    from kgcn_tpu.data import Batcher, build_dataset
    from kgcn_tpu.data.dataset import shard_for_host
    from kgcn_tpu.data.synthetic import make_ring_dataset
    from kgcn_tpu.models.registry import build_model
    from kgcn_tpu.parallel.dp import DPTrainer, stack_batches
    from kgcn_tpu.parallel.mesh import make_mesh

    cfg = _cfg()
    with jax_backend("dense"):
        ds, info = build_dataset(make_ring_dataset(**INGEST_RING), cfg)
        shards = [shard_for_host(ds, p, D) for p in range(D)]
        batchers = [Batcher(s, info, B, seed=p) for p, s in enumerate(shards)]
        for b in batchers:  # the dense path, as the port's: no ELL arrays (whose
            b._ell = None   # gate passes some slices and not others)
        perms = [b.epoch_indices(shuffle=True, epoch=0) for b in batchers]

        def step(s):
            local = []
            for p, b in enumerate(batchers):
                rows = perms[p][s * B:(s + 1) * B]
                if len(rows):
                    local.append(b.make_batch(rows))
                else:
                    pad = b.make_batch(np.array([0]))
                    local.append(dataclasses.replace(pad, pad_mask=jnp.zeros_like(
                        pad.pad_mask)))
            return stack_batches(local)

        tr = DPTrainer(build_model("gcn", info, cfg), cfg, info, mesh=make_mesh({"data": D}))
        state = tr.init_state(step(0), seed=0)
        tree = params_from_jax(jax.device_get(state.params),
                               jax.device_get(state.batch_stats))
        steps, total = -(-(-(-ds.num // D)) // B), 0.0
        for s in range(steps):
            state, cost, _ = tr.train_step(state, step(s))
            total += float(cost)
        return {"tree": tree, "steps": steps, "epoch_cost": total / ds.num,
                "epoch": params_from_jax(jax.device_get(state.params),
                                         jax.device_get(state.batch_stats)),
                "shards": [(s.features, s.labels) for s in shards]}


def _single_device_ckpt(path):
    """A training checkpoint of the port's single-device Trainer (a world
    of one) after one epoch at DROPOUT."""
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.train import Trainer
    from torch_parallel_worker import _ring

    cfg = _cfg(dropout_rate=DROPOUT)
    ds, info, be = _ring({"cfg": cfg, "ring": RING})
    tr = Trainer(build_model("gcn", info, cfg), cfg, info, device="cpu")
    state, _, _, _ = tr.run_epoch(tr.init_state(seed=0),
                                  Batcher(ds, info, B, seed=0, backend=be), epoch=0)
    tr.save_tree(str(path), tr.state_tree(state, 0, np.inf))
    return str(path)


def _write_cli_config(d, D):
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset

    with open(d / "ring.jbl", "wb") as f:
        pickle.dump(make_ring_dataset(**RING), f, protocol=4)
    with open(os.path.join(REPO, "example_config", "synth.json")) as f:
        cfg = json.load(f)
    cfg.update(dataset=str(d / "ring.jbl"), epoch=2, batch_size=B, mesh={"data": D},
               save_model_path=str(d / "model"), save_info_train=str(d / "info_train.json"),
               save_info_valid=str(d / "info_valid.json"),
               save_result_valid=str(d / "result_valid.csv"), make_plot=False)
    path = d / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{D: (the JAX side, the ranks' outputs, the CLI run's directory)}."""
    out, other = {}, None
    for D in WORLDS:
        d = tmp_path_factory.mktemp(f"dp{D}")
        jx = dict(_jax_side(D), ingest=_jax_ingest(D))
        # a checkpoint of another world size: a world of one's for the first
        # D, the previous D's after it
        other = other or _single_device_ckpt(d / "single.ckpt")
        inputs = {"dp": {"cfg": _cfg(), "ring": RING, "tree": jx["tree"],
                         "steps": _steps(D), "valid_rows": VALID_ROWS},
                  "dp_cli": {"config": _write_cli_config(d, D)},
                  "ckpt": {"cfg": _cfg(dropout_rate=DROPOUT), "ring": RING,
                           "path": str(d / "dp.ckpt"), "other": other},
                  "ingest": {"cfg": _cfg(), "ring": INGEST_RING,
                             "tree": jx["ingest"]["tree"]}}
        out[D] = (jx, launch_scenarios(d, D, inputs), d)
        other = inputs["ckpt"]["path"]
    return out


def _close_tree(got, want, tol, what):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w.numpy(), err_msg=f"{what} {k}", **tol)


@pytest.mark.parametrize("D", WORLDS)
def test_dp_steps_match_jax(runs, D):
    """One step's cost and metrics, three SGD steps' parameters and BN
    statistics (their mean over the ranks) against kgcn_tpu's DPTrainer;
    the last step leaves ranks without a graph; every rank holds the same
    replicated state."""
    jx, res, _ = runs[D]
    ranks = res["dp"]
    for r in ranks:
        np.testing.assert_allclose(r["step_costs"], jx["step_costs"], **TOL)
        for k, v in jx["step_metrics"][0].items():
            np.testing.assert_allclose(r["step_metrics"][0][k], np.asarray(v), **TOL)
        _close_tree(r["step_params"], jx["step"]["params"], TOL, "params")
        _close_tree(r["step_stats"], jx["step"]["batch_stats"], TOL, "batch_stats")
    for k in ranks[0]["step_params"]:
        assert np.array_equal(ranks[0]["step_params"][k], ranks[-1]["step_params"][k])


@pytest.mark.parametrize("D", WORLDS)
def test_dp_epochs_resident_and_streaming(runs, D):
    """An epoch (shuffled, epoch-keyed order) through the streaming and
    the resident sharded batchers: each against kgcn_tpu's streaming DP
    epoch, and the resident one against the streaming one."""
    jx, res, _ = runs[D]
    r = res["dp"][0]
    for name in ("stream", "resident"):
        np.testing.assert_allclose(r[f"{name}_epoch_cost"], jx["epoch_cost"], **TOL)
        _close_tree(r[f"{name}_epoch_params"], jx["epoch"]["params"], TOL, name)
        _close_tree(r[f"{name}_epoch_stats"], jx["epoch"]["batch_stats"], TOL, name)
    np.testing.assert_allclose(r["resident_epoch_cost"], r["stream_epoch_cost"], **SAME)
    for k, v in r["stream_epoch_params"].items():
        np.testing.assert_allclose(r["resident_epoch_params"][k], v, err_msg=k, **SAME)


@pytest.mark.parametrize("D", WORLDS)
def test_dp_evaluate_order(runs, D):
    """The evaluated predictions, gathered from the ranks, in kgcn_tpu's
    order (per step, rank-major, padding dropped), with its cost, count
    and metrics, on every rank."""
    jx, res, _ = runs[D]
    want = jx["eval"]
    for r in res["dp"]:
        ev = r["eval"]
        assert ev["num"] == want["num"] == len(VALID_ROWS)
        assert ev["prediction"].shape == np.asarray(want["prediction"]).shape
        np.testing.assert_allclose(ev["prediction"], np.asarray(want["prediction"]), **TOL)
        np.testing.assert_allclose(ev["cost"], want["cost"], **TOL)
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(ev["metrics"][k], np.asarray(v), err_msg=k, **TOL)


@pytest.mark.parametrize("D", WORLDS)
def test_dp_bf16_step(runs, D):
    """``"precision": "bfloat16"`` under the mesh: the payload cast, one
    step's cost finite and within BF16_RTOL of kgcn_tpu's."""
    jx, res, _ = runs[D]
    got = res["dp"][0]["bf16_cost"]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, jx["bf16_cost"], rtol=BF16_RTOL)


@pytest.mark.parametrize("D", WORLDS)
def test_cli_train_with_mesh(runs, D):
    """``cli.main train`` with ``mesh {"data": D}`` under the launcher:
    every rank prints the same epochs, rank 0 writes the files."""
    _, res, d = runs[D]
    outs = [r["stdout"] for r in res["dp_cli"]]
    epochs = [[ln for ln in o.splitlines() if ln.startswith("epoch")] for o in outs]
    assert len(epochs[0]) == 2 and all(e == epochs[0] for e in epochs)
    assert "[SAVE]" in outs[0] and all("[SAVE]" not in o for o in outs[1:])
    assert sorted(os.listdir(d / "model")) == ["model.best.ckpt", "model.last.ckpt",
                                               "serve_info.json"]
    hist = json.loads((d / "info_train.json").read_text())
    assert len(hist["training_cost"]) == 2 and np.isfinite(hist["training_cost"]).all()


@pytest.mark.parametrize("D", WORLDS)
def test_dp_resume_equals_the_continued_run(runs, D):
    """ROADMAP C.12: at dropout DROPOUT the epoch after a restore is the
    epoch the saving run went on to train, bitwise (cost, parameters, BN
    statistics), on every rank: each rank restores its own dropout
    generator, not rank 0's."""
    _, res, _ = runs[D]
    for r, got in enumerate(res["ckpt"]):
        cont, back = got["continued"], got["resumed"]
        assert back["epoch"] == 2
        assert back["cost"] == cont["cost"], (r, back["cost"], cont["cost"])
        for part in ("params", "stats"):
            for k, v in cont[part].items():
                assert np.array_equal(back[part][k], v), (
                    r, part, k, float(np.max(np.abs(back[part][k] - v))))
        assert np.array_equal(got["rng_restored"], got["rng_saved"]), r


@pytest.mark.parametrize("D", WORLDS)
def test_single_device_trainer_resumes_a_dp_checkpoint(runs, D):
    """The checkpoint of D ranks holds every rank's generator in rank order
    (``rng_ranks``) and rank 0's as ``rng``: the single-device Trainer
    restores its parameters exactly, with rank 0's generator, and trains
    on."""
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime import checkpoint as ckpt
    from kgcn_tpu_torch.runtime.train import Trainer
    from torch_parallel_worker import _ring

    ranks = runs[D][1]["ckpt"]
    tree = ckpt.load_checkpoint(ranks[0]["path"])
    assert tree["rng_ranks"].shape[0] == D
    for r, got in enumerate(ranks):
        assert np.array_equal(tree["rng_ranks"][r].numpy(), got["rng_saved"]), r
    assert torch.equal(tree["rng"], tree["rng_ranks"][0])
    cfg = _cfg(dropout_rate=DROPOUT)
    ds, info, be = _ring({"cfg": cfg, "ring": RING})
    tr = Trainer(build_model("gcn", info, cfg), cfg, info, device="cpu")
    state = tr.restore(ranks[0]["path"])
    _same_tree(state.params, tree["params"])
    assert torch.equal(state.rng.get_state(), tree["rng"]) and state.epoch == 2
    _, cost, _, _ = tr.run_epoch(state, Batcher(ds, info, B, seed=0, backend=be),
                                 epoch=state.epoch)
    assert np.isfinite(cost)


@pytest.mark.parametrize("D", WORLDS)
def test_dp_resume_at_another_world_size(runs, D):
    """A checkpoint written at another data width (at D 2 the single-device
    Trainer's, a world of one; at D 4 the D 2 run's) restores on every
    rank: its parameters exactly, and rank r's dropout generator re-seeded
    from (seed, r, saved step) (``dp.resume_seed``, ROADMAP C.5), so no two
    ranks draw the same masks; an epoch trains."""
    from kgcn_tpu_torch.parallel.dp import resume_seed
    from kgcn_tpu_torch.runtime import checkpoint as ckpt

    ranks = runs[D][1]["ckpt"]
    saved = ckpt.load_checkpoint(ranks[0]["other_path"])
    assert len(saved.get("rng_ranks", saved["rng"][None])) != D
    step = int(saved["step"])
    for r, got in enumerate(ranks):
        other = got["other"]
        for k, v in saved["params"].items():
            assert np.array_equal(other["params"][k], v.numpy()), (r, k)
        assert other["step"] == step
        want = torch.Generator().manual_seed(resume_seed(0, r, step)).get_state()
        assert np.array_equal(other["rng"], want.numpy()), r
        assert np.isfinite(other["cost"])
    assert len({got["other"]["rng"].tobytes() for got in ranks}) == D


@pytest.mark.parametrize("D", WORLDS)
def test_shard_ingest_covers_the_dataset_once(runs, D):
    """Shard mode: each rank holds ``kgcn_tpu``'s ``shard_for_host`` slice
    (the same rows), its permutation covers the slice once, every rank
    yields the same number of global steps (⌈⌈N/D⌉/B⌉) and together they
    see the N rows once; the evaluation gathers N predictions."""
    jx, res, _ = runs[D]
    ranks, want = res["ingest"], jx["ingest"]
    n = 2 * INGEST_RING["num_pairs"]
    for r, got in enumerate(ranks):
        features, labels = want["shards"][r]
        np.testing.assert_array_equal(got["features"], features)
        np.testing.assert_array_equal(got["labels"], labels)
        assert sorted(got["perm"].tolist()) == list(range(len(labels)))
        assert got["steps"] == want["steps"] == -(-(-(-n // D)) // B)
        assert got["valid_per_epoch"] == got["n"] == n
        assert got["valid_counts"] == [min(D * B, n - s) for s in range(0, n, D * B)]
        assert got["eval"]["num"] == got["eval"]["rows"] == n
    assert sum(len(w[1]) for w in want["shards"]) == n
    assert sum(got["seen"] for got in ranks) == n


@pytest.mark.parametrize("D", WORLDS)
def test_shard_ingest_epoch_matches_jax(runs, D):
    """A shard-mode epoch (dropout 0) against kgcn_tpu's DPTrainer fed the
    same local batches stacked on D devices: the cost and the parameters
    and BN statistics within TOL; every rank holds the same cost."""
    jx, res, _ = runs[D]
    want = jx["ingest"]
    for got in res["ingest"]:
        assert got["epoch_cost"] == res["ingest"][0]["epoch_cost"]
        np.testing.assert_allclose(got["epoch_cost"], want["epoch_cost"], **TOL)
        _close_tree(got["epoch"]["params"], want["epoch"]["params"], TOL, "params")
        _close_tree(got["epoch"]["stats"], want["epoch"]["batch_stats"], TOL, "stats")


def test_mesh_must_match_the_world():
    """A plain process is a world of one: ``{"data": 1}`` and ``-1`` build,
    ``{"data": 2}`` raises naming both numbers and the launcher, and so
    does a ``model`` axis that the world cannot hold."""
    assert pmesh.make_mesh({"data": 1}).shape == {"data": 1}
    assert pmesh.make_mesh({"data": -1}).size == 1
    with pytest.raises(ValueError, match=r"2 ranks.*world of 1.*kgcn-torch-launch "
                                         r"--nprocs 2"):
        pmesh.make_mesh({"data": 2})
    with pytest.raises(ValueError, match=r"2 ranks.*world of 1.*kgcn-torch-launch "
                                         r"--nprocs 2"):
        pmesh.make_mesh({"data": 1, "model": 2})
    assert pmesh.host_view({"a": 1}) == [{"a": 1}]


@pytest.mark.parametrize("n", [0, 1, 7, 46, 101])
def test_process_index_range_matches_jax(n):
    from kgcn_tpu.parallel.mesh import process_index_range as j_range

    for procs in (1, 2, 3, 4, 8):
        got = [pmesh.process_index_range(n, procs, p) for p in range(procs)]
        assert got == [j_range(n, procs, p) for p in range(procs)]
        assert sum(b - a for a, b in got) == n


def test_launcher_propagates_the_first_failure(tmp_path):
    """A rank that fails ends the job with its exit code, and the launcher
    ends the ranks still running (else they would wait forever)."""
    from kgcn_tpu_torch.parallel.launch import first_failure, launch

    code = ("import os, sys, time\n"
            "if os.environ['RANK'] == '1': sys.exit(3)\n"
            "time.sleep(120)\n")
    results = launch(2, [sys.executable, "-c", code], cpu=True, timeout=60, stream=False)
    assert first_failure(results) == 3
    assert results[0].returncode != 0


def test_launcher_sets_torchrun_variables(tmp_path):
    from kgcn_tpu_torch.parallel.launch import launch

    code = ("import os\nprint(*[os.environ[k] for k in ('RANK', 'WORLD_SIZE', "
            "'LOCAL_RANK', 'OMP_NUM_THREADS')])")
    results = launch(2, [sys.executable, "-c", code], cpu=True, timeout=60, stream=False)
    assert [r.stdout.split() for r in results] == [["0", "2", "0", "1"],
                                                  ["1", "2", "1", "1"]]


def test_command_device_must_match_the_launcher(monkeypatch):
    """``--cpu`` on one side only raises: nothing switches device quietly."""
    from kgcn_tpu_torch.parallel import launch

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv(launch.ENV_DEVICE, "cpu")
    with pytest.raises(ValueError, match="--cpu"):
        launch.initialize_from_env(cpu=False)
    monkeypatch.setenv(launch.ENV_DEVICE, "cuda")
    with pytest.raises(ValueError, match="--cpu"):
        launch.initialize_from_env(cpu=True)
    r = subprocess.run([sys.executable, "-m", "kgcn_tpu_torch.parallel.launch",
                        "--nprocs", "1"], cwd=REPO, capture_output=True, text=True,
                       timeout=60)
    assert r.returncode != 0 and "no command given" in r.stderr


def _same_tree(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_mesh_of_one_is_the_single_device_run(tmp_path):
    """A plain process is a world of one: ``train_cv`` (its sharded test
    evaluation) and ``cli.sparse train`` with ``mesh {"data": 1}`` give the
    results and checkpoints of the same runs without ``mesh``, bitwise."""
    from kgcn_tpu_torch.cli import sparse
    from kgcn_tpu_torch.cli.main import cmd_train_cv
    from kgcn_tpu_torch.runtime import checkpoint as ckpt
    from kgcn_tpu_torch.runtime.config import load_config
    from test_torch_sparse import _config, _write_run_sparse_data

    runs = {}
    for side, over in (("plain", {}), ("mesh", {"mesh": {"data": 1}})):
        d = tmp_path / side
        d.mkdir()
        cfg = load_config(os.path.join(REPO, "example_config", "synth.json"), dict(
            over, epoch=2, make_plot=False, save_model_path=str(d / "model"),
            save_info_cv=None, save_result_cv=None,
            dataset=os.path.join(REPO, "example_jbl", "synthetic.jbl"),
            **{"k-fold_num": 2}))
        runs[side] = cmd_train_cv(cfg, device="cpu")
        data = str(tmp_path / "sparse.tfrecords")
        if not os.path.exists(data):
            _write_run_sparse_data(data)
        scfg = load_config(_config(tmp_path, f"sparse_{side}", data), over)
        runs[f"sparse_{side}"] = sparse.cmd_train(scfg, fold=0, device="cpu")[3]
    assert runs["mesh"] == runs["plain"]
    for k in ("cost", "num"):
        assert runs["sparse_mesh"][k] == runs["sparse_plain"][k]
    np.testing.assert_array_equal(runs["sparse_mesh"]["prediction"],
                                  runs["sparse_plain"]["prediction"])
    for f in (0, 1):
        a, b = (ckpt.load_checkpoint(str(tmp_path / s / "model" / f"model.{f}.last.ckpt"))
                for s in ("mesh", "plain"))
        _same_tree(a["params"], b["params"])
