"""Import hygiene of the port: every module of kgcn_tpu_torch (and
chip_smoke.py) imports with JAX, flax, optax, joblib, scikit-learn, msgpack
and kgcn_tpu made unimportable (the GPU machine has none of them), and the
entry points (serving, training, KG training and inference, graph
inference, cross-validation, IG visualisation, and the sparse, pair and VAE
engines) refuse to run without a GPU unless the CPU is asked for."""
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = ("jax", "jaxlib", "flax", "optax", "joblib", "sklearn", "msgpack",
               "kgcn_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]
    sys.meta_path.insert(0, Block())
""")


def _run(body: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-c", _BLOCKER + textwrap.dedent(body)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )


def test_every_module_imports_without_jax():
    r = _run("""
        import importlib, pkgutil
        import kgcn_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            kgcn_tpu_torch.__path__, "kgcn_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        engines = {"kgcn_tpu_torch.data.tfrecord", "kgcn_tpu_torch.models.sparse",
                   "kgcn_tpu_torch.models.pair", "kgcn_tpu_torch.models.vae",
                   "kgcn_tpu_torch.cli.sparse", "kgcn_tpu_torch.cli.pair",
                   "kgcn_tpu_torch.cli.gen"}
        assert engines <= set(names), sorted(engines - set(names))
        print(len(names))
    """)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 34


def test_entry_points_refuse_to_run_without_a_gpu():
    r = _run("""
        from kgcn_tpu_torch.runtime.device import resolve_device
        from kgcn_tpu_torch.runtime.serve import ExportPredictor, Predictor
        from kgcn_tpu_torch.cli.serve import build_server
        from kgcn_tpu_torch.cli.main import main as train_main
        from kgcn_tpu_torch.cli import gen, pair, sparse
        engines = [lambda mode=mode, m=m, cfg=cfg: m.main([mode, "--config", cfg])
                   for m, modes, cfg in (
                       (sparse, ("train", "train_cv", "infer"), "example_config/vae.json"),
                       (pair, ("train", "infer"), "example_config/pair.json"),
                       (gen, ("train", "reconstruct", "generate"),
                        "example_config/vae.json"))
                   for mode in modes]
        for fn in engines + [lambda: resolve_device(),
                   lambda: Predictor({"model.py": "gcn"}),
                   lambda: ExportPredictor("model.pt2"),
                   lambda: build_server({"model.py": "gcn"}, port=0),
                   lambda: build_server({"model.py": "gcn"}, port=0,
                                        dynamic_batching=True),
                   lambda: build_server({}, port=0, export="model.pt2"),
                   lambda: train_main(["train", "--config",
                                       "example_config/gat.json"]),
                   lambda: train_main(["train", "--config",
                                       "example_config/kg.json"]),
                   lambda: train_main(["infer", "--config",
                                       "example_config/kg.json"]),
                   lambda: train_main(["infer", "--config",
                                       "example_config/gin.json"]),
                   lambda: train_main(["train_cv", "--config",
                                       "example_config/solubility_reg.json"]),
                   lambda: train_main(["visualize", "--config",
                                       "example_config/synth.json"])]:
            try:
                fn()
            except RuntimeError as e:
                assert "no CUDA device" in str(e), e
            else:
                raise AssertionError("ran without a GPU")
        assert str(resolve_device(cpu=True)) == "cpu"
        Predictor({"model.py": "gcn"}, device="cpu")
        print("ok")
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_gpu(tmp_path, where):
    """chip_smoke.py exits non-zero and prints no result line without a
    card, in the checkout and copied alone into an empty directory."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        with open(script) as src, open(tmp_path / "chip_smoke.py", "w") as dst:
            dst.write(src.read())
        script = str(tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                       text=True, timeout=240,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


DATA_PREPARATION = ("kgcn_tpu_torch.data.molparse", "kgcn_tpu_torch.data.featurizer",
                    "kgcn_tpu_torch.cli.chem", "kgcn_tpu_torch.cli.chem_summary",
                    "kgcn_tpu_torch.cli.cv_splitter", "kgcn_tpu_torch.cli.data_join",
                    "kgcn_tpu_torch.knime", "kgcn_tpu_torch.knime.helpers")


def test_data_preparation_modules_import_without_jax_or_joblib():
    """The data-preparation modules and the KNIME helpers are in the package
    and import with JAX, joblib and kgcn_tpu blocked."""
    r = _run(f"""
        import importlib, pkgutil
        import kgcn_tpu_torch
        names = {{m.name for m in pkgutil.walk_packages(
            kgcn_tpu_torch.__path__, "kgcn_tpu_torch.")}}
        want = {DATA_PREPARATION!r}
        assert set(want) <= names, sorted(set(want) - names)
        for name in want:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("ok")
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_a_kgcn_tpu_chem_dataset_loads_without_kgcn_tpu(tmp_path):
    """A ``.jbl`` that ``kgcn_tpu``'s ``chem`` wrote (joblib, ``mol_info``
    holding ``kgcn_tpu.data.molparse.Molecule`` objects) loads through the
    port's ``load_jbl`` with kgcn_tpu, JAX and joblib blocked: its
    molecules are the port's, with the same state."""
    import joblib

    from kgcn_tpu.cli.chem import main as chem

    smi = tmp_path / "mols.smi"
    smi.write_text("CCO\nc1ccccc1C(=O)[O-]\nc1cc[nH]c1\n[NH4+].[Cl-]\n")
    out = tmp_path / "chem.jbl"
    chem(["--smiles", str(smi), "-o", str(out)])
    want = [m.__getstate__() for m in joblib.load(out)["mol_info"]["obj_list"]]
    with open(out, "rb") as f:
        assert b"kgcn_tpu.data.molparse" in f.read()
    r = _run(f"""
        from kgcn_tpu_torch.data import jbl, molparse
        from kgcn_tpu_torch.data.dataset import load_jbl
        ds, info = load_jbl({str(out)!r})
        mols = info.mol_info["obj_list"]
        assert ds.num == 4 and all(type(m) is molparse.Molecule for m in mols)
        assert [m.__getstate__() for m in mols] == {want!r}
        assert mols[1].GetAtomWithIdx(1).GetIsAromatic()
        raw = jbl.load({str(out)!r})
        assert type(raw["mol_info"]["obj_list"][0]) is molparse.Molecule
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("ok")
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_other_kgcn_tpu_classes_in_a_stream_are_refused():
    """A stream that names any other class of kgcn_tpu raises
    ``UnpicklingError`` naming it, and imports nothing of kgcn_tpu."""
    r = _run("""
        import pickle
        from kgcn_tpu_torch.data import jbl
        for module, name in (("kgcn_tpu.graph.batch", "GraphBatch"),
                             ("kgcn_tpu.data.dataset", "DatasetInfo"),
                             ("kgcn_tpu", "Trainer"),
                             ("kgcn_tpu.data.molparse", "parse_smiles")):
            raw = b"\\x80\\x02c" + f"{module}\\n{name}\\n".encode() + b"."
            try:
                jbl.loads(raw)
            except pickle.UnpicklingError as e:
                assert f"{module}.{name}" in str(e), e
            else:
                raise AssertionError(f"{module}.{name} was read")
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("ok")
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_data_preparation_runs_without_a_gpu(tmp_path):
    """``cli.chem`` touches no device: it runs with no GPU visible and no
    ``--cpu`` flag (it has none), as do ``cv_splitter``, ``data_join`` and
    ``chem_summary`` on its output, with JAX, joblib and kgcn_tpu blocked."""
    smi = tmp_path / "mols.smi"
    smi.write_text("CCO\nc1ccccc1O\nCC(=O)Nc1ccccc1\nC1CCCCC1N\nc1ccncc1Cl\nCCS\n")
    r = _run(f"""
        import os
        from kgcn_tpu_torch.cli import chem, chem_summary, cv_splitter, data_join
        from kgcn_tpu_torch.data import jbl
        d = {str(tmp_path)!r}
        chem.main(["--smiles", os.path.join(d, "mols.smi"), "--morgan-fingerprint",
                   "-o", os.path.join(d, "out", "chem.jbl")])
        cv_splitter.main(["--input", os.path.join(d, "out", "chem.jbl"), "--output-dir",
                          os.path.join(d, "folds"), "--fold", "3"])
        data_join.main(["--input", os.path.join(d, "folds", "chem.fold0.train.jbl"),
                        os.path.join(d, "folds", "chem.fold0.test.jbl"),
                        "--output", os.path.join(d, "joined.jbl")])
        chem_summary.main(["-p", os.path.join(d, "joined.jbl")])
        assert len(jbl.load(os.path.join(d, "joined.jbl"))["adj"]) == 6
        import torch
        assert not torch.cuda.is_available()
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("ok")
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


TOOLS = ("kgcn_tpu_torch.tools.hpo", "kgcn_tpu_torch.tools.nas",
         "kgcn_tpu_torch.tools.estimators", "kgcn_tpu_torch.tools.graph_kernels",
         "kgcn_tpu_torch.tools.active_learning", "kgcn_tpu_torch.runtime.timing",
         "kgcn_tpu_torch.cli.opt", "kgcn_tpu_torch.cli.gk")


def test_tools_import_and_run_without_jax_joblib_or_sklearn(tmp_path):
    """The tools (HPO, NAS, the estimators, graph kernels, active learning,
    timing, ``cli.opt`` and ``cli.gk``) are in the package and import with
    JAX, joblib, scikit-learn and kgcn_tpu blocked; ``cli.gk`` and an SVC
    active-learning loop run so on the host, and ``cli.opt`` and
    ``nas.search`` refuse to run without a GPU unless the CPU is asked
    for."""
    r = _run(f"""
        import importlib, json, pickle, pkgutil
        import numpy as np
        import kgcn_tpu_torch
        names = {{m.name for m in pkgutil.walk_packages(
            kgcn_tpu_torch.__path__, "kgcn_tpu_torch.")}}
        want = {TOOLS!r}
        assert set(want) <= names, sorted(set(want) - names)
        for name in want:
            importlib.import_module(name)
        from kgcn_tpu_torch.cli import gk, opt
        from kgcn_tpu_torch.data.synthetic import make_ring_dataset
        from kgcn_tpu_torch.data.dataset import build_dataset
        from kgcn_tpu_torch.tools import active_learning, nas
        path = {str(tmp_path / "ring.jbl")!r}
        with open(path, "wb") as f:
            pickle.dump(make_ring_dataset(num_pairs=10, num_nodes=8), f)
        gk.main(["--dataset", path, "--folds", "3"])
        rng = np.random.RandomState(0)
        X = (rng.rand(60, 32) < 0.3).astype(float)
        y = (X[:, :4].sum(1) > 1).astype(int)
        accs, _ = active_learning.run_loop(X[:40], y[:40], X[40:], y[40:], initial=8,
                                           batch=4, iterations=2)
        assert len(accs) == 3
        ds, info = build_dataset(make_ring_dataset(num_pairs=4, num_nodes=6), {{}})
        for fn in (lambda: opt.main(["--config", "example_config/synth.json",
                                     "--domain", "example_config/synth.json"]),
                   lambda: nas.search(ds, ds, info, {{"epoch": 1}}, max_iter=1)):
            try:
                fn()
            except RuntimeError as e:
                assert "no CUDA device" in str(e), e
            else:
                raise AssertionError("ran without a GPU")
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("ok")
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
