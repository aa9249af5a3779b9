"""Import hygiene of the port: every module of kgcn_tpu_torch (and
chip_smoke.py) imports with JAX, flax, optax, joblib and kgcn_tpu made
unimportable, and the entry points (serving, training, KG training and
inference, graph inference) refuse to run without a GPU unless the CPU is
asked for."""
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = ("jax", "jaxlib", "flax", "optax", "joblib", "kgcn_tpu")

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
        print(len(names))
    """)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 27


def test_entry_points_refuse_to_run_without_a_gpu():
    r = _run("""
        from kgcn_tpu_torch.runtime.device import resolve_device
        from kgcn_tpu_torch.runtime.serve import Predictor
        from kgcn_tpu_torch.cli.serve import build_server
        from kgcn_tpu_torch.cli.main import main as train_main
        for fn in (lambda: resolve_device(),
                   lambda: Predictor({"model.py": "gcn"}),
                   lambda: build_server({"model.py": "gcn"}, port=0),
                   lambda: train_main(["train", "--config",
                                       "example_config/gat.json"]),
                   lambda: train_main(["train", "--config",
                                       "example_config/kg.json"]),
                   lambda: train_main(["infer", "--config",
                                       "example_config/kg.json"]),
                   lambda: train_main(["infer", "--config",
                                       "example_config/gin.json"])):
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
