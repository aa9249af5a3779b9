"""Regenerate ``tests/fixtures/jax_gcn_solubility/``: a model that the JAX
package (``kgcn_tpu``) trained, for the tests and ``chip_smoke.py`` to load
into the PyTorch port.

    python tests/fixtures/make_jax_gcn_solubility.py

Runs ``kgcn_tpu``'s ``train`` on ``example_config/solubility_cls.json`` for
2 epochs (seed 0, on the CPU) in a temporary directory and keeps what it
wrote that serving reads — ``model.best.ckpt`` (flax msgpack: parameters,
BN statistics, Adam state, step, PRNG key, epoch, best cost) and
``serve_info.json`` — plus ``predictions.json``: ``kgcn_tpu``'s
``Predictor`` answers to the first 32 molecules of
``examples/solubility/solubility_cls.jbl`` (float32, as lists).
"""
import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(REPO, "tests", "fixtures", "jax_gcn_solubility")
N_MOLECULES = 32
EPOCHS = 2


def payload(data, idx):
    """Molecules ``idx`` as a /predict body (the jbl ``adj`` schema)."""
    import numpy as np

    return {
        "feature": np.asarray(data["feature"])[idx].tolist(),
        "adj": [[[np.asarray(data["adj"][i][0]).tolist(),
                  np.asarray(data["adj"][i][1]).tolist(),
                  [int(s) for s in data["adj"][i][2]]]] for i in idx],
        "max_node_num": int(data["max_node_num"]),
    }


def main():
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import joblib

    from kgcn_tpu.cli.main import main as jax_main
    from kgcn_tpu.runtime.serve import Predictor

    with open(os.path.join(REPO, "example_config", "solubility_cls.json")) as f:
        cfg = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        cfg.update(dataset=os.path.join(REPO, cfg["dataset"]), epoch=EPOCHS, seed=0,
                   save_interval=0, save_model_path=os.path.join(tmp, "model"),
                   save_info_valid=os.path.join(tmp, "info_valid.json"))
        path = os.path.join(tmp, "config.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        jax_main(["train", "--config", path, "--cpu"])
        os.makedirs(OUT, exist_ok=True)
        for name in ("model.best.ckpt", "serve_info.json"):
            shutil.copy(os.path.join(tmp, "model", name), os.path.join(OUT, name))
    data = joblib.load(cfg["dataset"])
    body = payload(data, list(range(N_MOLECULES)))
    serve_cfg = dict(cfg, save_model_path=OUT, load_model=None)
    resp = Predictor(serve_cfg).predict(body)
    with open(os.path.join(OUT, "predictions.json"), "w") as f:
        json.dump({"molecules": list(range(N_MOLECULES)), "epochs": EPOCHS,
                   "prediction": resp["prediction"]}, f)
    print(f"[SAVE] {OUT}: " + ", ".join(
        f"{n} {os.path.getsize(os.path.join(OUT, n))} bytes" for n in sorted(os.listdir(OUT))))


if __name__ == "__main__":
    main()
