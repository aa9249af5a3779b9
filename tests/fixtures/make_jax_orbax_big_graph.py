"""Regenerate ``tests/fixtures/jax_orbax_big_graph/``: a sharded big-graph
KG checkpoint that the JAX package (``kgcn_tpu``) wrote with orbax, for the
tests and ``chip_smoke.py`` to restore into the PyTorch port without JAX.

    python tests/fixtures/make_jax_orbax_big_graph.py

Runs ``kgcn_tpu``'s ``train`` on the KG of ``examples/run_kg_sharded.sh``
(``make_kg_dataset(num_entities=512, num_relations=2, seed=0)``, the gcn
encoder at ``embedding_dim`` 32, ``label_batch_size`` 256, learning rate
0.05, seed 0) for 2 epochs over a mesh of 4 virtual CPU devices
(``{"data": 4}``) in a temporary directory, and keeps:

* ``model.big_graph.ckpt/`` — the orbax directory ``BigGraphKGTrainer.save``
  writes (``params`` ``embed`` ``[512, 32]`` and ``theta``, the optax Adam
  state, ``step`` ``[1]``);
* ``arrays/<leaf>.npy`` — each leaf as ``kgcn_tpu``'s ``load_checkpoint``
  reads it back, the key path joined by ``.``;
* ``config.json`` — the run's config (its ``dataset`` and paths relative).
"""
import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(REPO, "tests", "fixtures", "jax_orbax_big_graph")
DEVICES = 4
EPOCHS = 2
KG = dict(num_entities=512, num_relations=2, seed=0)
CONFIG = {
    "task": "link_prediction", "with_feature": False, "with_node_embedding": True,
    "embedding_dim": 32, "kg_encoder": "gcn", "epoch": EPOCHS, "batch_size": 1,
    "label_batch_size": 256, "learning_rate": 0.05, "mesh": {"data": DEVICES},
    "halo_strategy": "ring", "save_interval": 0, "seed": 0,
}


def leaves(tree):
    """(dotted key path, array) of every array leaf of a pytree (a tuple's
    items by index, a named tuple's by field, as orbax names them)."""
    import jax

    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))) for k in path]
        yield ".".join(str(k) for k in keys), v


def main():
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count={DEVICES}")
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import joblib
    import numpy as np

    from kgcn_tpu.cli.main import main as jax_main
    from kgcn_tpu.data.synthetic import make_kg_dataset
    from kgcn_tpu.runtime.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        joblib.dump(make_kg_dataset(**KG), os.path.join(tmp, "kg.jbl"))
        cfg = dict(CONFIG, dataset=os.path.join(tmp, "kg.jbl"),
                   save_model_path=os.path.join(tmp, "model"))
        path = os.path.join(tmp, "config.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        jax_main(["train", "--config", path, "--cpu"])
        shutil.rmtree(OUT, ignore_errors=True)
        os.makedirs(os.path.join(OUT, "arrays"))
        ckpt = os.path.join(OUT, "model.big_graph.ckpt")
        shutil.copytree(os.path.join(tmp, "model", "model.big_graph.ckpt"), ckpt)
    for name, arr in leaves(load_checkpoint(ckpt)):
        np.save(os.path.join(OUT, "arrays", f"{name}.npy"), np.asarray(arr))
    with open(os.path.join(OUT, "config.json"), "w") as f:
        json.dump(dict(CONFIG, dataset="kg.jbl", save_model_path="model", kg=KG), f,
                  indent=1)
    total = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(OUT) for n in ns)
    print(f"[SAVE] {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
