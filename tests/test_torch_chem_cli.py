"""The port's data-preparation CLIs and KNIME helpers against the JAX
package's, on the CPU, on seeded molecules (``chip_smoke.make_smiles``):

* ``cli.chem`` with each flag set (SMILES + labels, SDF, an assay CSV with
  ``--pseudo-negative``, ``--sequence``, ``--morgan-fingerprint``, the
  feature modes, ``--no-mol-info``, ``--tfrecords``): the output dicts are
  equal key by key (arrays exactly, with their dtypes; ``mol_info``'s
  molecules by their pickled state), the TFRecord files byte for byte, the
  printed lines equal;
* ``cv_splitter``'s fold files, ``data_join``'s output and
  ``chem_summary``'s printout equal ``kgcn_tpu``'s (``kgcn_tpu``'s files
  read with joblib, the port's with ``data/jbl.py``), and the port's
  ``cv_splitter`` reads ``kgcn_tpu``'s ``chem`` output (its molecules
  become the port's);
* the KNIME helpers' intermediate files are equal at every step, through
  their argparse entry points;
* a dataset the port's ``chem`` made trains for one epoch through the
  port's ``cli.main --cpu`` and through ``kgcn_tpu``'s ``cli.main``, both
  resuming one ``kgcn_tpu`` checkpoint of the initial weights (dropout 0):
  costs within ``rtol=0, atol=1e-4`` (``tests/test_torch_resident.py``'s
  tolerance); and ``visualize`` of one of its molecules dumps the port's
  ``Molecule``, which ``cli.gcnv`` reads back.
"""
import contextlib
import io
import json
import os
import pickle
import sys

import joblib
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.data import jbl
from kgcn_tpu_torch.data import molparse as t_mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

N_MOLECULES = 60
ATOM_LIMIT = 40   # drops some of the seeded molecules (up to 60 atoms)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """SMILES (seeded, an invalid one, a large one), one-hot labels, an
    assay CSV with blanks, protein sequences, and an SDF of the first 24
    molecules with a headerless label CSV with blanks."""
    d = tmp_path_factory.mktemp("chem_inputs")
    smiles = chip_smoke.make_smiles(N_MOLECULES, seed=3) + ["C1CC", "c1ccccc1O"]
    labels, tasks = chip_smoke.smiles_labels([s if s != "C1CC" else "C" for s in smiles])
    (d / "mols.smi").write_text("\n".join(smiles) + "\n")
    (d / "labels.txt").write_text("".join(f"{a},{b}\n" for a, b in labels))
    rng = np.random.RandomState(0)
    blank = rng.rand(*tasks.shape) < 0.25
    (d / "assay.csv").write_text("smiles,t0,t1,t2,t3\n" + "".join(
        smi + "," + ",".join("" if g else str(int(v)) for v, g in zip(row, gaps)) + "\n"
        for smi, row, gaps in zip(smiles, tasks, blank)))
    aa = "ACDEFGHIKLMNPQRSTVWYXB"
    (d / "seq.txt").write_text("".join(
        "".join(aa[k] for k in rng.randint(0, len(aa), rng.randint(5, 70))) + "\n"
        for _ in smiles))
    chip_smoke.write_sdf(str(d / "mols.sdf"), [t_mp.parse_smiles(s) for s in smiles[:24]])
    (d / "sdf_labels.csv").write_text("".join(
        f"{a},{'' if i % 5 == 2 else b}\n" for i, (a, b) in enumerate(labels[:24])))
    return d


def _same(a, b, where="data"):
    """``a`` (the JAX package's) and ``b`` (the port's) equal: containers
    key by key, arrays with their dtypes (object arrays element by
    element), molecules by their pickled state, scalars with their types."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (where, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (where, type(b), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, \
            (where, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype == object:
            for i, (x, y) in enumerate(zip(a.ravel(), b.ravel())):
                _same(x, y, f"{where}.flat[{i}]")
        else:
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    elif type(a).__name__ == "Molecule":
        assert type(a).__module__ in ("kgcn_tpu.data.molparse",
                                      "kgcn_tpu_torch.data.molparse"), where
        assert type(b) is t_mp.Molecule, (where, type(b))
        assert a.__getstate__() == b.__getstate__(), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _chem_both(inputs, tmp_path, args, name="out.jbl"):
    from kgcn_tpu.cli.chem import main as j_main
    from kgcn_tpu_torch.cli.chem import main as t_main

    outs, said = [], []
    for side, main in (("jax", j_main), ("port", t_main)):
        path = tmp_path / side / name
        argv = [str(inputs / a) if a in os.listdir(inputs) else a for a in args]
        said.append(_run(main, argv + ["-o", str(path)]).replace(str(path), "OUT"))
        outs.append(path)
    assert said[0] == said[1]
    return outs, said[1]


CHEM_CASES = {
    "smiles label": ["--smiles", "mols.smi", "--label", "labels.txt"],
    "sdf": ["--sdf", "mols.sdf"],
    "assay pseudo-negative": ["--assay-csv", "assay.csv", "--pseudo-negative"],
    "assay": ["--assay-csv", "assay.csv"],
    "sequence": ["--smiles", "mols.smi", "--label", "labels.txt", "--sequence", "seq.txt",
                 "--max-len-seq", "50"],
    "morgan": ["--smiles", "mols.smi", "--morgan-fingerprint"],
    "sybyl electronegativity": ["--smiles", "mols.smi", "--use-sybyl",
                                "--use-electronegativity"],
    "gaff": ["--smiles", "mols.smi", "--use-gaff"],
    "deepchem": ["--smiles", "mols.smi", "--deepchem-compat", "--use-sybyl"],
    "no mol info": ["--smiles", "mols.smi", "--label", "labels.txt", "--no-mol-info"],
}


@pytest.mark.parametrize("case", sorted(CHEM_CASES))
def test_chem_writes_the_jax_packages_dataset(inputs, tmp_path, case):
    (jpath, tpath), said = _chem_both(
        inputs, tmp_path, CHEM_CASES[case] + ["--atom-num-limit", str(ATOM_LIMIT)])
    want, got = joblib.load(jpath), jbl.load(str(tpath))
    _same(want, got)
    assert "[SAVE] OUT" in said
    assert ("mol_info" in got) == (case != "no mol info")
    if case == "assay pseudo-negative":
        assert "pseudo negative count" in said
    # a plain pickle, which joblib reads too (its molecules the port's)
    with open(tpath, "rb") as f:
        assert f.read(1) == b"\x80"
    _same(want, joblib.load(tpath))


def test_chem_tfrecords_are_the_jax_packages_bytes(inputs, made, tmp_path):
    (jpath, tpath), said = _chem_both(
        inputs, tmp_path, ["--smiles", "mols.smi", "--label", "labels.txt",
                           "--morgan-fingerprint", "--atom-num-limit", str(ATOM_LIMIT),
                           "--tfrecords"], name="out.tfrecords")
    assert "dropping ['chemical_fp', 'mol_info']" in said
    assert tpath.read_bytes() == jpath.read_bytes()
    from kgcn_tpu_torch.data.tfrecord import load_tfrecord_dataset

    ds, info = load_tfrecord_dataset([str(tpath)])
    data = jbl.load(str(made[1]))
    sizes = [a[2][0] for a in data["adj"]]
    assert ds.num == len(sizes) and list(ds.enabled_node_nums) == sizes
    assert info.feature_dim == 81 and np.array_equal(ds.labels, data["label"])
    for i, k in enumerate(sizes):
        assert np.array_equal(ds.features[i, :k], data["feature"][i, :k])


def test_chem_refuses_gaff_with_other_feature_flags(inputs, tmp_path):
    from kgcn_tpu_torch.cli.chem import main

    with pytest.raises(SystemExit):
        main(["--smiles", str(inputs / "mols.smi"), "--use-gaff", "--use-sybyl",
              "-o", str(tmp_path / "x.jbl")])
    with pytest.raises(SystemExit):
        main(["-o", str(tmp_path / "x.jbl")])


@pytest.fixture(scope="module")
def made(inputs, tmp_path_factory):
    """The SMILES + labels + fingerprints dataset, by each package."""
    d = tmp_path_factory.mktemp("chem_made")
    (jpath, tpath), _ = _chem_both(inputs, d, ["--smiles", "mols.smi", "--label",
                                               "labels.txt", "--morgan-fingerprint",
                                               "--atom-num-limit", str(ATOM_LIMIT)],
                                   name="chem.jbl")
    return jpath, tpath


def _folds(directory):
    return sorted(p for p in os.listdir(directory) if ".fold" in p)


@pytest.mark.parametrize("stratified", [False, True])
def test_cv_splitter_writes_the_jax_packages_folds(made, tmp_path, stratified):
    from kgcn_tpu.cli.cv_splitter import main as j_main
    from kgcn_tpu_torch.cli.cv_splitter import main as t_main

    jpath, tpath = made
    extra = ["--fold", "3", "--seed", "4"] + (["--stratified"] if stratified else [])
    said = [_run(j_main, ["--input", str(jpath), "--output-dir", str(tmp_path / "j")] + extra),
            _run(t_main, ["--input", str(tpath), "--output-dir", str(tmp_path / "t")] + extra),
            _run(t_main, ["--input", str(jpath), "--output-dir", str(tmp_path / "x")] + extra)]
    assert said[0].replace(str(tmp_path / "j"), "") == said[1].replace(str(tmp_path / "t"), "")
    names = _folds(tmp_path / "j")
    assert len(names) == 6 and names == _folds(tmp_path / "t") == _folds(tmp_path / "x")
    for name in names:
        want = joblib.load(tmp_path / "j" / name)
        _same(want, jbl.load(str(tmp_path / "t" / name)))
        # kgcn_tpu's chem output split by the port: its molecules the port's
        _same(want, jbl.load(str(tmp_path / "x" / name)))


def test_data_join_writes_the_jax_packages_join(made, tmp_path):
    from kgcn_tpu.cli.cv_splitter import main as j_split
    from kgcn_tpu.cli.data_join import main as j_main
    from kgcn_tpu_torch.cli.cv_splitter import main as t_split
    from kgcn_tpu_torch.cli.data_join import main as t_main
    from kgcn_tpu_torch.data.dataset import kfold_indices

    jpath, tpath = made
    for split, path, side in ((j_split, jpath, "j"), (t_split, tpath, "t")):
        _run(split, ["--input", str(path), "--output-dir", str(tmp_path / side)])
    n = len(jbl.load(str(tpath))["adj"])
    np.savetxt(tmp_path / "modal.csv", np.random.RandomState(0).rand(n, 3), delimiter=",")
    for main, side in ((j_main, "j"), (t_main, "t")):
        d = tmp_path / side
        _run(main, ["--input", str(d / "chem.fold1.train.jbl"), str(d / "chem.fold1.test.jbl"),
                    "--output", str(d / "joined.jbl")])
        _run(main, ["--input", str(d / "joined.jbl"), "--output", str(d / "modal.jbl"),
                    "--modal-csv", str(tmp_path / "modal.csv"), "--modal-name", "profeat"])
    for name in ("joined.jbl", "modal.jbl"):
        _same(joblib.load(tmp_path / "j" / name), jbl.load(str(tmp_path / "t" / name)))
    # the join of a fold's two files is the dataset in fold order
    train_idx, test_idx = kfold_indices(n, 5)[1]
    order = np.concatenate([train_idx, test_idx])
    full, joined = jbl.load(str(tpath)), jbl.load(str(tmp_path / "t" / "joined.jbl"))
    assert np.array_equal(joined["feature"], full["feature"][order])
    assert [m.__getstate__() for m in joined["mol_info"]["obj_list"]] == \
        [full["mol_info"]["obj_list"][i].__getstate__() for i in order]


def test_data_join_repads_to_the_common_node_count(inputs, tmp_path):
    """Two datasets made with different atom limits: per-node arrays are
    padded to the larger before they are joined, as in kgcn_tpu."""
    from kgcn_tpu.cli.data_join import main as j_main
    from kgcn_tpu_torch.cli.chem import main as chem
    from kgcn_tpu_torch.cli.data_join import main as t_main

    for limit in (30, 60):
        _run(chem, ["--smiles", str(inputs / "mols.smi"), "--atom-num-limit", str(limit),
                    "-o", str(tmp_path / f"l{limit}.jbl")])
    paths = [str(tmp_path / "l30.jbl"), str(tmp_path / "l60.jbl")]
    _run(j_main, ["--input", *paths, "--output", str(tmp_path / "j.jbl")])
    _run(t_main, ["--input", *paths, "--output", str(tmp_path / "t.jbl")])
    got = jbl.load(str(tmp_path / "t.jbl"))
    _same(joblib.load(tmp_path / "j.jbl"), got)
    assert got["feature"].shape[1] == 60 and got["max_node_num"] == 60


def test_chem_summary_prints_what_the_jax_package_prints(inputs, made, tmp_path):
    from kgcn_tpu.cli.chem_summary import main as j_main
    from kgcn_tpu_torch.cli.chem_summary import main as t_main

    _, tpath = made
    for argv in (["-p", str(inputs / "mols.smi")], ["-p", str(inputs / "mols.sdf")],
                 ["-p", str(inputs / "mols.smi"), "-f", "smarts", "-b", "5"],
                 ["-p", str(tpath)]):
        want, got = _run(j_main, argv), _run(t_main, argv)
        assert got == want
        assert "#" * 30 + " Summary " in got
    assert "Histgram (atom number)" in _run(t_main, ["-p", str(inputs / "mols.smi")])


# ---- the KNIME helpers ------------------------------------------------------------

def _knime_chain(H, d, inputs):
    """The GCN-K node chain through the helpers' argparse entry points."""
    d.mkdir()
    H.main_prep_mol_info(["--sdf", str(inputs / "mols.sdf"), "--atom_num_limit", "30",
                          "--output", str(d / "mol_info.jbl")])
    H.main_prep_adj(["--mol_info", str(d / "mol_info.jbl"), "--output", str(d / "adj.jbl")])
    H.main_prep_feat(["--mol_info", str(d / "mol_info.jbl"), "--output", str(d / "feat.jbl")])
    H.main_prep_label(["--label", str(inputs / "sdf_labels.csv"),
                       "--output", str(d / "label.jbl")])
    H.main_prep_dataset(["--label", str(d / "label.jbl"), "--adjacent", str(d / "adj.jbl"),
                         "--atom_feature", str(d / "feat.jbl"),
                         "--output", str(d / "dataset.jbl")])
    H.main_clean_dataset(["--dataset", str(d / "dataset.jbl"), "--output", str(d / "clean.jbl")])
    H.main_split_dataset(["--dataset", str(d / "clean.jbl"), "--ratio", "0.6",
                          "--output1", str(d / "s1.jbl"), "--output2", str(d / "s2.jbl")])
    (d / "profeat.csv").write_text("".join(f"{i},0.5,{i * 2}\n" for i in range(5)))
    (d / "seq.csv").write_text("1,2,3\n4,5\n1\n2,2,2,2\n3\n")
    H.main_preprocess_modality(["--profeat", str(d / "profeat.csv"), "--sequence",
                                str(d / "seq.csv"), "--output", str(d / "modality.jbl")])
    H.main_add_modality(["--dataset", str(d / "clean.jbl"), "--modality",
                         str(d / "modality.jbl"), "--output", str(d / "with_modality.jbl")])


KNIME_FILES = ("mol_info.jbl", "adj.jbl", "feat.jbl", "label.jbl", "dataset.jbl",
               "clean.jbl", "s1.jbl", "s2.jbl", "modality.jbl", "with_modality.jbl")


def test_knime_helpers_write_the_jax_packages_files(inputs, tmp_path):
    from kgcn_tpu.knime import helpers as JH
    from kgcn_tpu_torch.knime import helpers as TH

    with contextlib.redirect_stdout(io.StringIO()):
        _knime_chain(JH, tmp_path / "j", inputs)
        _knime_chain(TH, tmp_path / "t", inputs)
    for name in KNIME_FILES:
        _same(joblib.load(tmp_path / "j" / name), jbl.load(str(tmp_path / "t" / name)), name)
    raw, clean = (jbl.load(str(tmp_path / "t" / n)) for n in ("dataset.jbl", "clean.jbl"))
    dropped = sum(a is None for a in raw["adj"])
    assert 0 < dropped < 24 and len(clean["adj"]) == 24 - dropped
    assert clean["feature"].shape == (24 - dropped, 30, 81)


def test_knime_scores_and_viewer(tmp_path):
    """gcn_score's CSV (graph- and node-centric) equals kgcn_tpu's; the score
    viewer draws its AUC plots (matplotlib) where kgcn_tpu draws them."""
    pytest.importorskip("matplotlib")
    from kgcn_tpu.knime import helpers as JH
    from kgcn_tpu_torch.knime import helpers as TH

    rng = np.random.RandomState(0)
    for name, pred in (("graph", rng.rand(12, 2)), ("node", rng.rand(3, 4, 2))):
        obj = {"prediction_data": pred, "true_label": rng.randint(0, 2, 12)}
        with open(tmp_path / f"{name}.jbl", "wb") as f:
            pickle.dump(obj, f)
        with contextlib.redirect_stdout(io.StringIO()):
            JH.main_gcn_score(["--prediction_data", str(tmp_path / f"{name}.jbl"),
                               "--output", str(tmp_path / f"j_{name}.csv")])
            TH.main_gcn_score(["--prediction_data", str(tmp_path / f"{name}.jbl"),
                               "--output", str(tmp_path / f"t_{name}.csv")])
        assert (tmp_path / f"t_{name}.csv").read_text() == \
            (tmp_path / f"j_{name}.csv").read_text()
    with contextlib.redirect_stdout(io.StringIO()):
        want = JH.gcn_score_viewer(str(tmp_path / "graph.jbl"), str(tmp_path / "j_plots"))
        got = TH.gcn_score_viewer(str(tmp_path / "graph.jbl"), str(tmp_path / "t_plots"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert all(os.path.getsize(p) > 0 for p in got)


# ---- training on a dataset the port made ------------------------------------------

def _train_config(tmp_path, dataset, side, **over):
    with open(os.path.join(REPO, "example_config", "solubility_cls.json")) as f:
        cfg = json.load(f)
    cfg.update(dict(dict(dataset=str(dataset), epoch=1, dropout_rate=0.0, save_interval=0,
                         save_model_path=str(tmp_path / side / "model"),
                         save_info_train=str(tmp_path / side / "info_train.json"),
                         save_info_valid=str(tmp_path / side / "info_valid.json"),
                         save_result_valid=str(tmp_path / side / "result_valid.csv")),
                    **over))
    (tmp_path / side).mkdir(exist_ok=True)
    path = tmp_path / side / "config.json"
    path.write_text(json.dumps(cfg))
    return cfg, str(path)


def _initial_checkpoint(cfg, path):
    """``kgcn_tpu``'s initial state of the config's model (the CLI's draw
    on its first training batch, seed 0) as a training checkpoint at epoch
    -1, which both CLIs resume at epoch 0."""
    from kgcn_tpu.data import Batcher, load_jbl, split_dataset
    from kgcn_tpu.models.registry import build_model
    from kgcn_tpu.runtime import checkpoint
    from kgcn_tpu.runtime.train import Trainer

    ds, info = load_jbl(cfg["dataset"], cfg)
    train, _, _, _ = split_dataset(ds, cfg["validation_data_rate"], seed=0,
                                   shuffle=bool(cfg["shuffle_data"]))
    trainer = Trainer(build_model(cfg["model.py"], info, cfg), cfg, info)
    bs = int(cfg["batch_size"])
    state = trainer.init_state(
        Batcher(train, info, bs).make_batch(np.arange(min(bs, train.num))), seed=0)
    return checkpoint.save_checkpoint(path, trainer.state_tree(state, -1, float("inf")))


def test_a_chem_dataset_trains_like_kgcn_tpu_from_the_same_weights(tmp_path):
    """160 seeded molecules made by the port's chem at the phase-17 atom
    limit (64), 2 epochs of 4 steps on each side."""
    from kgcn_tpu.cli.main import main as j_main
    from kgcn_tpu_torch.cli.chem import main as chem
    from kgcn_tpu_torch.cli.main import main as t_main

    smiles = chip_smoke.make_smiles(160, seed=5)
    labels, _ = chip_smoke.smiles_labels(smiles)
    (tmp_path / "mols.smi").write_text("\n".join(smiles) + "\n")
    (tmp_path / "labels.txt").write_text("".join(f"{a},{b}\n" for a, b in labels))
    tpath = tmp_path / "chem.jbl"
    _run(chem, ["--smiles", str(tmp_path / "mols.smi"), "--label",
                str(tmp_path / "labels.txt"), "--atom-num-limit", "64", "-o", str(tpath)])
    cfg, _ = _train_config(tmp_path, tpath, "jax")
    start = _initial_checkpoint(cfg, str(tmp_path / "start.ckpt"))
    costs = {}
    for side, main in (("jax", j_main), ("port", t_main)):
        _, path = _train_config(tmp_path, tpath, side, retrain=start, epoch=2)
        out = _run(main, ["train", "--config", path, "--cpu"])
        assert f"[LOAD] {start}" in out
        with open(tmp_path / side / "info_train.json") as f:
            costs[side] = json.load(f)["training_cost"]
    assert len(costs["port"]) == 2 and np.isfinite(costs["port"]).all()
    np.testing.assert_allclose(costs["port"], costs["jax"], rtol=0, atol=1e-4)


def test_visualize_dumps_the_ports_molecule_and_gcnv_reads_it(made, tmp_path):
    """``visualize`` of one molecule of a chem-made dataset: the dump holds
    the port's ``Molecule`` (the dataset's ``mol_info``), pickles, and
    ``cli.gcnv`` draws it on the CPU."""
    pytest.importorskip("matplotlib")
    from kgcn_tpu_torch.cli import gcnv
    from kgcn_tpu_torch.cli.main import main as t_main

    _, tpath = made
    _, path = _train_config(tmp_path, tpath, "port", visualize_num=1, ig_divide_number=8,
                            visualize_path=str(tmp_path / "vis"))
    _run(t_main, ["train", "--config", path, "--cpu"])
    _run(t_main, ["visualize", "--config", path, "--cpu"])
    dumps = sorted(os.listdir(tmp_path / "vis"))
    assert dumps, "no IG dump"
    dump = jbl.load(str(tmp_path / "vis" / dumps[0]))
    mols = jbl.load(str(tpath))["mol_info"]["obj_list"]
    assert type(dump["mol"]) is t_mp.Molecule
    assert dump["mol"].__getstate__() == mols[0].__getstate__()
    assert pickle.loads(pickle.dumps(dump))["mol"].__getstate__() == mols[0].__getstate__()
    said = _run(gcnv.main, [str(tmp_path / "vis" / dumps[0]), "--outdir", str(tmp_path / "g")])
    assert "IG completeness" in said
    assert any(p.endswith("_features_IG.png") for p in os.listdir(tmp_path / "g"))
