#!/usr/bin/env python3
"""Time this checkout of the port against another one on the GPU, in turns.

    python3 tree_compare.py BASE [--out chiprun_out/tree_compare.json] [--parts gconv]

BASE is a directory holding another checkout's ``kgcn_tpu_torch`` (for
example a parent commit unpacked with ``git archive`` into a git-ignored
directory).  The script copies that package to
``build/tree_compare/kgcn_tpu_torch_base`` with its imports renamed, builds
both packages' kernels, and times the two through their public entry points
only, so that any two checkouts which share them can be compared:

* the ELL aggregation on the pallas backend (``ops/spmm.ell_aggregate``,
  given the host-built transposed slot lists where the tree takes them):
  its forward, and forward plus the backward's dx, on a ring6 training
  batch (25 graphs of 6 nodes: V 150, K 5, F 3 and 50), on three ring6
  batches as channels (C 3, F 50), and on V 10⁵, K 10, F 128;
* the tiled SDDMM (``ops/tiled_spmm.tiled_sddmm``, bf16 payload) on the GAT
  batch of ``example_config/gat.json`` (F 50) and on a uniform graph of
  10⁵ nodes and 10⁶ edges (F 128, ``choose_tiling``'s tiling);
* the stream weight gradient (``ops/stream_spmm.stream_dw``, bf16 and f32
  payloads) on ``chip_smoke.stream_cases``' KG largest and smallest
  relation channels (of the WN18RR-shaped KG it generates), its uniform
  graph of 10⁵ nodes and 10⁶ edges and its hub graph (50 000 in-edges into
  one receiver), at F 128, and its rectangular (5 000 → 3 000 nodes) and
  macro-budget-padded (2 000 nodes) graphs at F 40, 64, 133 and 200, each
  tree building the structures from the same edges and macro count (the
  KG's channels are padded to one macro budget);
* the dense graph convolution (``ops/gconv.gconv``), float32 and bf16
  operands, at ``chip_smoke.GCONV_SHAPES`` and the reaction engine's three
  call shapes (``chip_smoke.ENGINE_GCONV``): the float32 outputs asserted bitwise
  equal to BASE's, the bf16 ones each within one bf16 rounding of the f64
  sum; then the captured bf16 training steps of the dense solubility GCN
  (``example_config/solubility_cls.json``) and of the reaction engine
  (``chip_smoke.REACTION`` through ``cli.sparse``'s model), each tree's
  whole-epoch runner in the order base, new, new, base;
* training steps of GIN (pallas, ring6 data), GAT (tiled,
  ``example_config/gat.json``) and GCN (stream, batch 1, 16 ring graphs of
  300 nodes): two trainers of BASE (A and B) and one of this tree (N) from
  one seed, stepped in rotation on the same host batches, each step timed
  from the move to the card to a synchronise; the medians of the paired
  differences N − A and B − A (the method's A/A spread), and the host's
  batch assembly (``make_batch``, its ELL or tiled part) per batch; after
  the steps N's parameters are asserted bitwise equal to A's.

Device times are ``chip_smoke.device_ms`` (torch.profiler, every CUDA
kernel of the call) taken in the order base, new, new, base.  Prints one
line per measure and writes every number to ``--out`` as JSON;
``--parts`` takes a subset of the measures.  Needs one
CUDA device; exits non-zero without one.
"""
import argparse
import inspect
import json
import os
import pickle
import re
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "tree_compare")
GIN_CONFIG = os.path.join(ROOT, "example_config", "gin.json")
GAT_CONFIG = os.path.join(ROOT, "example_config", "gat.json")
GCN_CONFIG = os.path.join(ROOT, "example_config", "synth.json")
DEVICE = "cuda"
SCALE = (100_000, 1_000_000)  # the SDDMM's uniform graph: nodes, edges
V_ELL = 100_000               # the ELL case at scale: V rows of K 10
SMALL_WIDTHS = (40, 64, 133, 200)  # the stream weight gradient's small structures
PARTS = ("ell", "sddmm", "stream_dw", "gconv", "steps")
SOLUBILITY_CONFIG = os.path.join(ROOT, "example_config", "solubility_cls.json")


def say(msg):
    print(msg, flush=True)


def renamed_copy(base):
    """BASE's ``kgcn_tpu_torch`` as the package ``kgcn_tpu_torch_base``."""
    dst = os.path.join(WORK, "kgcn_tpu_torch_base")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(base, "kgcn_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    for d, _, files in os.walk(dst):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(d, f)
                with open(p) as fh:
                    src = fh.read()
                # the package and its custom ops' namespace (one registry a
                # process: two trees' ``kgcn_torch::gconv`` would be one op)
                src = re.sub(r"\bkgcn_tpu_torch\b", "kgcn_tpu_torch_base", src)
                with open(p, "w") as fh:
                    fh.write(re.sub(r"\bkgcn_torch\b", "kgcn_torch_base", src))
    sys.path.insert(0, WORK)


def packages(base):
    import importlib

    renamed_copy(base)
    sys.path.insert(0, ROOT)
    out = {}
    for tag, name in (("base", "kgcn_tpu_torch_base"), ("new", "kgcn_tpu_torch")):
        mods = {m: importlib.import_module(f"{name}.{m}") for m in (
            "ops._build", "ops.spmm", "ops.tiled_spmm", "ops.stream_spmm", "ops.gconv",
            "data.batcher", "data.dataset", "data.tfrecord",
            "data.synthetic", "runtime.backend", "runtime.config", "runtime.train",
            "runtime.resident", "models.registry", "cli.sparse")}
        if DEVICE == "cuda":  # every kernel, one compiler process a source
            mods["ops._build"].build()
        out[tag] = mods
    return out


def in_turns(fns, iters):
    """{tag: [ms, ms]} of ``device_ms`` over ``fns`` {tag: fn}, in the order
    base, new, new, base."""
    from chip_smoke import device_ms

    res = {"base": [], "new": []}
    for tag in ("base", "new", "new", "base"):
        res[tag].append(device_ms(fns[tag], iters))
    return res


def report(rows, what, res):
    b, n = (sum(res[k]) / 2 for k in ("base", "new"))
    rows.append(dict(what=what, base=res["base"], new=res["new"]))
    say(f"{what}: base {res['base'][0]:.6f} {res['base'][1]:.6f} new {res['new'][0]:.6f} "
        f"{res['new'][1]:.6f} ms (means {b:.6f} -> {n:.6f})")


def ring6_file():
    path = os.path.join(WORK, "ring6.jbl")
    if not os.path.exists(path):
        from kgcn_tpu_torch.data.synthetic import make_ring_dataset

        with open(path, "wb") as f:
            pickle.dump(make_ring_dataset(num_pairs=1000, num_nodes=6, seed=0), f, protocol=4)
    return path


def config(mods, path, **over):
    cfg = mods["runtime.config"].load_config(path, over)
    if not os.path.isabs(cfg["dataset"]):
        cfg["dataset"] = os.path.join(ROOT, cfg["dataset"])
    return cfg


def host_batches(mods, cfg, n=None):
    """(model info, a Batcher of the config's resolved backend, its first
    ``n`` batches in dataset order, all of them by default) on the host."""
    ds, info = mods["data.dataset"].load_jbl(cfg["dataset"], cfg)
    be = mods["runtime.backend"].resolve(dict(cfg), info, log=False)
    bs = int(cfg["batch_size"])
    tb = mods["data.batcher"].Batcher(ds, info, bs, backend=be)
    idx = tb.epoch_indices(shuffle=False)
    starts = list(range(0, len(idx), bs))[:n]
    return info, tb, [tb.make_batch(idx[s:s + bs]) for s in starts]


def ell_kernels(P, rows):
    import numpy as np
    import torch

    from kgcn_tpu_torch.ops.ell import ell_transpose

    cfg = config(P["new"], GIN_CONFIG, dataset=ring6_file(), spmm_backend="pallas")
    _, _, batches = host_batches(P["new"], cfg, 3)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rng = np.random.RandomState(0)
    V = V_ELL
    big = (torch.from_numpy(rng.randint(0, V, (1, V, 10)).astype(np.int32)),
           torch.from_numpy((rng.random_sample((1, V, 10)) + 0.1).astype(np.float32)))
    one = batches[0].graph
    cases = [("ring6 batch C 1", one.ell_senders, one.ell_weights, (3, 50)),
             ("three ring6 batches C 3", torch.cat([b.graph.ell_senders for b in batches]),
              torch.cat([b.graph.ell_weights for b in batches]), (50,)),
             (f"V {V} K 10 C 1", *big, (128,))]
    for label, idx_h, w_h, widths in cases:
        C, V, K = idx_h.shape
        idx, w = idx_h.to(DEVICE), w_h.to(DEVICE)
        transpose = tuple(torch.from_numpy(a).to(DEVICE) for a in
                          ell_transpose(idx_h.numpy(), w_h.numpy(), V))
        for F in widths:
            x = torch.randn((V, F), device=DEVICE, generator=gen)
            g = torch.randn((V, F), device=DEVICE, generator=gen)
            fns_f, fns_b = {}, {}
            for tag in ("base", "new"):
                agg = P[tag]["ops.spmm"].ell_aggregate
                # the host-built transposed lists, to each tree that takes them
                takes = "transpose" in inspect.signature(agg).parameters
                kw = {"transpose": transpose} if takes else {}
                xg = x.clone().requires_grad_(True)
                fns_f[tag] = (lambda agg=agg, kw=kw: agg(idx, w, x, "pallas", **kw))
                fns_b[tag] = (lambda agg=agg, kw=kw, xg=xg: torch.autograd.grad(
                    agg(idx, w, xg, "pallas", **kw), xg, g))
            iters = 10 if V * K > 500_000 else 50
            report(rows, f"ell forward {label} F {F}", in_turns(fns_f, iters))
            report(rows, f"ell forward + dx {label} F {F}", in_turns(fns_b, iters))


def sddmm_kernels(P, rows):
    import numpy as np
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    structs = {}
    for tag in ("base", "new"):
        tt = P[tag]["ops.tiled_spmm"]
        cfg = config(P[tag], GAT_CONFIG, spmm_backend="tiled")
        _, _, (batch,) = host_batches(P[tag], cfg, 1)
        rng = np.random.RandomState(5)
        V, E = SCALE
        s, r = rng.randint(0, V, E), rng.randint(0, V, E)
        w = (rng.random_sample(E) + 0.1).astype(np.float32)
        ts, tr, chunk = tt.choose_tiling(s, r, V, 128)
        structs[tag] = [("GAT batch", batch.graph.tiled_adj[0].to(DEVICE), 50),
                        ("10^6 edges", tt.build_tiled(s, r, V, weights=w, ts=ts, tr=tr,
                                                      chunk=chunk).to(DEVICE), 128)]
    for i, (label, te, F) in enumerate(structs["new"]):
        V = te.meta.num_receivers
        a = torch.randn((V, F), device=DEVICE, generator=gen)
        b = torch.randn((te.meta.num_senders, F), device=DEVICE, generator=gen)
        fns = {tag: (lambda tag=tag: P[tag]["ops.tiled_spmm"].tiled_sddmm(
            structs[tag][i][1], a, b)) for tag in ("base", "new")}
        got = {tag: fn() for tag, fn in fns.items()}
        if not torch.allclose(got["base"], got["new"], rtol=1e-4, atol=1e-4):
            raise AssertionError(f"tiled_sddmm {label}: base and new differ")
        report(rows, f"tiled_sddmm {label} F {F}", in_turns(fns, 10 if F == 128 else 50))


def stream_dw_kernels(P, rows):
    import numpy as np
    import torch

    from chip_smoke import stream_cases

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    for label, ss_new, widths, _ in stream_cases(WORK):
        if "order-1" in label:
            continue
        if label.startswith(("rectangular", "budget")):
            widths = SMALL_WIDTHS
        _, row, send = ss_new.plan.entries.long().numpy()
        m = ss_new.meta
        structs = {}
        for tag in ("base", "new"):
            st = P[tag]["ops.stream_spmm"]
            structs[tag] = st.build_stream(  # the forward direction, macros padded alike
                send, row, m.num_receivers, weights=np.ones(len(row), np.float32),
                num_sender_nodes=m.num_senders, with_transpose=False,
                macro_budget=m.n_macros, materialize=False,
                **st.choose_stream(send, row, m.num_receivers, widths[0])).to(DEVICE)
        for F in widths:
            x = torch.randn((m.num_senders, F), device=DEVICE, generator=gen)
            g = torch.randn((m.num_receivers, F), device=DEVICE, generator=gen)
            for bf16 in (True, False):
                fns = {tag: (lambda tag=tag, bf16=bf16, x=x, g=g: P[tag][
                    "ops.stream_spmm"].stream_dw(structs[tag], x, g, bf16))
                    for tag in ("base", "new")}
                got = {tag: fn() for tag, fn in fns.items()}
                if not torch.allclose(got["base"], got["new"], rtol=1e-4, atol=1e-4):
                    raise AssertionError(f"stream_dw {label} F {F}: base and new differ")
                report(rows, f"stream_dw {label} F {F} {'bf16' if bf16 else 'f32'}",
                       in_turns(fns, 10 if len(row) > 500_000 else 50))


def gconv_kernels(P, rows):
    """Each tree's gconv at float32 and bf16, in turns; float32 outputs
    bitwise equal, bf16 ones each within one bf16 rounding of the f64 sum."""
    import math

    import torch

    from chip_smoke import ENGINE_GCONV, GCONV_SHAPES, within_one_bf16_rounding

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    for label, (C, B, N, Fin, Fout) in list(GCONV_SHAPES) + ENGINE_GCONV:
        adj = torch.rand((C, B, N, N), device=DEVICE, generator=gen) * (2.0 / N)
        x = torch.rand((B, N, Fin), device=DEVICE, generator=gen)
        w = torch.randn((C, Fin, Fout), device=DEVICE, generator=gen) / math.sqrt(Fin)
        b = torch.randn((C, Fout), device=DEVICE, generator=gen) * 0.1
        for dt in (torch.float32, torch.bfloat16):
            ops = [t.to(dt) for t in (adj, x, w, b)]
            fns = {tag: (lambda tag=tag, ops=ops: P[tag]["ops.gconv"].gconv(*ops))
                   for tag in ("base", "new")}
            got = {tag: fn() for tag, fn in fns.items()}
            if dt == torch.float32:
                if not torch.equal(got["base"], got["new"]):
                    raise AssertionError(f"gconv float32 {label}: base and new differ")
                check = "bitwise equal to base"
            else:
                for tag in ("base", "new"):
                    within_one_bf16_rounding(f"gconv bf16 {label} {tag}", ops, got[tag])
                diff = float((got["base"].float() - got["new"].float()).abs().max())
                check = f"each within one bf16 rounding of the f64 sum; |base - new| {diff:.3g}"
            name = str(dt).replace("torch.", "")
            say(f"gconv {name} {label} {(C, B, N, Fin, Fout)}: {check}")
            report(rows, f"gconv {name} {label}", in_turns(fns, 20 if B * N > 10000 else 100))


def captured_bf16_steps(P, rows, workdir):
    """The captured bf16 steps of the dense solubility GCN and of the
    reaction engine, each tree's whole-epoch runner from seed 0; epochs in
    the order base, new, new, base (``chip_smoke.epoch_numbers``: wall ms a
    step, device busy ms a step, idle share)."""
    import glob

    import numpy as np

    from chip_smoke import REACTION, epoch_numbers, sparse_config, write_molecules

    pattern, _ = write_molecules(workdir, "reaction", REACTION)
    os.makedirs(os.path.join(workdir, "reaction_bf16"))
    cfg_r, _ = sparse_config(workdir, "reaction_bf16", pattern, REACTION,
                             precision="bfloat16")
    runs = {}
    for tag in ("base", "new"):
        mods = P[tag]
        cfg = config(mods, SOLUBILITY_CONFIG, dropout_rate=0.0, precision="bfloat16")
        ds, info = mods["data.dataset"].load_jbl(cfg["dataset"], cfg)
        be = mods["runtime.backend"].resolve(dict(cfg), info, log=False)
        train, _, _, _ = mods["data.dataset"].split_dataset(
            ds, cfg["validation_data_rate"], seed=int(cfg["seed"]),
            shuffle=bool(cfg["shuffle_data"]))
        rb = mods["runtime.resident"].ResidentBatcher(
            train, info, int(cfg["batch_size"]), seed=0, backend=be, device=DEVICE)
        model = mods["models.registry"].build_model(cfg["model.py"], info, cfg)
        runs.setdefault("gcn dense solubility bf16", {})[tag] = (
            mods["runtime.train"].Trainer(model, cfg, info, device=DEVICE), rb)
        ds, info = mods["data.tfrecord"].load_tfrecord_dataset(sorted(glob.glob(pattern)),
                                                               cfg_r)
        be = mods["runtime.backend"].resolve(dict(cfg_r), info, log=False)
        train = ds.subset(np.arange(ds.num)[np.arange(ds.num) % 5 != 0])
        rb = mods["runtime.resident"].ResidentBatcher(train, info, REACTION["batch"], seed=0,
                                                      backend=be, device=DEVICE)
        model = mods["cli.sparse"]._model(cfg_r, info)
        runs.setdefault("reaction bf16", {})[tag] = (
            mods["runtime.train"].Trainer(model, cfg_r, info, device=DEVICE), rb)
    for what, trees in runs.items():
        numbers = {"base": [], "new": []}
        states = {tag: tr.init_state(0) for tag, (tr, _) in trees.items()}
        for tag in ("base", "new", "new", "base"):
            trainer, rb = trees[tag]

            def run(tag=tag, tr=trainer, rb=rb):
                states[tag] = tr.run_epoch(states[tag], rb, epoch=0)[0]
            wall, _, busy, idle = epoch_numbers(run, rb.num_batches)
            numbers[tag].append(dict(wall_ms=wall, busy_ms=busy, idle=idle))
        rows.append(dict(what=f"captured step {what}", steps=rb.num_batches, **numbers))
        say(f"captured step {what} ({rb.num_batches} steps an epoch; base, new, new, base): "
            + "; ".join(f"{tag} " + ", ".join(
                f"wall {n['wall_ms']:.4f} busy {n['busy_ms']:.4f} idle {n['idle']:.4f}"
                for n in numbers[tag]) for tag in ("base", "new")))


def gconv_part(P, rows):
    gconv_kernels(P, rows)
    with tempfile.TemporaryDirectory(prefix="tree_compare_") as workdir:
        captured_bf16_steps(P, rows, workdir)


def ring300_file():
    """16 ring graphs of 300 nodes (the stream case's data)."""
    path = os.path.join(WORK, "ring300.jbl")
    if not os.path.exists(path):
        from kgcn_tpu_torch.data.synthetic import make_ring_dataset

        with open(path, "wb") as f:
            pickle.dump(make_ring_dataset(num_pairs=8, num_nodes=300, seed=0), f, protocol=4)
    return path


def step_walls(P, rows, runs=3):
    import numpy as np
    import torch

    for name, src, over in (
            ("gin pallas ring6", GIN_CONFIG, dict(dataset=ring6_file(), spmm_backend="pallas")),
            ("gat tiled", GAT_CONFIG, dict(spmm_backend="tiled")),
            ("gcn stream ring300", GCN_CONFIG, dict(dataset=ring300_file(), batch_size=1,
                                                    spmm_backend="stream"))):
        trees = {}
        for key, tag in (("A", "base"), ("B", "base"), ("N", "new")):
            mods = P[tag]
            cfg = config(mods, src, **over)
            info, tb, batches = host_batches(mods, cfg)
            model = mods["models.registry"].build_model(cfg["model.py"], info, cfg)
            trainer = mods["runtime.train"].Trainer(model, cfg, info, device=DEVICE)
            trees[key] = dict(tb=tb, trainer=trainer, batches=batches,
                              state=trainer.init_state(seed=0), walls=[], moves=[])
        n = len(trees["N"]["batches"])
        for r in range(runs + 1):  # the first pass warms up
            order = ("A", "N", "B") if r % 2 == 0 else ("B", "N", "A")
            for i in range(n):
                for key in order:
                    t = trees[key]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    batch = t["batches"][i].to(DEVICE)
                    t1 = time.perf_counter()
                    t["state"], _, _ = t["trainer"].train_step(t["state"], batch)
                    torch.cuda.synchronize()
                    if r:
                        t["walls"].append(time.perf_counter() - t0)
                        t["moves"].append(t1 - t0)
        # the same steps from one seed: this tree's state bitwise BASE's
        bitwise = all(torch.equal(trees["N"]["state"].params[k], trees["A"]["state"].params[k])
                      for k in trees["A"]["state"].params)
        if not bitwise:
            raise AssertionError(f"step wall {name}: the state after the same steps "
                                 "differs from BASE's")
        w = {k: np.asarray(t["walls"]) * 1e3 for k, t in trees.items()}
        host = {}
        for key in ("A", "N", "N", "A"):  # host batch assembly, in turns
            t = trees[key]
            tb = t["tb"]
            part0 = tb.ell_seconds + tb.tiled_seconds
            idx = tb.epoch_indices(shuffle=False)
            bs = tb.batch_size
            t0 = time.perf_counter()
            for s in range(0, len(idx), bs):
                tb.make_batch(idx[s:s + bs])
            k = -(-len(idx) // bs)
            host.setdefault(key, []).append(((time.perf_counter() - t0) / k * 1e3,
                                             (tb.ell_seconds + tb.tiled_seconds - part0)
                                             / k * 1e3))
        row = dict(what=f"step wall {name}", steps=len(w["N"]), bitwise_equal_to_base=bitwise,
                   median_ms={k: float(np.median(v)) for k, v in w.items()},
                   new_minus_A=float(np.median(w["N"] - w["A"])),
                   B_minus_A=float(np.median(w["B"] - w["A"])),
                   move_ms={k: float(np.median(t["moves"]) * 1e3) for k, t in trees.items()},
                   host_batch_ms={"base": host["A"], "new": host["N"]})
        rows.append(row)
        say(f"step wall {name} ({row['steps']} steps each): medians A "
            f"{row['median_ms']['A']:.4f} B {row['median_ms']['B']:.4f} N "
            f"{row['median_ms']['N']:.4f} ms; N - A {row['new_minus_A']:+.4f}, B - A "
            f"{row['B_minus_A']:+.4f} (A/A); move median A {row['move_ms']['A']:.4f} N "
            f"{row['move_ms']['N']:.4f}; host batch ms (all, its ELL/tiled part) base "
            f"{host['A']} new {host['N']}; the state after the same steps bitwise equal "
            "to BASE's")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", help="directory holding the other checkout's kgcn_tpu_torch")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "tree_compare.json"))
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated measures to take, of {', '.join(PARTS)}")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        say("FAIL: no CUDA device")
        sys.exit(2)
    os.makedirs(WORK, exist_ok=True)
    P = packages(os.path.abspath(args.base))
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    say(f"nvidia-smi: {smi}")
    parts = args.parts.split(",")
    if set(parts) - set(PARTS):
        ap.error(f"--parts: unknown {sorted(set(parts) - set(PARTS))}")
    rows = []
    for name, fn in zip(PARTS, (ell_kernels, sddmm_kernels, stream_dw_kernels, gconv_part,
                                step_walls)):
        if name in parts:
            fn(P, rows)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": smi, "rows": rows}, f, indent=1)
    say(f"wrote {args.out}")


if __name__ == "__main__":
    main()
