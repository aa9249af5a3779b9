#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kgcn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced on its own line; any failure ends the run with a
non-zero exit and no result line:

1. environment — the card (nvidia-smi name and power limit), torch, CUDA;
2. build — every CUDA kernel of the port (gconv.cu, tiled.cu, stream.cu, ell.cu)
   and the tiled backend's host library (tiled_host.cc), from
   kgcn_tpu_torch/ops/csrc, one compiler process per source, in parallel;
3. kernel check: gconv — against its plain PyTorch version on the card at
   the serving path's shapes, a misaligned toy, a reaction-scale batch,
   dense graphs of 600 and 1024 nodes and 70 000 graphs of 8 nodes (more
   than a grid dimension's 65 535) (float32, rtol = atol = 1e-4: the sums
   run over ≤ 2 048 terms in another order; the distance of both from an
   f64 sum is printed), two launches bitwise equal, the kernels a call
   launches as the wrapper counts them equal to those torch.profiler
   records, with its device time (torch.profiler), the plain version's, one
   library call's, and the least time the card could take (bytes at
   3.35 TB/s vs FLOP at 67 TFLOP/s FP32);
4. kernel check: tiled SpMM (forward and on the transpose structure, the
   backward's dx) and SDDMM — against their plain versions on the card, with
   the float32 and the bf16 payload, rtol = atol = 1e-4 (both versions apply
   the same bf16 roundings; only the order of the f32 sums differs), on the
   solubility training batch (F 81 and 50), the GAT batch of synthetic.jbl
   (F 50), a rectangular case, one with edge-free receiver tiles, a
   budget-padded, a locality-relabelled and a wide-tile case (sums in the
   output), and a uniform random graph of 100 000 nodes and 1 000 000
   edges at F 128 tiled by choose_tiling; each case's SpMM plans (built by
   the host library csrc/tiled_host.cc, as the move to the card builds
   them), with their shape and host ms; two launches of the SpMM bitwise
   equal; device times as in phase 3, the library calls being
   torch.sparse.mm and torch.sparse.sampled_addmm;
5. train — ``python -m kgcn_tpu_torch.cli.main train`` in this process:
   the tiled solubility GCN and the tiled GAT for 2 epochs (finite, falling
   training cost, the [SAVE] and [restore] lines, every file written, and
   kernel launches = 6 SpMM per GCN step, 6 SpMM + 3 SDDMM per GAT step,
   3 SpMM per evaluated batch), the dense solubility GCN for 1 epoch (3 gconv
   kernels per step and per evaluated batch), the dense GCN of synth.json
   for 1 epoch on 32 ring graphs of 700 nodes (``make_ring_dataset(
   num_pairs=16, num_nodes=700)``, 768 padded; per step and evaluated batch
   the gconv kernels of one forward at that shape, at least one a
   GraphConv), and
   the solubility GCN with dropout 0 and the f32 payload on the GPU and on
   the CPU from one seed (per-epoch training costs within 1e-3 relative);
   3 dense GCN steps on the 700-node graphs, GPU vs CPU (1e-3); two GPU
   runs of 3 steps from one seed bitwise equal, for GAT on the tiled backend
   and GIN with xla; ``segment_sum``'s and ``segment_softmax``'s values and
   gradients on the card with no host sync (with a GAT batch's segments,
   sorted on the host, and with ids on the card alone); then one epoch of each timed step by step (host batch
   assembly and tiled-structure building, step wall time and the SpMM plans
   that the move to the card builds within it, device busy time and idle
   share);
6. serve — the port's HTTP server (cli/serve.build_server) answers /predict
   requests of 1, 8, 32 and 100 real molecules of
   examples/solubility/solubility_cls.jbl with a seeded GCN at the config's
   full width (example_config/solubility_cls.json: hidden 50, batch 32,
   47 nodes, 81 features); answers are checked (rows sum to 1, finite,
   equal to the same model run on the CPU to 1e-4) and the kernel launch
   counts read back;
7. kernel check: stream — the stream backend's three kernels (the
   iota-route scatter, the one-hot scatter, the weight gradient), forward
   and on the transpose structure (dx), against their plain versions run on
   CPU copies of the inputs, with the float32 and the bf16 payload,
   rtol = atol = 1e-4, on the KG path's largest and smallest relation
   channels (F 128), a uniform random graph of 100 000 nodes and 1 000 000
   edges at F 128 with choose_stream's parameters, a hub graph (the KG's
   40 960 nodes, 81 920 uniform edges and 50 000 more into one receiver,
   weighted as the KG's channels are, F 128), the same hub graph with
   weights of order 1, a rectangular (F 64 and 200) and a
   macro-budget-padded case (F 40 and 133: the scatters' scalar path, F not
   a multiple of 4, and more than one 128-column group); on the hub cases
   the scatters are also held against an f64 sum, each row within 1e-4 +
   sqrt(n)·2^-24·Σ|message| (n its messages), and with order-1 weights
   against that alone (the plain version's own f32 error on the hub row
   passes 1e-4); two launches of each scatter bitwise equal; device times
   as in phase 3, the library calls being torch.sparse.mm and
   torch.sparse.sampled_addmm;
8. kg — a knowledge graph of WN18RR's published shape (40 943 entities, 11
   relations with its training-set relation shares, 89 969 distinct
   triples, power-law entity frequency) generated from a seed as a triple
   TSV, preprocessed by ``python -m kgcn_tpu_torch.cli.kg``, then
   ``cli.main train`` (KG GCN encoder, width 128, label batch 1024, 2 epochs,
   spmm_backend auto → stream, bf16 payload) and ``cli.main infer`` in this
   process: finite falling cost, the checkpoint, finite ranking metrics, and
   exact launch counts (4·C one-hot scatters per step, 2·C per infer, no
   weight gradient); the same with the float32 payload for 1 epoch (4·C
   iota-route scatters per step); the first 3 steps of the float32 run on
   the GPU and on the CPU from one seed (costs within 1e-3 relative); and a
   step breakdown (the graph batch's host build and its stream structures,
   host ms per step, step wall time, device busy time and idle share);
9. kernel check: ELL — the pallas backend's ELL gather kernel against its
   plain version run on CPU copies of the inputs (float32 rtol = atol =
   1e-4, bf16 x 1e-2: the einsum sums in another order, and bf16 rounds the
   output once), on the ELL path's batch of 25 ring graphs (V 150, K 5; F 3
   and 50), 1 024 ring graphs (F 50), uniform degree 8 (V 16 384, F 128),
   V 100 000 with K 10 (10⁶ slots, F 128), a skewed case (K 16, mean degree
   5, most slots padding) and K 1 at F 81; the autograd wrapper's value, dx
   and dw on the card against the CPU; device times as in phase 3, the
   library call being torch.sparse.mm on a CSR of the same slots;
10. ell — a ring dataset of 6-node graphs (``make_ring_dataset(num_pairs=
   1000, num_nodes=6, seed=0)``, which the ELL gate admits) written as a
   pickle, then ``cli.main train`` for gin (example_config/gin.json's
   settings, spmm_backend pallas, 2 epochs) and ``cli.main infer``, and gcn
   for 1 epoch: exact launch counts (2·C ELL launches per GIN forward, 3·C
   per GCN forward, none in a backward), falling cost, every file; 3 f32
   GIN steps on the GPU and on the CPU from one seed (1e-3); a step
   breakdown with the idle share; then gin on example_config/gin.json
   itself with pallas and with xla, where the gate refuses ELL: 0 ELL
   launches and, on pallas, the JAX package's fallback message;
11. summary — one JSON line of kernel numbers, then the result line.

Kernel launch counts are set to 0 just before each run of a path (phases 5,
6, 8 and 10) and read just after; the summary's ``launches`` add up the
tiled GCN, tiled GAT and dense GCN training runs and the serve run, the KG
runs (train and infer) for the stream kernels, and the ring runs (train and
infer) for the ELL kernel.
Exits non-zero without a CUDA device and outside a checkout of the repo.
``SCALE`` and ``KG_SHRINK`` cut the scale case and the KG for a rehearsal
on the CPU, with ``DEVICE = "cpu"`` and the kernels' launch functions
swapped for counted plain versions.
"""
import contextlib
import io
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "example_config", "solubility_cls.json")
GAT_CONFIG = os.path.join(ROOT, "example_config", "gat.json")
DATASET = os.path.join(ROOT, "examples", "solubility", "solubility_cls.jbl")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, FP32 outside tensor cores
TOL = 1e-4
TRAJECTORY_RTOL = 1e-3      # GPU vs CPU training cost, tests/test_reference_parity.py:434-441
DEVICE = "cuda"
SCALE = (100_000, 1_000_000, 128)  # uniform random graph: nodes, edges, F
HUB_EDGES = 50_000   # in-edges of the hub case's one hub receiver
KG_CONFIG = os.path.join(ROOT, "example_config", "kg.json")
# WN18RR (Dettmers et al. 2018): entities, and the training-set triple count
# of each of its 11 relations; train 86 835 + test 3 134 distinct triples
WN18RR_ENTITIES = 40_943
WN18RR_RELATION_COUNTS = (34_796, 29_715, 7_402, 4_816, 3_116, 2_921, 1_299,
                          1_138, 923, 629, 80)
WN18RR_TRIPLES = 86_835 + 3_134
KG_TEST_RATE = 0.035
KG_OVERRIDES = dict(kg_encoder="gcn", embedding_dim=128, label_batch_size=1024,
                    epoch=2)
KG_SHRINK = 1        # divide entities and triples (CPU rehearsal only)
# kernels that no main-path run launches, and why
NO_MAIN_PATH_LAUNCH = {
    "stream_dw": "the KG's adjacency weights are constants, so no step asks "
                 "for their gradient",
}
ZIPF_EXPONENT = 0.75  # entity frequency ∝ (rank + 1)^-0.75

# (C, B, N, Fin, Fout): the serving path's three GraphConv calls per batch,
# a misaligned toy (tests/test_kernels.py:89), a reaction-scale batch, dense
# graphs of 600 and 1024 nodes (the two-launch design at mid sizes), and more
# small graphs than a grid dimension's 65 535 (the one-launch design)
GCONV_SHAPES = [
    ("path layer 1", (1, 32, 47, 81, 50)),
    ("path layer 2", (1, 32, 47, 50, 50)),
    ("path layer 3", (1, 32, 47, 50, 50)),
    ("misaligned", (2, 2, 10, 7, 5)),
    ("reaction-scale", (3, 128, 203, 81, 128)),
    ("N 600", (1, 8, 600, 64, 64)),
    ("N 1024", (2, 4, 1024, 81, 50)),
    ("B 70 000", (1, 70_000, 8, 16, 16)),
]
# the dense train on large graphs: ring graphs of 700 nodes (768 padded)
RING700 = dict(num_pairs=16, num_nodes=700, seed=0)
REQUEST_SIZES = (1, 8, 32, 100)
GIN_CONFIG = os.path.join(ROOT, "example_config", "gin.json")
GCN_RING_CONFIG = os.path.join(ROOT, "example_config", "synth.json")
RING6 = dict(num_pairs=1000, num_nodes=6, seed=0)  # 2 000 graphs, ELL K 5
ELL_TOL = {"float32": TOL, "bfloat16": 1e-2}


def say(msg):
    print(msg, flush=True)


def phase(n, name):
    say(f"== phase {n}: {name}")


def call_ms(fn, iters):
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls from
    this host loop (CUDA events, after a warm-up): what a Python caller
    pays, launch overhead included."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, attempts=3):
    """Device time per call of ``fn`` in ms: the summed duration of every
    CUDA kernel it launches (torch.profiler), over ``iters`` calls.  A
    profiling window that records no device time at all (seen once on the
    H100 for a 1.5 µs kernel) is taken again, up to ``attempts`` times, and
    then the time comes from CUDA events around the calls (``call_ms``:
    launch overhead included, so an upper bound), said so on the log."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(getattr(ev, "device_time_total", 0.0)
                       for ev in prof.key_averages())
        if total_us > 0:
            return total_us / iters / 1e3
        say("  torch.profiler recorded no device time; profiling again")
    ms = call_ms(fn, iters)
    say(f"  device time from CUDA events instead (upper bound): {ms:.6f} ms")
    return ms


def kernels_in(fn, counted, attempts=3):
    """(CUDA kernels that torch.profiler records in one call of ``fn``, the
    launches that ``counted.launches`` added in that call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        before = counted.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(ev.count for ev in prof.key_averages()
                if getattr(ev, "device_type", None) == DeviceType.CUDA)
        if n:
            return n, counted.launches - before
        say("  torch.profiler recorded no kernel; profiling again")
    raise AssertionError("torch.profiler recorded no kernel in three windows")


def library_ms(fn, iters):
    """``device_ms`` of a PyTorch library call used as a yardstick; None,
    with the reason printed, where the library refuses the inputs."""
    try:
        return device_ms(fn, iters)
    except RuntimeError as e:
        say(f"  library call refused: {str(e).splitlines()[0]}")
        return None


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes at the HBM rate and FLOP at
    the FP32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gconv_bound(C, B, N, Fin, Fout):
    """Every input read once and the output written once, against X W_c
    computed once per graph plus the aggregation."""
    nbytes = 4 * (C * B * N * N + B * N * Fin + C * Fin * Fout + C * Fout + B * N * Fout)
    flops = 2 * C * B * N * (Fin * Fout + N * Fout) + 2 * C * B * N * Fout
    return bound(nbytes, flops)


def phase_environment():
    import torch

    phase(1, "environment")
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false; this run needs one GPU")
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"nvidia-smi: {smi}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    sys.path.insert(0, ROOT)
    import kgcn_tpu_torch  # noqa: F401  (fails outside a checkout)
    return smi


def phase_build():
    from kgcn_tpu_torch.ops import _build

    phase(2, "build")
    t0 = time.time()
    paths = _build.build(log=say)
    say(f"built {sorted(paths)} in {time.time() - t0:.2f} s")


def phase_gconv_check():
    import torch

    from kgcn_tpu_torch.ops.gconv import gconv, gconv_reference

    phase(3, "kernel check: gconv (kgcn_tpu_torch/ops/csrc/gconv.cu)")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    for label, (C, B, N, Fin, Fout) in GCONV_SHAPES:
        # operands at the model's scales: a normalised adjacency (rows sum
        # ~1), features in [0, 1), Glorot-sized weights
        adj = torch.rand((C, B, N, N), device=DEVICE, generator=gen) * (2.0 / N)
        x = torch.rand((B, N, Fin), device=DEVICE, generator=gen)
        w = torch.randn((C, Fin, Fout), device=DEVICE, generator=gen) / math.sqrt(Fin)
        b = torch.randn((C, Fout), device=DEVICE, generator=gen) * 0.1
        got = gconv(adj, x, w, b)
        want = gconv_reference(adj, x, w, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=TOL, atol=TOL):
            raise AssertionError(f"gconv {label} {(C, B, N, Fin, Fout)}: "
                                 f"max |kernel - plain| = {err}")
        if not torch.equal(got, gconv(adj, x, w, b)):
            raise AssertionError(f"gconv {label}: two launches differ")
        kernels, counted = kernels_in(lambda: gconv(adj, x, w, b), gconv)
        if counted != kernels:
            raise AssertionError(f"gconv {label}: the wrapper counted {counted} "
                                 f"kernels, torch.profiler recorded {kernels}")
        exact = gconv_reference(*(t.double() for t in (adj, x, w, b)))
        err64 = float((got.double() - exact).abs().max())
        plain64 = float((want.double() - exact).abs().max())
        del exact

        def library():
            return (torch.einsum("cbnm,bmi,cif->bnf", adj, x, w)
                    + torch.einsum("cbn,cf->bnf", adj.sum(-1), b))

        lib_err = float((library() - want).abs().max())
        iters = 20 if B * N > 10000 else 100
        plain_ms = device_ms(lambda: gconv_reference(adj, x, w, b), iters)
        kernel_ms = device_ms(lambda: gconv(adj, x, w, b), iters)
        library_ms = device_ms(library, iters)
        host_ms = call_ms(lambda: gconv(adj, x, w, b), iters)
        bound_ms, bound_by = gconv_bound(C, B, N, Fin, Fout)
        rows.append(dict(label=label, shape=(C, B, N, Fin, Fout), err=err,
                         kernel_ms=kernel_ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        say(f"gconv {label:15s} C,B,N,Fin,Fout={(C, B, N, Fin, Fout)}: "
            f"max_abs_err={err:.3g} (library {lib_err:.3g}; against f64: kernel "
            f"{err64:.3g}, plain {plain64:.3g}); two launches bitwise equal; {kernels} "
            "kernel(s) a call, as counted; device time: "
            f"kernel_ms={kernel_ms:.6f} plain_ms={plain_ms:.6f} "
            f"library_ms={library_ms:.6f} bound_us={bound_ms * 1e3:.3f} "
            f"({bound_by}); host-loop ms per gconv call={host_ms:.5f}")
    return rows


# ---------------------------------------------------------------------------
# phase 4: the tiled kernels


def _load_config(path, **over):
    from kgcn_tpu_torch.runtime.config import load_config

    cfg = load_config(path, over)
    cfg["dataset"] = os.path.join(ROOT, cfg["dataset"])
    return cfg


def _path_batch(config_path, compute_dtype="bfloat16"):
    """The first training batch of a shipped config on the tiled backend:
    (TiledCOO of channel 0, its edge weights)."""
    import numpy as np

    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.runtime.backend import Backend

    cfg = _load_config(config_path)
    ds, info = load_jbl(cfg["dataset"], cfg)
    bs = int(cfg["batch_size"])
    g = Batcher(ds, info, bs, backend=Backend("tiled", compute_dtype)).make_batch(
        np.arange(bs)).graph
    return g.tiled_adj[0], g.edge_weights[0]


def tiled_cases():
    """(label, TiledCOO on the CPU, weights [E], widths, on the main path)."""
    import numpy as np
    import torch

    from kgcn_tpu_torch.ops import tiled_spmm as tt

    def uniform(V, E, seed, vs=None):
        rng = np.random.RandomState(seed)
        return (rng.randint(0, vs or V, E), rng.randint(0, V, E),
                (rng.random_sample(E) + 0.1).astype(np.float32))

    cases = []
    te, w = _path_batch(CONFIG)
    cases.append(("solubility batch", te, w, (81, 50), True))
    te, w = _path_batch(GAT_CONFIG)
    cases.append(("GAT batch", te, w, (50,), True))
    s, r, w = uniform(3000, 30000, seed=1, vs=5000)
    cases.append(("rectangular 5000->3000", tt.build_tiled(
        s, r, 3000, weights=w, num_sender_nodes=5000, ts=256, tr=128, chunk=128),
        torch.from_numpy(w), (64,), False))
    s, r, w = uniform(4000, 16000, seed=6)
    r[r >= 900] = 3100 + r[r >= 900] % 900  # receiver tiles 4-11 get no edge
    cases.append(("empty receiver tiles", tt.build_tiled(
        s, r, 4000, weights=w, ts=256, tr=256, chunk=256),
        torch.from_numpy(w), (48,), False))
    s, r, w = uniform(2000, 12000, seed=2)
    w[::5] = 0.0  # padding edges, dropped from the structure
    need = tt.build_tiled(s, r, 2000, weights=w, ts=256, tr=256, chunk=512)
    budget = 2 * max(need.meta.n_chunks, need.transpose.meta.n_chunks)
    cases.append((f"budget-padded ({budget} chunks)", tt.build_tiled(
        s, r, 2000, weights=w, ts=256, tr=256, chunk=512, chunk_budget=budget),
        torch.from_numpy(w), (40,), False))
    rng = np.random.RandomState(3)
    V, E = 20000, 200000
    s = np.minimum((rng.pareto(1.2, E) * 40).astype(np.int64), V - 1)  # hubs
    r = rng.randint(0, V, E)
    w = (rng.random_sample(E) + 0.1).astype(np.float32)
    cases.append(("locality-relabelled", tt.build_tiled(
        s, r, V, weights=w, ts=512, tr=512, chunk=512, locality=True),
        torch.from_numpy(w), (64,), False))
    s, r, w = uniform(6000, 60000, seed=4)  # 8 row slices per receiver tile
    cases.append(("wide tiles (tr 2048)", tt.build_tiled(
        s, r, 6000, weights=w, ts=2048, tr=2048, chunk=256),
        torch.from_numpy(w), (96,), False))
    V, E, F = SCALE
    s, r, w = uniform(V, E, seed=5)
    ts, tr, chunk = tt.choose_tiling(s, r, V, F)
    cases.append((f"scale V={V} E={E}", tt.build_tiled(
        s, r, V, weights=w, ts=ts, tr=tr, chunk=chunk),
        torch.from_numpy(w), (F,), False))
    return cases


def _csr(te, weights):
    """The structure's sparse matrix (receiver rows, sender columns) as CSR,
    and its 0/1 pattern, built from the same slots the kernels walk."""
    import torch

    from kgcn_tpu_torch.ops import tiled_spmm as tt

    m = te.meta
    valid, send, recv = tt._slot_rows(te)
    w_ext = torch.cat([weights, weights.new_zeros(1)])
    vals = w_ext[te.slot_src.reshape(-1).long()][valid]
    idx = torch.stack([recv[valid], send[valid]])
    shape = (m.num_receivers, m.num_senders)
    mat = torch.sparse_coo_tensor(idx, vals, shape).coalesce().to_sparse_csr()
    pat = torch.sparse_coo_tensor(idx, torch.ones_like(vals), shape).coalesce()
    pat = torch.sparse_coo_tensor(pat.indices(), torch.ones_like(pat.values()),
                                  shape).to_sparse_csr()
    return mat, pat


def tiled_bound(te, F):
    """(bound_ms, bound_by) of either kernel on this structure's real edges:
    the [num_senders, F] and [num_receivers, F] operands moved once (the
    SpMM reads x and writes out, the SDDMM reads x and g), per edge its
    sender, receiver and edge index and its weight (SpMM) or its output
    (SDDMM), 2·F FLOP per edge.  Padding slots and filler chunks are not
    work the function needs."""
    m = te.meta
    n_edges = int((te.slot_src < m.num_edges).sum())
    nbytes = 4 * ((m.num_senders + m.num_receivers) * F + 4 * n_edges)
    return bound(nbytes, 2 * n_edges * F)


def _check(what, got, want):
    import torch

    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=TOL, atol=TOL):
        raise AssertionError(f"{what}: max |kernel - plain| = {err}")
    return err


def phase_tiled_check():
    import torch

    from kgcn_tpu_torch.ops import tiled_spmm as tt

    phase(4, "kernel check: tiled SpMM and SDDMM (kgcn_tpu_torch/ops/csrc/tiled.cu)")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.time()
    cases = tiled_cases()
    say(f"structures built on the host in {time.time() - t0:.2f} s")
    # the SpMM plans, as the move to the card builds them
    cases = [(label, tt.with_plan(te), *rest) for label, te, *rest in cases]
    rows = []
    for label, te_cpu, w_cpu, widths, on_path in cases:
        te, w = te_cpu.to(DEVICE), w_cpu.to(DEVICE, torch.float32)
        m, mt = te.meta, te.transpose.meta
        n_edges = int((te_cpu.slot_src < m.num_edges).sum())
        say(f"tiled {label}: {m.num_senders} -> {m.num_receivers} nodes, "
            f"{n_edges} edges of {m.num_edges}, (ts, tr, chunk) = "
            f"{(m.ts, m.tr, m.chunk)}, chunks {m.n_chunks} (transpose "
            f"{mt.n_chunks}), locality {te.node_perm is not None}; plans: "
            + "; ".join(f"{d} piece {p.piece}, {p.pieces.shape[0]} pieces, "
                        f"{p.splits.shape[0]} split rows (longest "
                        f"{int(p.splits[:, 2].max()) if p.splits.shape[0] else 0} "
                        "partials)"
                        for d, p in (("forward", te_cpu.plan),
                                     ("transpose", te_cpu.transpose.plan)))
            + "; host ms (both directions) "
            f"{1e3 * (te_cpu.plan.seconds + te_cpu.transpose.plan.seconds):.4f}")
        mat, pat = _csr(te, w)
        for F in widths:
            x = torch.randn((m.num_senders, F), device=DEVICE, generator=gen)
            g = torch.randn((m.num_receivers, F), device=DEVICE, generator=gen)
            # The plain versions run on CPU copies of the same inputs: there
            # index_add_ sums each row in slot order (the kernel sums a row in
            # slot order too, a split row piece by piece).  On the card its
            # atomics reorder the f32 sums, which moves hub rows of thousands
            # of edges (the locality case) by up to ~2e-4.
            xc, gc = x.cpu(), g.cpu()
            errs = {}
            for dt in ("float32", "bfloat16"):
                bf16 = dt == "bfloat16"
                errs[f"spmm {dt}"] = _check(
                    f"tiled_spmm {label} F={F} {dt}", tt._spmm_launch(te, w, x, bf16),
                    tt.tiled_spmm_reference(te_cpu, w_cpu, xc, dt).to(DEVICE))
                errs[f"spmm^T {dt}"] = _check(
                    f"tiled_spmm (transpose) {label} F={F} {dt}",
                    tt._spmm_launch(te.transpose, w, g, bf16),
                    tt.tiled_spmm_reference(te_cpu.transpose, w_cpu, gc, dt).to(DEVICE))
                errs[f"sddmm {dt}"] = _check(
                    f"tiled_sddmm {label} F={F} {dt}", tt._sddmm_launch(te, x, g, bf16),
                    tt.tiled_sddmm_reference(te_cpu, xc, gc, dt).to(DEVICE))
            for dt in ("float32", "bfloat16"):
                bf16 = dt == "bfloat16"
                for name, st, op in (("spmm", te, x), ("spmm^T", te.transpose, g)):
                    if not torch.equal(tt._spmm_launch(st, w, op, bf16),
                                       tt._spmm_launch(st, w, op, bf16)):
                        raise AssertionError(f"tiled {name} {label} F={F} {dt}: "
                                             "two launches differ")
            lib_err = float((torch.sparse.mm(mat, x)
                             - tt.tiled_spmm_reference(te, w, x, "float32")).abs().max())
            iters = 10 if n_edges > 500_000 else 50
            xt = x.t().contiguous()
            t = dict(
                spmm=device_ms(lambda: tt._spmm_launch(te, w, x, True), iters),
                spmm_f32=device_ms(lambda: tt._spmm_launch(te, w, x, False), iters),
                spmm_T=device_ms(lambda: tt._spmm_launch(te.transpose, w, g, True), iters),
                spmm_plain=device_ms(
                    lambda: tt.tiled_spmm_reference(te, w, x, "bfloat16"), iters),
                spmm_library=library_ms(lambda: torch.sparse.mm(mat, x), iters),
                sddmm=device_ms(lambda: tt._sddmm_launch(te, x, g, True), iters),
                sddmm_f32=device_ms(lambda: tt._sddmm_launch(te, x, g, False), iters),
                sddmm_plain=device_ms(
                    lambda: tt.tiled_sddmm_reference(te, x, g, "bfloat16"), iters),
                sddmm_library=library_ms(
                    lambda: torch.sparse.sampled_addmm(pat, g, xt, beta=0.0), iters),
            )
            b, by = tiled_bound(te_cpu, F)
            rows.append(dict(label=label, F=F, on_path=on_path,
                             spmm_err=max(v for k, v in errs.items() if "spmm" in k),
                             sddmm_err=max(v for k, v in errs.items() if "sddmm" in k),
                             bound=b, bound_by=by, **t))
            say(f"  F={F}: max |kernel - plain| "
                + " ".join(f"{k} {v:.3g}" for k, v in errs.items())
                + f" (library spmm vs plain f32 {lib_err:.3g}); two launches of "
                "spmm and spmm^T bitwise equal, f32 and bf16")
            say(f"  F={F} device ms (bf16 payload unless marked): spmm kernel "
                f"{t['spmm']:.6f} (f32 {t['spmm_f32']:.6f}; transpose {t['spmm_T']:.6f}) "
                f"plain {t['spmm_plain']:.6f} "
                f"library {t['spmm_library']}; sddmm kernel "
                f"{t['sddmm']:.6f} (f32 {t['sddmm_f32']:.6f}) plain "
                f"{t['sddmm_plain']:.6f} library {t['sddmm_library']}; bound of "
                f"either {b:.6f} ({by})")
    _check_wrapper_gradients(cases)
    return rows


def _check_wrapper_gradients(cases):
    """The public ``tiled_spmm`` (locality permutation in and out, the
    autograd Function) on the card against the same call on the CPU: value,
    dx and d(weights), bf16 payload."""
    import torch

    from kgcn_tpu_torch.ops import tiled_spmm as tt

    for label, te_cpu, w_cpu, widths, _ in cases:
        if not label.startswith(("GAT batch", "locality")):
            continue
        F = widths[0]
        gen = torch.Generator().manual_seed(1)
        x0 = torch.randn((te_cpu.meta.num_senders, F), generator=gen)
        cot = torch.randn((te_cpu.meta.num_receivers, F), generator=gen)
        res = []
        for dev, te in ((DEVICE, te_cpu.to(DEVICE)), ("cpu", te_cpu)):
            w = w_cpu.to(dev, torch.float32).requires_grad_(True)
            x = x0.to(dev).requires_grad_(True)
            out = tt.tiled_spmm(te, w, x)
            (out * cot.to(dev)).sum().backward()
            res.append([t.detach().cpu() for t in (out, x.grad, w.grad)])
        for name, a, b in zip(("value", "dx", "dw"), *res):
            err = float((a - b).abs().max())
            if not torch.allclose(a, b, rtol=TOL, atol=TOL):
                raise AssertionError(f"tiled_spmm {label} {name}: GPU vs CPU {err}")
            say(f"tiled_spmm {label}: {name} GPU vs CPU max |diff| {err:.3g}")


# ---------------------------------------------------------------------------
# phase 5: training through the CLI


class _Tee(io.TextIOBase):
    """stdout that is also kept, so the run's lines can be checked."""

    def __init__(self, stream):
        self.stream, self.buf = stream, io.StringIO()

    def write(self, s):
        self.stream.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.stream.flush()


def _counted():
    """{kernel name: the wrapper function that carries its launch count}."""
    from kgcn_tpu_torch.ops import ell_spmm as te
    from kgcn_tpu_torch.ops import gconv as gconv_mod
    from kgcn_tpu_torch.ops import stream_spmm as ts
    from kgcn_tpu_torch.ops import tiled_spmm as tt

    return {"gconv": gconv_mod.gconv, "tiled_spmm": tt.tiled_spmm,
            "tiled_sddmm": tt.tiled_sddmm, "stream_scatter": ts.stream_scatter,
            "stream_scatter_mat": ts.stream_scatter_mat, "stream_dw": ts.stream_dw,
            "ell_spmm": te.spmm_ell_gpu}


def _counts():
    return {k: fn.launches for k, fn in _counted().items()}


def _zero_counts():
    for fn in _counted().values():
        fn.launches = 0


def _write_config(workdir, name, src, **over):
    with open(src) as f:
        cfg = json.load(f)
    cfg.update(over)
    d = os.path.join(workdir, name)
    os.makedirs(d)
    cfg.update(dataset=os.path.join(ROOT, cfg["dataset"]),
               save_model_path=os.path.join(d, "model"),
               save_info_train=os.path.join(d, "info_train.json"),
               save_info_valid=os.path.join(d, "info_valid.json"),
               save_result_valid=os.path.join(d, "result_valid.csv"))
    path = os.path.join(d, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return cfg, path


def _schedule(cfg, epochs):
    """(training steps, evaluated batches) of a ``train`` run: the split of
    cmd_train, one validation pass per epoch and the final one."""
    from kgcn_tpu_torch.data.dataset import load_jbl

    num = load_jbl(cfg["dataset"], cfg)[0].num
    n_valid = int(num * float(cfg.get("validation_data_rate", 0.3)))
    bs = int(cfg["batch_size"])
    return (epochs * -(-(num - n_valid) // bs), (epochs + 1) * -(-n_valid // bs))


def train_run(workdir, name, src, epochs, cpu=False, falling=True, **over):
    """One ``cli.main train`` run; checks its lines and files and returns
    (per-epoch training costs, launch counts, steps, evaluated batches, the
    run's stdout)."""
    import numpy as np

    from kgcn_tpu_torch.cli import main as cli

    cfg, path = _write_config(workdir, name, src, epoch=epochs, save_interval=1, **over)
    steps, evals = _schedule(cfg, epochs)
    say(f"-- train {name}: {os.path.relpath(src, ROOT)} with {over}, {epochs} "
        f"epoch(s) on the {'CPU' if cpu else 'GPU'}: {steps} steps, {evals} "
        "evaluated batches")
    tee = _Tee(sys.stdout)
    _zero_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(tee):
        cli.main(["train", "--config", path] + (["--cpu"] if cpu else []))
    wall = time.time() - t0
    counts = _counts()
    out = tee.buf.getvalue()
    model = cfg["save_model_path"]
    want_lines = ["[restore] best epoch"] + [
        f"[SAVE] {os.path.join(model, f'model.{e:05d}.ckpt')}" for e in range(1, epochs + 1)
    ] + [f"[SAVE] {cfg[k]}" for k in ("save_result_valid", "save_info_valid",
                                       "save_info_train")]
    for line in want_lines:
        if line not in out:
            raise AssertionError(f"train {name}: no line '{line}'")
    want_files = {f"model.{e:05d}.ckpt" for e in range(1, epochs + 1)} | {
        "model.best.ckpt", "model.last.ckpt", "serve_info.json"}
    if set(os.listdir(model)) != want_files:
        raise AssertionError(f"train {name}: files {sorted(os.listdir(model))}")
    with open(cfg["save_info_train"]) as f:
        costs = json.load(f)["training_cost"]
    if len(costs) != epochs or not np.isfinite(costs).all():
        raise AssertionError(f"train {name}: training costs {costs}")
    if falling and not costs[-1] < costs[0]:
        raise AssertionError(f"train {name}: training cost did not fall: {costs}")
    say(f"-- train {name}: {wall:.2f} s, training costs {costs}, launches {counts}")
    return costs, counts, steps, evals, out


def _expect(name, counts, want):
    """The run's launch counts equal ``want``; kernels it does not name
    must not have launched."""
    want = {k: want.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, want {want}")
    say(f"-- {name}: launch counts as predicted: {want}")


def phase_train(workdir):
    phase(5, "train: cli.main train on the tiled and dense backends")
    launches = {k: 0 for k in _counted()}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    _, counts, steps, evals, _ = train_run(workdir, "gcn_tiled", CONFIG, 2,
                                           spmm_backend="tiled")
    _expect("train gcn_tiled", counts, {"tiled_spmm": 6 * steps + 3 * evals})
    add(counts)
    _, counts, steps, evals, _ = train_run(workdir, "gat_tiled", GAT_CONFIG, 2,
                                           spmm_backend="tiled")
    _expect("train gat_tiled", counts, {"tiled_spmm": 6 * steps + 3 * evals,
                                        "tiled_sddmm": 3 * steps})
    add(counts)
    _, counts, steps, evals, _ = train_run(workdir, "gcn_dense", CONFIG, 1,
                                           falling=False)
    _expect("train gcn_dense", counts, {"gconv": 3 * steps + 3 * evals})
    add(counts)
    ring = dict(dataset=ring700_file(workdir), spmm_backend="dense")
    per_forward = gconv_kernels_a_forward(_load_config(GCN_RING_CONFIG, **ring))
    _, counts, steps, evals, _ = train_run(
        workdir, "gcn_dense_ring700", GCN_RING_CONFIG, 1, falling=False,
        make_plot=False, **ring)
    _expect("train gcn_dense_ring700", counts, {"gconv": per_forward * (steps + evals)})
    add(counts)

    exact = dict(spmm_backend="tiled", tiled_compute_dtype="float32", dropout_rate=0.0)
    gpu, counts, steps, evals, _ = train_run(workdir, "gcn_f32_gpu", CONFIG, 2, **exact)
    _expect("train gcn_f32_gpu", counts, {"tiled_spmm": 6 * steps + 3 * evals})
    cpu, counts, _, _, _ = train_run(workdir, "gcn_f32_cpu", CONFIG, 2, cpu=True, **exact)
    _expect("train gcn_f32_cpu", counts, {})
    rel = [abs(a - b) / abs(b) for a, b in zip(gpu, cpu)]
    say(f"GPU vs CPU per-epoch training cost: GPU {gpu} CPU {cpu} relative "
        f"difference {rel} (limit {TRAJECTORY_RTOL})")
    if max(rel) > TRAJECTORY_RTOL:
        raise AssertionError(f"GPU and CPU training costs differ by {max(rel)}")
    # dense graphs of 768 padded nodes (the gconv's two-launch design), dropout 0
    cfg = _load_config(GCN_RING_CONFIG, dropout_rate=0.0, **ring)
    per_forward = gconv_kernels_a_forward(cfg, bs=10)
    steps_gpu_vs_cpu("dense GCN (700-node rings, batch 10)", cfg, 3,
                     lambda info: {"gconv": 3 * per_forward}, bs=10)
    steps_repeat_bitwise()
    segments_without_sync()
    step_breakdown()
    return launches


def ring700_file(workdir):
    """The ring dataset of 700-node graphs (``RING700``: 32 graphs, padded to
    768 nodes a graph) as a pickle ``.jbl``, written on the first call."""
    path = os.path.join(workdir, "ring700.jbl")
    if not os.path.exists(path):
        from kgcn_tpu_torch.data.synthetic import make_ring_dataset

        with open(path, "wb") as f:
            pickle.dump(make_ring_dataset(**RING700), f, protocol=4)
    return path


def gconv_kernels_a_forward(cfg, bs=None):
    """The gconv kernels that one forward of ``cfg``'s model launches on a
    batch of ``bs`` graphs, as the wrapper counts them (phase 3 holds the
    count to torch.profiler's); at least one for each of its 3 GraphConv
    calls.  Launched before a run's counts are set to 0."""
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.ops.gconv import gconv
    from kgcn_tpu_torch.runtime.train import Trainer

    info, (batch,) = _trainer_batches(cfg, 1, bs)
    trainer = Trainer(build_model(cfg["model.py"], info, cfg), cfg, info, device=DEVICE)
    state = trainer.init_state(seed=0)
    before = gconv.launches
    trainer.eval_step(state.params, state.batch_stats, batch)
    n = gconv.launches - before
    if n < 3:
        raise AssertionError(f"a forward of 3 GraphConv layers launched {n} gconv kernels")
    say(f"-- {os.path.basename(cfg['dataset'])}, batch {bs or cfg['batch_size']}: "
        f"{n} gconv kernels a forward")
    return n


def _trainer_batches(cfg, steps, bs=None):
    """(model info, the first ``steps`` batches of ``bs`` graphs) of a
    config on its resolved backend."""
    import numpy as np

    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.runtime import backend

    ds, info = load_jbl(cfg["dataset"], cfg)
    be = backend.resolve(dict(cfg), info, log=False)
    bs = bs or int(cfg["batch_size"])
    tb = Batcher(ds, info, bs, backend=be)
    return info, [tb.make_batch(np.arange(i * bs, (i + 1) * bs)) for i in range(steps)]


def steps_gpu_vs_cpu(label, cfg, steps, launches, bs=None):
    """The first ``steps`` training steps of ``cfg`` on the GPU and on the
    CPU from one seed: costs within TRAJECTORY_RTOL, and the GPU run's
    kernel launches equal to ``launches(info)``."""
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.train import Trainer

    info, batches = _trainer_batches(cfg, steps, bs)
    costs = {}
    for dev in (DEVICE, "cpu"):
        trainer = Trainer(build_model(cfg["model.py"], info, cfg), cfg, info, device=dev)
        state = trainer.init_state(seed=0)
        _zero_counts()
        c = []
        for batch in batches:
            state, cost, _ = trainer.train_step(state, batch)
            c.append(float(cost))
        costs[dev] = c
        _expect(f"{label} steps on {dev}", _counts(),
                launches(info) if dev == DEVICE else {})
    rel = [abs(a - b) / abs(b) for a, b in zip(costs[DEVICE], costs["cpu"])]
    say(f"GPU vs CPU {label} step costs: GPU {costs[DEVICE]} CPU {costs['cpu']} "
        f"relative difference {rel} (limit {TRAJECTORY_RTOL})")
    if max(rel) > TRAJECTORY_RTOL:
        raise AssertionError(f"GPU and CPU {label} step costs differ by {max(rel)}")


def steps_repeat_bitwise(steps=3):
    """Two GPU runs of the first ``steps`` training steps from one seed give
    the same bits, costs and every parameter: GAT on the tiled backend (the
    edge softmax's segment sums, the tiled SpMM and SDDMM) and GIN on
    example_config/gin.json with xla (the edge-list scatter's segment sum)."""
    import torch

    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.train import Trainer

    for name, src, over in (("gat tiled", GAT_CONFIG, {"spmm_backend": "tiled"}),
                            ("gin xla", GIN_CONFIG, {"spmm_backend": "xla"})):
        cfg = _load_config(src, **over)
        info, batches = _trainer_batches(cfg, steps)
        runs = []
        for _ in range(2):
            trainer = Trainer(build_model(cfg["model.py"], info, cfg), cfg, info,
                              device=DEVICE)
            state = trainer.init_state(seed=0)
            costs = []
            for batch in batches:
                state, cost, _ = trainer.train_step(state, batch)
                costs.append(cost.detach().clone())
            runs.append((costs, {k: v.detach().clone() for k, v in state.params.items()}))
        (c1, p1), (c2, p2) = runs
        differ = [k for k in p1 if not torch.equal(p1[k], p2[k])]
        if differ or not all(torch.equal(a, b) for a, b in zip(c1, c2)):
            raise AssertionError(f"{name}: two runs of {steps} steps differ: costs "
                                 f"{[float(c) for c in c1]} vs {[float(c) for c in c2]}, "
                                 f"parameters {differ}")
        say(f"{name}: two runs of {steps} GPU steps from seed 0 bitwise equal (costs "
            f"{[float(c) for c in c1]}, {len(p1)} parameters)")


def segments_without_sync(iters=200):
    """``ops/segment``'s ``segment_sum`` (the xla scatter) and
    ``segment_softmax`` (GAT's edge softmax, masked), their values and
    gradients at a GAT (tiled) batch's shape, with the batch's segments
    (``GraphBatch.receiver_segments``: sorted on the host, sent with one
    copy) and with ids on the card alone, all without a host sync: under
    ``torch.cuda.set_sync_debug_mode("error")`` a synchronising call
    raises.  Values against ``index_add_`` and a plain
    softmax (1e-5); at the GAT batch's shape it also times a value and
    gradient on the host clock against ``index_add_`` (whose atomics do not
    repeat bitwise): the step is host-bound, so this is its cost."""
    import torch

    from kgcn_tpu_torch.ops.segment import segment_softmax, segment_sum

    _, (host_batch,) = _trainer_batches(_load_config(GAT_CONFIG, spmm_backend="tiled"), 1)
    moved = host_batch.graph.to(DEVICE)
    V = moved.total_nodes
    segments = moved.receiver_segments(0)
    ids = moved.receivers[0].long()
    E = ids.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    data = torch.randn((E,), device=DEVICE, generator=gen).requires_grad_()
    mask = moved.edge_mask()[0]

    def index_add(d, i, n):
        return torch.zeros((n,), device=d.device, dtype=d.dtype).index_add_(0, i, d)

    def batch_sum(d, i, n):
        return segment_sum(d, i, n, segments)

    def softmax(d, i, n):
        return segment_softmax(d, i, n, mask=mask, sorted_segments=segments)

    def value_and_grad(fn):
        out = fn(data, ids, V)
        return out, torch.autograd.grad(out, data, torch.ones_like(out))[0]

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, grad = value_and_grad(batch_sum)
        out_card, grad_card = value_and_grad(segment_sum)  # sorted on the card
        alpha, _ = value_and_grad(softmax)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = index_add(data.detach(), ids, V)
    for o, g in ((out, grad), (out_card, grad_card)):
        if not torch.allclose(o, want, rtol=1e-5, atol=1e-5) or not torch.equal(
                g, torch.ones_like(data)):
            raise AssertionError("segment_sum on the card: wrong value or gradient")
    if not torch.equal(out, out_card):
        raise AssertionError("segment_sum: the batch's segments and a sort on the "
                             "card sum in different orders")
    e = torch.exp(data.detach() - data.detach().max()) * mask
    want = e / index_add(e, ids, V)[ids].clamp(min=1e-30)
    if not torch.allclose(alpha, want, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"segment_softmax on the card: off by "
                             f"{float((alpha - want).abs().max())}")
    value_and_grad(index_add)  # warm-up
    host = {}
    for name, fn in (("segment_sum", batch_sum), ("index_add_", index_add)) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            value_and_grad(fn)
        torch.cuda.synchronize()
        host.setdefault(name, []).append((time.perf_counter() - t0) / iters * 1e3)
    say(f"segment_sum "
        "(the batch's segments and a sort on the card, equal) and segment_softmax: "
        "values and gradients on the card with no host sync (sync debug mode "
        f"error); host ms per segment_sum value and gradient at {E} edges, "
        f"{V} nodes (two rounds): "
        + ", ".join(f"{k} {v}" for k, v in host.items()))


MOLECULE_RUNS = (("gcn_tiled", CONFIG, {"spmm_backend": "tiled"}),
                 ("gat_tiled", GAT_CONFIG, {"spmm_backend": "tiled"}),
                 ("gcn_dense", CONFIG, {}))


def step_breakdown(runs=MOLECULE_RUNS):
    """One epoch of each run's training split (name, config, overrides),
    step by step: host batch assembly (and its tiled-structure or ELL-array
    part), the step's wall time to a synchronise, and, in a second profiled
    epoch, the device's busy time (every CUDA kernel and copy) against the
    epoch's wall time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl, split_dataset
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime import backend
    from kgcn_tpu_torch.runtime.train import Trainer

    for name, src, over in runs:
        cfg = _load_config(src, **over)
        ds, info = load_jbl(cfg["dataset"], cfg)
        be = backend.resolve(cfg, info, log=False)
        train, _, _, _ = split_dataset(ds, cfg["validation_data_rate"],
                                       seed=int(cfg["seed"]), shuffle=bool(cfg["shuffle_data"]))
        bs = int(cfg["batch_size"])
        tb = Batcher(train, info, bs, backend=be)
        trainer = Trainer(build_model(cfg["model.py"], info, cfg), cfg, info, device=DEVICE)
        state = trainer.init_state(seed=0)
        state, _, _, _ = trainer.run_epoch(state, tb, epoch=0)  # warm-up
        torch.cuda.synchronize()
        idx = tb.epoch_indices(shuffle=False)
        host, tiled, move, plans, step = [], [], [], [], []
        for start in range(0, len(idx), bs):
            t0, tiled0 = time.perf_counter(), tb.tiled_seconds + tb.ell_seconds
            batch = tb.make_batch(idx[start:start + bs])
            t1 = time.perf_counter()
            # the step's own move to the card, which builds the tiled SpMM plans
            batch = batch.to(DEVICE)
            move.append(time.perf_counter() - t1)
            state, _, _ = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append(t1 - t0)
            tiled.append(tb.tiled_seconds + tb.ell_seconds - tiled0)
            plans.append(sum(d.plan.seconds for t in batch.graph.tiled_adj or ()
                             for d in (t, t.transpose) if d.plan is not None))
            step.append(t2 - t1)
        n = len(step)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _, _, _ = trainer.run_epoch(state, tb, epoch=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(getattr(ev, "device_time_total", 0.0) for ev in prof.key_averages()) / 1e6
        payload = f", payload {be.compute_dtype}" if be.name == "tiled" else ""
        part = "ELL arrays" if be.name in ("xla", "pallas") else "tiled structures"
        plan = (f", its tiled SpMM plans {np.mean(plans) * 1e3:.4f}" if be.name == "tiled"
                else "")
        say(f"step time {name} ({be.name}{payload}, batch {bs}, "
            f"{n} steps): host batch ms {np.mean(host) * 1e3:.4f} (of which {part} "
            f"{np.mean(tiled) * 1e3:.4f}), step wall ms to sync "
            f"{np.mean(step) * 1e3:.4f} (median {np.median(step) * 1e3:.4f}; of which the "
            f"move to the card {np.mean(move) * 1e3:.4f}{plan}); "
            f"profiled epoch: wall ms/step {wall / n * 1e3:.4f}, device busy "
            f"ms/step {busy / n * 1e3:.4f}, idle share {1 - busy / wall:.4f}")


# ---------------------------------------------------------------------------
# phase 6: serving


def _post(url, payload):
    body = json.dumps(payload).encode()
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, resp = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:  # the body says why
        code, resp = e.code, json.loads(e.read())
    return code, resp, (time.perf_counter() - t0) * 1e3


def _payload(data, idx):
    """Molecules ``idx`` of the dataset as a /predict body (COO ``adj``)."""
    import numpy as np

    return {
        "feature": np.asarray(data["feature"])[idx].tolist(),
        "adj": [[[np.asarray(data["adj"][i][0]).tolist(),
                  np.asarray(data["adj"][i][1]).tolist(),
                  [int(s) for s in data["adj"][i][2]]]] for i in idx],
        "max_node_num": int(data["max_node_num"]),
    }


def phase_serve(workdir):
    import numpy as np
    import torch

    from kgcn_tpu_torch.cli.serve import build_server
    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.ops.gconv import gconv
    from kgcn_tpu_torch.runtime import checkpoint as ckpt
    from kgcn_tpu_torch.runtime.config import load_config
    from kgcn_tpu_torch.runtime.serve import Predictor
    from kgcn_tpu_torch.runtime.train import Trainer

    phase(6, "serve: solubility_cls GCN over HTTP")
    data = jbl.load(DATASET)
    cfg = load_config(CONFIG, {"save_model_path": os.path.join(workdir, "model"),
                               "label_dim": 2})
    ds, info = build_dataset(dict(data), cfg)
    say(f"dataset: {ds.num} molecules, {info.graph_node_num} nodes max, "
        f"{info.feature_dim} features, {info.adj_channel_num} channel(s); "
        f"model {cfg['model.py']}, batch {cfg['batch_size']}")
    model = build_model(cfg["model.py"], info, cfg)
    trainer = Trainer(model, cfg, info, device="cpu")
    state = trainer.init_state(seed=0)
    gen = torch.Generator().manual_seed(1)  # non-trivial BN statistics
    stats = {k: (v + 0.1 * torch.randn(v.shape, generator=gen)).abs() + 0.05
             for k, v in state.batch_stats.items()}
    path = ckpt.save_checkpoint(ckpt.ckpt_name(cfg["save_model_path"], "best"),
                                state.params, stats)
    say(f"checkpoint: {path} ({sum(v.numel() for v in state.params.values())} "
        "parameters, seeded)")

    server, predictor = build_server(cfg, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    offsets = np.cumsum((0,) + REQUEST_SIZES)
    requests = [list(range(int(offsets[i]), int(offsets[i + 1])))
                for i in range(len(REQUEST_SIZES))]
    payloads = [_payload(data, idx) for idx in requests]
    answers = []
    try:
        _zero_counts()
        for idx, body in zip(requests, payloads):
            code, resp, ms = _post(url + "/predict", body)
            if code != 200:
                raise AssertionError(
                    f"/predict {len(idx)} molecules: HTTP {code} {resp}")
            answers.append(resp)
            say(f"request {len(idx):3d} molecules: HTTP {code}, {ms:.2f} ms "
                f"round trip, {resp['latency_ms']:.2f} ms in the predictor")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        launches = gconv.launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    say(f"healthz: {json.dumps(health)}")
    if thread.is_alive():
        raise AssertionError("server thread did not stop")
    if not (health["ready"] and health["requests"] == len(requests)
            and health["backend"] == torch.cuda.get_device_name(0)):
        raise AssertionError(f"unexpected health {health}")

    bs = int(cfg["batch_size"])
    batches = 1 + sum(-(-len(idx) // bs) for idx in requests)  # + warm-up
    say(f"gconv launches: {launches} for {batches} batches "
        f"(incl. the predictor's one warm-up batch), 3 GraphConv each")
    if launches != 3 * batches:
        raise AssertionError(f"gconv launched {launches} times, want {3 * batches}")

    cpu = Predictor(cfg, checkpoint=path, device="cpu")
    worst = 0.0
    for idx, body, resp in zip(requests, payloads, answers):
        pred = np.asarray(resp["prediction"], np.float64)
        if resp["num"] != len(idx) or pred.shape != (len(idx), 2):
            raise AssertionError(f"{len(idx)} molecules: got shape {pred.shape}")
        if not np.isfinite(pred).all():
            raise AssertionError(f"{len(idx)} molecules: non-finite rows")
        if not np.allclose(pred.sum(axis=1), 1.0, atol=1e-5):
            raise AssertionError(f"{len(idx)} molecules: rows do not sum to 1")
        ref = np.asarray(cpu.predict(body)["prediction"], np.float64)
        worst = max(worst, float(np.abs(pred - ref).max()))
    say(f"GPU vs CPU predictions: max |diff| = {worst:.3g} (limit {TOL})")
    if worst > TOL:
        raise AssertionError(f"GPU and CPU predictions differ by {worst}")
    return launches


# ---------------------------------------------------------------------------
# phase 7: the stream kernels


def make_kg_triples(path, seed=0):
    """Write a triple TSV of WN18RR's published shape (``KG_SHRINK`` 1):
    its entity count, 11 relations with its training-set shares, its number
    of distinct triples; heads and tails Zipf-distributed over a random
    ranking of the entities, every entity at least once, no duplicate and no
    self triple.  Returns the triple count."""
    import numpy as np

    rng = np.random.RandomState(seed)
    n = WN18RR_ENTITIES // KG_SHRINK
    total = WN18RR_TRIPLES // KG_SHRINK
    shares = np.asarray(WN18RR_RELATION_COUNTS, np.float64)
    per_rel = np.maximum((shares / shares.sum() * total).astype(np.int64), 1)
    per_rel[0] += total - per_rel.sum()
    R = len(per_rel)
    p = (np.arange(n) + 1.0) ** -ZIPF_EXPONENT
    p /= p.sum()
    rank_to_id = rng.permutation(n)

    def draw(k):
        return rank_to_id[rng.choice(n, k, p=p)]

    rel = np.repeat(np.arange(R), per_rel)
    heads, tails = draw(total), draw(total)
    tails[rng.choice(total, n, replace=False)] = rng.permutation(n)  # cover all
    while True:
        key = (heads * R + rel) * n + tails
        _, first = np.unique(key, return_index=True)
        bad = np.ones(total, bool)
        bad[first] = False
        bad |= heads == tails
        if not bad.any():
            break
        heads[bad] = draw(int(bad.sum()))
    order = rng.permutation(total)
    with open(path, "w") as f:
        f.writelines(f"e{h}\tr{r}\te{t}\n"
                     for h, r, t in zip(heads[order], rel[order], tails[order]))
    return total


def kg_files(workdir):
    """(tsv, jbl): the WN18RR-shaped triples and their ``cli.kg`` output,
    made on the first call."""
    from kgcn_tpu_torch.cli import kg as kg_cli

    d = os.path.join(workdir, "kg_data")
    tsv, jbl_path = os.path.join(d, "triples.tsv"), os.path.join(d, "kg.jbl")
    if not os.path.exists(jbl_path):
        os.makedirs(d, exist_ok=True)
        t0 = time.time()
        n = make_kg_triples(tsv)
        say(f"WN18RR-shaped triple TSV: {n} triples ({time.time() - t0:.2f} s)")
        t0 = time.time()
        kg_cli.main(["--input", tsv, "--output", jbl_path,
                     "--test-rate", str(KG_TEST_RATE)])
        say(f"python -m kgcn_tpu_torch.cli.kg: {time.time() - t0:.2f} s")
    return tsv, jbl_path


def kg_config(workdir, name, **over):
    """The KG config of the main path (example_config/kg.json with
    ``KG_OVERRIDES``) on the generated dataset, its outputs in its own
    directory: (config dict, path)."""
    _, jbl_path = kg_files(workdir)
    with open(KG_CONFIG) as f:
        cfg = json.load(f)
    cfg.update(KG_OVERRIDES)
    cfg.update(over)
    d = os.path.join(workdir, name)
    os.makedirs(d, exist_ok=True)
    cfg.update(dataset=jbl_path, save_model_path=os.path.join(d, "model"),
               save_info_train=os.path.join(d, "info_train.json"),
               save_info_test=os.path.join(d, "info_test.json"),
               save_edge_result=os.path.join(d, "edges.csv"))
    path = os.path.join(d, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return _load_config(path, dataset=jbl_path), path


def kg_batcher(cfg, device=None, seed=0):
    """(KGBatcher, info, backend) of a KG config, graph batch built on the
    host and moved to ``device``."""
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.models.kg import KGBatcher
    from kgcn_tpu_torch.runtime import backend

    ds, info = load_jbl(cfg["dataset"], cfg)
    be = backend.resolve(dict(cfg), info, log=False)
    kb = KGBatcher(ds, info, label_batch_size=cfg["label_batch_size"], seed=seed,
                   backend=be, device=device)
    return kb, info, be


def stream_cases(workdir):
    """(label, StreamCOO on the CPU, widths, on the main path)."""
    import numpy as np

    from kgcn_tpu_torch.ops import stream_spmm as ts

    def uniform(V, E, seed, vs=None):
        rng = np.random.RandomState(seed)
        return (rng.randint(0, vs or V, E), rng.randint(0, V, E),
                (rng.random_sample(E) + 0.1).astype(np.float32))

    cfg, _ = kg_config(workdir, "kg_structures")
    kb, info, be = kg_batcher(cfg)
    if be.name != "stream":
        raise AssertionError(f"the KG resolved to {be.name}, want stream")
    sts = kb.graph_batch.graph.stream_adj
    real = [int((st.slot_src < st.meta.num_edges).sum()) for st in sts]
    say(f"KG graph batch: {info.all_node_num} entities ({sts[0].meta.num_receivers} "
        f"padded), {len(sts)} channels, {sum(real)} edges, built in "
        f"{kb.host_seconds:.2f} s (stream structures {kb.stream_seconds:.2f} s)")
    F = int(cfg["embedding_dim"])
    big, small = int(np.argmax(real)), int(np.argmin(real))
    cases = [(f"KG channel {big} (largest)", sts[big], (F,), True),
             (f"KG channel {small} (smallest)", sts[small], (F,), True)]
    V, E, Fs = SCALE
    s, r, w = uniform(V, E, seed=5)
    cases.append((f"scale V={V} E={E}", ts.build_stream(
        s, r, V, weights=w, **ts.choose_stream(s, r, V, Fs)), (Fs,), False))
    V = sts[0].meta.num_receivers
    s, r, _ = uniform(V, 2 * V + HUB_EDGES, seed=3)
    r[2 * V:] = V // 3  # one receiver with HUB_EDGES in-edges
    w = hub_weights(s, r, V)
    cases.append((f"hub V={V} E={len(s)}", ts.build_stream(
        s, r, V, weights=w, **ts.choose_stream(s, r, V, F)), (F,), False))
    w = (np.random.RandomState(4).random_sample(len(s)) + 0.1).astype(np.float32)
    cases.append((f"hub V={V} E={len(s)}, order-1 weights", ts.build_stream(
        s, r, V, weights=w, **ts.choose_stream(s, r, V, F)), (F,), False))
    s, r, w = uniform(3000, 30000, seed=1, vs=5000)
    cases.append(("rectangular 5000->3000", ts.build_stream(
        s, r, 3000, weights=w, num_sender_nodes=5000), (64, 200), False))
    s, r, w = uniform(2000, 12000, seed=2)
    w[::5] = 0.0  # padding edges, dropped from the structure
    need = ts.build_stream(s, r, 2000, weights=w)
    budget = 2 * max(need.meta.n_macros, need.transpose.meta.n_macros)
    cases.append((f"budget-padded ({budget} macros)", ts.build_stream(
        s, r, 2000, weights=w, macro_budget=budget), (40, 133), False))
    return cases


def hub_weights(s, r, V):
    """Edge weights as the KG's channels carry them (cli.kg's symmetric
    normalisation): 1 / sqrt(d(r) d(s)), d the in-degree (at least 1).
    With weights of order 1 instead (the second hub case), the plain
    version's own f32 rounding over the hub row's 50 000 terms in slot order
    (~2e-3 from the exact sum of a row of magnitude ~150) exceeds the 1e-4
    check, whatever order the kernel sums in: there the scatters are held
    against an f64 sum (``_exact_rows``)."""
    import numpy as np

    deg = np.maximum(np.bincount(r, minlength=V), 1)
    return (1.0 / np.sqrt(deg[r] * deg[s])).astype(np.float32)


def _stream_csr(ss):
    """The structure's matrix (receiver rows, sender columns, baked
    weights) as CSR, and its 0/1 pattern, from the slots the kernels walk."""
    import torch

    from kgcn_tpu_torch.ops import stream_spmm as ts

    m = ss.meta
    valid, send, recv = ts._slot_rows(ss)
    idx = torch.stack([recv[valid], send[valid]])
    vals = ss.w_slots[valid]
    shape = (m.num_receivers, m.num_senders)
    mat = torch.sparse_coo_tensor(idx, vals, shape).coalesce().to_sparse_csr()
    pat = torch.sparse_coo_tensor(idx, torch.ones_like(vals), shape).coalesce()
    pat = torch.sparse_coo_tensor(pat.indices(), torch.ones_like(pat.values()),
                                  shape).to_sparse_csr()
    return mat, pat


def stream_bound(ss, F, kind):
    """(bound_ms, bound_by) on this structure's real edges: the
    [num_senders, F] and [num_receivers, F] f32 operands moved once (the
    scatters read x and write out, the weight gradient reads x and dy), per
    edge its sender and, by kind, its receiver row and weight (scatter),
    its one-hot row of tr_w bf16 (scatter_mat) or its receiver row and
    output (dw); 2·F FLOP per edge.  Padding slots are not needed work."""
    m = ss.meta
    n_edges = int((ss.slot_src < m.num_edges).sum())
    per_edge = {"scatter": 12, "scatter_mat": 4 + 2 * m.tr_w, "dw": 12}[kind]
    nbytes = 4 * (m.num_senders + m.num_receivers) * F + per_edge * n_edges
    return bound(nbytes, 2 * n_edges * F)


def phase_stream_check(workdir):
    import torch

    from kgcn_tpu_torch.ops import stream_spmm as ts

    phase(7, "kernel check: stream scatter, one-hot scatter and weight gradient "
          "(kgcn_tpu_torch/ops/csrc/stream.cu)")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.time()
    cases = stream_cases(workdir)
    say(f"structures built on the host in {time.time() - t0:.2f} s")
    rows = []
    for label, ss_cpu, widths, on_path in cases:
        ss = ss_cpu.to(DEVICE)
        m, mt = ss.meta, ss.transpose.meta
        n_edges = int((ss_cpu.slot_src < m.num_edges).sum())
        say(f"stream {label}: {m.num_senders} -> {m.num_receivers} nodes, {n_edges} "
            f"edges of {m.num_edges}, (tr_w, chunk, mc, wb) = "
            f"{(m.tr_w, m.chunk, m.mc, m.wb)}, slots {m.slots} (transpose "
            f"{mt.slots}), one-hots {ss.oh is not None}")
        mat, pat = _stream_csr(ss)
        for F in widths:
            x = torch.randn((m.num_senders, F), device=DEVICE, generator=gen)
            g = torch.randn((m.num_receivers, F), device=DEVICE, generator=gen)
            # plain versions on CPU copies: index_add_ sums in slot order there
            xc, gc = x.cpu(), g.cpu()
            hub = label.startswith("hub")

            def held(what, got, ss_c, w_c, x_c, mode, plain):
                """The kernel against its plain version (1e-4) and, on the hub
                cases, against an f64 sum; the order-1 hub against the f64 sum
                alone, the plain version's own error there being larger."""
                plain = plain()
                if not hub:
                    return _check(what, got, plain.to(DEVICE))
                exact, tol = _exact_rows(ss_c, w_c, x_c, mode)
                err = _check_exact(what, got, exact, tol)
                say(f"  {what}: against an f64 sum kernel {err:.3g}, plain "
                    f"{float((plain.double() - exact).abs().max()):.3g} (tolerance "
                    f"up to {float(tol.max()):.3g})")
                if "order-1" not in label:
                    _check(what, got, plain.to(DEVICE))
                return err

            errs = {}
            for dt in ("float32", "bfloat16"):
                bf16 = dt == "bfloat16"
                errs[f"scatter {dt}"] = held(
                    f"stream_scatter {label} F={F} {dt}",
                    ts._scatter_launch(ss, ss.w_slots, x, bf16), ss_cpu, ss_cpu.w_slots,
                    xc, dt, lambda: ts.stream_scatter_reference(ss_cpu, ss_cpu.w_slots,
                                                                xc, dt))
                errs[f"scatter^T {dt}"] = held(
                    f"stream_scatter (transpose) {label} F={F} {dt}",
                    ts._scatter_launch(ss.transpose, ss.transpose.w_slots, g, bf16),
                    ss_cpu.transpose, ss_cpu.transpose.w_slots, gc, dt,
                    lambda: ts.stream_scatter_reference(
                        ss_cpu.transpose, ss_cpu.transpose.w_slots, gc, dt))
                errs[f"dw {dt}"] = _check(
                    f"stream_dw {label} F={F} {dt}", ts._dw_launch(ss, x, g, bf16),
                    ts.stream_dw_reference(ss_cpu, xc, gc, dt).to(DEVICE))
            errs["scatter_mat"] = held(
                f"stream_scatter_mat {label} F={F}", ts._scatter_mat_launch(ss, x),
                ss_cpu, ss_cpu.oh, xc, "onehot",
                lambda: ts.stream_scatter_mat_reference(ss_cpu, ss_cpu.oh, xc))
            errs["scatter_mat^T"] = held(
                f"stream_scatter_mat (transpose) {label} F={F}",
                ts._scatter_mat_launch(ss.transpose, g), ss_cpu.transpose,
                ss_cpu.transpose.oh, gc, "onehot",
                lambda: ts.stream_scatter_mat_reference(ss_cpu.transpose,
                                                        ss_cpu.transpose.oh, gc))
            _check_repeatable(label, F, ss, x, g)
            lib_err = float((torch.sparse.mm(mat, x) - ts.stream_scatter_reference(
                ss, ss.w_slots, x, "float32")).abs().max())
            iters = 10 if n_edges > 500_000 else 50
            xt = x.t().contiguous()
            w = ss.w_slots
            t = dict(
                scatter=device_ms(lambda: ts._scatter_launch(ss, w, x, False), iters),
                scatter_bf16=device_ms(lambda: ts._scatter_launch(ss, w, x, True), iters),
                scatter_plain=device_ms(
                    lambda: ts.stream_scatter_reference(ss, w, x, "float32"), iters),
                scatter_mat=device_ms(lambda: ts._scatter_mat_launch(ss, x), iters),
                scatter_mat_plain=device_ms(
                    lambda: ts.stream_scatter_mat_reference(ss, ss.oh, x), iters),
                spmm_library=library_ms(lambda: torch.sparse.mm(mat, x), iters),
                dw=device_ms(lambda: ts._dw_launch(ss, x, g, True), iters),
                dw_f32=device_ms(lambda: ts._dw_launch(ss, x, g, False), iters),
                dw_plain=device_ms(
                    lambda: ts.stream_dw_reference(ss, x, g, "bfloat16"), iters),
                dw_library=library_ms(
                    lambda: torch.sparse.sampled_addmm(pat, g, xt, beta=0.0), iters),
            )
            bounds = {k: stream_bound(ss_cpu, F, k) for k in ("scatter", "scatter_mat", "dw")}
            rows.append(dict(label=label, F=F, on_path=on_path, bounds=bounds,
                             scatter_err=max(v for k, v in errs.items()
                                             if k.startswith("scatter ")
                                             or k.startswith("scatter^T")),
                             mat_err=max(errs["scatter_mat"], errs["scatter_mat^T"]),
                             dw_err=max(v for k, v in errs.items() if k.startswith("dw")),
                             **t))
            say(f"  F={F}: max |kernel - plain| "
                + " ".join(f"{k} {v:.3g}" for k, v in errs.items())
                + f" (library spmm vs plain f32 {lib_err:.3g})")
            say(f"  F={F} device ms: scatter f32 {t['scatter']:.6f} (bf16 "
                f"{t['scatter_bf16']:.6f}) plain f32 {t['scatter_plain']:.6f}; "
                f"scatter_mat {t['scatter_mat']:.6f} plain {t['scatter_mat_plain']:.6f}; "
                f"library spmm {t['spmm_library']}; dw bf16 {t['dw']:.6f} (f32 "
                f"{t['dw_f32']:.6f}) plain {t['dw_plain']:.6f} library {t['dw_library']}; "
                "bounds " + ", ".join(f"{k} {b:.6f} ({by})" for k, (b, by) in bounds.items()))
    _check_stream_gradients(cases)
    return rows


def _exact_rows(ss, w, x, mode):
    """(f64 sums, tolerance) of a stream scatter's output rows on the CPU:
    the messages of the kernel's payload (``mode`` float32, bfloat16 or
    onehot, ``w`` the slot weights or the one-hots) summed in float64, and
    per row 1e-4 + sqrt(n)·2^-24·Σ|message|, n the row's messages — the
    probabilistic bound of an f32 sum of n terms in any order (Higham and
    Mary, SIAM J. Sci. Comput. 41(5), 2019), so a row's tolerance grows with
    its length as its rounding error does."""
    import torch

    from kgcn_tpu_torch.ops import stream_spmm as ts

    m = ss.meta
    valid, send, recv = ts._slot_rows(ss)
    slot = valid.nonzero().squeeze(1)
    x = x.to(torch.float32)
    if mode == "onehot":
        wv, xs = w[slot, ss.r_loc.reshape(-1)[slot].long()].float(), ts._rb(x[send[slot]])
    else:
        wv, xs = w[slot], x[send[slot]]
        if mode == "bfloat16":
            wv, xs = ts._rb(wv), ts._rb(xs)
    msg = wv.double()[:, None] * xs.double()
    rows = recv[slot]
    exact = torch.zeros((m.num_receivers, x.shape[1]), dtype=torch.float64)
    exact.index_add_(0, rows, msg)
    mag = torch.zeros_like(exact).index_add_(0, rows, msg.abs())
    n = torch.bincount(rows, minlength=m.num_receivers).double()
    return exact, TOL + n.sqrt()[:, None] * 2.0 ** -24 * mag


def _check_exact(what, got, exact, tol):
    """max |got - exact|; raises where a row's entry passes its tolerance."""
    diff = (got.cpu().double() - exact).abs()
    if (diff > tol).any():
        raise AssertionError(f"{what}: kernel off the f64 sum by {float(diff.max())} "
                             f"(tolerance {float(tol.max())})")
    return float(diff.max())


def _check_repeatable(label, F, ss, x, g):
    """Two launches of each scatter on the same inputs give the same bits
    (each sum runs in the plan's fixed order; no atomics on values)."""
    import torch

    from kgcn_tpu_torch.ops import stream_spmm as ts

    runs = {
        "scatter f32": lambda: ts._scatter_launch(ss, ss.w_slots, x, False),
        "scatter bf16": lambda: ts._scatter_launch(ss, ss.w_slots, x, True),
        "scatter^T f32": lambda: ts._scatter_launch(ss.transpose, ss.transpose.w_slots,
                                                    g, False),
        "scatter_mat": lambda: ts._scatter_mat_launch(ss, x),
        "scatter_mat^T": lambda: ts._scatter_mat_launch(ss.transpose, g),
    }
    for name, run in runs.items():
        if not torch.equal(run(), run()):
            raise AssertionError(f"{name} {label} F={F}: two launches differ")
    say(f"  F={F}: two launches bitwise equal: {', '.join(runs)}")


def _check_stream_gradients(cases):
    """The public ``stream_spmm_edges`` (the autograd Function: dx on the
    transpose, dw by the weight-gradient kernel) and the static route's dx,
    on the card against the same calls on the CPU, both payloads."""
    import torch

    from kgcn_tpu_torch.ops import stream_spmm as ts

    for label, ss_cpu, widths, _ in cases:
        if "smallest" not in label and not label.startswith("rectangular"):
            continue
        F, m = widths[0], ss_cpu.meta
        gen = torch.Generator().manual_seed(1)
        x0 = torch.randn((m.num_senders, F), generator=gen)
        cot = torch.randn((m.num_receivers, F), generator=gen)
        w0 = torch.rand(m.num_edges, generator=gen) + 0.1
        for dt in ("float32", "bfloat16"):
            res = []
            for dev, ss in ((DEVICE, ss_cpu.to(DEVICE)), ("cpu", ss_cpu)):
                # fresh leaves on both devices (.to("cpu") would alias x0)
                w = w0.to(dev).clone().requires_grad_(True)
                x = x0.to(dev).clone().requires_grad_(True)
                out = ts.stream_spmm_edges(ss, w, x, compute_dtype=dt)
                (out * cot.to(dev)).sum().backward()
                xs = x0.to(dev).clone().requires_grad_(True)
                (ts.stream_spmm(ss, x=xs, compute_dtype=dt) * cot.to(dev)).sum().backward()
                res.append([t.detach().cpu() for t in (out, x.grad, w.grad, xs.grad)])
            for name, a, b in zip(("value", "dx", "dw", "baked dx"), *res):
                err = float((a - b).abs().max())
                if not torch.allclose(a, b, rtol=TOL, atol=TOL):
                    raise AssertionError(f"stream_spmm {label} {dt} {name}: GPU vs CPU {err}")
                say(f"stream_spmm {label} {dt}: {name} GPU vs CPU max |diff| {err:.3g}")


# ---------------------------------------------------------------------------
# phase 8: knowledge-graph link prediction through the CLIs


def _cli(argv, cpu=False):
    """One ``cli.main`` run in this process: (stdout text, returned value,
    launch counts, wall seconds)."""
    from kgcn_tpu_torch.cli import main as cli

    tee = _Tee(sys.stdout)
    _zero_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(tee):
        result = cli.main(argv + (["--cpu"] if cpu else []))
    return tee.buf.getvalue(), result, _counts(), time.time() - t0


def kg_run(workdir, name, **over):
    """``train`` then ``infer`` of one KG config on the GPU, lines, files
    and launch counts checked; returns (launches, training costs, infer
    result)."""
    import numpy as np

    from kgcn_tpu_torch.data.dataset import load_jbl

    cfg, path = kg_config(workdir, name, **over)
    ds, info = load_jbl(cfg["dataset"], cfg)
    C = info.adj_channel_num
    epochs = int(cfg["epoch"])
    L = int(cfg["label_batch_size"])
    n_train = len(ds.label_list[0])
    steps = epochs * -(-n_train // L)
    payload = cfg.get("tiled_compute_dtype", "bfloat16")
    kernel = "stream_scatter_mat" if payload == "bfloat16" else "stream_scatter"
    say(f"-- kg {name}: {info.all_node_num} entities, {C} relations, {n_train} "
        f"training triples, label batch {L}, {epochs} epoch(s) = {steps} steps, "
        f"payload {payload}")
    launches = {k: 0 for k in _counted()}
    out, _, counts, wall = _cli(["train", "--config", path])
    if "[spmm] backend: stream" not in out:
        raise AssertionError(f"kg {name}: the run did not take the stream backend")
    costs = [float(line.split("training cost ")[1].split()[0])
             for line in out.splitlines() if line.startswith("epoch ")]
    if len(costs) != epochs or not np.isfinite(costs).all():
        raise AssertionError(f"kg {name}: training costs {costs}")
    if epochs > 1 and not costs[-1] < costs[0]:
        raise AssertionError(f"kg {name}: training cost did not fall: {costs}")
    model = cfg["save_model_path"]
    if os.listdir(model) != ["model.last.ckpt"] or not os.path.exists(cfg["save_info_train"]):
        raise AssertionError(f"kg {name}: files {os.listdir(model)}")
    say(f"-- kg {name} train: {wall:.2f} s, training costs {costs}")
    _expect(f"kg {name} train", counts, {kernel: 4 * C * steps})
    for k, v in counts.items():
        launches[k] += v
    out, result, counts, wall = _cli(["infer", "--config", path])
    n_test = int(WN18RR_TRIPLES // KG_SHRINK * KG_TEST_RATE)
    ok = (np.isfinite(list(result.values())).all() and 1.0 <= result["mean_rank"]
          <= info.all_node_num and all(0.0 <= result[k] <= 1.0
                                       for k in ("mrr", "hits@1", "hits@10")))
    if not ok or result["num_test_triples"] != n_test:
        raise AssertionError(f"kg {name}: infer result {result}, want {n_test} triples")
    for f in (cfg["save_info_test"], cfg["save_edge_result"]):
        if not os.path.exists(f):
            raise AssertionError(f"kg {name}: infer wrote no {f}")
    say(f"-- kg {name} infer: {wall:.2f} s, {json.dumps(result)}")
    _expect(f"kg {name} infer", counts, {kernel: 2 * C})
    for k, v in counts.items():
        launches[k] += v
    return launches, costs, result


def kg_gpu_vs_cpu(workdir, steps=3):
    """The float32-payload KG training's first steps on the GPU and on the
    CPU, from one seed (weights drawn on the CPU, the same label slices and
    negatives): per-step costs within TRAJECTORY_RTOL."""
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.train import Trainer

    cfg, _ = kg_config(workdir, "kg_gpu_vs_cpu", tiled_compute_dtype="float32")
    costs = {}
    for dev in (DEVICE, "cpu"):
        kb, info, _ = kg_batcher(cfg, device=dev)
        trainer = Trainer(build_model("kg_distmult", info, cfg), cfg, info, device=dev)
        state = trainer.init_state(seed=0)
        _zero_counts()
        c = []
        for _, batch in zip(range(steps), kb.batches()):
            state, cost, _ = trainer.train_step(state, batch)
            c.append(float(cost))
        costs[dev] = c
        want = {"stream_scatter": 4 * info.adj_channel_num * steps} if dev == DEVICE else {}
        _expect(f"kg steps on {dev}", _counts(), want)
    rel = [abs(a - b) / abs(b) for a, b in zip(costs[DEVICE], costs["cpu"])]
    say(f"GPU vs CPU KG step costs (float32 payload): GPU {costs[DEVICE]} CPU "
        f"{costs['cpu']} relative difference {rel} (limit {TRAJECTORY_RTOL})")
    if max(rel) > TRAJECTORY_RTOL:
        raise AssertionError(f"GPU and CPU KG step costs differ by {max(rel)}")


def kg_step_breakdown(workdir, steps=20):
    """The bf16 KG training step by step: the graph batch's one-time host
    build (and its stream structures), then per step the host time of the
    label slice and its negatives, the step's wall time to a synchronise,
    and over a profiled window the device's busy time and idle share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.train import Trainer

    cfg, _ = kg_config(workdir, "kg_breakdown")
    t0 = time.perf_counter()
    kb, info, be = kg_batcher(cfg, device=DEVICE)
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    trainer = Trainer(build_model("kg_distmult", info, cfg), cfg, info, device=DEVICE)
    state = trainer.init_state(seed=0)
    t0 = time.perf_counter()
    lls, lvs = kb._epoch_label_lists(True)
    lists = (time.perf_counter() - t0) / len(lls)
    S = len(lls)
    for i in range(3):  # warm-up
        state, _, _ = trainer.train_step(state, kb._with_labels(lls[i % S], lvs[i % S]))
    torch.cuda.synchronize()
    host, step = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        batch = kb._with_labels(lls[i % S], lvs[i % S])
        t1 = time.perf_counter()
        state, _, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        host.append(lists + t1 - t0)
        step.append(time.perf_counter() - t1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            state, _, _ = trainer.train_step(state, kb._with_labels(lls[i % S], lvs[i % S]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(getattr(ev, "device_time_total", 0.0) for ev in events) / 1e6
    top = sorted(events, key=lambda ev: -getattr(ev, "device_time_total", 0.0))[:10]
    for ev in top:
        t = getattr(ev, "device_time_total", 0.0) / 1e3 / steps
        say(f"  kg step device ms {t:.4f} ({t / (busy * 1e3 / steps):.3f} of busy) "
            f"in {ev.count / steps:.1f} launches a step: {ev.key[:90]}")
    scatter = [ev for ev in events if "stream_scatter" in ev.key]
    t = sum(getattr(ev, "device_time_total", 0.0) for ev in scatter) / 1e3 / steps
    share = t / (busy * 1e3 / steps) if busy else float("nan")
    say(f"  kg step: the stream scatter kernel {t:.4f} device ms a step "
        f"({share:.3f} of busy) in "
        f"{sum(ev.count for ev in scatter) / steps:.1f} launches a step")
    say(f"step time kg ({be.name}, payload {be.compute_dtype}, {info.adj_channel_num} "
        f"channels, label batch {cfg['label_batch_size']}, {steps} steps): graph "
        f"batch host build ms {build * 1e3:.2f} (of which stream structures "
        f"{kb.stream_seconds * 1e3:.2f}); host ms per step {np.mean(host) * 1e3:.4f}, "
        f"step wall ms to sync {np.mean(step) * 1e3:.4f} (median "
        f"{np.median(step) * 1e3:.4f}); profiled: wall ms/step {wall / steps * 1e3:.4f}, "
        f"device busy ms/step {busy / steps * 1e3:.4f}, idle share {1 - busy / wall:.4f}")


def phase_kg(workdir):
    phase(8, "kg: cli.kg, cli.main train and infer on a WN18RR-shaped knowledge graph")
    kg_files(workdir)
    launches = {k: 0 for k in _counted()}
    for name, over in (("kg_bf16", {}),
                       ("kg_f32", {"tiled_compute_dtype": "float32", "epoch": 1})):
        counts, _, _ = kg_run(workdir, name, **over)
        for k, v in counts.items():
            launches[k] += v
    kg_gpu_vs_cpu(workdir)
    kg_step_breakdown(workdir)
    return launches


# ---------------------------------------------------------------------------
# phase 9: the ELL kernel


def ring6_file(workdir):
    """The ring dataset of 6-node graphs (``RING6``) as a pickle ``.jbl``,
    written on the first call."""
    path = os.path.join(workdir, "ring6.jbl")
    if not os.path.exists(path):
        from kgcn_tpu_torch.data.synthetic import make_ring_dataset

        with open(path, "wb") as f:
            pickle.dump(make_ring_dataset(**RING6), f, protocol=4)
    return path


def _ring6_ell(workdir, bs):
    """Channel 0's ELL arrays (idx, w) of the first ring6 batch of ``bs``
    graphs on the pallas backend."""
    import numpy as np

    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.runtime.backend import Backend

    cfg = _load_config(GIN_CONFIG, dataset=ring6_file(workdir))
    ds, info = load_jbl(cfg["dataset"], cfg)
    g = Batcher(ds, info, bs, backend=Backend("pallas")).make_batch(np.arange(bs)).graph
    if g.ell_senders is None:
        raise AssertionError("the ELL gate refused the ring6 dataset")
    return g.ell_senders[0], g.ell_weights[0]


def ell_cases(workdir):
    """(label, idx [V, K] int32, w [V, K] f32 on the CPU, widths, on the
    main path)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)

    def uniform(V, K):
        return (torch.from_numpy(rng.randint(0, V, (V, K)).astype(np.int32)),
                torch.from_numpy((rng.random_sample((V, K)) + 0.1).astype(np.float32)))

    cases = [("ring6 batch (25 graphs)", *_ring6_ell(workdir, 25), (3, 50), True),
             ("ring6 1024 graphs", *_ring6_ell(workdir, 1024), (50,), False),
             ("uniform degree 8", *uniform(16384, 8), (128,), False),
             ("V=100000 K=10", *uniform(100_000, 10), (128,), False)]
    V, K = 16384, 16
    idx, w = uniform(V, K)
    deg = np.minimum(rng.poisson(4.0, V) + 1, K)  # mean degree ~5 of K 16
    pad = torch.from_numpy(np.arange(K)[None, :] >= deg[:, None])
    idx[pad], w[pad] = 0, 0.0
    cases.append(("skewed K=16 mean degree 5", idx, w, (128,), False))
    cases.append(("K=1", *uniform(1504, 1), (81,), False))
    return cases


def _ell_csr(idx, w, n_cols):
    """The ELL matrix (row v, column idx[v, k], value w[v, k]; padding
    slots left out) as CSR."""
    import torch

    V, K = idx.shape
    rows = torch.arange(V, device=idx.device).repeat_interleave(K)
    keep = w.reshape(-1) != 0
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], idx.reshape(-1).long()[keep]]),
                                  w.reshape(-1)[keep], (V, n_cols))
    return coo.coalesce().to_sparse_csr()


def ell_bound(idx, w, F, elem=4):
    """(bound_ms, bound_by): idx and w read once (8 B a slot), x read once
    and the output written once (V·F each), 2·F FLOP per real slot."""
    V, K = idx.shape
    nnz = int((w != 0).sum())
    return bound(V * K * 8 + 2 * V * F * elem, 2 * nnz * F)


def phase_ell_check(workdir):
    import torch

    from kgcn_tpu_torch.ops import ell_spmm as te

    phase(9, "kernel check: ELL gather (kgcn_tpu_torch/ops/csrc/ell.cu)")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    cases = ell_cases(workdir)
    for label, idx_c, w_c, widths, on_path in cases:
        idx, w = idx_c.to(DEVICE), w_c.to(DEVICE)
        V, K = idx.shape
        real = int((w_c != 0).sum())
        say(f"ell {label}: V {V}, K {K}, {real} real slots of {V * K}")
        mat = _ell_csr(idx, w, V)
        for F in widths:
            x = torch.randn((V, F), device=DEVICE, generator=gen)
            errs = {}
            for dt in ("float32", "bfloat16"):
                xd = x.to(getattr(torch, dt))
                got = te._launch(idx, w, xd)
                want = te.spmm_ell_reference(idx_c, w_c, xd.cpu()).to(DEVICE)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                tol = ELL_TOL[dt]
                if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
                    raise AssertionError(f"ell_spmm {label} F={F} {dt}: max |kernel - "
                                         f"plain| = {err} (limit {tol})")
                errs[dt] = err
            lib_err = float((torch.sparse.mm(mat, x) - te.spmm_ell_reference(idx, w, x))
                            .abs().max())
            iters = 10 if V * K > 500_000 else 50
            xb = x.to(torch.bfloat16)
            t = dict(
                kernel=device_ms(lambda: te._launch(idx, w, x), iters),
                kernel_bf16=device_ms(lambda: te._launch(idx, w, xb), iters),
                plain=device_ms(lambda: te.spmm_ell_reference(idx, w, x), iters),
                library=library_ms(lambda: torch.sparse.mm(mat, x), iters),
            )
            b, by = ell_bound(idx_c, w_c, F)
            rows.append(dict(label=label, F=F, on_path=on_path, err=errs["float32"],
                             err_bf16=errs["bfloat16"], bound=b, bound_by=by, **t))
            say(f"  F={F}: max |kernel - plain| f32 {errs['float32']:.3g} bf16 "
                f"{errs['bfloat16']:.3g} (library vs plain f32 {lib_err:.3g}); device ms: "
                f"kernel f32 {t['kernel']:.6f} (bf16 {t['kernel_bf16']:.6f}) plain "
                f"{t['plain']:.6f} library {t['library']}; bound {b:.6f} ({by})")
    _check_ell_gradients(cases)
    return rows


def _check_ell_gradients(cases):
    """``SpmmEll`` (the autograd Function: dx by the transpose scatter, dw
    asked for) on the card against the same call on the CPU."""
    import torch

    from kgcn_tpu_torch.ops import ell_spmm as te

    for label, idx_c, w_c, widths, _ in cases:
        if not label.startswith(("ring6 batch", "skewed")):
            continue
        F = widths[-1]
        gen = torch.Generator().manual_seed(1)
        x0 = torch.randn((idx_c.shape[0], F), generator=gen)
        cot = torch.randn((idx_c.shape[0], F), generator=gen)
        res = []
        for dev in (DEVICE, "cpu"):
            w = w_c.to(dev).clone().requires_grad_(True)
            x = x0.to(dev).clone().requires_grad_(True)
            out = te.SpmmEll.apply(idx_c.to(dev), w, x)
            (out * cot.to(dev)).sum().backward()
            res.append([t.detach().cpu() for t in (out, x.grad, w.grad)])
        for name, a, b in zip(("value", "dx", "dw"), *res):
            err = float((a - b).abs().max())
            if not torch.allclose(a, b, rtol=TOL, atol=TOL):
                raise AssertionError(f"SpmmEll {label} {name}: GPU vs CPU {err}")
            say(f"SpmmEll {label} F={F}: {name} GPU vs CPU max |diff| {err:.3g}")


# ---------------------------------------------------------------------------
# phase 10: GIN and GCN on the ELL path through the CLI


def ell_infer(workdir, name, n_graphs, per_forward):
    """``cli.main infer`` on a train run's config: result keys, files,
    predictions and the ELL launch count (``per_forward`` per batch)."""
    import numpy as np

    path = os.path.join(workdir, name, "config.json")
    with open(path) as f:
        cfg = json.load(f)
    out, result, counts, wall = _cli(["infer", "--config", path])
    protocol = result["test_metrics_protocol"]
    if not (np.isfinite(result["test_cost"]) and protocol["test_count"] == n_graphs
            and 0.0 <= protocol["test_accuracy"] <= 1.0):
        raise AssertionError(f"infer {name}: {result}")
    with open(cfg["prediction_data"], "rb") as f:
        pred = pickle.load(f)
    if pred.shape != (n_graphs, 2) or not np.allclose(pred.sum(axis=1), 1.0, atol=1e-5):
        raise AssertionError(f"infer {name}: predictions {pred.shape}")
    for f in (cfg["save_info_test"], cfg["save_result_test"]):
        if not os.path.exists(f):
            raise AssertionError(f"infer {name}: no {f}")
    if "[LOAD]" not in out:
        raise AssertionError(f"infer {name}: no [LOAD] line")
    say(f"-- infer {name}: {wall:.2f} s, test cost {result['test_cost']:.6g}, accuracy "
        f"{protocol['test_accuracy']:.4g} over {n_graphs} graphs")
    bs = int(cfg["batch_size"])
    _expect(f"infer {name}", counts, {"ell_spmm": per_forward * -(-n_graphs // bs)})
    return counts


def phase_ell(workdir):
    from kgcn_tpu_torch.ops import spmm as tspmm

    phase(10, "ell: cli.main train and infer for gin and gcn on the pallas backend")
    tspmm._PALLAS_FALLBACK_WARNED[0] = False  # a fallback here must show
    data = ring6_file(workdir)
    n_graphs = 2 * RING6["num_pairs"]
    C = 1
    launches = {k: 0 for k in _counted()}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    outputs = dict(dataset=data, spmm_backend="pallas", make_plot=False)
    for name, src, epochs, per_forward in (("gin_pallas", GIN_CONFIG, 2, 2 * C),
                                           ("gcn_pallas", GCN_RING_CONFIG, 1, 3 * C)):
        d = os.path.join(workdir, name)
        _, counts, steps, evals, out = train_run(
            workdir, name, src, epochs, falling=epochs > 1,
            save_info_test=os.path.join(d, "info_test.json"),
            save_result_test=os.path.join(d, "result_test.csv"),
            prediction_data=os.path.join(d, "prediction.jbl"), **outputs)
        if "[spmm] backend: pallas" not in out or "pallas backend requested" in out:
            raise AssertionError(f"train {name}: did not take the ELL route")
        _expect(f"train {name}", counts, {"ell_spmm": per_forward * (steps + evals)})
        add(counts)
        add(ell_infer(workdir, name, n_graphs, per_forward))
    steps_gpu_vs_cpu("GIN (pallas, ring6)", _load_config(
        GIN_CONFIG, dataset=ring6_file(workdir), spmm_backend="pallas"), 3,
        lambda info: {"ell_spmm": 2 * info.adj_channel_num * 3})
    step_breakdown((("gin_pallas", GIN_CONFIG, dict(dataset=data, spmm_backend="pallas")),))

    # synthetic.jbl: the gate refuses ELL, so the data (not a fault of the
    # kernel) sends pallas to the edge-list scatter, with the JAX message
    for backend in ("pallas", "xla"):
        tspmm._PALLAS_FALLBACK_WARNED[0] = False
        _, counts, _, _, out = train_run(workdir, f"gin_synthetic_{backend}", GIN_CONFIG,
                                         1, falling=False, spmm_backend=backend)
        said = out.count("[spmm] pallas backend requested")
        if said != (backend == "pallas"):
            raise AssertionError(f"gin on synthetic.jbl ({backend}): the fallback "
                                 f"message printed {said} times")
        _expect(f"train gin_synthetic_{backend}", counts, {})
        say(f"-- gin on synthetic.jbl ({backend}): the ELL gate refused the dataset; "
            f"0 ELL launches, fallback message printed {said} time(s)")
    return launches


# ---------------------------------------------------------------------------


def summary_rows(gconv_rows, tiled_rows, stream_rows, ell_rows, launches):
    """The ``kernels`` line: each kernel at the main path's shapes (gconv:
    the served batch's three GraphConv calls; tiled: the solubility batch at
    F 81 and 50 and the GAT batch, bf16 payload; stream: the KG's largest
    and smallest relation channels at F 128 — the iota-route scatter with
    the float32 payload of its KG run, the one-hot scatter and the weight
    gradient with bf16; ELL: the ring6 batch at F 3 and 50, float32),
    errors over every shape (float32)."""
    def mean(rows, key):
        vals = [r[key] for r in rows]
        return None if None in vals else sum(vals) / len(vals)

    path = gconv_rows[:3]
    on_path = [r for r in tiled_rows if r["on_path"]]
    gat = [r for r in on_path if r["label"] == "GAT batch"]
    return [{
        "name": "gconv",
        "route": "cuda",
        "source": "kgcn_tpu_torch/ops/csrc/gconv.cu",
        "replaces": "kgcn_tpu/ops/pallas_gconv.py:33",
        "launches": launches["gconv"],
        "max_abs_err": max(r["err"] for r in gconv_rows),
        "ms": mean(path, "kernel_ms"),
        "plain_ms": mean(path, "plain_ms"),
        "bound_ms": mean(path, "bound_ms"),
        "bound_by": path[0]["bound_by"],
        "library_ms": mean(path, "library_ms"),
    }, {
        "name": "tiled_spmm",
        "route": "cuda",
        "source": "kgcn_tpu_torch/ops/csrc/tiled.cu",
        "replaces": "kgcn_tpu/ops/tiled_spmm.py:320",
        "launches": launches["tiled_spmm"],
        "max_abs_err": max(r["spmm_err"] for r in tiled_rows),
        "ms": mean(on_path, "spmm"),
        "plain_ms": mean(on_path, "spmm_plain"),
        "bound_ms": mean(on_path, "bound"),
        "bound_by": on_path[0]["bound_by"],
        "library_ms": mean(on_path, "spmm_library"),
    }, {
        "name": "tiled_sddmm",
        "route": "cuda",
        "source": "kgcn_tpu_torch/ops/csrc/tiled.cu",
        "replaces": "kgcn_tpu/ops/tiled_spmm.py:353",
        "launches": launches["tiled_sddmm"],
        "max_abs_err": max(r["sddmm_err"] for r in tiled_rows),
        "ms": mean(gat, "sddmm"),
        "plain_ms": mean(gat, "sddmm_plain"),
        "bound_ms": mean(gat, "bound"),
        "bound_by": gat[0]["bound_by"],
        "library_ms": mean(gat, "sddmm_library"),
    }] + stream_summary_rows(stream_rows, launches, mean) + [
        ell_summary_row(ell_rows, launches, mean)]


def ell_summary_row(rows, launches, mean):
    on_path = [r for r in rows if r["on_path"]]
    return {
        "name": "ell_spmm",
        "route": "cuda",
        "source": "kgcn_tpu_torch/ops/csrc/ell.cu",
        "replaces": "kgcn_tpu/ops/pallas_spmm.py:30",
        "launches": launches["ell_spmm"],
        "max_abs_err": max(r["err"] for r in rows),
        "ms": mean(on_path, "kernel"),
        "plain_ms": mean(on_path, "plain"),
        "bound_ms": mean(on_path, "bound"),
        "bound_by": on_path[0]["bound_by"],
        "library_ms": mean(on_path, "library"),
    }


def stream_summary_rows(rows, launches, mean):
    kg = [r for r in rows if r["on_path"]]
    out = []
    for name, line, key, kind, err in (
            ("stream_scatter", 335, "scatter", "scatter", "scatter_err"),
            ("stream_scatter_mat", 374, "scatter_mat", "scatter_mat", "mat_err"),
            ("stream_dw", 448, "dw", "dw", "dw_err")):
        bounds = [r["bounds"][kind] for r in kg]
        out.append({
            "name": name,
            "route": "cuda",
            "source": "kgcn_tpu_torch/ops/csrc/stream.cu",
            "replaces": f"kgcn_tpu/ops/stream_spmm.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(r[err] for r in rows),
            "ms": mean(kg, key),
            "plain_ms": mean(kg, f"{key}_plain"),
            "bound_ms": sum(b for b, _ in bounds) / len(bounds),
            "bound_by": bounds[0][1],
            "library_ms": mean(kg, "dw_library" if kind == "dw" else "spmm_library"),
        })
    return out


def main():
    t_start = time.time()
    smi = phase_environment()
    phase_build()
    gconv_rows = phase_gconv_check()
    tiled_rows = phase_tiled_check()
    say(f"kernel checks done at {time.time() - t_start:.1f} s")
    with tempfile.TemporaryDirectory(prefix="kgcn_smoke_") as workdir:
        launches = phase_train(workdir)
        say(f"train done at {time.time() - t_start:.1f} s")
        launches["gconv"] += phase_serve(workdir)
        say(f"serve done at {time.time() - t_start:.1f} s")
        stream_rows = phase_stream_check(workdir)
        say(f"stream check done at {time.time() - t_start:.1f} s")
        for k, v in phase_kg(workdir).items():
            launches[k] += v
        say(f"kg done at {time.time() - t_start:.1f} s")
        ell_rows = phase_ell_check(workdir)
        say(f"ell check done at {time.time() - t_start:.1f} s")
        for k, v in phase_ell(workdir).items():
            launches[k] += v

    import torch

    phase(11, "summary")
    for k, v in launches.items():
        if k in NO_MAIN_PATH_LAUNCH:
            if v != 0:
                raise AssertionError(f"{k} launched {v} times on the main path, want 0")
            say(f"{k}: 0 launches on the main path, as predicted "
                f"({NO_MAIN_PATH_LAUNCH[k]}); checked against its plain version in phase 7")
        elif v <= 0:
            raise AssertionError(f"{k} was not launched on the main path")
    kernels = summary_rows(gconv_rows, tiled_rows, stream_rows, ell_rows, launches)
    say(f"total {time.time() - t_start:.1f} s")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
