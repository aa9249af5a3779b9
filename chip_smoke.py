#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kgcn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced on its own line; any failure ends the run with a
non-zero exit and no result line:

1. environment — the card (nvidia-smi name and power limit), torch, CUDA;
2. build — every CUDA kernel of the port, from kgcn_tpu_torch/ops/csrc,
   one nvcc per source, in parallel;
3. kernel check — each kernel against its plain PyTorch version on the card
   at the serving path's shapes and two more (float32, rtol = atol = 1e-4:
   the sums run over ≤ 256 terms in another order), with its device time
   (torch.profiler), the plain version's, one library call's, and the least
   time the card could take (bytes at 3.35 TB/s vs FLOP at 67 TFLOP/s FP32);
4. serve — the port's HTTP server (cli/serve.build_server) answers /predict
   requests of 1, 8, 32 and 100 real molecules of
   examples/solubility/solubility_cls.jbl with a seeded GCN at the config's
   full width (example_config/solubility_cls.json: hidden 50, batch 32,
   47 nodes, 81 features); answers are checked (rows sum to 1, finite,
   equal to the same model run on the CPU to 1e-4) and the kernel launch
   counts read back;
5. summary — one JSON line of kernel numbers, then the result line.

Exits non-zero without a CUDA device and outside a checkout of the repo.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "example_config", "solubility_cls.json")
DATASET = os.path.join(ROOT, "examples", "solubility", "solubility_cls.jbl")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, FP32 outside tensor cores
TOL = 1e-4

# (C, B, N, Fin, Fout): the serving path's three GraphConv calls per batch,
# a misaligned toy (tests/test_kernels.py:89), a reaction-scale batch
GCONV_SHAPES = [
    ("path layer 1", (1, 32, 47, 81, 50)),
    ("path layer 2", (1, 32, 47, 50, 50)),
    ("path layer 3", (1, 32, 47, 50, 50)),
    ("misaligned", (2, 2, 10, 7, 5)),
    ("reaction-scale", (3, 128, 203, 81, 128)),
]
REQUEST_SIZES = (1, 8, 32, 100)


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


def device_ms(fn, iters):
    """Device time per call of ``fn`` in ms: the summed duration of every
    CUDA kernel it launches (torch.profiler), over ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(ev, "device_time_total", 0.0) for ev in prof.key_averages())
    if total_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total_us / iters / 1e3


def gconv_bound(C, B, N, Fin, Fout):
    """(bound_ms, bound_by): every input read once and the output written
    once, against X W_c computed once per graph plus the aggregation."""
    nbytes = 4 * (C * B * N * N + B * N * Fin + C * Fin * Fout + C * Fout + B * N * Fout)
    flops = 2 * C * B * N * (Fin * Fout + N * Fout) + 2 * C * B * N * Fout
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def phase_kernel_check():
    import torch

    from kgcn_tpu_torch.ops.gconv import gconv, gconv_reference

    phase(3, "kernel check: gconv (kgcn_tpu_torch/ops/csrc/gconv.cu)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, (C, B, N, Fin, Fout) in GCONV_SHAPES:
        # operands at the model's scales: a normalised adjacency (rows sum
        # ~1), features in [0, 1), Glorot-sized weights
        adj = torch.rand((C, B, N, N), device="cuda", generator=gen) * (2.0 / N)
        x = torch.rand((B, N, Fin), device="cuda", generator=gen)
        w = torch.randn((C, Fin, Fout), device="cuda", generator=gen) / math.sqrt(Fin)
        b = torch.randn((C, Fout), device="cuda", generator=gen) * 0.1
        got = gconv(adj, x, w, b)
        want = gconv_reference(adj, x, w, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=TOL, atol=TOL):
            raise AssertionError(f"gconv {label} {(C, B, N, Fin, Fout)}: "
                                 f"max |kernel - plain| = {err}")

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
            f"max_abs_err={err:.3g} (library {lib_err:.3g}); device time: "
            f"kernel_ms={kernel_ms:.6f} plain_ms={plain_ms:.6f} "
            f"library_ms={library_ms:.6f} bound_us={bound_ms * 1e3:.3f} "
            f"({bound_by}); host-loop ms per gconv call={host_ms:.5f}")
    return rows


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

    phase(4, "serve: solubility_cls GCN over HTTP")
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
        gconv.launches = 0
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


def main():
    smi = phase_environment()
    phase_build()
    rows = phase_kernel_check()
    with tempfile.TemporaryDirectory(prefix="kgcn_smoke_") as workdir:
        launches = phase_serve(workdir)

    import torch

    phase(5, "summary")
    path_rows = rows[:3]  # the three GraphConv calls of one served batch

    def mean(key):
        return sum(r[key] for r in path_rows) / len(path_rows)

    bound_by = path_rows[0]["bound_by"]
    kernels = [{
        "name": "gconv",
        "route": "cuda",
        "source": "kgcn_tpu_torch/ops/csrc/gconv.cu",
        "replaces": "kgcn_tpu/ops/pallas_gconv.py:33",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in rows),
        "ms": mean("kernel_ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": bound_by,
        "library_ms": mean("library_ms"),
    }]
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
