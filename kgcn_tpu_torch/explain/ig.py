"""Integrated gradients — the counterpart of ``kgcn_tpu/explain/ig.py``
(reference: kgcn/visualization.py:22-287).

Methods (reference ``cal_integrated_gradients``): ``ig`` (the mean
gradient over the scalings ``(1..k)/k`` times the input), ``grad`` (the
gradient at the input), ``grad_prod`` (times the input), ``smooth_grad``
(the mean gradient over ``k`` noisy copies at scale 1) and ``smooth_ig``
(``ig`` with noise).  The attributed inputs are the node features, the
adjacency values (``edge_weights``, whose gradient reaches the model
through ``GraphBatch.dense_adjacency``) and the vector modals, scaled
together.  ``embedded_layer_ig`` is the IG of the sequence-embedding
layer's output (integer sequences are not differentiable), through the
multimodal model's ``embedding()`` hook and its ``embedded`` input.  The
completeness oracle ``sum(IG) ≈ F(1) − F(0)`` is computed as the
reference's ``check_IG`` (kgcn/visualization.py:279-287) and saved with
every dump.

The JAX package sums the k gradients in one jitted ``lax.scan`` over
scaled batches (``_scale_batch``).  Here the k scaled copies of the batch
are stacked along the batch axis, chunks of
up to ``chunk_copies(...)`` copies at a time, each copy a block of its own
graphs: in evaluation no layer couples graphs (batch normalisation reads
its running statistics, dropout is off), so the gradient of the summed
score with respect to one copy's inputs is the gradient at that copy's
scale.  A molecule costs one forward and one backward per chunk, plus one
forward of the two copies F(1) and F(0).  The copies keep the batch's
backend (``_stacked``): the dense adjacency through the gconv kernel and
its dA, the tiled and stream kernels with their weight gradients, the ELL
arrays (``xla``, and ``pallas``: the ELL kernel and its dx) with their
baked slot weights.  On a batch with ELL arrays the layers never read
``edge_weights``, so, as in ``kgcn_tpu``, the adjacency's IG is 0 and
F(1) − F(0) scales the features alone.

Output: one dump per sample with the reference's keys and shapes —
``features``, ``features_IG``, ``adjs``, ``adjs_IG``, ``check_score``,
``sum_of_IG``; ``vector_modal`` and ``vector_modal_IG`` where the batch
has vector modals; ``embedded_layer``, ``embedded_layer_IG``,
``embedded_check_score`` and ``embedded_sum_of_IG`` for a sequence model
with an ``embedding()`` hook; ``mol`` where the dataset has molecules — as
a plain pickle (``joblib.load`` reads it), where the JAX package writes a
joblib file.  The KG route of ``visualize`` is ``explain/kg_ig.py``.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from kgcn_tpu_torch.data.batcher import Batch
from kgcn_tpu_torch.graph.batch import GraphBatch
from kgcn_tpu_torch.ops.ell import ell_transpose

# dense adjacency elements of one chunk of stacked copies (float32: 64 MB)
CHUNK_ADJ_ELEMENTS = 1 << 24


def target_scores(prediction, labels, mode, label_index: Optional[int] = None):
    """The attributed output of each example ``[B]`` (reference
    ig_label_target: kgcn/visualization.py:497-530; ``kgcn_tpu``'s
    ``make_target_score`` returns their sum, and the stacked copies need
    them per copy): the largest output (``max``), the
    true class's (``label``) or class ``label_index``'s (``index``); a
    multitask prediction ``[B, T, 2]`` is read at its positive class."""
    pred = prediction
    if pred.dim() == 3:
        pred = pred[..., 1]
    if mode == "max":
        return torch.amax(pred, dim=-1)
    if mode == "label":
        idx = torch.argmax(labels, dim=-1)
        return torch.gather(pred, -1, idx[:, None])[:, 0]
    if mode == "index":
        return pred[..., label_index]
    raise ValueError(mode)


def _stacked(batch: Batch, K: int) -> Batch:
    """``K`` copies of ``batch`` as one batch of ``K·B`` graphs on the
    batch's backend, without features: copy ``j``'s nodes are rows ``j·V
    …``, its edges (padding ones too) columns ``j·E …`` of each channel,
    offset into its own block of nodes.  The copies' padding edges stay in
    place (an explicit ``edge_valid`` mask), so each copy sees the original
    batch's edge layout.  Built on the host and moved, once a batch and
    copy count: the tiled and stream structures as the ``Batcher`` builds
    them (``with_tiled`` / ``with_stream``), so their kernels aggregate the
    copies and their weight gradients (the tiled SDDMM, the stream dw)
    reach the scaled ``edge_weights`` (``live_weights`` on stream).  ELL
    arrays are tiled per copy, their senders offset into the copy's block,
    with the slot weights baked in as ``kgcn_tpu``'s batcher bakes them,
    and their transpose (the dx kernel's slot lists) built alongside.  The
    batch's sequences and labels are repeated per copy; the vector modals
    come with the scaled inputs (``_copy_scores``)."""
    g = batch.graph
    C, E = g.senders.shape
    V = g.total_nodes
    offset = (np.arange(K, dtype=np.int32) * V)[None, :, None]

    def tile(idx):  # [C, E] → [C, K·E], copy j offset by j·V
        return torch.from_numpy(np.ascontiguousarray(
            (np.asarray(idx, np.int32)[:, None, :] + offset).reshape(C, K * E)))

    def host(t):
        return t.detach().cpu()

    stacked = GraphBatch(
        senders=tile(host(g.senders).numpy()),
        receivers=tile(g.host_receivers if g.host_receivers is not None
                       else host(g.receivers).numpy()),
        edge_weights=host(g.edge_weights).repeat(1, K),
        n_edge=torch.full((C,), K * E, dtype=torch.int32),
        n_node=host(g.n_node).repeat(K), node_mask=host(g.node_mask).repeat(K),
        edge_valid=host(g.edge_mask()).repeat(1, K),
        n_graph=K * g.n_graph, max_nodes=g.max_nodes, backend=g.backend,
        compute_dtype=g.compute_dtype, live_weights=g.stream_adj is not None,
    )
    if g.tiled_adj is not None:
        stacked = stacked.with_tiled(feature_dim=int(g.nodes.shape[-1]))
    elif g.stream_adj is not None:
        stacked = stacked.with_stream()
    transposed = None
    if g.ell_senders is not None:
        idx = host(g.ell_senders).numpy()  # [C, V, slots]
        idx = (idx[:, None] + offset[:, :, :, None]).reshape(C, K * V, -1)
        w = host(g.ell_weights).repeat(1, K, 1)
        stacked = stacked.replace(ell_senders=torch.from_numpy(idx), ell_weights=w)
        transposed = tuple(torch.from_numpy(a) for a in ell_transpose(idx, w.numpy(), K * V))

    def rep(x):
        return None if x is None else x.repeat(K, *([1] * (x.dim() - 1)))

    moved = stacked.to(g.senders.device)
    if transposed is not None:
        moved = moved.replace(ell_transposed=tuple(t.to(g.senders.device)
                                                   for t in transposed))
    return Batch(graph=moved, labels=rep(batch.labels),
                 mask_label=rep(batch.mask_label), node_label=rep(batch.node_label),
                 mask_node_label=rep(batch.mask_node_label),
                 sequences=rep(batch.sequences), sequences_len=rep(batch.sequences_len),
                 pad_mask=rep(batch.pad_mask))


def chunk_copies(batch: Batch) -> int:
    """How many scaled copies of ``batch`` one forward stacks: as many as
    keep their dense adjacency within ``CHUNK_ADJ_ELEMENTS``."""
    g = batch.graph
    per_copy = g.senders.shape[0] * g.n_graph * g.max_nodes ** 2
    return max(1, CHUNK_ADJ_ELEMENTS // max(per_copy, 1))


def _copy_scores(model, variables, stack, copies, nodes, weights, mode, label_index,
                 vm=None):
    """Per-copy summed target scores ``[copies]`` of ``stack`` (``_stacked``'s
    copies) at features ``nodes`` ``[copies·V, F]``, adjacency values
    ``weights`` ``[C, copies·E]`` and vector modals ``vm`` (each
    ``[copies·B, D]``, or None)."""
    sb = stack.replace(graph=stack.graph.replace(nodes=nodes, edge_weights=weights),
                       vector_modal=vm)
    out = functional_call(model, variables, (sb,), {"train": False})
    rows = target_scores(out.prediction, sb.labels, mode, label_index)
    return rows.reshape(copies, -1).sum(dim=1)


def integrated_gradients(
    model: torch.nn.Module,
    variables: Dict[str, torch.Tensor],
    batch: Batch,
    *,
    steps: int = 100,
    method: str = "ig",
    target: str = "max",
    label_index: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    noise_scale: float = 0.1,
) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    """IG of ``batch``'s node features and adjacency values for ``model``
    with ``variables`` (its parameters and BN statistics, as
    ``functional_call`` takes them), on the batch's device and backend.

    Returns ``(igs, check)``: ``igs`` has ``features_IG`` ``[V, F]``,
    ``adjs_IG`` ``[C, E]`` (per edge, padding edges included) and, for a
    batch with vector modals, ``vector_modal_IG`` (one ``[B, D]`` array a
    modal), ``check`` the completeness oracle (``check_score`` = F(1) −
    F(0), ``sum_of_IG``).  ``generator`` draws the smooth variants' noise
    (of the features; the modals are scaled without noise, as in
    ``kgcn_tpu``)."""
    if method in ("ig", "smooth_ig"):
        scales = (torch.arange(steps, dtype=torch.float32) + 1.0) / steps
    elif method in ("grad", "grad_prod", "smooth_grad"):
        scales = torch.ones(steps if method == "smooth_grad" else 1)
    else:
        raise ValueError(method)
    noisy = method in ("smooth_grad", "smooth_ig")
    g = batch.graph
    if g.nodes is None:
        raise ValueError("IG needs node features; node-embedding graphs have none")
    nodes0, ew0 = g.nodes, g.edge_weights
    vm0 = batch.vector_modal  # a tuple of [B, D_m], or None
    dev = nodes0.device
    scales = scales.to(dev)
    k = scales.shape[0]
    chunk = chunk_copies(batch)
    stacks = {}  # copy count → the copies' batch, built once
    gsum_n = torch.zeros_like(nodes0)
    gsum_e = torch.zeros_like(ew0)
    gsum_vm = None if vm0 is None else [torch.zeros_like(v) for v in vm0]
    C, E = ew0.shape

    def scaled_vm(s):  # each modal's copies at the scales ``s``
        if vm0 is None:
            return None
        return tuple((v[None] * s[:, None, None]).reshape(len(s) * v.shape[0], -1)
                     for v in vm0)

    for start in range(0, k, chunk):
        s = scales[start:start + chunk]
        K = s.shape[0]
        if K not in stacks:
            stacks[K] = _stacked(batch, K)
        x = nodes0[None].expand(K, *nodes0.shape)
        if noisy:
            x = x + noise_scale * torch.randn(x.shape, generator=generator, device=dev)
        x = (x * s[:, None, None]).reshape(K * nodes0.shape[0], -1)
        w = (ew0[:, None, :] * s[None, :, None]).reshape(C, K * E)
        x = x.detach().requires_grad_(True)
        w = w.detach().requires_grad_(True)
        vm = scaled_vm(s)
        vm = None if vm is None else tuple(v.detach().requires_grad_(True) for v in vm)
        with torch.enable_grad():
            score = _copy_scores(model, variables, stacks[K], K, x, w, target,
                                 label_index, vm)
            # a batch with ELL arrays never reads edge_weights: no gradient,
            # 0 as in kgcn_tpu
            grads = torch.autograd.grad(score.sum(), (x, w) + (vm or ()),
                                        allow_unused=True)
        grads = [torch.zeros_like(t) if gr is None else gr
                 for t, gr in zip((x, w) + (vm or ()), grads)]
        gsum_n += grads[0].reshape(K, *nodes0.shape).sum(dim=0)
        gsum_e += grads[1].reshape(C, K, E).sum(dim=1)
        for acc, gv, v in zip(gsum_vm or (), grads[2:], vm0 or ()):
            acc += gv.reshape(K, *v.shape).sum(dim=0)
    if method in ("ig", "grad_prod", "smooth_ig"):
        ig_nodes, ig_edges = (gsum_n / k) * nodes0, (gsum_e / k) * ew0
        ig_vm = None if vm0 is None else [(a / k) * v for a, v in zip(gsum_vm, vm0)]
    else:  # pure gradients
        ig_nodes, ig_edges = gsum_n / k, gsum_e / k
        ig_vm = None if vm0 is None else [a / k for a in gsum_vm]
    # completeness: F(1) − F(0) (kgcn/visualization.py:279-287), one forward
    # of the two copies
    with torch.no_grad():
        two = torch.tensor([1.0, 0.0], device=dev)
        f = _copy_scores(
            model, variables, stacks.get(2) or _stacked(batch, 2), 2,
            (nodes0[None] * two[:, None, None]).reshape(2 * nodes0.shape[0], -1),
            (ew0[:, None, :] * two[None, :, None]).reshape(C, 2 * E),
            target, label_index, scaled_vm(two))
        check_score = f[0] - f[1]
        sum_of_ig = torch.sum(ig_nodes) + torch.sum(ig_edges)
        for v in ig_vm or ():
            sum_of_ig = sum_of_ig + torch.sum(v)
    igs = {"features_IG": ig_nodes.detach().cpu().numpy(),
           "adjs_IG": ig_edges.detach().cpu().numpy()}
    if ig_vm is not None:
        igs["vector_modal_IG"] = [v.detach().cpu().numpy() for v in ig_vm]
    return igs, {"check_score": float(check_score), "sum_of_IG": float(sum_of_ig)}


class _Method(torch.nn.Module):
    """A method of a model as a module's forward, so that ``functional_call``
    runs it on substituted parameters (``m.``-prefixed names)."""

    def __init__(self, model, name):
        super().__init__()
        self.m = model
        self.name = name

    def forward(self, *args, **kwargs):
        return getattr(self.m, self.name)(*args, **kwargs)


def embedded_layer_ig(model: torch.nn.Module, variables: Dict[str, torch.Tensor],
                      batch: Batch, *, steps: int = 100, target: str = "max",
                      label_index: Optional[int] = None):
    """IG on the SEQUENCE-EMBEDDING layer's output (``kgcn_tpu``'s
    ``embedded_layer_ig``, ``explain/ig.py:190-239``; the reference scales
    the embedded layer, ``feed_embedded_layer=True``,
    kgcn/visualization.py:64,123-126,302-320): the embedded sequences
    ``model.embedding(sequences)`` ``[B, L, D]`` scaled by ``(1..steps) /
    steps`` and fed through the model's ``embedded`` input, the gradients
    summed in step order.  Returns ``(embedded_layer, embedded_layer_IG,
    check)`` with ``check_score`` = F(emb) − F(0) and ``sum_of_IG``."""
    params = {f"m.{k}": v for k, v in variables.items()}
    emb0 = functional_call(_Method(model, "embedding"), params,
                           (batch.sequences,)).detach()
    scorer = _Method(model, "forward")

    def score(emb):
        out = functional_call(scorer, params, (batch,), {"train": False, "embedded": emb})
        return torch.sum(target_scores(out.prediction, batch.labels, target, label_index))

    scales = (torch.arange(steps, dtype=torch.float32) + 1.0) / steps
    gsum = torch.zeros_like(emb0)
    for s in scales.to(emb0.device):
        e = (emb0 * s).requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(score(e), e)
        gsum += g
    ig = (gsum / steps) * emb0
    with torch.no_grad():
        check = score(emb0) - score(torch.zeros_like(emb0))
    ig = ig.cpu().numpy()
    return (emb0.cpu().numpy(), ig,
            {"check_score": float(check), "sum_of_IG": float(np.sum(ig))})


def edge_ig_to_dense(graph: GraphBatch, ig_edges: np.ndarray) -> np.ndarray:
    """Per-edge IG ``[C, E]`` scattered into a dense ``[C, B, N, N]``
    (receiver row, sender column), what gcnvisualizer's adjacency heatmap
    expects; duplicate edges add up."""
    ig_edges = np.asarray(ig_edges)
    C, _ = ig_edges.shape
    B, N = graph.n_graph, graph.max_nodes
    out = np.zeros((C, B, N, N), np.float32)
    s = graph.senders.cpu().numpy()
    r = graph.receivers.cpu().numpy()
    ne = graph.n_edge.cpu().numpy()
    for c in range(C):
        k = int(ne[c])
        b = r[c, :k] // N
        # np.add.at: a fancy-index += would drop duplicate (r, s) pairs
        np.add.at(out[c], (b, r[c, :k] % N, s[c, :k] % N), ig_edges[c, :k])
    return out


def _squeeze_c(dense):
    """[C, N, N] → [N, N] for the common single-channel case."""
    return dense[0] if dense.shape[0] == 1 else dense


def _dump_ig(outdir, i, tag, batch, igs, check, info) -> str:
    """``mol_{i:05d}_{tag}.jbl``: the sample's inputs, their IG and the
    completeness check, with ``kgcn_tpu``'s keys and shapes."""
    g = batch.graph
    N = g.max_nodes
    out = {
        "features": g.nodes.cpu().numpy().reshape(N, -1),
        "features_IG": igs["features_IG"].reshape(N, -1),
        # [C, N, N]; single-channel datasets keep the legacy [N, N] shape
        "adjs": _squeeze_c(edge_ig_to_dense(g, g.edge_weights.cpu().numpy())[:, 0]),
        "adjs_IG": _squeeze_c(edge_ig_to_dense(g, igs["adjs_IG"])[:, 0]),
        **check,
    }
    if "vector_modal_IG" in igs:
        out["vector_modal"] = [v.cpu().numpy()[0] for v in batch.vector_modal]
        out["vector_modal_IG"] = [v[0] for v in igs["vector_modal_IG"]]
    if "embedded_layer_IG" in igs:
        out["embedded_layer"] = igs["embedded_layer"][0]
        out["embedded_layer_IG"] = igs["embedded_layer_IG"][0]
    if info.mol_info is not None and "obj_list" in info.mol_info:
        try:
            out["mol"] = info.mol_info["obj_list"][i]
        except (IndexError, KeyError, TypeError):
            pass
    path = os.path.join(outdir, f"mol_{i:05d}_{tag}.jbl")
    with open(path, "wb") as f:
        pickle.dump(out, f, protocol=4)
    rel_err = (abs(check["sum_of_IG"] - check["check_score"])
               / (abs(check["check_score"]) + 1e-12))
    print(f"[SAVE] {path} (check: F(1)-F(0)={check['check_score']:.4f} "
          f"sum_IG={check['sum_of_IG']:.4f} rel_err={rel_err:.3f})")
    return path


def run_visualization(config, device=None, raw=None) -> list:
    """IG over a dataset, one sample at a time from the streaming
    ``Batcher`` (batch 1), each dumped to ``visualize_path`` (reference:
    gcn.py:637-657 with cal_feature_IG, kgcn/visualization.py:442-574; as
    ``kgcn_tpu``'s ``run_visualization``).  ``visualize_type`` picks the
    target: ``max`` (or ``graph``), a class index, ``correct`` /
    ``uncorrect`` (the predicted class, for the samples predicted right /
    wrong), or ``all`` (every class).  ``raw``: the dataset's dict, where
    the caller has read it already.  Returns the dump paths."""
    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime import backend as backend_mod
    from kgcn_tpu_torch.runtime.train import Trainer

    ds, info = build_dataset(jbl.load(config["dataset"]) if raw is None else raw,
                             config)
    if ds.features is None:
        raise ValueError(
            "IG visualization needs dense node features; embedding-mode "
            "graphs (with_node_embedding / KG) use the kg_ig visualizer "
            "(task: link_prediction routes there automatically)")
    backend = backend_mod.resolve(config, info)
    trainer = Trainer(build_model(config["model.py"], info, config), config, info,
                      device=device)
    load_path = config.get("load_model") or os.path.join(
        config.get("save_model_path", "model"), "model.best.ckpt")
    state = trainer.restore(load_path)
    print(f"[LOAD] {load_path}")
    model, dev = trainer.model, trainer.device
    variables = {**state.params, **state.batch_stats}
    b1 = Batcher(ds, info, batch_size=1, backend=backend)

    outdir = config.get("visualize_path", "./visualization/")
    os.makedirs(outdir, exist_ok=True)
    target = config.get("visualize_type", "max")
    if target == "graph":  # the reference's dispatch value (gcn.py:651):
        target = "max"     # it selects this path, not an IG target mode
    num = int(config.get("visualize_num", ds.num) or ds.num)
    steps = int(config.get("ig_divide_number", 100))
    method = str(config.get("visualize_method", "ig"))
    generator = torch.Generator(device=dev).manual_seed(0)

    def compute(batch, mode, label_index):
        """Every modality's IG of one sample (``kgcn_tpu``'s ``_compute_igs``):
        the inputs', and the sequence-embedding layer's for a model with an
        ``embedding()`` hook."""
        igs, check = integrated_gradients(model, variables, batch, steps=steps,
                                          method=method, target=mode,
                                          label_index=label_index, generator=generator)
        if batch.sequences is not None and hasattr(model, "embedding"):
            emb, emb_ig, emb_check = embedded_layer_ig(
                model, variables, batch, steps=steps, target=mode,
                label_index=label_index)
            igs["embedded_layer"], igs["embedded_layer_IG"] = emb, emb_ig
            check["embedded_check_score"] = emb_check["check_score"]
            check["embedded_sum_of_IG"] = emb_check["sum_of_IG"]
        return igs, check

    paths = []
    for i in range(min(num, ds.num)):
        batch = b1.make_batch(np.asarray([i])).to(dev)
        ig_target, label_index = target, None
        if isinstance(target, (int, np.integer)) or (
                isinstance(target, str) and target.isdigit()):
            ig_target, label_index = "index", int(target)  # a class index
        if target in ("correct", "uncorrect", "all"):
            with torch.no_grad():
                out = functional_call(model, variables, (batch,), {"train": False})
            pred = out.prediction.cpu().numpy()
            pred2 = pred[..., 1] if pred.ndim == 3 else pred
            pred_cls = int(np.argmax(pred2[0]))
            true_cls = int(np.argmax(batch.labels.cpu().numpy()[0]))
            if target == "correct" and pred_cls != true_cls:
                continue
            if target == "uncorrect" and pred_cls == true_cls:
                continue
            if target == "all":
                for cls in range(pred2.shape[-1]):
                    igs, check = compute(batch, "index", cls)
                    paths.append(_dump_ig(outdir, i, f"class{cls}", batch, igs, check,
                                          info))
                continue
            ig_target, label_index = "index", pred_cls
        igs, check = compute(batch, ig_target, label_index)
        paths.append(_dump_ig(outdir, i, str(target), batch, igs, check, info))
    return paths
