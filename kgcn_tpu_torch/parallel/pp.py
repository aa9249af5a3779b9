"""Pipeline-parallel GNN training over a ``pipe`` axis (the GPipe
schedule) — the counterpart of ``kgcn_tpu/parallel/pp.py``.

The network: stage 0 embeds the raw features (``x W_e + b_e``), then S·k
blocks of ``relu(Σ_c A_c (z W_c + b_c))`` (the reference's dense
GraphConv, ``kgcn/layers.py:110-115``, summed over the channels, plus
ReLU), then the last stage's masked-sum readout (GraphGather) and dense
head, and the masked softmax cross-entropy.  The block is ``ops.gconv``
(the CUDA kernel on the card), the adjacency laid out ``[C, mb, N, N]`` as
gconv takes it.

* The stack is split into S stages, one a rank of the ``pipe`` axis; rank
  s holds only stage s's parameters and Adam moments (stage 0 also the
  embed, stage S−1 also the head).  ``kgcn_tpu`` keeps a stage-stacked
  ``[S, ...]`` tree whose spare embed and head slices get zero gradients
  and never change; here they are dropped.
* A step splits the batch into M microbatches (``prepare_batch`` raises
  ``ValueError`` when the batch does not divide) and runs M + S − 1
  ticks: at tick t stage s works on microbatch t − s when it holds one,
  and hands its activation to stage s + 1 by P2P (``dist.batch_isend_irecv``)
  inside an autograd Function whose backward is the reverse shift.  The
  ticks' Functions are chained by a token, so every rank runs their
  backwards in the reverse tick order and the P2P messages pair up.  At
  S = 1 nothing is sent.
* The last stage's logits reach every rank by an all-reduce over the pipe
  group whose backward is the identity: the loss is computed replicated on
  every rank, so an all-reduce there would scale the gradients by S.

``sequential_logits`` is the same network unpipelined on one device (the
plain path the tests hold the pipeline to)."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from kgcn_tpu_torch.ops.gconv import gconv
from kgcn_tpu_torch.parallel import mesh as pmesh
from kgcn_tpu_torch.runtime.device import device_from_arg
from kgcn_tpu_torch.runtime.optim import make_optimizer

EMBED = ("embed_w", "embed_b")
BODY = ("body_w", "body_b")
HEAD = ("head_w", "head_b")


@dataclasses.dataclass
class PPConfig:
    stages: int                 # pipe-axis size S
    layers_per_stage: int = 1   # k GraphConv+ReLU blocks per stage
    hidden: int = 64            # uniform activation width H
    microbatches: int = 4       # M
    channels: int = 1           # adjacency channels C
    label_dim: int = 2


def init_pipeline_params(generator: torch.Generator, cfg: PPConfig,
                         feature_dim: int) -> Dict[str, torch.Tensor]:
    """The whole stage-stacked tree (leaves ``[S, ...]``, ``kgcn_tpu``'s
    layout), drawn from ``generator`` on the CPU: Glorot-uniform kernels,
    zero biases."""
    S, k, C, H, L = (cfg.stages, cfg.layers_per_stage, cfg.channels, cfg.hidden,
                     cfg.label_dim)

    def glorot(shape, fan_in, fan_out):
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(shape).uniform_(-lim, lim, generator=generator)

    return {
        "embed_w": glorot((S, feature_dim, H), feature_dim, H),
        "embed_b": torch.zeros(S, H),
        "body_w": glorot((S, k, C, H, H), H, H),
        "body_b": torch.zeros(S, k, C, H),
        "head_w": glorot((S, H, L), H, L),
        "head_b": torch.zeros(S, L),
    }


def stage_params(full: Dict[str, torch.Tensor], s: int, S: int) -> Dict[str, torch.Tensor]:
    """Stage ``s``'s own parameters of a stacked tree (its body; the embed
    at stage 0, the head at stage S−1)."""
    names = BODY + (EMBED if s == 0 else ()) + (HEAD if s == S - 1 else ())
    return {n: full[n][s].clone() for n in names}


def _stage_apply(body_w, body_b, z, adj):
    """k × ``relu(Σ_c A_c (z W_c + b_c))`` on one microbatch: ``z`` ``[mb,
    N, H]``, ``adj`` ``[C, mb, N, N]``."""
    for i in range(body_w.shape[0]):
        z = torch.relu(gconv(adj, z, body_w[i], body_b[i]))
    return z


def _head(p, z, nmask):
    pooled = torch.sum(z * nmask[..., None], dim=1)  # GraphGather
    return pooled @ p["head_w"] + p["head_b"]


def sequential_logits(params: Dict[str, torch.Tensor], x, adj, node_mask, *,
                      cfg: PPConfig) -> torch.Tensor:
    """The same network unpipelined on one device: stage 0's embed, the
    S×k blocks in order, stage S−1's head.  ``params``: the stacked tree;
    ``x`` ``[B, N, F]``, ``adj`` ``[B, C, N, N]`` (``kgcn_tpu``'s layout),
    ``node_mask`` ``[B, N]``."""
    S = cfg.stages
    a = adj.transpose(0, 1).contiguous()
    z = x @ params["embed_w"][0] + params["embed_b"][0]
    for s in range(S):
        z = _stage_apply(params["body_w"][s], params["body_b"][s], z, a)
    return _head({"head_w": params["head_w"][S - 1], "head_b": params["head_b"][S - 1]},
                 z, node_mask)


def masked_xent(logits, labels, pad):
    """(mean cost, cost sum, metrics) of ``kgcn_tpu``'s ``loss_fn``."""
    logp = torch.log_softmax(logits, dim=-1)
    cost = -torch.sum(labels * logp, dim=-1) * pad
    correct = pad * (torch.argmax(logits, -1) == torch.argmax(labels, -1)).to(torch.float32)
    n = torch.sum(pad)
    metrics = {"correct_count": torch.sum(correct), "count": n}
    return torch.sum(cost) / torch.clamp(n, min=1.0), torch.sum(cost), metrics


# ---- the pipe's collectives -------------------------------------------------------
class _Pipe:
    """This rank's place on the pipe: S, s, the group, its neighbours'
    global ranks."""

    def __init__(self, mesh: pmesh.Mesh, axis: str):
        self.S, self.s, self.pg = mesh.axis_size(axis), mesh.coord(axis), mesh.group(axis)
        stride = 1
        names = list(mesh.shape)
        for a in names[names.index(axis) + 1:] if axis in names else []:
            stride *= mesh.shape[a]
        self.next = mesh.rank + stride if self.s + 1 < self.S else None
        self.prev = mesh.rank - stride if self.s > 0 else None


def _p2p(send: Optional[Tuple[torch.Tensor, int]], recv: Optional[Tuple[torch.Tensor, int]]):
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send[0].contiguous(), send[1]))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv[0], recv[1]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _Shift(torch.autograd.Function):
    """One tick's hand-over: ``out`` (this stage's activation, or an empty
    placeholder) to stage s+1 when ``send``, the activation of stage s−1
    into a new ``[shape]`` tensor when ``recv`` (else an empty
    placeholder); ``token`` chains the ticks.  The backward sends the
    received tensor's gradient back to s−1 and receives ``out``'s from
    s+1."""

    @staticmethod
    def forward(ctx, out, token, pipe: _Pipe, send: bool, recv: bool, shape):
        ctx.pipe, ctx.send, ctx.recv, ctx.shape = pipe, send, recv, out.shape
        got = (torch.empty(shape, dtype=out.dtype, device=out.device) if recv
               else out.new_zeros(0))
        _p2p((out, pipe.next) if send else None, (got, pipe.prev) if recv else None)
        return got, token.clone()

    @staticmethod
    def backward(ctx, g_got, g_token):
        pipe = ctx.pipe
        g_out = torch.empty(ctx.shape, dtype=g_got.dtype, device=g_got.device) \
            if ctx.send else torch.zeros(ctx.shape, dtype=g_got.dtype, device=g_got.device)
        _p2p((g_got, pipe.prev) if ctx.recv else None,
             (g_out, pipe.next) if ctx.send else None)
        return g_out, g_token, None, None, None, None


class _PipeSum(torch.autograd.Function):
    """The logits summed over the pipe group; the backward is the identity
    (the loss after it is computed alike on every rank)."""

    @staticmethod
    def forward(ctx, x, pipe: _Pipe):
        return pmesh.all_reduce_sum_(x.clone(), pipe.pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _microbatches(t: torch.Tensor, M: int) -> torch.Tensor:
    G = t.shape[0]
    if G % M:
        raise ValueError(f"batch {G} not divisible by {M} microbatches")
    return t.reshape(M, G // M, *t.shape[1:])


class PPTrainer:
    """GPipe trainer: stage-sharded parameters, microbatched steps, Adam at
    ``learning_rate`` (``kgcn_tpu``'s ``optax.adam``).  ``mesh`` must carry
    a ``pipe`` axis of size ``cfg.stages``."""

    def __init__(self, cfg: PPConfig, mesh: pmesh.Mesh, *, axis: str = "pipe",
                 learning_rate: float = 0.01, device=None):
        if mesh.axis_size(axis) != cfg.stages:
            raise ValueError(f"mesh axis {axis}={mesh.axis_size(axis)} != stages "
                             f"{cfg.stages}")
        self.cfg, self.mesh, self.axis = cfg, mesh, axis
        self.pipe = _Pipe(mesh, axis)
        self.device = device_from_arg(device)
        self.tx = make_optimizer({"learning_rate": float(learning_rate)})

    # ---- state -------------------------------------------------------------
    def init_state(self, feature_dim: int, seed: int = 0,
                   params: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
        """This stage's parameters (of ``params``, a whole stacked tree, or
        one drawn from ``torch.Generator().manual_seed(seed)``), a fresh
        Adam state and step 0."""
        if params is None:
            params = init_pipeline_params(torch.Generator().manual_seed(int(seed)),
                                          self.cfg, feature_dim)
        own = {k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
               for k, v in stage_params(params, self.pipe.s, self.pipe.S).items()}
        return {"params": own, "opt_state": self.tx.init(own), "step": 0}

    # ---- batches -----------------------------------------------------------
    def prepare_batch(self, batch) -> Tuple[torch.Tensor, ...]:
        """A Batch (any backend: the dense adjacency is built when the batch
        does not carry it) as microbatch stacks on this device: x ``[M, mb,
        N, F]``, adj ``[M, C, mb, N, N]``, node mask ``[M, mb, N]``,
        labels ``[M, mb, L]``, pad mask ``[M, mb]``."""
        M = self.cfg.microbatches
        g = batch.graph.to(self.device)
        dense = g.dense_adj if g.dense_adj is not None else g.dense_adjacency(torch.float32)
        C, B, N = dense.shape[0], g.n_graph, g.max_nodes
        x = g.nodes.reshape(B, N, -1).to(torch.float32)
        adj = _microbatches(dense.transpose(0, 1), M).transpose(1, 2).contiguous()
        return (_microbatches(x, M), adj, _microbatches(g.mask_batched(), M),
                _microbatches(batch.labels.to(self.device, torch.float32), M),
                _microbatches(batch.pad_mask.to(self.device), M))

    # ---- the pipeline ---------------------------------------------------------
    def pipeline_logits(self, params, x_mbs, adj_mbs, nmask_mbs) -> torch.Tensor:
        """The GPipe forward → ``[M, mb, L]`` logits, the same on every
        rank (module docstring)."""
        S, M, s = self.pipe.S, self.cfg.microbatches, self.pipe.s
        mb, N = x_mbs.shape[1], x_mbs.shape[2]
        shape = (mb, N, self.cfg.hidden)
        logits = [x_mbs.new_zeros(mb, self.cfg.label_dim) for _ in range(M)]
        # the ticks' chain starts at a parameter (times 0): a backward that
        # asks for the parameters' gradients then runs every tick's hand-over
        token = 0.0 * next(iter(params.values())).reshape(-1)[0]
        buf = None
        for t in range(M + S - 1):
            m = t - s
            out = x_mbs.new_zeros(0)
            if 0 <= m < M:
                z = (x_mbs[m] @ params["embed_w"] + params["embed_b"]) if s == 0 else buf
                out = _stage_apply(params["body_w"], params["body_b"], z, adj_mbs[m])
                if s == S - 1:
                    logits[m] = _head(params, out, nmask_mbs[m])
            send = 0 <= m < M and s + 1 < S
            recv = s > 0 and 0 <= t - (s - 1) < M
            if S > 1:
                buf, token = _Shift.apply(out, token, self.pipe, send, recv, shape)
        acc = torch.stack(logits)
        if S > 1:
            acc = acc + 0.0 * token  # every tick's backward runs (the chain's end)
        return _PipeSum.apply(acc, self.pipe)

    def loss_and_grads(self, params, arrays):
        """(mean cost, cost sum, metrics, this stage's gradients) of one
        batch's microbatch stacks (``prepare_batch``'s)."""
        x, adj, nmask, labels, pad = arrays
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits = self.pipeline_logits(leaves, x, adj, nmask)
        loss, cost_sum, metrics = masked_xent(logits, labels, pad)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        return loss.detach(), cost_sum.detach(), metrics, dict(zip(names, grads))

    def train_step(self, state, batch):
        """One Adam step → (state, cost sum, metrics)."""
        _, cost_sum, metrics, grads = self.loss_and_grads(state["params"],
                                                          self.prepare_batch(batch))
        with torch.no_grad():
            updates, opt = self.tx.update(grads, state["opt_state"], state["params"])
            params = {k: v + updates[k] for k, v in state["params"].items()}
        return ({"params": params, "opt_state": opt, "step": state["step"] + 1},
                cost_sum, {k: v.detach() for k, v in metrics.items()})

    @torch.no_grad()
    def logits(self, state, batch) -> torch.Tensor:
        """Full-batch inference through the pipeline → ``[B, L]``."""
        x, adj, nmask, _, _ = self.prepare_batch(batch)
        return self.pipeline_logits(state["params"], x, adj, nmask).reshape(
            -1, self.cfg.label_dim)
