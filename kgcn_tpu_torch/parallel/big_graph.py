"""Sharded whole-graph KG training — the counterpart of
``kgcn_tpu/parallel/big_graph.py``: one giant multi-relation graph whose
node-embedding table no longer fits one device.

* the table lives sharded: each rank holds ``[V/D, dim]`` rows (V padded
  to a multiple of D, the padding rows masked to 0);
* the ``gcn`` and ``gin`` encoders aggregate over the relation channels
  through the edge-partitioned halo (``parallel/edge_partition.py``,
  ``ring`` or ``allgather``: one exchange a hop for all channels);
* DistMult scores each rank's shard of the triples against the final
  embeddings all-gathered once a step; the gather's backward (a
  reduce-scatter) routes the score gradients to the rows' owners;
* the replicated parameters (DistMult's relations, the convolutions'
  kernels, biases and ε) get their gradients summed over the ranks in one
  all-reduce with the step's loss, correct count and count; the embedding
  rows keep theirs.  The optimizer is the port's (``runtime/optim.py``,
  the config's chain): an elementwise one (Adam, SGD, …) updates each
  rank's rows where they are; one that needs global norms (a global-norm
  clip, LAMB) sees the whole table, gathered for the update and sliced
  back (``tx_shard_safe`` False).

The loss is ``KGLinkPredictor``'s (``models/kg.py``): ``softplus(s_neg −
s_pos + γ)`` summed over the valid triples, and the parameters carry its
names (``embed.embedding``, ``conv1.kernel``, …, ``distmult.kernel``), so
``to_flax_variables``/``from_flax_variables`` exchange weights with the
single-device model and ``convert.py``.  ``save``/``restore`` write and
read a sharded checkpoint through ``torch.distributed.checkpoint``: each
rank writes its own rows and no rank gathers the table; a checkpoint
restores at the world size that wrote it.  ``restore`` also reads
``kgcn_tpu``'s own ``model.big_graph.ckpt`` (orbax, through
``runtime/orbax.py``: ``params.embed`` ``[V_pad, dim]``, ``theta``, the
optax state and ``step``) at any world size: each rank reads the chunks
that hold its rows of the first V, padded to this world's layout."""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from kgcn_tpu_torch.nn.layers import per_channel_glorot_
from kgcn_tpu_torch.parallel import mesh as pmesh
from kgcn_tpu_torch.parallel.edge_partition import (HALOS, DevicePartition,
                                                    all_gather_blocks, partition_edges)
from kgcn_tpu_torch.runtime.device import device_from_arg

EMBED = "embed.embedding"


def _map_embed(tree, fn):
    """``tree`` (params or an optimizer state: nested dicts) with each
    tensor under the key ``EMBED`` replaced by ``fn`` of it."""
    if isinstance(tree, dict):
        return {k: fn(v) if k == EMBED and isinstance(v, torch.Tensor)
                else _map_embed(v, fn) for k, v in tree.items()}
    return tree


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


class BigGraphKGTrainer:
    """Edge-partitioned trainer for one giant multi-relation graph over the
    ranks of the process group (a world of one without one).

    num_nodes: true entity count V (padded to a multiple of D).
    channels: relation channel count C.
    embedding_dim: entity embedding width.
    encoder: 'embedding' (DistMult alone), 'gcn' or 'gin'.
    num_layers: convolutions of the gcn/gin encoders (2 in the reference).
    gamma: margin of the preference loss.
    strategy: 'ring' or 'allgather' halo.
    tx: the optimizer (``runtime/optim.Transform``; Adam at
        ``learning_rate`` by default); ``tx_shard_safe``: whether it is
        elementwise (see the module docstring).
    device: this rank's device (None: its GPU, "cpu": the CPU)."""

    def __init__(self, *, num_nodes: int, channels: int, embedding_dim: int,
                 encoder: str = "gcn", num_layers: int = 2, gamma: float = 0.1,
                 learning_rate: float = 0.01, strategy: str = "ring",
                 node_mask: Optional[np.ndarray] = None, tx=None,
                 tx_shard_safe: bool = True, device=None):
        from kgcn_tpu_torch.runtime.optim import make_optimizer

        if encoder not in ("embedding", "gcn", "gin"):
            raise ValueError(f"unknown encoder {encoder!r}")
        if strategy not in HALOS:
            raise ValueError(f"unknown halo strategy {strategy!r}")
        self.device = device_from_arg(device)
        self.D = pmesh.world_size()
        self.rank = pmesh.rank()
        self.num_nodes = int(num_nodes)
        self.v_pad = -(-self.num_nodes // self.D) * self.D
        self.v_loc = self.v_pad // self.D
        self.channels = int(channels)
        self.dim = int(embedding_dim)
        self.encoder = encoder
        self.num_layers = int(num_layers) if encoder != "embedding" else 0
        self.gamma = float(gamma)
        self.strategy = strategy
        self.tx = tx if tx is not None else make_optimizer({"learning_rate": learning_rate})
        self.tx_shard_safe = bool(tx_shard_safe)
        mask = np.ones(self.v_pad, np.float32)
        if node_mask is not None:
            node_mask = np.asarray(node_mask, np.float32)
            n = min(len(node_mask), self.v_pad)
            mask[:n] = node_mask[:n]
        mask[self.num_nodes:] = 0.0
        self._mask = torch.from_numpy(self._rows(mask).copy()).to(self.device)
        self._part: Optional[DevicePartition] = None

    def _rows(self, full):
        """This rank's rows of a ``[V_pad, ...]`` array or tensor."""
        return full[self.rank * self.v_loc:(self.rank + 1) * self.v_loc]

    # ---- the graph ----------------------------------------------------------
    def partition_graph(self, senders, receivers, weights) -> None:
        """Partition the ``[C, E]`` COO relation-typed adjacency (receiver =
        row, sender = column) and move this rank's groups to its device;
        channels share one padded budget.  A new partition replaces what
        the last one built."""
        senders = np.asarray(senders)
        if senders.ndim == 1:
            senders = senders[None]
            receivers = np.asarray(receivers)[None]
            weights = np.asarray(weights)[None]
        C = senders.shape[0]
        parts = [partition_edges(senders[c], receivers[c], weights[c], self.v_pad, self.D)
                 for c in range(C)]
        E = max(p.senders_local.shape[-1] for p in parts)

        def mine(arrs, dtype):
            out = np.zeros((C, self.D, E), dtype)
            for c, a in enumerate(arrs):
                out[c, :, :a.shape[-1]] = a[self.rank]
            return out

        self._part = DevicePartition(mine([p.senders_local for p in parts], np.int32),
                                     mine([p.receivers_local for p in parts], np.int32),
                                     mine([p.weights for p in parts], np.float32),
                                     self.v_loc, self.device)

    def _need_graph(self):
        if self._part is None:
            raise RuntimeError("call partition_graph first")

    # ---- parameters ---------------------------------------------------------
    def _layer_names(self, i):
        pre = f"conv{i + 1}"
        return ((f"{pre}.kernel", f"{pre}.bias") if self.encoder == "gcn"
                else (f"{pre}.epsilon",))

    def init_params(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Parameters drawn from ``torch.Generator().manual_seed(seed)`` on
        the CPU (the same on every rank and at every world size): the table
        from N(0, 0.05²), DistMult's relations and the gcn kernels
        Glorot-uniform per channel, biases and ε 0; this rank's rows of the
        table."""
        gen = torch.Generator().manual_seed(int(seed))
        embed = torch.randn(self.v_pad, self.dim, generator=gen) * 0.05
        params = {EMBED: self._rows(embed).clone(),
                  "distmult.kernel": per_channel_glorot_(
                      torch.empty(self.channels, self.dim), gen)}
        for i in range(self.num_layers):
            if self.encoder == "gcn":
                k, b = self._layer_names(i)
                params[k] = per_channel_glorot_(
                    torch.empty(self.channels, self.dim, self.dim), gen)
                params[b] = torch.zeros(self.channels, self.dim)
            else:
                params[self._layer_names(i)[0]] = torch.zeros(self.channels)
        return {k: v.to(self.device) for k, v in params.items()}

    def from_flax_variables(self, variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Parameters from a single-device ``KGLinkPredictor``'s tree in the
        port's layout (``{"params": {name: tensor}}``, e.g. a checkpoint's,
        or ``convert.params_from_jax`` of ``kgcn_tpu``'s): its table padded
        and this rank's rows taken."""
        if self.num_layers not in (0, 2):
            raise ValueError(f"KGLinkPredictor has exactly 2 conv layers; cannot import "
                             f"into a {self.num_layers}-layer trainer")
        p = variables["params"]
        src = torch.as_tensor(np.asarray(p[EMBED]), dtype=torch.float32)
        embed = torch.zeros(self.v_pad, self.dim)
        embed[:src.shape[0]] = src
        params = {EMBED: self._rows(embed).clone()}
        names = ["distmult.kernel"] + [n for i in range(self.num_layers)
                                       for n in self._layer_names(i)]
        for n in names:
            params[n] = torch.as_tensor(np.asarray(p[n]), dtype=torch.float32).clone()
        return {k: v.to(self.device) for k, v in params.items()}

    def to_flax_variables(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The single-device ``KGLinkPredictor`` tree (``{"params": {name:
        CPU tensor}}``, padding rows stripped): the table is gathered, so a
        checkpoint in the single-device format can be written."""
        params = state["params"]
        out = {k: v.detach().cpu().clone() for k, v in params.items() if k != EMBED}
        table = all_gather_blocks(params[EMBED].detach()).reshape(self.v_pad, self.dim)
        out[EMBED] = table[:self.num_nodes].cpu().clone()
        return {"params": out}

    def init_state(self, seed: int = 0, params=None) -> Dict[str, Any]:
        params = params if params is not None else self.init_params(seed)
        return {"params": params, "opt_state": self.tx.init(params), "step": 0}

    # ---- forward ------------------------------------------------------------
    def _encode_local(self, params):
        x = params[EMBED] * self._mask[:, None]
        halo = HALOS[self.strategy]
        for i in range(self.num_layers):
            if self.encoder == "gcn":
                k, b = self._layer_names(i)
                hw = torch.einsum("vf,cfo->cvo", x, params[k]) + params[b][:, None, :]
                agg = halo(hw, self._part)
            else:
                eps = params[self._layer_names(i)[0]]
                agg = torch.sum(eps) * x + halo(x, self._part)
            x = torch.tanh(agg)
        return x

    def _local_loss(self, params, ll, lv):
        """(loss sum, correct count, count) of this rank's triples."""
        z = all_gather_blocks(self._encode_local(params)).reshape(self.v_pad, self.dim)
        dm = params["distmult.kernel"]
        s1 = torch.sum(z[ll[:, 0]] * z[ll[:, 2]] * dm[ll[:, 1]], dim=-1)
        s2 = torch.sum(z[ll[:, 3]] * z[ll[:, 5]] * dm[ll[:, 4]], dim=-1)
        score = s2 - s1 + self.gamma
        cost = torch.logaddexp(score, torch.zeros_like(score)) * lv
        correct = torch.sum((s1 > s2).to(torch.float32) * lv)
        return torch.sum(cost), correct, torch.sum(lv)

    def _sharded_grads(self, params, ll, lv):
        """(gradients, stats ``[loss, correct, count]`` summed over the
        ranks): the replicated parameters' gradients summed with the stats
        in one all-reduce, the table's rows' left local."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, correct, count = self._local_loss(leaves, ll, lv)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(names, grads)}
        rep = [k for k in names if k != EMBED]
        parts = [grads[k] for k in rep] + [torch.stack([loss, correct, count]).detach()]
        flat = pmesh.all_reduce_sum_(torch.cat([t.reshape(-1) for t in parts]))
        at = 0
        for k in rep:
            n = grads[k].numel()
            grads[k] = flat[at:at + n].view(grads[k].shape)
            at += n
        return grads, flat[at:at + 3]

    def _gather_rows(self, t):
        return all_gather_blocks(t.detach()).reshape(self.v_pad, *t.shape[1:])

    def _update(self, params, opt_state, grads):
        """(new params, new optimizer state) from the scaled gradients."""
        if self.tx_shard_safe or self.D == 1:
            updates, opt_state = self.tx.update(grads, opt_state, params)
            return {k: params[k] + updates[k] for k in params}, opt_state
        # a global-norm transform: the whole table for the update
        full_g = dict(grads, **{EMBED: self._gather_rows(grads[EMBED])})
        full_p = dict(params, **{EMBED: self._gather_rows(params[EMBED])})
        full_opt = _map_embed(opt_state, self._gather_rows)
        updates, opt_state = self.tx.update(full_g, full_opt, full_p)
        updates[EMBED] = self._rows(updates[EMBED])
        return ({k: params[k] + updates[k] for k in params},
                _map_embed(opt_state, lambda t: self._rows(t).clone()))

    def _shard_labels(self, label_list, width: int = 6):
        """This rank's shard of a ``[L, width]`` triple list padded to D
        equal shards → (``[L/D, width]`` int64, ``[L/D]`` validity, L)."""
        ll = np.asarray(label_list, np.int64)[:, :width]
        n = len(ll)
        per = -(-n // self.D) if n else 1
        out = np.zeros((per * self.D, width), np.int64)
        out[:n] = ll
        lv = (np.arange(per * self.D) < n).astype(np.float32)
        return (torch.from_numpy(self._rows_of(out, per)).to(self.device),
                torch.from_numpy(self._rows_of(lv, per)).to(self.device), n)

    def _rows_of(self, a, per):
        return np.ascontiguousarray(a[self.rank * per:(self.rank + 1) * per])

    # ---- public API ---------------------------------------------------------
    def _step(self, state, ll, lv, inv_n):
        grads, stats = self._sharded_grads(state["params"], ll, lv)
        with torch.no_grad():
            grads = {k: g * inv_n for k, g in grads.items()}
            params, opt = self._update(state["params"], state["opt_state"], grads)
        return {"params": params, "opt_state": opt, "step": state["step"] + 1}, stats

    def train_step(self, state, label_list):
        """One step on a ``[L, 6]`` (h, r, t, h', r', t') list → (state,
        {'cost': mean loss, 'accuracy': rank accuracy})."""
        self._need_graph()
        ll, lv, n = self._shard_labels(label_list)
        state, stats = self._step(state, ll, lv, 1.0 / max(n, 1))
        loss, correct, count = stats.cpu().numpy()
        return state, {"cost": float(loss) / max(n, 1),
                       "accuracy": float(correct) / max(float(count), 1.0)}

    def gradients(self, state, label_list) -> Dict[str, np.ndarray]:
        """The mean-loss gradients the optimizer takes ({name: NumPy}; the
        table's: this rank's rows)."""
        self._need_graph()
        ll, lv, n = self._shard_labels(label_list)
        grads, _ = self._sharded_grads(state["params"], ll, lv)
        return {k: g.detach().cpu().numpy() / max(n, 1) for k, g in grads.items()}

    @torch.no_grad()
    def evaluate(self, state, label_list) -> Dict[str, Any]:
        self._need_graph()
        ll, lv, n = self._shard_labels(label_list)
        stats = torch.stack(self._local_loss(state["params"], ll, lv))
        loss, correct, count = pmesh.all_reduce_sum_(stats).cpu().numpy()
        return {"cost": float(loss) / max(n, 1),
                "accuracy": float(correct) / max(float(count), 1.0), "num": n}

    @torch.no_grad()
    def node_embeddings(self, state) -> np.ndarray:
        """The gathered ``[V, dim]`` final embeddings."""
        self._need_graph()
        z = all_gather_blocks(self._encode_local(state["params"]))
        return z.reshape(self.v_pad, self.dim)[:self.num_nodes].cpu().numpy()

    def _device_negatives(self, gen, ll3, pair_mode: str):
        """Corrupted copies of the positives, drawn on the device from
        ``gen`` (kgcn/feed.py:33-86: one random side for 'both')."""
        L = ll3.shape[0]
        neg = torch.randint(0, self.num_nodes, (L,), generator=gen, device=ll3.device)
        h, r, t = ll3[:, 0], ll3[:, 1], ll3[:, 2]
        if pair_mode == "right":
            h_n, t_n = h, neg
        elif pair_mode == "left":
            h_n, t_n = neg, t
        else:
            side = torch.rand(L, generator=gen, device=ll3.device) < 0.5
            h_n = torch.where(side, h, neg)
            t_n = torch.where(side, neg, t)
        return torch.stack([h, r, t, h_n, r, t_n], dim=1)

    def fit_resident(self, state, label_list, *, epochs: int, pair_mode: str = "both",
                     seed: int = 0):
        """Every epoch on the device: this rank's positives stay there, each
        epoch draws fresh negatives from a generator seeded from (seed,
        rank, epoch) and takes one step on the whole list; the history is
        read back once, at the end.  An optimizer that needs global norms
        takes the per-step path (``fit``), as in ``kgcn_tpu``."""
        self._need_graph()
        if not self.tx_shard_safe:
            print("[big-graph] optimizer needs global norms — using the per-step "
                  "path instead of the one-dispatch resident run")
            return self.fit(state, label_list, epochs=epochs, pair_mode=pair_mode,
                            seed=seed)
        ll3, lv, n = self._shard_labels(label_list, width=3)
        inv_n = 1.0 / max(n, 1)
        stats = torch.zeros(epochs, 3, device=self.device)
        gen = torch.Generator(device=self.device)
        for e in range(epochs):
            gen.manual_seed(((int(seed) * 1_000_003 + e) * 65_537 + self.rank) % (1 << 62))
            ll6 = self._device_negatives(gen, ll3, pair_mode)
            state, st = self._step(state, ll6, lv, inv_n)
            stats[e] = st
        stats = stats.cpu().numpy()
        history = [{"epoch": e, "train_cost": float(stats[e, 0]) * inv_n,
                    "train_accuracy": float(stats[e, 1]) / max(float(stats[e, 2]), 1.0)}
                   for e in range(epochs)]
        return state, history

    def fit(self, state, label_list, *, epochs: int, pair_mode: str = "both",
            seed: int = 0, validation_list=None, label_batch_size: Optional[int] = None,
            log_every: int = 0):
        """Epochs of steps on slices of ``label_batch_size`` triples (default
        one step on the whole list; the last slice wrap-padded), negatives
        resampled every epoch from the host ``RandomState(seed)`` (the same
        draws on every rank), as ``kgcn_tpu``'s ``fit``."""
        from kgcn_tpu_torch.models.kg import sample_negatives

        rng = np.random.RandomState(seed)
        all_nodes = np.arange(self.num_nodes, dtype=np.int32)
        ll = np.asarray(label_list, np.int32)
        if ll.shape[1] == 3:
            ll = np.concatenate([ll, ll], axis=1)
        if validation_list is not None:
            validation_list = np.asarray(validation_list, np.int32)
            if validation_list.shape[1] == 3:
                validation_list = np.concatenate([validation_list, validation_list], axis=1)
        L = int(label_batch_size) if label_batch_size else len(ll)
        history = []
        for epoch in range(epochs):
            ep = sample_negatives(ll, all_nodes, rng, pair_mode)
            order = np.arange(len(ep))
            rng.shuffle(order)
            costs, corrects, counts = [], [], []
            for start in range(0, len(ep), L):
                idx = order[start:start + L]
                if len(idx) < L:
                    idx = np.resize(idx, L)
                state, tr = self.train_step(state, ep[idx])
                costs.append(tr["cost"])
                corrects.append(tr["accuracy"] * L)
                counts.append(L)
            rec = {"epoch": epoch, "train_cost": float(np.mean(costs)),
                   "train_accuracy": float(np.sum(corrects) / np.sum(counts))}
            if validation_list is not None:
                va = self.evaluate(state, validation_list)
                rec.update({f"valid_{k}": v for k, v in va.items() if k != "num"})
            history.append(rec)
            if log_every and epoch % log_every == 0:
                print(f"[big_graph] epoch {epoch}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in rec.items() if k != "epoch"))
        return state, history

    # ---- the sharded checkpoint -----------------------------------------------
    def _checkpoint_tree(self, state, wrap):
        return {"params": _map_embed(state["params"], wrap),
                "opt_state": _map_embed(state["opt_state"], wrap),
                "step": torch.tensor(int(state["step"]), dtype=torch.int64)}

    def _wrapper(self):
        """Tensor → what the checkpoint stores for a sharded leaf: a DTensor
        sharded by rows over the group, or the tensor in a world of one
        without one."""
        if not pmesh.initialized():
            return lambda t: t
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Shard

        mesh = init_device_mesh(self.device.type, (self.D,))
        return lambda t: DTensor.from_local(t.contiguous(), mesh, [Shard(0)],
                                            run_check=False)

    def save(self, path: str, state) -> str:
        """Write the sharded checkpoint directory ``path``
        (``torch.distributed.checkpoint``): the table's rows and their
        optimizer moments by their owners, the rest once."""
        import torch.distributed.checkpoint as dcp

        dcp.save(self._checkpoint_tree(state, self._wrapper()), checkpoint_id=path,
                 no_dist=not pmesh.initialized())
        return path

    def restore(self, path: str, state):
        """The state saved at ``path`` (the port's checkpoint, written at
        this world size, or ``kgcn_tpu``'s orbax one, at any), laid onto
        ``state``'s layout."""
        from kgcn_tpu_torch.runtime import orbax

        if orbax.is_orbax_dir(path):
            return self._restore_orbax(path, state)
        import torch.distributed.checkpoint as dcp

        tree = self._checkpoint_tree(_clone(state), self._wrapper())
        dcp.load(tree, checkpoint_id=path, no_dist=not pmesh.initialized())

        def local(t):
            return t.to_local() if hasattr(t, "to_local") else t

        return {"params": _map_embed(tree["params"], local),
                "opt_state": _map_embed(tree["opt_state"], local),
                "step": int(tree["step"])}


    def _theta_names(self) -> Dict[str, str]:
        """``kgcn_tpu``'s ``theta`` leaves → the port's names."""
        names = {"distmult": "distmult.kernel"}
        for i in range(self.num_layers):
            port = self._layer_names(i)
            jax = (f"w{i}", f"b{i}") if self.encoder == "gcn" else (f"eps{i}",)
            names.update(zip(jax, port))
        return names

    def _restore_orbax(self, path: str, state):
        """``kgcn_tpu``'s orbax big-graph checkpoint: this rank's rows of the
        table and of its moments (only the chunks that hold them are read),
        the replicated leaves whole, the optax state laid onto the port's
        optimizer (``convert.opt_state_from_jax``)."""
        from kgcn_tpu_torch.convert import opt_state_from_jax
        from kgcn_tpu_torch.runtime import orbax
        from kgcn_tpu_torch.runtime.train import _opt_to

        ck = orbax.Checkpoint(path)
        lo = self.rank * self.v_loc
        hi = min(lo + self.v_loc, self.num_nodes)
        theta = self._theta_names()

        def like_params(prefix: str) -> Dict[str, np.ndarray]:
            rows = ck.array(f"{prefix}.embed").read((lo, hi))
            if rows.shape[1:] != (self.dim,):
                raise ValueError(f"{path}: embedding width {rows.shape[1:]}, the trainer's "
                                 f"{self.dim}")
            table = np.zeros((self.v_loc, self.dim), np.float32)
            table[:len(rows)] = rows
            out = {EMBED: table}
            for jax_name, port in theta.items():
                out[port] = np.asarray(ck.array(f"{prefix}.theta.{jax_name}").read())
            return out

        stored = {tuple(k) for k, _ in ck.leaves()}
        want = {("params", "theta", n) for n in theta} | {("params", "embed")}
        if not want <= stored or any(k[:2] == ("params", "theta") and k[2] not in theta
                                     for k in stored):
            raise ValueError(
                f"{path}: its leaves {sorted('.'.join(k) for k in stored if k[0] == 'params')}"
                f" do not fit a {self.encoder} trainer with {self.num_layers} layers")
        params = {k: torch.from_numpy(v) for k, v in like_params("params").items()}
        raw: Dict[str, Any] = {}  # the optax state, as flax_msgpack would nest it
        for keys, value in ck.leaves():
            if keys[0] != "opt_state":
                continue
            cut = next((i for i, k in enumerate(keys) if k in ("embed", "theta")), len(keys))
            node = raw
            for k in keys[1:cut - 1]:
                node = node.setdefault(k, {})
            if cut < len(keys):  # a leaf of a tree shaped like the parameters
                if keys[cut - 1] not in node:
                    node[keys[cut - 1]] = like_params(".".join(keys[:cut]))
            else:
                node[keys[-1]] = (None if value.get("skip_deserialize")
                                  else ck.array(".".join(keys)).read())
        opt = opt_state_from_jax(raw, self.tx.init(params))
        step = int(np.asarray(ck.array("step").read()).reshape(-1)[0])
        return {"params": {k: v.to(self.device) for k, v in params.items()},
                "opt_state": _opt_to(opt, self.device), "step": step}


def make_tx(config):
    from kgcn_tpu_torch.runtime.optim import make_optimizer

    return make_optimizer({"learning_rate": 0.01, **config})


def tx_shard_safe(config) -> bool:
    """Whether the configured chain is elementwise (no global-norm clip, no
    LAMB), so each rank may update its own rows alone."""
    if config.get("gradient_clip"):
        return False
    return str(config.get("optimizer", "adam")).lower() != "lamb"


def from_kg_dataset(ds, info, config, device=None) -> BigGraphKGTrainer:
    """A trainer over a loaded KG dataset (``data/dataset.load_jbl``'s, the
    one ``KGBatcher`` reads), its graph partitioned: the ``[C, E]`` COO
    adjacency straight from ``ds.adjs[0]``."""
    adj = ds.adjs[0]
    C = len(adj)
    E = max((len(ch[2]) for ch in adj), default=1) or 1
    senders = np.zeros((C, E), np.int64)
    receivers = np.zeros((C, E), np.int64)
    weights = np.zeros((C, E), np.float32)
    for c, (row, col, val) in enumerate(adj):
        k = len(val)
        receivers[c, :k] = row
        senders[c, :k] = col
        weights[c, :k] = val
    trainer = BigGraphKGTrainer(
        num_nodes=int(info.all_node_num), channels=int(info.adj_channel_num),
        embedding_dim=int(config.get("embedding_dim", 10)),
        encoder=config.get("kg_encoder", "embedding"),
        num_layers=int(config.get("kg_layers", 2)),
        gamma=float(config.get("kg_gamma", 0.1)),
        learning_rate=float(config.get("learning_rate", 0.01)),
        strategy=config.get("halo_strategy", "ring"),
        tx=make_tx(config), tx_shard_safe=tx_shard_safe(config), device=device)
    trainer.partition_graph(senders, receivers, weights)
    return trainer
