"""Data-parallel training over the ranks — the counterpart of
``kgcn_tpu/parallel/dp.py`` (``shard_map`` + ``psum`` there).

Each rank holds the whole model (parameters replicated: every rank draws
them from the same seed or restores the same file) and trains on its own
rows of each global step: rank r takes rows ``r·B:(r+1)·B`` of the step's
``D·B`` examples, as device r does under ``kgcn_tpu``'s ``ShardedBatcher``
and ``ShardedResidentBatcher`` (a trailing rank's rows may be padding).
After the backward, ONE all-reduce of one flat float32 buffer carries the
step's gradients and BN statistics (then divided by D: their mean, as
``pmean`` gives) and its cost sum and metrics (their sum, ``psum``), so
every rank applies the same update.  ``DistributedDataParallel`` is not
used: it broadcasts buffers from rank 0, where ``kgcn_tpu`` averages the BN
statistics.  Dropout draws from the rank's generator, seeded from (seed,
rank); rank 0's is the single-device trainer's.  A checkpoint carries every
rank's generator (``rng_ranks``), so a resumed run is the continued one; at
another data width each rank is re-seeded from (seed, rank, saved step)
(``resume_seed``).

``ShardedBatcher(mode="shard")`` is ``kgcn_tpu``'s per-host ingest
(``GlobalShardedBatcher(mode="shard")``, one device a process): each rank
holds only its slice of the data (``data/dataset.shard_for_host``).

On a mesh with a ``model`` or ``pipe`` axis the all-reduce runs over the
``data`` group and the ranks of one model group are replicas (the same
rows, the same dropout), as ``kgcn_tpu``'s ``cli.main`` runs such a mesh.

The steps run eagerly (the resident runner without its CUDA graph, or the
streaming loop): a captured step with the all-reduce inside is ROADMAP.md
A.2.  Rank 0 writes the run's checkpoints; the others wait at a barrier.
``evaluate`` gathers the ranks' predictions and flattens them in
``kgcn_tpu``'s order (per step, rank-major, padding dropped)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kgcn_tpu_torch.parallel import mesh as pmesh
from kgcn_tpu_torch.runtime import checkpoint as ckpt
from kgcn_tpu_torch.runtime.metrics import aggregate_metrics
from kgcn_tpu_torch.runtime.train import Trainer, TrainState

RANK_SEED_STRIDE = 1_000_003  # rank r's dropout generator: seed + r·stride


def resume_seed(seed: int, rank: int, step: int) -> int:
    """The dropout seed of data rank ``rank`` resuming, at ``step``, a
    checkpoint written at another data width (ROADMAP.md C.5)."""
    return int(np.random.SeedSequence([int(seed), int(rank), int(step)]).generate_state(1)[0])


def _counts(n: int, bs: int):
    return [min(bs, n - s) for s in range(0, n, bs)]


class ShardedBatcher:
    """Rank ``rank``'s view of a streaming ``Batcher``.

    ``mode="full"``: the batcher holds the whole dataset; each global step
    of ``num_shards · batch_size`` examples (its epoch order) yields this
    rank's rows as one local batch.  ``mode="shard"``: the batcher holds
    only this rank's rows (``shard_for_host``, its own permutation seed) and
    ``global_num`` counts the whole dataset; step s yields the s-th
    ``batch_size`` rows of the local permutation, and every rank yields
    ⌈⌈N/D⌉/B⌉ steps, a shorter slice padding its last ones with
    all-invalid batches (``kgcn_tpu``'s ``GlobalShardedBatcher``,
    ``kgcn_tpu/parallel/dp.py:74-206``)."""

    def __init__(self, batcher, num_shards: int, rank: Optional[int] = None, *,
                 mode: str = "full", global_num: Optional[int] = None):
        if mode not in ("full", "shard"):
            raise ValueError(f"mode {mode!r}: 'full' or 'shard'")
        self.b = batcher
        self.num_shards = int(num_shards)
        self.rank = pmesh.rank() if rank is None else int(rank)
        self.mode = mode
        self.ds = batcher.ds
        self.global_batch = batcher.batch_size * self.num_shards
        self._n_global = int(batcher.ds.num if global_num is None else global_num)

    @property
    def batch_size(self) -> int:
        return self.global_batch

    @property
    def valid_per_epoch(self) -> int:
        return self._n_global

    def batch_valid_counts(self):
        return _counts(self._n_global, self.global_batch)

    def rows(self, idx: np.ndarray) -> np.ndarray:
        per = self.b.batch_size
        return np.asarray(idx)[self.rank * per:(self.rank + 1) * per]

    def make_batch(self, idx: np.ndarray):
        self.last_valid = len(idx)
        return self.b.make_batch(self.rows(idx))

    def _local_batch(self, rows: np.ndarray):
        """A shard-mode step's batch; for no rows, graph 0's with every row
        invalid (``kgcn_tpu``'s ``_padded_local_batch``)."""
        if len(rows):
            return self.b.make_batch(rows)
        batch = self.b.make_batch(np.zeros(1, np.int64))
        return batch.replace(pad_mask=torch.zeros_like(batch.pad_mask))

    def _steps_shard(self) -> int:
        base, extra = divmod(self._n_global, self.num_shards)
        return -(-(base + (1 if extra else 0)) // self.b.batch_size)

    def batches(self, shuffle: bool = True, epoch=None):
        idx = self.b.epoch_indices(shuffle, epoch=epoch)
        if self.mode == "shard":
            B = self.b.batch_size
            for s in range(self._steps_shard()):
                yield self._local_batch(idx[s * B:(s + 1) * B])
            return
        for start in range(0, len(idx), self.global_batch):
            yield self.make_batch(idx[start:start + self.global_batch])


class ShardedResidentBatcher:
    """Rank ``rank``'s view of a ``ResidentBatcher``: the epoch schedule is
    ``kgcn_tpu``'s ``[S, D, B]`` and this rank trains column ``rank`` of
    it, gathered on its device from the resident dataset."""

    def __init__(self, rb, num_shards: int, rank: Optional[int] = None):
        self.rb = rb
        self.num_shards = int(num_shards)
        self.rank = pmesh.rank() if rank is None else int(rank)
        self.ds = rb.ds
        self.device_data = rb.device_data
        self.global_batch = rb.batch_size * self.num_shards

    @property
    def batch_size(self) -> int:
        return self.global_batch

    @property
    def valid_per_epoch(self) -> int:
        return self.ds.num

    def batch_valid_counts(self):
        return _counts(self.ds.num, self.global_batch)

    def _columns(self, idx: np.ndarray):
        D, B = self.num_shards, self.rb.batch_size
        S = max(-(-len(idx) // (D * B)), 1)
        sched = np.zeros(S * D * B, np.int32)
        sched[:len(idx)] = idx
        valid = (np.arange(S * D * B) < len(idx)).astype(np.float32)
        return (np.ascontiguousarray(sched.reshape(S, D, B)[:, self.rank]),
                np.ascontiguousarray(valid.reshape(S, D, B)[:, self.rank]))

    def epoch_schedule(self, shuffle: bool = True, epoch=None):
        """This rank's ``[S, B]`` schedule and validity of one epoch."""
        return self._columns(self.rb.epoch_indices(shuffle, epoch=epoch))

    def make_batch(self, idx: np.ndarray):
        self.last_valid = len(idx)
        sched, valid = self._columns(np.asarray(idx))
        return self.rb._gather(sched[0], valid[0])

    def batches(self, shuffle: bool = True, epoch=None):
        sched, valid = self.epoch_schedule(shuffle, epoch=epoch)
        for s in range(sched.shape[0]):
            yield self.rb._gather(sched[s], valid[s])


def _flat_sum(tensors, device, group=None) -> torch.Tensor:
    """The tensors' float32 values in one buffer, summed over the ranks of
    ``group``."""
    flat = torch.cat([t.detach().reshape(-1).to(device, torch.float32) for t in tensors])
    return pmesh.all_reduce_sum_(flat, group)


def _split(flat: torch.Tensor, like):
    out, at = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[at:at + n].view(t.shape).to(t.dtype))
        at += n
    return out


class DPTrainer(Trainer):
    """The port's ``Trainer`` with its steps reduced across the ranks of
    ``mesh`` (``parallel/mesh.make_mesh``)."""

    def __init__(self, model, config, info=None, device=None, tx=None, *,
                 mesh: pmesh.Mesh):
        super().__init__(model, config, info, device=device, tx=tx, capture=False)
        self.mesh = mesh
        self.world = mesh.size
        self.group = mesh.group("data")

    def _generator(self, seed: int) -> torch.Generator:
        return super()._generator(int(seed) + RANK_SEED_STRIDE * self.mesh.coord("data"))

    def reduce_step(self, grads, batch_stats, cost_sum, metrics):
        """One all-reduce: gradients and BN statistics averaged, the cost
        sum and metrics summed."""
        names = list(grads)
        stat_names = list(batch_stats)
        metric_names = list(metrics)
        mean_part = [grads[k] for k in names] + [batch_stats[k] for k in stat_names]
        sum_part = [cost_sum] + [metrics[k] for k in metric_names]
        flat = _flat_sum(mean_part + sum_part, self.device, self.group)
        n_mean = sum(t.numel() for t in mean_part)
        flat[:n_mean].div_(self.world)
        values = _split(flat, mean_part + sum_part)
        new_grads = dict(zip(names, values[:len(names)]))
        with torch.no_grad():
            for k, v in zip(stat_names, values[len(names):len(mean_part)]):
                batch_stats[k].copy_(v)
        sums = values[len(mean_part):]
        return new_grads, sums[0], dict(zip(metric_names, sums[1:]))

    def state_tree(self, state: TrainState, epoch: int, best_cost: float) -> ckpt.Tree:
        """The training tree with ``rng_ranks``: every data rank's generator
        state in rank order (gathered: every rank takes part)."""
        tree = super().state_tree(state, epoch, best_cost)
        every = pmesh.host_view(tree["rng"].numpy(), self.group)
        tree["rng_ranks"] = torch.from_numpy(np.stack(every))
        return tree

    def state_from_tree(self, tree: ckpt.Tree, seed: int = 0) -> TrainState:
        """``Trainer.state_from_tree`` with this rank's dropout generator: its
        row of ``rng_ranks`` (a single-device tree's ``rng`` is a world of
        one's) when the tree was written at this data width, else re-seeded
        from (seed, rank, saved step).  A row of the other device type keeps
        the fresh seeded generator, as ``Trainer`` does."""
        state = super().state_from_tree(tree, seed)
        if "opt_state" not in tree:
            return state
        ranks = tree.get("rng_ranks", tree["rng"][None])
        d = self.mesh.coord("data")
        if len(ranks) != self.world:
            state.rng = super()._generator(resume_seed(seed, d, state.step))
        elif ranks[d].numel() == state.rng.get_state().numel():
            state.rng.set_state(ranks[d].clone())  # set_state crashes on a storage offset
        return state

    def save_tree(self, path: str, tree: ckpt.Tree) -> str:
        if pmesh.is_main_process():
            ckpt.save_tree(path, tree)
        pmesh.barrier()
        return path

    @torch.no_grad()
    def evaluate(self, state: TrainState, batcher, key_prefix: str = ""):
        """Every global step of ``batcher`` (a sharded batcher, or one that
        wraps it): this rank's predictions, the costs and metrics summed
        over the ranks in one all-reduce, the predictions of every rank
        gathered and flattened per step in rank order without padding, as
        ``kgcn_tpu``'s ``DPTrainer.evaluate``."""
        preds, pads, costs, metric_list = [], [], [], []
        for batch in batcher.batches(shuffle=False):
            pred, cost_sum, metrics = self.eval_step(state.params, state.batch_stats, batch)
            preds.append({k: v.cpu().numpy() for k, v in pred.items()}
                         if isinstance(pred, dict) else pred.cpu().numpy())
            pads.append(batch.pad_mask.cpu().numpy())
            costs.append(cost_sum)
            metric_list.append(metrics)
        names = list(metric_list[0]) if metric_list else []
        parts = costs + [m[k] for m in metric_list for k in names]
        if parts:
            summed = _split(_flat_sum(parts, self.device, self.group), parts)
            costs = [float(c) for c in summed[:len(costs)]]
            rest = summed[len(costs):]
            metric_list = [{k: rest[i * len(names) + j].cpu().numpy()
                            for j, k in enumerate(names)} for i in range(len(metric_list))]
        every = pmesh.host_view((preds, pads), self.group)
        flat_preds, n_total = [], 0
        for s in range(len(preds)):
            keep = np.concatenate([p[1][s] for p in every]) > 0
            n_total += int(keep.sum())
            if isinstance(preds[s], dict):
                flat_preds.append({k: np.concatenate([p[0][s][k] for p in every])[keep]
                                   for k in preds[s]})
            else:
                flat_preds.append(np.concatenate([p[0][s] for p in every])[keep])
        agg = aggregate_metrics(metric_list, n_total, self.config.get("task", ""),
                                key_prefix)
        if flat_preds and isinstance(flat_preds[0], dict):
            prediction = {k: np.concatenate([p[k] for p in flat_preds])
                          for k in flat_preds[0]}
        elif flat_preds:
            prediction = np.concatenate(flat_preds)
        else:
            prediction = None
        return {
            "cost": float(np.sum(costs)) / max(n_total, 1),
            "metrics": agg or {},
            "prediction": prediction,
            "num": n_total,
        }
