"""Segment reductions of the sparse paths — the counterparts of
``segment_sum`` and ``segment_softmax`` (``kgcn_tpu/ops/segment.py:17,77``),
plain PyTorch (GAT's edge softmax and the ``xla`` scatter need them).

Sums run in a fixed order on every device: each segment's entries in their
order in ``data`` (a stable sort by id, then a sorted segment reduction), so
a GPU run repeats bitwise, where an ``index_add`` on the card adds through
atomics in an order that changes from run to run.  Nothing here reads a
device value on the host: a batch's segments are sorted once on the host,
where its receivers come from (``host_segments``, through
``GraphBatch.receiver_segments``); ids given on the card alone are sorted
there and their offsets found by a search of the sorted ids (a
``bincount`` on the card would read the ids' range back to size its
output); constants enter as Python scalars, never as tensors copied to the
card."""
from __future__ import annotations

import numpy as np
import torch

_NEG = -1e30  # the logit of a masked-out entry


def host_segments(segment_ids: np.ndarray, num_segments: int):
    """``sort_segments`` of host ids in ``[0, num_segments)``, in NumPy:
    ``(ids, order, offsets)`` as int64 arrays.  Below 2^16 segments the
    stable sort runs on 16-bit keys, which NumPy sorts by radix, ~10×
    faster than on wider ones."""
    ids = np.asarray(segment_ids, np.int64)
    keys = ids.astype(np.uint16) if num_segments <= 1 << 16 else ids
    order = np.argsort(keys, kind="stable")
    offsets = np.zeros(num_segments + 1, np.int64)
    np.cumsum(np.bincount(ids, minlength=num_segments)[:num_segments], out=offsets[1:])
    return ids, order, offsets


def sort_segments(segment_ids: torch.Tensor, num_segments: int):
    """``(ids, order, offsets)`` of ``segment_ids``: as int64, the stable
    sorting permutation, and each segment's start in the sorted order
    (``[num_segments + 1]``, from a search of the sorted ids), on the ids'
    device."""
    ids = segment_ids.long()
    sorted_ids, order = torch.sort(ids, stable=True)
    offsets = torch.searchsorted(sorted_ids,
                                 torch.arange(num_segments + 1, device=ids.device))
    return ids, order, offsets


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                sorted_segments=None) -> torch.Tensor:
    """``out[k] = Σ_{i: ids[i] = k} data[i]``, ``[num_segments, ...]``,
    each segment summed from 0 in the order of ``data`` (empty segments 0).
    ``sorted_segments``: ``sort_segments(segment_ids, num_segments)``, when
    the caller has it."""
    _, order, offsets = sorted_segments or sort_segments(segment_ids, num_segments)
    # unsafe: skip the offsets' validation, which reads them on the host.  The
    # backward gathers each segment's gradient and scatters it back through
    # the permutation: one entry a destination, no order to vary
    return torch.segment_reduce(data.index_select(0, order), "sum", offsets=offsets,
                                axis=0, unsafe=True)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, mask=None, sorted_segments=None) -> torch.Tensor:
    """Softmax of ``logits`` ([E] or [E, H]) within each segment; masked-out
    entries get probability 0 and empty segments stay finite.

    The segment maximum only shifts the exponent, so it is taken without
    gradient: the softmax's gradient does not depend on it.  It is a
    ``scatter_reduce`` amax, whose result does not depend on the order of
    the atomics."""
    ids = segment_ids.long()
    if mask is not None and mask.dim() < logits.dim():
        mask = mask.reshape(mask.shape + (1,) * (logits.dim() - mask.dim()))
    masked = logits if mask is None else torch.where(mask > 0, logits, _NEG)
    with torch.no_grad():
        seg_max = torch.full((num_segments, *logits.shape[1:]), float("-inf"),
                             dtype=logits.dtype, device=logits.device)
        index = ids.reshape(ids.shape + (1,) * (logits.dim() - 1)).expand_as(masked)
        seg_max = seg_max.scatter_reduce(0, index, masked, reduce="amax")
        seg_max = seg_max.clamp(min=_NEG)
    exp = torch.exp(masked - seg_max.index_select(0, ids))
    if mask is not None:
        exp = exp * (mask > 0)
    denom = segment_sum(exp, ids, num_segments, sorted_segments)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    return exp / denom.index_select(0, ids)
