"""Segment reductions of the sparse paths — the counterparts of
``segment_sum`` and ``segment_softmax`` (``kgcn_tpu/ops/segment.py:17,77``),
plain PyTorch (GAT's edge softmax needs them)."""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[k] = Σ_{i: ids[i] = k} data[i]``, ``[num_segments, ...]``."""
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, mask=None) -> torch.Tensor:
    """Softmax of ``logits`` ([E] or [E, H]) within each segment; masked-out
    entries get probability 0 and empty segments stay finite.

    The segment maximum only shifts the exponent, so it is taken without
    gradient: the softmax's gradient does not depend on it."""
    ids = segment_ids.long()
    neg = torch.tensor(-1e30, dtype=logits.dtype, device=logits.device)
    if mask is not None and mask.dim() < logits.dim():
        mask = mask.reshape(mask.shape + (1,) * (logits.dim() - mask.dim()))
    masked = logits if mask is None else torch.where(mask > 0, logits, neg)
    with torch.no_grad():
        seg_max = torch.full((num_segments, *logits.shape[1:]), float("-inf"),
                             dtype=logits.dtype, device=logits.device)
        index = ids.reshape(ids.shape + (1,) * (logits.dim() - 1)).expand_as(masked)
        seg_max = seg_max.scatter_reduce(0, index, masked, reduce="amax")
        seg_max = torch.maximum(seg_max, neg)
    exp = torch.exp(masked - seg_max[ids])
    if mask is not None:
        exp = exp * (mask > 0)
    denom = segment_sum(exp, ids, num_segments)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    return exp / denom[ids]
