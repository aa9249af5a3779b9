"""Sequence and vector-modal encoders of the multimodal (compound–protein
interaction) models — the counterparts of ``kgcn_tpu/nn/multimodal.py``
(reference: example_model/model_multimodal.py:72-92).

``SequenceEncoder``: Embed → Conv1D (``SAME``) → relu → MaxPool1D (window
and stride 4, ``VALID``) → an LSTM run reversed over the full padded
length → the state after the last reversed step, as flax's ``nn.RNN(
OptimizedLSTMCell, reverse=True)`` with no ``seq_lengths`` computes it
(``y[:, -1]``).  Sequences are not packed: the padding tokens go through
the recurrence as they do there.

* ``SAME`` for a kernel of ``k`` pads ``(k - 1) // 2`` positions before and
  the rest after, as XLA's convolution does (1 and 2 for ``k = 4``).
* ``LSTMCell`` is flax's ``OptimizedLSTMCell``: ``i, f, o = σ(·)``,
  ``g = tanh(·)``, ``c' = f·c + i·g``, ``h' = o·tanh(c')``, a zero initial
  carry, input kernels without bias and hidden kernels with one.  The
  input side of every step is one matmul over the whole sequence; each
  step is a matmul and pointwise ops (``torch.matmul``, not cuDNN's
  ``nn.LSTM``, whose second bias flax does not have), so a captured step
  replays the eager step's arithmetic.

Parameter names follow flax's scopes (``Embed_0``, ``Conv_0``,
``OptimizedLSTMCell_0``, ``Dense_0``); ``convert.py`` maps the JAX trees
onto them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from kgcn_tpu_torch.models.standard import dropout
from kgcn_tpu_torch.nn import layers as knn


@torch.no_grad()
def _lecun_normal(t: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """flax's ``lecun_normal`` (truncated normal, variance 1/fan_in)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class Conv1dSame(nn.Conv1d):
    """flax ``nn.Conv(features, (k,), padding="SAME")`` over ``[B, L, C]``
    inputs; the weight is ``[out, in, k]`` (flax's ``[k, in, out]``)."""

    def __init__(self, in_features: int, features: int, kernel: int):
        super().__init__(in_features, features, kernel)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        _lecun_normal(self.weight, self.in_channels * self.kernel_size[0], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size[0]
        x = F.pad(x.transpose(1, 2), ((k - 1) // 2, k - 1 - (k - 1) // 2))
        return super().forward(x).transpose(1, 2)


def max_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """flax ``nn.max_pool(x, (w,), strides=(w,))`` (``VALID``) over
    ``[B, L, C]``."""
    return F.max_pool1d(x.transpose(1, 2), window, window).transpose(1, 2)


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: ``weight_ih`` ``[4H, in]`` (gates i, f,
    g, o; no bias), ``weight_hh`` ``[4H, H]`` and ``bias`` ``[4H]``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        self.weight_ih = nn.Parameter(torch.empty(4 * features, in_features))
        self.weight_hh = nn.Parameter(torch.empty(4 * features, features))
        self.bias = nn.Parameter(torch.zeros(4 * features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        H = self.features
        for gate in range(4):  # per gate, as flax draws each Dense
            _lecun_normal(self.weight_ih[gate * H:(gate + 1) * H],
                          self.weight_ih.shape[1], generator)
            nn.init.orthogonal_(self.weight_hh[gate * H:(gate + 1) * H],
                                generator=generator)
        nn.init.zeros_(self.bias)

    def scan_reversed(self, x: torch.Tensor) -> torch.Tensor:
        """The carry ``h`` after the cell ran over ``x`` ``[B, T, in]`` from
        ``t = T - 1`` down to 0, from a zero carry."""
        B, T, _ = x.shape
        H = self.features
        xp = torch.matmul(x, self.weight_ih.t())  # [B, T, 4H]
        h = x.new_zeros((B, H))
        c = x.new_zeros((B, H))
        for t in range(T - 1, -1, -1):
            gates = xp[:, t] + torch.matmul(h, self.weight_hh.t()) + self.bias
            i, f, g, o = gates.split(H, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        return h


class SequenceEncoder(nn.Module):
    """Embedding → Conv1D(relu) → MaxPool1D → backward LSTM → ``[B, H]``."""

    def __init__(self, vocab_size: int, embedding_dim: int = 10,
                 conv_features: int = 50, conv_kernel: int = 4,
                 pool_stride: int = 4, lstm_features: int = 32):
        super().__init__()
        self.pool_stride = pool_stride
        self.Embed_0 = knn.Embed(vocab_size, embedding_dim)
        self.Conv_0 = Conv1dSame(embedding_dim, conv_features, conv_kernel)
        self.OptimizedLSTMCell_0 = LSTMCell(conv_features, lstm_features)

    def reset_parameters(self, generator=None) -> None:
        for layer in (self.Embed_0, self.Conv_0, self.OptimizedLSTMCell_0):
            layer.reset_parameters(generator)

    def forward(self, sequences: torch.Tensor, return_embedded: bool = False,
                embedded=None) -> torch.Tensor:
        """``sequences`` ``[B, L]`` token ids → ``[B, H]``.  ``embedded``
        feeds a computed embedding ``[B, L, D]`` instead, and
        ``return_embedded`` returns the embedding (the IG-on-embeddings
        hooks, reference model_multimodal.py:76-80)."""
        x = embedded if embedded is not None else self.Embed_0(sequences)
        if return_embedded:
            return x
        x = max_pool(torch.relu(self.Conv_0(x)), self.pool_stride)
        return self.OptimizedLSTMCell_0.scan_reversed(x)


class VectorModalEncoder(nn.Module):
    """Dense(2·features) → relu → dropout → Dense(features) → relu, for a
    profeat / dragon / fingerprint vector (reference:
    example_model/model_multimodal_vec.py)."""

    def __init__(self, in_features: int, features: int = 32,
                 dropout_rate: float = 0.2):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.Dense_0 = knn.Dense(in_features, 2 * features)
        self.Dense_1 = knn.Dense(2 * features, features)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        knn.reset_linear_(self.Dense_0, generator)
        knn.reset_linear_(self.Dense_1, generator)

    def forward(self, v: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:
        x = torch.relu(self.Dense_0(v))
        x = dropout(x, self.dropout_rate, train, generator)
        return torch.relu(self.Dense_1(x))
