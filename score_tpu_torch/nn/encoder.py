"""Sequence encoders: GRU over time slots and pooling.

Counterpart of score_tpu/nn/encoder.py. The GRU cell is hand-rolled over T
because its convention differs from `torch.nn.GRU` (which computes
h' = (1-z)*n + z*h with a second bias):
    z = sigmoid(x Wxz + h Whz + bz)
    r = sigmoid(x Wxr + h Whr + br)
    c = tanh(x Wxc + r * (h Whc) + bc)
    h' = (1 - z) * h + z * c
Masked steps (padded slots) carry h through unchanged. On a CUDA device
in bf16 with no gradient to keep (serving, evaluation) the whole recurrence
is one hand-written kernel (`kernels/gru.py`); elsewhere it runs op by op.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import gru
from .coattn import masked_softmax


class GRU(nn.Module):
    """Unidirectional GRU over axis 1. xs: [B,T,d], mask: [B,T] -> [B,T,f].

    Weights keep the flax layout: wx [d,3f], wh [f,3f], b [3f], gates in
    z, r, c order."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.wx = nn.Parameter(torch.empty(in_dim, 3 * features))
        self.wh = nn.Parameter(torch.empty(features, 3 * features))
        self.b = nn.Parameter(torch.zeros(3 * features))

    def forward(self, xs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = xs.dtype
        Wx, Wh, b = self.wx.to(dt), self.wh.to(dt), self.b.to(dt)
        needs_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (xs, Wx, Wh, b))
        if gru.uses_kernel(xs.device.type, dt, xs.shape[-1], Wh.shape[0],
                           needs_grad):
            return gru.gru_fwd(xs, mask, Wx, Wh, b)
        if xs.is_cuda:
            gru.gru_fwd.plain_calls += 1
        return gru.gru_fwd_plain(xs, mask, Wx, Wh, b)


class AttnPool(nn.Module):
    """Attention pooling of GRU states with the opposite target embedding
    as query: scores_t = (h_t W) . q / sqrt(dq), out = sum_t softmax_t h_t.
    All-masked rows pool to exact zero.

    hs [B,Ch,T,f] (Ch = 1 shared or C), query [B,C,dq], mask [B,T] ->
    [B,C,f]."""

    def __init__(self, features: int, query_dim: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(features, query_dim))

    def forward(self, hs, query, mask):
        dt = hs.dtype
        dq = query.shape[-1]
        # einsum("fq,bcq->bcf", W, query) is query @ W^T, in the states'
        # dtype (f32 states of the Caser and SASRec encoders promote a bf16
        # query, as in the reference)
        q = query.to(dt) @ self.w.to(dt).T                     # [B,C,f]
        # 1/sqrt(dq) rounded to the activations' dtype, as the reference
        scale = (1.0 / torch.tensor(float(dq), dtype=dt).sqrt()).item()
        if hs.shape[1] == 1:
            scores = torch.einsum("btf,bcf->bct", hs[:, 0], q) * scale
            a = masked_softmax(scores, mask[:, None])
            return torch.einsum("bct,btf->bcf", a, hs[:, 0])
        scores = torch.einsum("bctf,bcf->bct", hs, q) * scale
        a = masked_softmax(scores, mask[:, None])
        return torch.einsum("bct,bctf->bcf", a, hs)


def last_pool(hs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Last valid state; zero if none is valid. hs [B,T,f], mask [B,T]."""
    idx = (mask.sum(dim=1) - 1).clamp_min(0)
    out = hs[torch.arange(hs.shape[0], device=hs.device), idx]
    return out * mask.any(dim=1, keepdim=True).to(hs.dtype)
