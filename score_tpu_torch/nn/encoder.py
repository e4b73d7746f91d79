"""Sequence encoders: GRU over time slots and pooling.

Counterpart of score_tpu/nn/encoder.py. The GRU cell is hand-rolled over T
because its convention differs from `torch.nn.GRU` (which computes
h' = (1-z)*n + z*h with a second bias):
    z = sigmoid(x Wxz + h Whz + bz)
    r = sigmoid(x Wxr + h Whr + br)
    c = tanh(x Wxc + r * (h Whc) + bc)
    h' = (1 - z) * h + z * c
Masked steps (padded slots) carry h through unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

from .coattn import masked_softmax


class _Logistic(torch.autograd.Function):
    """The logistic function in bf16 as the reference's lowering computes
    it, 1 / (1 + exp(-x)) with every op rounded to bf16 (torch.sigmoid
    rounds once, and differs in the last bit on many inputs); its
    gradient g * y * (1 - y), JAX's rule and torch.sigmoid's kernel."""

    @staticmethod
    def forward(ctx, x):
        y = torch.exp(-x).add_(1.0).reciprocal_()
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.ops.aten.sigmoid_backward(g, y)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        return _Logistic.apply(x)
    return torch.sigmoid(x)


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
        B, T, d = xs.shape
        dt = xs.dtype
        Wx, Wh, b = self.wx.to(dt), self.wh.to(dt), self.b.to(dt)
        # the input projection of every step in one product
        gx_all = (xs.reshape(B * T, d) @ Wx + b).reshape(B, T, -1)
        f = Wh.shape[0]
        h = torch.zeros(B, f, dtype=dt, device=xs.device)
        hs = []
        for t in range(T):
            gx_zr, gx_c = gx_all[:, t].split([2 * f, f], dim=-1)
            gh_zr, gh_c = (h @ Wh).split([2 * f, f], dim=-1)
            z, r = _sigmoid(gx_zr + gh_zr).chunk(2, dim=-1)  # one call
            c = torch.tanh(gx_c + r * gh_c)
            h = torch.where(mask[:, t, None], (1.0 - z) * h + z * c, h)
            hs.append(h)
        return torch.stack(hs, dim=1)


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
