"""Plain PyTorch reference of the scoring models the configurations name:
SCoRe (Qin et al., WSDM 2020; co-attention with the sum pool of the
relation matrix, target-aware, attention pooling) and RRN (slot means, a
GRU, the last state), both dual side, as the repository defines them.

Written from the model's equations in f32, with no kernel of the
program, no cache and no batching beyond blocks of rows. It reads the
benchmark's own inputs (the graph tensors, the ids, the weights by name)
and nothing the program made. Every product runs in f32 with TF32 off
(`set_precision`).

Equations, for a user u with slot histories Eu [T, n, d] (item rows),
a candidate i with Ei [T, m, d] (user rows), masks mu, mi (neighbour j
of slot t valid iff j < count and t < t*), eu, ei their own rows:

  co-attention (per slot t), s = 1/sqrt(d):
    M[j, k]   = s * (Eu[j] Wr) . Ei[k]
    su[j]     = sum_k mi[k] M[j, k] + s * Eu[j] . (ei Wtu^T)
    si[k]     = sum_j mu[j] M[j, k] + s * Ei[k] . (eu Wti^T)
    a = softmax_mu(su), b = softmax_mi(si)   (all masked: zeros)
    cu = sum_j a[j] Eu[j],  ci = sum_k b[k] Ei[k]
  slot mean: cu = sum_j mu[j] Eu[j] / max(sum mu, 1), likewise ci
  GRU over t (wx [d, 3f], wh [f, 3f], b [3f]; gates z, r, c):
    z, r = sigmoid(x wx + b + h wh)[:2f]; c = tanh(x wx_c + b_c + r * h wh_c)
    h' = (1 - z) h + z c where slot t is valid, else h
  attention pool: q = query W^T, a_t = softmax_t(s' hs_t . q) over valid
    t (s' = 1/sqrt(d)), out = sum_t a_t hs_t; last pool: the last valid h
  scorer: MLP([h_u, h_i, eu, ei, h_u h_i, eu ei]) with ReLU, logit.

A `q` function, applied to every table row, weight and layer output the
program casts to its compute dtype, makes the same model in a lower
precision: the control (`round_to`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch

NEG = -1e30
# the model block's values these equations cover; any other raises
SUPPORTED = dict(arch=("score",), sides=("dual",),
                 slot_agg=("coattn", "mean"), seq_encoder=("gru",),
                 seq_pool=("attn", "last"))
COATTN_POOLS = ("sum",)


def check_supported(model: dict) -> None:
    """Raise NotImplementedError for a model block these equations (and
    the benchmark's weights and work counters, which follow them) do not
    cover."""
    for key, values in SUPPORTED.items():
        if model[key] not in values:
            raise NotImplementedError(
                f"model.{key} = {model[key]!r}: the benchmark's reference "
                f"covers {values}")
    if model["slot_agg"] == "coattn" and \
            model["coattn_pool"] not in COATTN_POOLS:
        raise NotImplementedError(
            f"model.coattn_pool = {model['coattn_pool']!r}: the benchmark's "
            f"reference covers {COATTN_POOLS}")


def set_precision() -> None:
    """f32 products in f32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Round(torch.autograd.Function):
    """x rounded to `dtype` and back to f32; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).float()

    @staticmethod
    def backward(ctx, g):
        return g, None


def round_to(dtype: Optional[torch.dtype]) -> Callable:
    """The rounding function of `dtype` (None: f32, no rounding). fp8
    (e4m3) saturates at its largest value, 448, as a scaled fp8 path
    would clip."""
    if dtype is None:
        return lambda x: x
    if dtype == torch.float8_e4m3fn:
        top = torch.finfo(dtype).max
        return lambda x: _Round.apply(x.clamp(-top, top), dtype)
    return lambda x: _Round.apply(x, dtype)


def _softmax(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    s = torch.where(mask, s, NEG)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    return e / e.sum(dim=-1, keepdim=True).clamp_min(1e-20)


def mask(cnt: torch.Tensor, k: int, sv: torch.Tensor) -> torch.Tensor:
    """[..., T, k]: neighbour j of slot t valid iff j < cnt[t] and slot t
    is before the target's (sv [..., T], broadcast)."""
    return (torch.arange(k, device=cnt.device) < cnt[..., None]) \
        & sv[..., None]


def _roll(x: torch.Tensor, shifts: Sequence[int]) -> torch.Tensor:
    """[B, 1, ...] -> [B, 1 + k, ...]: candidate c >= 1 of example b is
    example (b + shifts[c-1]) mod B's."""
    return torch.cat([x] + [torch.roll(x, -s, 0) for s in shifts], dim=1)


def coattention(Eu, Ei, mu, mi, eu, ei, w, q):
    """Per-slot co-attention, sum pool, target-aware when w has Wtu."""
    d = Eu.shape[-1]
    s = 1.0 / math.sqrt(d)
    EuW = q(torch.einsum("btjd,de->btje", Eu, q(w["coattn.wr"])))
    M = torch.einsum("btje,bctke->bctjk", EuW, Ei) * s
    muf, mif = mu.float(), mi.float()
    su = torch.einsum("bctjk,bctk->bctj", M, mif)
    si = torch.einsum("bctjk,btj->bctk", M, muf)
    if "coattn.wtu" in w:
        ei_t = q(ei @ q(w["coattn.wtu"]).T)                      # [B,C,d]
        eu_t = q(eu @ q(w["coattn.wti"]).T)                      # [B,d]
        su = su + torch.einsum("btjd,bcd->bctj", Eu, ei_t) * s
        si = si + torch.einsum("bctkd,bd->bctk", Ei, eu_t) * s
    a = _softmax(su, mu[:, None])
    b = _softmax(si, mi)
    cu = torch.einsum("bctj,btjd->bctd", a, Eu)
    ci = torch.einsum("bctk,bctkd->bctd", b, Ei)
    return q(cu), q(ci)


def slot_mean(E, mask, q):
    m = mask[..., None].float()
    return q((E * m).sum(dim=-2) / m.sum(dim=-2).clamp_min(1.0))


def gru(x, sv, w, side, q):
    """x [S, T, d], sv [S, T] -> states [S, T, f]."""
    wx, wh, b = (q(w[f"gru_{side}.{k}"]) for k in ("wx", "wh", "b"))
    S, T, _ = x.shape
    f = wh.shape[0]
    gx = q(x @ wx + b)
    h = torch.zeros(S, f, device=x.device)
    hs = []
    for t in range(T):
        gh = q(h @ wh)
        z = q(torch.sigmoid(gx[:, t, :f] + gh[:, :f]))
        r = q(torch.sigmoid(gx[:, t, f:2 * f] + gh[:, f:2 * f]))
        c = q(torch.tanh(gx[:, t, 2 * f:] + r * gh[:, 2 * f:]))
        h = torch.where(sv[:, t, None], q((1.0 - z) * h + z * c), h)
        hs.append(h)
    return torch.stack(hs, dim=1)


def attn_pool(hs, query, sv, wp, q):
    """hs [B, Ch, T, f] (Ch 1 or C), query [B, C, dq] -> [B, C, f]."""
    qv = q(query @ q(wp).T)                                      # [B,C,f]
    s = 1.0 / math.sqrt(query.shape[-1])
    if hs.shape[1] == 1:
        scores = torch.einsum("btf,bcf->bct", hs[:, 0], qv) * s
        a = _softmax(scores, sv[:, None])
        return q(torch.einsum("bct,btf->bcf", a, hs[:, 0]))
    scores = torch.einsum("bctf,bcf->bct", hs, qv) * s
    a = _softmax(scores, sv[:, None])
    return q(torch.einsum("bct,bctf->bcf", a, hs))


def last_pool(hs, sv):
    """hs [S, T, f] -> the last valid state [S, f], zeros if none."""
    idx = (sv.sum(dim=1) - 1).clamp_min(0)
    out = hs[torch.arange(hs.shape[0], device=hs.device), idx]
    return out * sv.any(dim=1, keepdim=True).float()


def scorer(feats, w, mlp_depth: int, q):
    x = q(torch.cat(feats, dim=-1))
    for i in range(mlp_depth):
        x = q(torch.relu(q(x @ q(w[f"scorer.mlp_{i}.weight"]).T)
                         + q(w[f"scorer.mlp_{i}.bias"])))
    logit = x @ w["scorer.out.weight"].T + w["scorer.out.bias"]
    return logit.squeeze(-1)


def logits(model: dict, w: Dict[str, torch.Tensor],
           graph: Dict[str, torch.Tensor], users: torch.Tensor,
           cand: torch.Tensor, slots: torch.Tensor,
           shifts: Optional[Sequence[int]] = None,
           q: Callable = round_to(None)) -> torch.Tensor:
    """Logits [B, C] of users [B] against candidates cand [B, C] at slots
    [B] (with `shifts`, cand is [B, 1] and candidate c >= 1 is a rolled
    positive: [B, 1 + k]), for model block `model` ('coattn' or 'mean'
    slot aggregation, 'attn' or 'last' pooling, dual side)."""
    check_supported(model)
    uh = graph["u2i"][users.long()]                              # [B,T,n]
    ih = graph["i2u"][cand.long()]                               # [B,C,T,m]
    uc = graph["u2i_cnt"][users.long()]
    ic = graph["i2u_cnt"][cand.long()]
    T = uh.shape[1]
    sv = torch.arange(T, device=users.device)[None, :] < slots[:, None]
    Tu, Ti = w["tables.user_table"], w["tables.item_table"]
    eu = q(Tu[users.long()])                                     # [B,d]
    ei = q(Ti[cand.long()])                                      # [B,C,d]
    Eu = q(Ti[uh.long()])                                        # [B,T,n,d]
    Ei = q(Tu[ih.long()])                                        # [B,C,T,m,d]
    if shifts:
        # a rolled candidate's history is seen up to this target's slot
        ei, Ei, ic = (_roll(x, shifts) for x in (ei, Ei, ic))
    mu = mask(uc, uh.shape[2], sv)                               # [B,T,n]
    mi = mask(ic, ih.shape[-1], sv[:, None])                     # [B,C,T,m]
    B, C = ei.shape[:2]
    if model["slot_agg"] == "coattn":
        cu, ci = coattention(Eu, Ei, mu, mi, eu, ei, w, q)       # [B,C,T,d]
    else:
        cu = slot_mean(Eu, mu, q)[:, None]                       # [B,1,T,d]
        ci = slot_mean(Ei, mi, q)
    eu_c = eu[:, None].expand(B, C, -1)
    out = []
    for side, c, query in (("u", cu, ei), ("i", ci, eu_c)):
        Ch = c.shape[1]
        svc = sv[:, None].expand(B, Ch, T).reshape(B * Ch, T)
        hs = gru(c.reshape(B * Ch, T, -1), svc, w, side, q)
        if model["seq_pool"] == "attn":
            h = attn_pool(hs.reshape(B, Ch, T, -1), query, sv,
                          w[f"pool_{side}.w"], q)
        else:
            h = last_pool(hs, svc).reshape(B, Ch, -1)
        out.append(h.expand(B, C, -1))
    h_u, h_i = out
    feats = [h_u, h_i, eu_c, ei, q(h_u * h_i), q(eu_c * ei)]
    return scorer(feats, w, len(model["mlp_dims"]), q)


def blocked_logits(model, w, graph, users, cand, slots, block: int,
                   q: Callable = round_to(None)) -> torch.Tensor:
    """`logits` in blocks of `block` rows, without autograd."""
    with torch.no_grad():
        return torch.cat([logits(model, w, graph, users[lo:lo + block],
                                 cand[lo:lo + block], slots[lo:lo + block],
                                 q=q)
                          for lo in range(0, users.numel(), block)])
