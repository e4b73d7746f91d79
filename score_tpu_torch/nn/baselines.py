"""The baseline roster: MF, SVD++, the popularity floor and DELF, and the
Caser and SASRec sequence encoders.

Counterpart of score_tpu/nn/baselines.py. The four archs share
ScoreModel's interface (`forward(batch)`, `score_candidates(batch,
neg_shift=None)`, `cfg`, `num_users`, `num_items`, `dual`), so the train,
eval and serve entry points run them unchanged through
`nn.model.build_model`:

  MFModel          <eu, ei> + b_u + b_i + b
  PopModel         b_i alone
  SVDPPModel       MF with the implicit factor |N(u)|^-1/2 sum_j y_j
  DELFModel        id and history embeddings on both sides, four pairwise
                   MLPs and a linear head
  CaserEncoder     seq_encoder 'caser': causal horizontal convolutions and
                   a causal running mean
  SelfAttnEncoder  seq_encoder 'selfattn': one pre-LN causal self-attention
                   block

Submodule and parameter names follow the flax tree (`score_tpu_torch.params`
maps one onto the other). Every lookup goes through `EmbeddingTables` and
so through the gather kernel, its gradient through the scatter-add kernel;
the rest is plain PyTorch, as the JAX side has no Pallas kernel here.

Dtypes follow the reference's. The archs never cast to the compute dtype:
they compute in the dtype of the rows they gather (f32 in training, bf16
from tables that serving casts), and their flax Dense layers promote a
bf16 input against f32 weights to f32, as `_dense` does. The encoders have
no dtype either, so under bf16 compute they take bf16 input and compute
and return f32. The archs' scores come back in f32 (the popularity
floor's bf16 bias rows cast exactly).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from .embed import EmbeddingTables
from .model import _nbr_mask as _hist_mask
from .model import candidates_form

CASER_WIDTHS = (2, 3, 4)
SELFATTN_HEADS = 2
LN_EPS = 1e-6      # flax LayerNorm's epsilon (torch's default is 1e-5)


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A flax Dense with no dtype: the input promoted to the weights'
    dtype, the product, then the bias."""
    return F.linear(x.to(layer.weight.dtype), layer.weight, layer.bias)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) as the reference's fused multiply-reduce computes it:
    the products unrounded in f32, an f32 sum, one rounding to a's dtype
    (an elementwise bf16 product would round each product first)."""
    return (a.float() * b.float()).sum(dim=-1).to(a.dtype)


def _masked_mean_flat(E: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of E [..., T, k, d] over all valid (t, j); zero if none is
    valid."""
    m = mask[..., None].to(E.dtype)
    s = (E * m).sum(dim=(-3, -2))
    return s / m.sum(dim=(-3, -2)).clamp_min(1.0)


class _Baseline(nn.Module):
    """What the archs share: the config, the id ranges and `forward`, the
    candidates form at C == 1."""

    dual = False        # reads the candidates' item-side histories

    def __init__(self, cfg: ModelConfig, num_users: int, num_items: int,
                 lookup_fn=None):
        super().__init__()
        self.cfg = cfg
        self.num_users, self.num_items = num_users, num_items
        self.lookup_fn = lookup_fn

    def _tables(self, users: bool = True, items: bool = True,
                dim: Optional[int] = None, shared: bool = False
                ) -> EmbeddingTables:
        """Tables of width `dim` (default embed_dim); a side left out keeps
        a table of the pad row's 64 rows, as in the reference."""
        return EmbeddingTables(self.num_users if users else 0,
                               self.num_items if items else 0,
                               self.cfg.embed_dim if dim is None else dim,
                               shared=shared, lookup_fn=self.lookup_fn)

    def forward(self, batch: dict) -> torch.Tensor:
        """Flat (u, i) pairs -> [B]."""
        return self.score_candidates(candidates_form(batch, self.dual))[:, 0]


class MFModel(_Baseline):
    """score = <eu, ei> + b_u + b_i + b (no histories)."""

    def __init__(self, cfg: ModelConfig, num_users: int, num_items: int,
                 lookup_fn=None):
        super().__init__(cfg, num_users, num_items, lookup_fn)
        self.tables = self._tables(shared=cfg.shared_table)
        self.user_bias = self._tables(items=False, dim=1)
        self.item_bias = self._tables(users=False, dim=1)
        self.bias = nn.Parameter(torch.zeros(()))

    def score_candidates(self, batch: dict,
                         neg_shift: Optional[Sequence[int]] = None
                         ) -> torch.Tensor:
        """[B, C] scores of batch['user'] against batch['cand']. The
        reference ignores in-batch shifts here; so does the port."""
        user, cand = batch["user"], batch["cand"]
        (eu,), (ei,) = self.tables.lookup([user], [cand])
        bu = self.user_bias.user_emb(user)[..., 0]
        bi = self.item_bias.item_emb(cand)[..., 0]
        s = _dot(eu[:, None], ei) + bu[:, None] + bi
        # the scalar bias is an f32 array in the reference: it promotes
        return s.float() + self.bias


class PopModel(_Baseline):
    """Popularity floor: score = b_i."""

    def __init__(self, cfg: ModelConfig, num_users: int, num_items: int,
                 lookup_fn=None):
        super().__init__(cfg, num_users, num_items, lookup_fn)
        self.item_bias = self._tables(users=False, dim=1)

    def score_candidates(self, batch: dict,
                         neg_shift: Optional[Sequence[int]] = None
                         ) -> torch.Tensor:
        return self.item_bias.item_emb(batch["cand"])[..., 0].float()


class SVDPPModel(_Baseline):
    """SVD++: b + b_u + b_i + < e_u + |N(u)|^-1/2 sum_{j in N(u)} y_j, e_i >,
    N(u) the user's valid history (slots t < t*), y a separate implicit
    item table; the implicit factor once a user in the candidates form."""

    def __init__(self, cfg: ModelConfig, num_users: int, num_items: int,
                 lookup_fn=None):
        super().__init__(cfg, num_users, num_items, lookup_fn)
        self.tables = self._tables(shared=cfg.shared_table)
        self.implicit_tables = self._tables(users=False)
        self.user_bias = self._tables(items=False, dim=1)
        self.item_bias = self._tables(users=False, dim=1)
        self.bias = nn.Parameter(torch.zeros(()))

    def user_vec(self, batch: dict, eu: torch.Tensor) -> torch.Tensor:
        """eu [B, d] plus the implicit factor -> [B, d]."""
        mask = _hist_mask(batch["u_cnt"], batch["u_hist"].shape[-1],
                          batch["slot_valid"])                    # [B, T, n]
        Y = self.implicit_tables.item_emb(batch["u_hist"])        # [B,T,n,d]
        m = mask[..., None].to(Y.dtype)
        s = (Y * m).sum(dim=(1, 2))
        cnt = m.sum(dim=(1, 2))                                   # [B, 1]
        return eu + s * torch.rsqrt(cnt.clamp_min(1.0))

    def score_candidates(self, batch: dict,
                         neg_shift: Optional[Sequence[int]] = None
                         ) -> torch.Tensor:
        user, cand = batch["user"], batch["cand"]
        (eu,), (ei,) = self.tables.lookup([user], [cand])
        pu = self.user_vec(batch, eu)                             # [B, d]
        bu = self.user_bias.user_emb(user)[..., 0]                # [B]
        bi = self.item_bias.item_emb(cand)[..., 0]                # [B, C]
        s = _dot(pu[:, None], ei) + bu[:, None] + bi
        return s.float() + self.bias


class DELFModel(_Baseline):
    """DELF-style dual embeddings: each side an id embedding and a history
    embedding (the user's: mean of its items' `hist_tables` rows; the
    item's: mean of its users'), four pairwise MLPs over the cross pairs,
    then a linear head. Both sides' histories, no time structure."""

    dual = True
    PAIRS = ("ee", "eq", "pe", "pq")

    def __init__(self, cfg: ModelConfig, num_users: int, num_items: int,
                 lookup_fn=None):
        super().__init__(cfg, num_users, num_items, lookup_fn)
        d, h = cfg.embed_dim, cfg.hidden_dim
        self.tables = self._tables(shared=cfg.shared_table)
        self.hist_tables = self._tables()
        for k in self.PAIRS:
            self.add_module(f"pair_{k}", nn.Linear(2 * d, h))
        self.head = nn.Linear(4 * h, 1)

    def score_candidates(self, batch: dict,
                         neg_shift: Optional[Sequence[int]] = None
                         ) -> torch.Tensor:
        sv = batch["slot_valid"]
        (eu,), (ei,) = self.tables.lookup([batch["user"]], [batch["cand"]])
        (Qi,), (Pu,) = self.hist_tables.lookup([batch["i_hist"]],
                                               [batch["u_hist"]])
        mu = _hist_mask(batch["u_cnt"], Pu.shape[-2], sv)         # [B, T, n]
        pu = _masked_mean_flat(Pu, mu)                            # [B, d]
        mi = _hist_mask(batch["i_cnt"], Qi.shape[-2], sv[:, None])
        qi = _masked_mean_flat(Qi, mi)                            # [B, C, d]
        eu_b = eu[:, None].expand_as(ei)
        pu_b = pu[:, None].expand_as(ei)
        pairs = [(eu_b, ei), (eu_b, qi), (pu_b, ei), (pu_b, qi)]
        feats = [F.relu(_dense(getattr(self, f"pair_{k}"),
                               torch.cat([a, b], dim=-1)))
                 for k, (a, b) in zip(self.PAIRS, pairs)]
        return _dense(self.head, torch.cat(feats, dim=-1))[..., 0]


class CaserEncoder(nn.Module):
    """Caser-style causal CNN over the slots: horizontal convolutions of
    widths CASER_WIDTHS, left-padded by w - 1 so the output at slot t sees
    slots <= t only, and a causal running mean over the valid slots in
    place of Caser's vertical filter. xs [B, T, d], mask [B, T] ->
    [B, T, f], zero at invalid slots.

    Conv weights keep conv1d's layout [f, d, w] (flax: [w, d, f])."""

    def __init__(self, in_dim: int, features: int,
                 widths: Sequence[int] = CASER_WIDTHS):
        super().__init__()
        self.widths = tuple(widths)
        for w in self.widths:
            self.add_module(f"hconv_{w}", nn.Conv1d(in_dim, features, w))
        self.vproj = nn.Linear(in_dim, features)
        self.out = nn.Linear(features * (len(self.widths) + 1), features)

    def forward(self, xs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        mf = mask[..., None].to(xs.dtype)
        xs = xs * mf
        x = xs.float()
        outs = []
        for w in self.widths:
            # the convolution as one product over the windows [B, T, d, w]
            # (no cuDNN, so no TF32 on the card)
            conv = getattr(self, f"hconv_{w}")
            win = F.pad(x, (0, 0, w - 1, 0)).unfold(1, w, 1)
            outs.append(F.relu(F.linear(win.flatten(2),
                                        conv.weight.flatten(1), conv.bias)))
        # in the input's dtype, as the reference's cumsums: XLA sums the
        # slots in order and rounds the running sum at each add (in bf16 a
        # torch.cumsum, which rounds once, differs)
        run = [xs[:, 0]]
        for t in range(1, xs.shape[1]):
            run.append(run[-1] + xs[:, t])
        vert = torch.stack(run, dim=1) / torch.cumsum(mf, dim=1).clamp_min(1.0)
        outs.append(_dense(self.vproj, vert))
        h = _dense(self.out, torch.cat(outs, dim=-1))
        return F.relu(h) * mf


class LayerNorm(nn.Module):
    """flax's LayerNorm: epsilon 1e-6, the variance as E[x^2] - E[x]^2
    (clipped at 0), y = (x - mean) * (rsqrt(var + eps) * scale) + bias, in
    at least f32."""

    def __init__(self, features: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


class MultiHeadAttention(nn.Module):
    """flax's MultiHeadDotProductAttention (no dropout) with the same
    weights: query, key and value weights [heads, head_dim, in] with
    biases [heads, head_dim] (flax: kernels [in, heads, head_dim]), the out
    weight [out, heads, head_dim] (flax: [heads, head_dim, out]) and its
    bias [out]. The query is divided by sqrt(head_dim); masked logits take
    finfo.min, not -inf, so a query whose keys are all masked averages
    uniformly instead of giving NaN."""

    def __init__(self, features: int, num_heads: int):
        super().__init__()
        hd = features // num_heads
        for name in ("query", "key", "value"):
            proj = nn.Module()
            proj.weight = nn.Parameter(torch.empty(num_heads, hd, features))
            proj.bias = nn.Parameter(torch.zeros(num_heads, hd))
            self.add_module(name, proj)
        self.out = nn.Module()
        self.out.weight = nn.Parameter(torch.empty(features, num_heads, hd))
        self.out.bias = nn.Parameter(torch.zeros(features))

    @staticmethod
    def _project(proj: nn.Module, x: torch.Tensor) -> torch.Tensor:
        h, hd, i = proj.weight.shape
        y = x @ proj.weight.reshape(h * hd, i).T                  # [B,T,h*hd]
        return y.unflatten(-1, (h, hd)) + proj.bias

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [B, T, f] (f32), mask [B, 1, T, T] bool (query, key) ->
        [B, T, f]."""
        q, k, v = (self._project(getattr(self, n), x)
                   for n in ("query", "key", "value"))
        q = q / math.sqrt(q.shape[-1])
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
        y = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return y.flatten(-2) @ self.out.weight.flatten(1).T + self.out.bias


class SelfAttnEncoder(nn.Module):
    """One pre-LN self-attention block over the slots (SASRec-style):
    h = in_proj(x); h += MHA(LN1(h)) causal and length-masked;
    h += ff2(relu(ff1(LN2(h)))); zero at invalid slots. xs [B, T, d],
    mask [B, T] -> [B, T, f] in f32."""

    def __init__(self, in_dim: int, features: int,
                 num_heads: int = SELFATTN_HEADS):
        super().__init__()
        self.in_proj = nn.Linear(in_dim, features)
        self.ln1 = LayerNorm(features)
        self.mha = MultiHeadAttention(features, num_heads)
        self.ln2 = LayerNorm(features)
        self.ff1 = nn.Linear(features, 2 * features)
        self.ff2 = nn.Linear(2 * features, features)

    def forward(self, xs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        T = xs.shape[1]
        h = _dense(self.in_proj, xs)
        causal = torch.ones(T, T, dtype=torch.bool, device=xs.device).tril()
        attn_mask = mask[:, None, None, :] & causal               # [B,1,T,T]
        h = h + self.mha(self.ln1(h), attn_mask)
        y = F.relu(_dense(self.ff1, self.ln2(h)))
        h = h + _dense(self.ff2, y)
        return h * mask[..., None].to(h.dtype)
