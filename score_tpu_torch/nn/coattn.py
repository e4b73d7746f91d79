"""Per-slot neighbour-set aggregation: the masked mean (configs0-1), per-side
slot attention (configs2) and SCoRe's cross-neighbour co-attention
(configs3).

Counterpart of score_tpu/nn/coattn.py: `masked_softmax`, `slot_mean`,
`SlotAttention`, and the co-attention with the sum, mean and max pools of
the relation matrix. The co-attention's routing mirrors the reference's
(score_tpu/nn/coattn.py CrossCoAttention):
  * pool='sum' runs the candidates-form kernels,
    `kernels.coattn_cand.cross_coattn_cand`, forward and backward;
  * pool='mean' or 'max' runs the per-pair kernels,
    `kernels.coattn.cross_coattn_pair`, which read the shared user side
    in place where the reference tiles it C times.
The route follows the pool alone: the reference's benchmark switches
`use_pallas` / `force_pairflat`, which send the sum pool through the
per-pair form, have no counterpart here (`cross_coattn_pair` computes the
sum pool too, and the kernel tests hold it to the candidates kernels).
The candidates kernels compute the sum pool only. The reference's
candidates path for 'mean' (count-normalised opposite-side sums) is the
same function as its per-pair 'mean', so routing 'mean' through the
per-pair kernels changes no result. Each kernel wrapper runs the CUDA
kernel for CUDA tensors and its plain version for CPU tensors; the torch
counterpart of the reference's `cross_coattn_ref` is
`kernels.coattn.cross_coattn_pair_plain` (its flat form at C == 1).
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.coattn import POOLS, cross_coattn_pair
from ..kernels.coattn_cand import cross_coattn_cand

_NEG = -1e9


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis; rows with no valid entry give all zeros.

    Runs in f32 whatever the input dtype, and casts the result back."""
    dt = scores.dtype
    s = torch.where(mask, scores.float(), _NEG)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s) * mask
    return (e / e.sum(dim=-1, keepdim=True).clamp_min(1e-20)).to(dt)


def roll_candidates(x: torch.Tensor, shifts) -> torch.Tensor:
    """In-batch negatives: x [B, 1, ...] -> [B, 1 + k, ...], candidate
    c >= 1 of example b being example (b + shifts[c-1]) mod B's."""
    return torch.cat([x] + [torch.roll(x, -s, 0) for s in shifts], dim=1)


def slot_mean(E: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the neighbour axis. E: [..., n, d], mask: [..., n]."""
    m = mask[..., None].to(E.dtype)
    return (E * m).sum(dim=-2) / m.sum(dim=-2).clamp_min(1.0)


class SlotAttention(nn.Module):
    """Per-side target-aware attention over each slot's neighbour set
    (configs2): scores = (E W) . target / sqrt(d), c_t = softmax^T E.

    E [B, Ce, T, k, d] with Ce = 1 (shared by the candidates: the user
    side) or C (the item side), mask [B, Ce, T, k], target [B, C, d] ->
    [B, C, T, d]. The shared side is not expanded C times: only the
    [B, C, T, k] scores carry the candidate axis. `w` starts at zero, so
    the rung starts as the masked mean and learns to deviate."""

    def __init__(self, dim: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(dim, dim))

    def forward(self, E, mask, target):
        dt = E.dtype
        d = E.shape[-1]
        # project the target, not the neighbours: (E W) . t == E . (t W^T)
        tq = target @ self.w.to(dt).T                           # [B,C,d]
        # 1/sqrt(d) rounded to the activations' dtype, as the reference
        scale = (1.0 / torch.tensor(float(d), dtype=dt).sqrt()).item()
        if E.shape[1] == 1:        # the mask [B,1,T,k] broadcasts over C
            Es = E[:, 0]
            scores = torch.einsum("btkd,bcd->bctk", Es, tq) * scale
            a = masked_softmax(scores, mask)
            return torch.einsum("bctk,btkd->bctd", a, Es)
        scores = torch.einsum("bctkd,bcd->bctk", E, tq) * scale
        a = masked_softmax(scores, mask)
        return torch.einsum("bctk,bctkd->bctd", a, E)


class CrossCoAttention(nn.Module):
    """Owns the bilinear Wr (and, target-aware, the target projections Wtu
    and Wti); candidates-form forward with pooling `pool` ('sum', 'mean'
    or 'max'), through the per-pair kernels for 'mean' and 'max', and
    through the candidates kernels for 'sum'.

    Inputs: Eu [B,T,n,d] (user side, shared by the candidates),
    Ei [B,C,T,m,d], bool mu [B,T,n] and mi [B,C,T,m], eu [B,d],
    ei [B,C,d]. Returns cu, ci [B,C,T,d]. The f32 master weights are cast
    to the activations' dtype where they are used.

    In-batch negatives: with `i_shifts` (k batch-axis shifts), Ei arrives
    un-rolled as [B,1,T,m,d] and candidate c >= 1 is the item side of
    example b + i_shifts[c-1]. The rolled item side is materialised, as
    the reference does by default (score_tpu/nn/coattn.py PUSH_ROLLS =
    False), and autograd of the roll sums each copy's gradient back onto
    its example."""

    def __init__(self, dim: int, pool: str = "sum",
                 target_aware: bool = True):
        super().__init__()
        if pool not in POOLS:
            raise ValueError(f"pool must be one of {POOLS}, got {pool!r}")
        self.pool = pool
        self.target_aware = target_aware
        self.wr = nn.Parameter(torch.zeros(dim, dim))
        if target_aware:
            self.wtu = nn.Parameter(torch.zeros(dim, dim))
            self.wti = nn.Parameter(torch.zeros(dim, dim))

    def forward(self, Eu, Ei, mu, mi, eu, ei, i_shifts=None):
        dt = Eu.dtype
        if i_shifts is not None:
            Ei = roll_candidates(Ei, i_shifts)
        if self.target_aware:
            # project each target once: einsum("de,bce->bcd", W, x) is x @ W^T
            ei = ei @ self.wtu.to(dt).T
            eu = eu @ self.wti.to(dt).T
        Wr = self.wr.to(dt)
        if self.pool == "sum":
            return cross_coattn_cand(Eu, Ei, mu, mi, Wr, eu, ei,
                                     self.target_aware)
        return cross_coattn_pair(Eu, Ei, mu, mi, Wr, eu, ei, self.pool,
                                 self.target_aware)
