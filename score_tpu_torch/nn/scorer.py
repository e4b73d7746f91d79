"""Interaction scorer z = MLP([h_u; h_i; eu; ei; h_u*h_i; eu*ei]) -> logit,
and the pointwise loss.

Counterpart of score_tpu/nn/scorer.py (Scorer, bce_loss). Hidden layers
run in the compute dtype and the logit in f32. Dropout (ModelConfig
.dropout) follows each hidden ReLU in training mode only, as flax's
Dropout does: kept activations are divided by the keep probability in
the activations' dtype, dropped ones are 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Scorer(nn.Module):
    """MLP head. Layers are named as in flax (mlp_0, mlp_1, ..., out)."""

    def __init__(self, in_dim: int, mlp_dims: Sequence[int],
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.dropout = float(dropout)
        self.num_hidden = len(mlp_dims)
        for i, w in enumerate(mlp_dims):
            self.add_module(f"mlp_{i}", nn.Linear(in_dim, w))
            in_dim = w
        self.out = nn.Linear(in_dim, 1)

    def forward(self, feats: Sequence[torch.Tensor],
                dropout_masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """feats [..., *] -> logits [...] in f32. In training mode with
        dropout > 0, hidden layer i keeps the elements where
        dropout_masks[i] (bool, the layer's shape) is true, or, with no
        masks, where uniform draws from torch's default generator (on the
        activations' device) fall below the keep probability."""
        cdt = self.dtype
        x = torch.cat([f.to(cdt) for f in feats], dim=-1)
        for i in range(self.num_hidden):
            layer = getattr(self, f"mlp_{i}")
            # the bias is added after the product is rounded to the compute
            # dtype, as flax's Dense does (one fused rounding differs in bf16)
            x = F.relu(F.linear(x, layer.weight.to(cdt)) + layer.bias.to(cdt))
            if self.training and self.dropout > 0:
                x = self._drop(x, None if dropout_masks is None
                               else dropout_masks[i])
        logit = F.linear(x.float(), self.out.weight.float(),
                         self.out.bias.float())
        return logit.squeeze(-1)

    def _drop(self, x: torch.Tensor, mask: Optional[torch.Tensor]
              ) -> torch.Tensor:
        keep = 1.0 - self.dropout
        if keep <= 0.0:
            return torch.zeros_like(x)
        if mask is None:
            mask = torch.rand(x.shape, device=x.device) < keep
        # flax divides by keep_prob rounded to x's dtype (a bf16 division
        # for bf16 activations), not by a multiply with 1 / keep_prob
        kp = float(torch.tensor(keep, dtype=x.dtype))
        return torch.where(mask, x / kp, 0.0)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy; with `weights` (same shape as
    logits) the weighted mean sum(l * w) / max(sum(w), 1), so elements of
    weight 0 (in-batch negatives that collide with their positive) drop
    out."""
    ell = F.binary_cross_entropy_with_logits(logits, labels,
                                             reduction="none")
    if weights is None:
        return ell.mean()
    return (ell * weights).sum() / weights.sum().clamp_min(1.0)
