"""Evaluation metrics. Counterpart of score_tpu/metrics.py; so far only the
in-memory `auc` that the train step reports for its batch."""

from __future__ import annotations

from typing import Optional

import torch


def auc(scores: torch.Tensor, labels: torch.Tensor,
        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pooled pointwise AUC with average-tie ranks (rank-sum, as
    sklearn.roc_auc_score). scores/labels/weights [N]; an entry counts iff
    its weight is > 0. 0.5 when either class is empty."""
    if weights is None:
        weights = torch.ones_like(scores)
    valid = weights > 0
    # masked entries sort to the top, where they move no valid rank
    sorted_s = torch.sort(torch.where(valid, scores, torch.inf)).values
    lo = torch.searchsorted(sorted_s, scores)
    hi = torch.searchsorted(sorted_s, scores, right=True)
    rank = (lo + hi + 1).float() / 2.0            # 1-based average rank
    pos = (labels > 0) & valid
    neg = (labels <= 0) & valid
    # f32 counts, and the mean-rank form, keep magnitudes ~N, not ~N^2
    n_pos = pos.sum().float()
    n_neg = neg.sum().float()
    mean_rank_pos = torch.where(pos, rank, 0.0).sum() / n_pos.clamp_min(1.0)
    a = (mean_rank_pos - (n_pos + 1.0) / 2.0) / n_neg.clamp_min(1.0)
    return torch.where((n_pos > 0) & (n_neg > 0), a, 0.5)
