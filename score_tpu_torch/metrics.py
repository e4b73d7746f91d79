"""Evaluation metrics: AUC, HR@K, NDCG@K, MRR and GAUC. Counterpart of
score_tpu/metrics.py.

* `auc`: the in-memory tie-aware rank-sum AUC (the train step's batch
  AUC).
* `score_hists` + `hist_auc`: the streaming AUC of `train.evaluate`.
  Scores are bucketed at float16 resolution into order-preserving keys
  (`f16_bucket`), and two F16_BINS-bin int32 histograms (positives,
  negatives) accumulate on the device, exactly; the AUC falls out of them
  in one f64 pass on the host. Scores equal at float16 resolution count
  as ties.
* `ranking_sums` / `ranking_metrics`: each positive ranked against its N
  fixed negatives, ties counting half; the sums add exactly over blocks.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

F16_BINS = 1 << 16


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


def rank_sum_keys(ks: Sequence[int] = (1, 5, 10)) -> Tuple[str, ...]:
    """Fixed metric-name order of the stacked sums vector."""
    names = []
    for k in ks:
        names += [f"hr@{k}", f"ndcg@{k}"]
    return tuple(names + ["mrr", "gauc", "wsum"])


def ranking_sums(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
                 ks: Sequence[int] = (1, 5, 10),
                 weights: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """Weighted SUMS of the per-target ranking metrics, plus 'wsum'.
    pos_scores [B], neg_scores [B, N], weights [B]. Rank
    r = 1 + #(neg > pos) + 0.5 #(neg == pos); HR@K = [r <= K],
    NDCG@K = 1/log2(1 + r) if r <= K, MRR = 1/r, GAUC = 1 - (r - 1)/N."""
    if weights is None:
        weights = torch.ones_like(pos_scores)
    w = weights.float()
    gt = (neg_scores > pos_scores[:, None]).sum(dim=1)
    eq = (neg_scores == pos_scores[:, None]).sum(dim=1)
    rank = 1.0 + gt + 0.5 * eq                      # [B] f32
    out: Dict[str, torch.Tensor] = {}
    for k in ks:
        hit = rank <= k
        out[f"hr@{k}"] = (hit.float() * w).sum()
        ndcg = torch.where(hit, 1.0 / torch.log2(1.0 + rank), 0.0)
        out[f"ndcg@{k}"] = (ndcg * w).sum()
    out["mrr"] = (w / rank).sum()
    N = neg_scores.shape[1]
    out["gauc"] = ((1.0 - (rank - 1.0) / N) * w).sum()
    out["wsum"] = w.sum()
    return out


def ranking_metrics(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
                    ks: Sequence[int] = (1, 5, 10),
                    weights: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """HR@K / NDCG@K / MRR / GAUC means over the weighted targets
    (`ranking_sums` over 'wsum')."""
    sums = ranking_sums(pos_scores, neg_scores, ks=ks, weights=weights)
    denom = sums.pop("wsum").clamp_min(1.0)
    return {k: v / denom for k, v in sums.items()}


def f16_bucket(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 bucket of a score at float16 resolution:
    clipped to +-6e4, -0 made +0, the float16 bits mapped to a total order
    on [0, 65536) (negatives reversed, non-negatives shifted up). Two
    scores share a bucket iff they round to the same float16."""
    x = x.float().clamp(-6.0e4, 6.0e4) + 0.0           # -0 -> +0
    bits = x.half().view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.where(bits >= 0x8000, 0xFFFF - bits, bits + 0x8000)


def score_hists(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
                weights: Optional[torch.Tensor], hist_pos: torch.Tensor,
                hist_neg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Add one block of scores into the two int32 [F16_BINS] AUC
    histograms, in place, and return them. weights [B]: 0/1 padding mask,
    broadcast over each target's N negatives. Counts are exact."""
    if weights is None:
        wi = torch.ones(pos_scores.shape[0], dtype=torch.int32,
                        device=pos_scores.device)
    else:
        wi = (weights > 0).to(torch.int32)
    hist_pos.index_add_(0, f16_bucket(pos_scores).long(), wi)
    N = neg_scores.shape[1]
    hist_neg.index_add_(0, f16_bucket(neg_scores).reshape(-1).long(),
                        wi.repeat_interleave(N))
    return hist_pos, hist_neg


def hist_auc(hist_pos: np.ndarray, hist_neg: np.ndarray) -> float:
    """Pooled tie-aware AUC from the two score histograms, on the host in
    f64: U = sum_b pos[b] (neg_below[b] + neg[b] / 2), AUC = U / (P N)."""
    hp = np.asarray(hist_pos, np.float64)
    hn = np.asarray(hist_neg, np.float64)
    p_total, n_total = hp.sum(), hn.sum()
    if p_total == 0 or n_total == 0:
        return 0.5
    neg_below = np.concatenate([[0.0], np.cumsum(hn)[:-1]])
    u = float(np.sum(hp * (neg_below + 0.5 * hn)))
    return u / (p_total * n_total)
