"""Plain reference of the streaming eval's metrics, from scores [N, 1 + K]
(the positive first) of N targets:

  rank   = 1 + #(neg > pos) + #(neg == pos) / 2
  hr@k   = mean [rank <= k];  ndcg@k = mean [rank <= k] / log2(1 + rank)
  mrr    = mean 1 / rank;     gauc   = mean 1 - (rank - 1) / K
  auc    = the pooled AUC of positives against negatives with scores
           bucketed at float16 resolution (equal float16 values tie),
           as the program defines its streaming AUC
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

BINS = 1 << 16


def f16_bucket(x: torch.Tensor) -> torch.Tensor:
    """An order-preserving bucket in [0, 65536) of each score's float16
    value (clipped to +-6e4, -0 taken as +0)."""
    x = x.float().clamp(-6.0e4, 6.0e4) + 0.0
    bits = x.half().view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.where(bits >= 0x8000, 0xFFFF - bits, bits + 0x8000)


def metrics(scores: torch.Tensor, ks: Sequence[int] = (1, 5, 10)
            ) -> Dict[str, float]:
    pos, neg = scores[:, 0].float(), scores[:, 1:].float()
    K = neg.shape[1]
    rank = (1.0 + (neg > pos[:, None]).sum(1).double()
            + 0.5 * (neg == pos[:, None]).sum(1).double())
    out = {}
    for k in ks:
        hit = rank <= k
        out[f"hr@{k}"] = float(hit.double().mean())
        out[f"ndcg@{k}"] = float(torch.where(
            hit, 1.0 / torch.log2(1.0 + rank), 0.0).mean())
    out["mrr"] = float((1.0 / rank).mean())
    out["gauc"] = float((1.0 - (rank - 1.0) / K).mean())
    hp = torch.bincount(f16_bucket(pos).long(), minlength=BINS)
    hn = torch.bincount(f16_bucket(neg).reshape(-1).long(), minlength=BINS)
    hp, hn = hp.cpu().numpy().astype(np.float64), \
        hn.cpu().numpy().astype(np.float64)
    below = np.concatenate([[0.0], np.cumsum(hn)[:-1]])
    out["auc"] = float(np.sum(hp * (below + 0.5 * hn))
                       / (hp.sum() * hn.sum()))
    return out
