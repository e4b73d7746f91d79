"""Plain PyTorch reference of the training steps: in-batch negatives with
importance weights, the weighted BCE with the tables' L2, gradients by
autograd, and Adam with stride-K table updates at a boosted rate.

  loss    = sum(bce(logit, label) * w) / max(sum(w), 1) over [B, 1 + k],
            w = 1 for the positive, iw[j] for a rolled positive j unless
            it equals the example's own, iw[j] = N / (I * count_j) over
            the train split (0 for an item absent from it)
  total   = loss + l2 * sum over tables of |T|^2, on table-update steps
  Adam    : one count for all leaves; m = b1 m + (1 - b1) g,
            v = b2 v + (1 - b2) g^2, p -= lr (m / (1 - b1^t)) /
            (sqrt(v / (1 - b2^t)) + eps), times the boost on tables;
            tables (and their moments) move only on steps where
            step % table_update_every == 0

It imports nothing of the program: the batches are the rows the train
split's epoch-0 permutation gives (numpy's default_rng((seed, 0))), and
the shifts are handed to it by the benchmark, as to the program.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from . import model as ref

B1, B2, EPS = 0.9, 0.999, 1e-8


def is_table(name: str) -> bool:
    return "table" in name


def importance_weights(items: torch.Tensor, num_items: int) -> torch.Tensor:
    cnt = torch.bincount(items.long(), minlength=num_items + 1).double()
    w = items.numel() / (num_items * cnt.clamp_min(1.0))
    return torch.where(cnt > 0, w, 0.0).float()


def batch_rows(n: int, batch: int, seed: int, steps: int) -> List[np.ndarray]:
    """The rows of the first `steps` batches of epoch 0: a permutation of
    the split by numpy's default_rng((seed, 0)), cut in order."""
    perm = np.random.default_rng((seed, 0)).permutation(n)
    return [perm[j * batch:(j + 1) * batch] for j in range(steps)]


def loss_of(model: dict, w, graph, users, items, slots, shifts, iw,
            q: Callable, half: bool = False) -> torch.Tensor:
    lg = ref.logits(model, w, graph, users, items[:, None], slots,
                    shifts=shifts, q=q)
    B, k = lg.shape[0], lg.shape[1] - 1
    negs = torch.stack([torch.roll(items, -s, 0) for s in shifts], dim=1)
    wneg = (negs != items[:, None]).float() * iw[negs.long()]
    weights = torch.cat([torch.ones(B, 1, device=lg.device), wneg], dim=1)
    labels = torch.zeros_like(lg)
    labels[:, 0] = 1.0
    ell = torch.nn.functional.binary_cross_entropy_with_logits(
        lg, labels, reduction="none")
    if half:            # the fault: half of the batch left out
        ell, weights = ell[:B // 2], weights[:B // 2]
    return (ell * weights).sum() / weights.sum().clamp_min(1.0)


def run_steps(cfg: dict, w0: Dict[str, torch.Tensor], graph, split: dict,
              num_items: int, batch: int, seed: int,
              shifts: Sequence[Sequence[int]], steps: int,
              q: Callable = ref.round_to(None), half: bool = False) -> dict:
    """`steps` steps from weights w0 (left as they are). Returns {loss:
    [steps] floats, grad0: {leaf: norm of step 0's gradient}, change:
    {leaf: norm of the weights' change after the steps}}. `half` plants a
    fault: each loss the mean over the first half of the batch."""
    model, tc = cfg["model"], cfg["train"]
    stride, boost = tc["table_update_every"], tc["table_lr_boost"]
    lr, l2 = tc["learning_rate"], tc["l2_emb"]
    iw = importance_weights(split["item"], num_items)
    w = {k: v.detach().clone() for k, v in w0.items()}
    mom = {k: torch.zeros_like(v) for k, v in w.items()}
    vel = {k: torch.zeros_like(v) for k, v in w.items()}
    rows = batch_rows(split["user"].numel(), batch, seed, steps)
    out = dict(loss=[], grad0={}, change={})
    for step in range(steps):
        full = stride <= 1 or step % stride == 0
        names = [k for k in w if full or not is_table(k)]
        leaves = {k: (v.requires_grad_(True) if k in names else v)
                  for k, v in w.items()}
        idx = torch.from_numpy(rows[step]).to(split["user"].device)
        u, i, t = (split[c][idx] for c in ("user", "item", "slot"))
        loss = loss_of(model, leaves, graph, u, i, t, shifts[step], iw, q,
                       half)
        total = loss
        if full and l2 > 0:
            total = loss + l2 * sum(leaves[k].square().sum()
                                    for k in leaves if is_table(k))
        grads = torch.autograd.grad(total, [leaves[k] for k in names])
        out["loss"].append(float(loss.detach()))
        if step == 0:
            out["grad0"] = {k: float(g.norm()) for k, g in zip(names, grads)}
        count = step + 1
        bc1, bc2 = 1.0 - B1 ** count, 1.0 - B2 ** count
        with torch.no_grad():
            for k, g in zip(names, grads):
                mom[k].mul_(B1).add_(g, alpha=1 - B1)
                vel[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                upd = (mom[k] / bc1) / ((vel[k] / bc2).sqrt() + EPS)
                w[k] = w[k].detach() - lr * (boost if is_table(k) else 1.0
                                             ) * upd
        w = {k: v.detach() for k, v in w.items()}
    out["change"] = {k: float((w[k] - w0[k]).norm()) for k in w}
    return out


def leaf_gaps(prog: Dict[str, float], refn: Dict[str, float],
              skip: Sequence[str] = ()) -> Dict[str, float]:
    """Each leaf's | |prog| - |ref| | over max(|ref|, the median leaf's
    |ref|); leaves in `skip` left out."""
    keys = [k for k in refn if k not in skip]
    med = float(np.median([refn[k] for k in keys]))
    return {k: abs(prog[k] - refn[k]) / max(refn[k], med, 1e-30)
            for k in keys}


def leaf_gap(prog: Dict[str, float], refn: Dict[str, float],
             skip: Sequence[str] = ()) -> tuple:
    """The worst leaf's gap (`leaf_gaps`), and that leaf."""
    gaps = leaf_gaps(prog, refn, skip)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def median_leaf_gap(prog: Dict[str, float], refn: Dict[str, float],
                    skip: Sequence[str] = ()) -> float:
    """The median over the leaves of their gaps (`leaf_gaps`)."""
    return float(np.median(list(leaf_gaps(prog, refn, skip).values())))


def quiet_leaves(grad0: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is under a thousandth of the
    median leaf's: they move under Adam by round-off alone."""
    med = float(np.median(list(grad0.values())))
    return [k for k, v in grad0.items() if v < 1e-3 * med]
