"""Training: the configs3 train step, a K-step loop, and streaming eval.

Counterpart of score_tpu/train.py (make_optimizer, item_importance_weights,
_table_l2, the train step of _make_train_step_fn with in-batch negatives
and stride-K table updates, the train loop, make_eval_step, _eval_accum
and evaluate) for the path `bench.py` trains: in-batch
importance-weighted negatives, Adam at a constant learning rate,
`table_update_every` and `table_lr_boost`; any co-attention pool:

    state = init_state(cfg, ds.num_users, ds.num_items, state_dict)
    graph = device_graph(ds.graph, state.device)
    neg_iw = torch.from_numpy(item_importance_weights(ds.train,
                                                      ds.num_items))
    state, metrics = train_step(state, graph, batch, neg_iw=neg_iw)
    metrics = evaluate(make_eval_step(state.model), graph, ds.val)

Everything runs on `device`, the CUDA card unless the caller asks for
another. The parameters and Adam moments are updated in place. The step
never waits for the device: metrics come back as device tensors.

Left out, and refused where a config asks for them: uniform negatives,
neighbour re-sampling, optimizers other than Adam, learning-rate
schedules, scorer dropout, sharded layouts and non-f32 parameters; the
`train()` driver, checkpoints and the CLI are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config
from .data.pipeline import eval_index_batches
from .graph import DeviceGraph, gather_candidate_batch
from .metrics import (F16_BINS, auc, hist_auc, rank_sum_keys, ranking_sums,
                      score_hists)
from .nn.model import ScoreModel, check_config
from .nn.scorer import bce_loss
from .params import cast_tables


def is_table(name: str) -> bool:
    """The reference's path rule for embedding tables (L2, stride-K,
    table_lr_boost): a parameter whose name contains 'table'."""
    return "table" in name


def item_importance_weights(train_split, num_items: int) -> np.ndarray:
    """Per-item importance weights for train_neg_mode='inbatch_iw':
    w_j = uniform(j) / q(j), q the in-batch negative distribution (the
    train split's item popularity). E_q[w] = 1. Items absent from the
    train split never appear as in-batch negatives; their weight is 0."""
    cnt = np.bincount(np.asarray(train_split.item),
                      minlength=num_items + 1).astype(np.float64)
    w = train_split.item.size / (num_items * np.maximum(cnt, 1.0))
    w[cnt == 0] = 0.0
    return w.astype(np.float32)


class Adam:
    """optax.adam(lr) at a constant lr, chained with optax.masked(scale(
    table_lr_boost)) on the table updates, written out with one step count
    shared by all parameters, as optax keeps it. On a step that updates
    only some parameters (a dense step of stride-K training) the count
    still advances, and the others' values and moments stay bit-unchanged;
    torch.optim.Adam's per-parameter step would give their next update
    another bias correction. The arithmetic follows optax's order:
    mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu,
    u = -lr * (mu / bc1) / (sqrt(nu / bc2) + eps), times the boost on
    tables, p = p + u."""

    def __init__(self, params: Mapping[str, torch.Tensor], lr: float,
                 table_lr_boost: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = dict(params)
        self.lr, self.boost = float(lr), float(table_lr_boost)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0

    def load_state(self, count: int, mu: Mapping[str, torch.Tensor],
                   nu: Mapping[str, torch.Tensor]) -> None:
        """Start from a given count and moments (e.g. an optax state
        through score_tpu_torch.params.opt_state_from_optax)."""
        self.count = int(count)
        for k, p in self.params.items():
            self.mu[k] = mu[k].to(p.device, p.dtype).clone()
            self.nu[k] = nu[k].to(p.device, p.dtype).clone()

    def _bias_correction(self, decay: float) -> float:
        # f32, as optax computes 1 - decay**count
        return float(np.float32(1) - np.float32(decay) ** np.int32(self.count))

    @torch.no_grad()
    def step(self, names: Sequence[str],
             grads: Sequence[torch.Tensor]) -> None:
        """Update the parameters `names` with `grads`; the count advances
        once."""
        self.count += 1
        bc1 = self._bias_correction(self.b1)
        bc2 = self._bias_correction(self.b2)
        grads = list(grads)
        ps = [self.params[k] for k in names]
        mus = [self.mu[k] for k in names]
        nus = [self.nu[k] for k in names]
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - self.b1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - self.b2)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_add_(nus, g2)
        upd = torch._foreach_div(mus, bc1)
        den = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -self.lr)
        if self.boost != 1.0:
            tables = [u for k, u in zip(names, upd) if is_table(k)]
            if tables:
                torch._foreach_mul_(tables, self.boost)
        torch._foreach_add_(ps, upd)


def make_optimizer(cfg: Config, params: Mapping[str, torch.Tensor]) -> Adam:
    """The optimizer of TrainConfig: Adam at a constant learning rate, with
    table_lr_boost. Other optimizers and schedules are not ported yet."""
    tc = cfg.train
    if tc.optimizer != "adam" or tc.lr_schedule != "constant" or \
            tc.warmup_steps:
        raise NotImplementedError(
            f"score_tpu_torch trains with adam at a constant lr only; got "
            f"optimizer={tc.optimizer!r} lr_schedule={tc.lr_schedule!r} "
            f"warmup_steps={tc.warmup_steps}")
    return Adam(params, tc.learning_rate, tc.table_lr_boost)


def table_l2(model: torch.nn.Module) -> torch.Tensor:
    """Sum of squares over the embedding tables (the paper's λ‖Emb‖²)."""
    return sum(p.square().sum() for k, p in model.named_parameters()
               if is_table(k))


@dataclasses.dataclass
class TrainState:
    """The model (f32 master weights), its optimizer and the host-side
    step counter; `generator` draws the in-batch shifts a step is not
    given."""

    cfg: Config
    model: ScoreModel
    opt: Adam
    generator: torch.Generator
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def check_trainable(cfg: Config) -> None:
    """Raise NotImplementedError for what the port does not train yet."""
    check_config(cfg)
    if cfg.data.train_neg_mode not in ("inbatch", "inbatch_iw"):
        raise NotImplementedError(
            f"score_tpu_torch trains with in-batch negatives only; got "
            f"train_neg_mode={cfg.data.train_neg_mode!r}")
    if cfg.data.neighbor_resample:
        raise NotImplementedError("neighbor_resample is not ported yet")
    if cfg.model.dropout > 0:
        raise NotImplementedError("scorer dropout is not ported yet")


def init_state(cfg: Config, num_users: int, num_items: int,
               state_dict: Mapping[str, torch.Tensor], device="cuda",
               opt_state: Optional[Mapping] = None) -> TrainState:
    """A TrainState on `device` from f32 weights (`params.init_params` or
    `params.from_flax`), and optionally an optimizer state
    {count, mu, nu} to start from. A restored state resumes at step
    `count`, as the reference's restored TrainState carries its step, so
    stride-K table updates fall on the same steps."""
    check_trainable(cfg)
    model = ScoreModel(cfg.model, num_users, num_items)
    model.load_state_dict({k: v.to(device=device, dtype=torch.float32)
                           for k, v in state_dict.items()}, assign=True)
    model.train()
    opt = make_optimizer(cfg, dict(model.named_parameters()))
    if opt_state is not None:
        opt.load_state(**opt_state)
    return TrainState(cfg=cfg, model=model, opt=opt,
                      generator=torch.Generator().manual_seed(cfg.train.seed),
                      step=opt.count)


def draw_shifts(generator: torch.Generator, k: int, B: int) -> List[int]:
    """k distinct in-batch shifts in [1, max(B, 2)), as the reference draws
    them (with its own random bits)."""
    hi = max(B, 2)
    if k > hi - 1:
        raise ValueError(f"{k} distinct shifts need a batch of > {k}")
    return (torch.randperm(hi - 1, generator=generator)[:k] + 1).tolist()


def _as_device(x, device) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x.to(device=device, dtype=torch.int32)


def train_step(state: TrainState, graph: DeviceGraph, batch: Mapping,
               shifts: Optional[Sequence[int]] = None,
               neg_iw: Optional[torch.Tensor] = None,
               with_auc: bool = True) -> Tuple[TrainState, Dict]:
    """One step on batch {user, item, slot} [B]: in-batch negatives from
    `shifts` (k ints in [1, B); drawn from state.generator if None), the
    weighted BCE plus L2 on the tables, gradients and Adam. Tables and
    their moments update only on steps with step % table_update_every ==
    0; on the others no table gradient is computed at all (the
    reference's stop_gradient). Returns the state (updated in place) and
    {loss, batch_auc} (or {loss, logits, weights} without AUC), as device
    tensors."""
    cfg, model = state.cfg, state.model
    dev = state.device
    k = cfg.data.num_train_neg
    u, i, t = (_as_device(batch[key], dev) for key in ("user", "item",
                                                        "slot"))
    B = u.shape[0]
    if shifts is None:
        shifts = draw_shifts(state.generator, k, B)
    shifts = [int(s) for s in shifts]
    if len(shifts) != k:
        raise ValueError(f"{len(shifts)} shifts for {k} negatives")
    labels = torch.cat([torch.ones(B, 1, device=dev),
                        torch.zeros(B, k, device=dev)], dim=1)
    negs = torch.stack([torch.roll(i, -s, 0) for s in shifts], dim=1)
    # a rolled positive equal to the example's own positive drops out
    neg_w = (negs != i[:, None]).float()
    if cfg.data.train_neg_mode == "inbatch_iw":
        if neg_iw is None:
            raise ValueError("inbatch_iw needs neg_iw = "
                             "item_importance_weights(ds.train, ...)")
        neg_w = neg_w * neg_iw.to(dev)[negs.long()]
    weights = torch.cat([torch.ones(B, 1, device=dev), neg_w], dim=1)

    stride = cfg.train.table_update_every
    full = stride <= 1 or state.step % stride == 0
    names = [n for n, _ in model.named_parameters() if full or not is_table(n)]
    mb = gather_candidate_batch(graph, u, i[:, None], t)
    logits = model.score_candidates(mb, neg_shift=shifts)
    loss = bce_loss(logits, labels, weights)
    total = loss
    if full and cfg.train.l2_emb > 0:
        total = loss + cfg.train.l2_emb * table_l2(model)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(total, [params[n] for n in names])
    state.opt.step(names, grads)
    state.step += 1
    out = {"loss": loss.detach()}
    logits = logits.detach()
    if with_auc:
        out["batch_auc"] = auc(logits.reshape(-1), labels.reshape(-1),
                               weights.reshape(-1))
    else:
        out.update(logits=logits, weights=weights)
    return state, out


def train_loop(state: TrainState, graph: DeviceGraph,
               batches: Sequence[Mapping],
               shifts_list: Optional[Sequence[Sequence[int]]] = None,
               neg_iw: Optional[torch.Tensor] = None
               ) -> Tuple[TrainState, Dict]:
    """K steps, one per batch, each as `train_step` (the same results as K
    sequential calls); the batch AUC once, from the last step's logits,
    as the reference's fused loop reports it. Returns the state and
    {loss [K], batch_auc [1]} as device tensors."""
    if not batches:
        raise ValueError("train_loop needs at least one batch")
    losses = []
    for j, batch in enumerate(batches):
        shifts = None if shifts_list is None else shifts_list[j]
        state, m = train_step(state, graph, batch, shifts, neg_iw,
                              with_auc=False)
        losses.append(m["loss"])
    labels = torch.zeros_like(m["logits"])
    labels[:, 0] = 1.0
    batch_auc = auc(m["logits"].reshape(-1), labels.reshape(-1),
                    m["weights"].reshape(-1))
    return state, {"loss": torch.stack(losses), "batch_auc": batch_auc[None]}


def make_eval_step(model: ScoreModel) -> Callable:
    """eval_step(graph, batch) scores each positive against its fixed
    negatives: batch {user, item, slot [B], neg [B, N]} -> logits
    [B, 1 + N], the positive first. It runs an inference copy of `model`
    (`eval_step.model`): a snapshot of every weight as it stands now, the
    tables cast once by `params.cast_tables` as serving casts them. In f32
    and in bf16 alike, later training does not reach the copy, so make a
    new step to evaluate the updated model."""
    em = ScoreModel(model.cfg, model.num_users, model.num_items)
    sd = cast_tables(model.state_dict(), model.cfg.compute_dtype)
    em.load_state_dict({k: v.detach().clone() for k, v in sd.items()},
                       assign=True)
    em.eval()

    @torch.inference_mode()
    def eval_step(graph: DeviceGraph, batch: Mapping) -> torch.Tensor:
        cand = torch.cat([batch["item"][:, None], batch["neg"]], dim=1)
        mb = gather_candidate_batch(graph, batch["user"], cand,
                                    batch["slot"])
        return em.score_candidates(mb)

    eval_step.model = em
    return eval_step


def _eval_accum(scores: torch.Tensor, w: torch.Tensor, carry: Dict,
                bidx: int, ks: Sequence[int]) -> None:
    """Fold one block of eval scores into the streaming carry, on the
    device and in place: the two AUC histograms add (exact int32), and the
    block's ranking sums fill row `bidx` of carry['msums'], so no f32
    accumulator holds more than one block."""
    pos = scores[:, 0].float()
    neg = scores[:, 1:].float()
    sums = ranking_sums(pos, neg, ks=ks, weights=w)
    carry["msums"][bidx] = torch.stack([sums[k] for k in rank_sum_keys(ks)])
    score_hists(pos, neg, w, carry["hist_pos"], carry["hist_neg"])


def evaluate(eval_step: Callable, graph: DeviceGraph, targets,
             batch_size: int = 256, ks: Sequence[int] = (1, 5, 10),
             max_targets: Optional[int] = None) -> Dict[str, float]:
    """Streaming split evaluation: the pooled AUC and the per-target
    ranking metrics of `targets` (user, item, slot, neg), as the
    reference's evaluate.

    Fixed-size blocks from `data.pipeline.eval_index_batches` (the ragged
    tail padded with weight 0) are scored back to back; each folds into
    the device-resident carry (two F16_BINS histograms and one row of
    ranking sums per block), which is read back once at the end and
    reduced in f64 on the host. `max_targets` scores a subsample drawn
    with a fixed seed (np.random.default_rng(0)), the same every run."""
    n = len(targets)
    sel = None
    if max_targets is not None and n > max_targets:
        sel = np.random.default_rng(0).choice(n, max_targets, replace=False)
        n = max_targets
    cols = {k: (getattr(targets, k) if sel is None
                else getattr(targets, k)[sel])
            for k in ("user", "item", "slot", "neg")}
    dev = graph.u2i.device
    names = rank_sum_keys(tuple(ks))
    n_blocks = -(-n // batch_size)
    carry = dict(hist_pos=torch.zeros(F16_BINS, dtype=torch.int32,
                                      device=dev),
                 hist_neg=torch.zeros(F16_BINS, dtype=torch.int32,
                                      device=dev),
                 msums=torch.zeros(n_blocks, len(names), device=dev))
    for bi, (idx, w) in enumerate(eval_index_batches(n, batch_size)):
        batch = {k: _as_device(v[idx], dev) for k, v in cols.items()}
        scores = eval_step(graph, batch)
        _eval_accum(scores, torch.from_numpy(w).to(dev), carry, bi, ks)
    carry = {k: v.cpu().numpy() for k, v in carry.items()}   # one readback
    sums = carry["msums"].astype(np.float64).sum(axis=0)
    by_name = dict(zip(names, sums))
    denom = max(by_name.pop("wsum"), 1.0)
    out = {k: float(v / denom) for k, v in by_name.items()}
    out["auc"] = hist_auc(carry["hist_pos"], carry["hist_neg"])
    return out
