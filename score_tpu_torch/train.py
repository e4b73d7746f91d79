"""Training: the train step of the configs0-3 rungs and of the baseline
roster, a K-step loop, streaming eval, and the train/eval driver with
checkpoints and its CLI.

Counterpart of score_tpu/train.py (build_model, make_optimizer,
item_importance_weights, _table_l2, _resample_collisions, the train step
of _make_train_step_fn with uniform or in-batch negatives, per-step
neighbour re-sampling, scorer dropout and stride-K table updates, the
train loop, make_eval_step, _eval_accum, evaluate, train and main):
uniform negatives with collision resampling (every preset's default) or
in-batch (importance-weighted) ones; adam, adamw, adagrad or sgd at a
constant, linear-warmup or warmup-cosine learning rate (`optim.py`), with
`table_update_every` and `table_lr_boost`; any rung of the preset ladder,
any co-attention pool, and the baseline roster (the eight `baseline_*`
presets: MF, popularity, SVD++, DELF, and GRU4Rec, Caser, SASRec and RRN
as ScoreModel's flag sets), each model built by `build_model`:

    out = train(cfg, ds, device="cuda")    # epochs, val, early stop, test

or step by step:

    state = init_state(cfg, ds.num_users, ds.num_items, state_dict)
    graph = device_graph(ds.graph, state.device)
    neg_iw = torch.from_numpy(item_importance_weights(ds.train,
                                                      ds.num_items))
    state, metrics = train_step(state, graph, batch, neg_iw=neg_iw)
    metrics = evaluate(make_eval_step(state.model), graph, ds.val)

CLI:  python -m score_tpu_torch.train <preset> [data_dir] [--device cpu]
          [section.key=value ...]

Everything runs on `device`, the CUDA card unless the caller asks for
another. The parameters and optimizer state are updated in place. The
step never waits for the device: metrics come back as device tensors,
and dropout masks and re-sampling keys are drawn on the device from
generators seeded by (seed, step), so a resumed run draws the same ones.

Under a (data, rows) mesh (`sharding.bringup`) a sharded config (configs4)
trains as the reference's does under its mesh: `init_state(...,
mesh=mesh)` row-shards the tables and their optimizer state, and
`train_step` takes this rank's rows of the global batch and gives what
the unsharded step gives on the whole batch; the graph is row-sharded
too (`graph.mesh_graph`). `make_eval_step(model, mesh)` and `evaluate`
score each rank's share of every block and all-reduce the carry, so
every rank reads the same metrics; `train(cfg, ds, mesh=mesh)` (or under
`python -m torch.distributed.run`, which it joins) runs the driver with
sharded `latest` and `best` checkpoints:

    python -m torch.distributed.run --nproc-per-node 4 \
        -m score_tpu_torch.train configs4 <data_dir> \
        sharding.num_data=2 sharding.num_rows=2

With model.param_dtype 'bfloat16' ScoreModel's tables, and their
optimizer state, are bf16, as the reference's are (`optim.py` does
optax's bf16 arithmetic on them; their gradients come from the
scatter-add's bf16 form); every other leaf, and the baseline archs'
tables, stay f32.

Left out, and refused where a config asks for it: a sharded config
without a mesh (it is never run unsharded). In-batch negatives on a
baseline arch raise ValueError, as the reference's step does: those
archs score the positive alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .checkpoint import CheckpointManager, apply_restore
from .config import PRESETS, Config, apply_overrides
from .data.pipeline import TargetIterator, eval_index_batches
from .data.schema import Dataset
from .graph import (DeviceGraph, device_graph, gather_candidate_batch,
                    mesh_graph, subsample_neighbors)
from .metrics import (F16_BINS, auc, hist_auc, rank_sum_keys, ranking_sums,
                      score_hists)
from .nn.embed import EmbeddingTables
from .nn.model import (build_model, check_config, check_device,
                       stored_fanouts)
from .nn.scorer import bce_loss
from .optim import Optimizer, constant, is_table, make_optimizer
from .params import assign_weights, cast_tables, init_params
from .profiling import maybe_profile
from .sharding import (Mesh, ShardedLookup, all_gather_world, bringup,
                       make_lookup_fn, shard_state, state_spec)


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


def table_l2(model: torch.nn.Module,
             l2_emb: Optional[float] = None) -> torch.Tensor:
    """Sum of squares over the embedding tables (the paper's λ‖Emb‖²) in
    their dtype (of bf16 tables a bf16 sum, as the reference's jnp.sum of
    a bf16 square is); with `l2_emb`, times that rounded to the same
    dtype, as the reference's weak-typed constant is."""
    total = sum(p.square().sum() for k, p in model.named_parameters()
                if is_table(k))
    return total if l2_emb is None else constant(l2_emb, total.dtype) * total


@dataclasses.dataclass
class TrainState:
    """The model (f32 weights, and its tables in param_dtype), its
    optimizer and the host-side step counter; `generator` draws the
    in-batch shifts or the uniform negatives a step is not given. Under a
    `mesh` the tables and their optimizer state are this rank's row
    blocks."""

    cfg: Config
    model: torch.nn.Module
    opt: Optimizer
    generator: torch.Generator
    step: int = 0
    mesh: Optional[Mesh] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def check_trainable(cfg: Config, mesh: Optional[Mesh] = None) -> None:
    """Raise NotImplementedError for what the port does not train (a
    sharded layout without a mesh: `check_config`),
    and ValueError for in-batch negatives on a baseline arch: its
    score_candidates ignores the shifts and scores the positive alone, so
    its [B, 1] logits cannot meet [B, 1 + k] labels (the reference's step
    raises on the same shapes)."""
    check_config(cfg, mesh)
    if cfg.model.arch != "score" and cfg.data.train_neg_mode != "uniform":
        raise ValueError(
            f"arch {cfg.model.arch!r} scores no in-batch negatives "
            f"(train_neg_mode={cfg.data.train_neg_mode!r}); use 'uniform'")


def init_state(cfg: Config, num_users: int, num_items: int,
               state_dict: Mapping[str, torch.Tensor], device="cuda",
               opt_state: Optional[Mapping] = None,
               steps_per_epoch: int = 0,
               mesh: Optional[Mesh] = None) -> TrainState:
    """A TrainState on `device` from weights (`params.init_params` or
    `params.from_flax`), each loaded in its parameter's dtype (the tables
    in param_dtype, the rest f32), and optionally an optimizer state to
    start from ({count, and the optimizer's state dicts}: a checkpoint's, or
    `params.opt_state_from_optax`). A restored state resumes at step
    `count`, as the reference's restored TrainState carries its step, so
    stride-K table updates and the schedule fall on the same steps.
    `steps_per_epoch` sets a cosine schedule's horizon when
    cfg.train.decay_steps is 0, as the reference's init_state does.

    Under a `mesh` (whose shape is cfg.sharding's) the model looks its
    tables up through cfg.sharding.lookup_mode's exchange, and the whole
    weights and optimizer state given are cut to this rank's row blocks
    (`sharding.shard_state`)."""
    check_trainable(cfg, mesh)
    check_device(cfg, device)
    lookup_fn = None
    if mesh is not None:
        lookup_fn = make_lookup_fn(mesh, cfg.sharding.lookup_mode,
                                   cfg.sharding.a2a_capacity)
    model = build_model(cfg, num_users, num_items, lookup_fn)
    dtypes = {k: p.dtype for k, p in model.named_parameters()}
    model.load_state_dict({k: v.to(device=device, dtype=dtypes.get(k))
                           for k, v in state_dict.items()}, assign=True)
    model.train()
    opt = make_optimizer(cfg, dict(model.named_parameters()),
                         steps_per_epoch)
    if opt_state is not None:
        opt.load_state(**opt_state)
    state = TrainState(cfg=cfg, model=model, opt=opt,
                       generator=torch.Generator().manual_seed(
                           cfg.train.seed),
                       step=opt.count)
    return state if mesh is None else shard_state(mesh, state)


def draw_shifts(generator: torch.Generator, k: int, B: int) -> List[int]:
    """k distinct in-batch shifts in [1, max(B, 2)), as the reference draws
    them (with its own random bits)."""
    hi = max(B, 2)
    if k > hi - 1:
        raise ValueError(f"{k} distinct shifts need a batch of > {k}")
    return (torch.randperm(hi - 1, generator=generator)[:k] + 1).tolist()


def _step_generator(seed: int, step: int, stream: int = 0,
                    device="cpu") -> torch.Generator:
    """The counterpart of the reference's fold_in(PRNGKey(seed), step)
    (stream 0: the host's shifts and negatives), and of folding 1
    (dropout masks) or 2 (re-sampling keys) into it: a generator on
    `device` for each."""
    g = torch.Generator(device=device)
    if stream == 0:
        return g.manual_seed(((seed & 0xFFFFFFFF) << 32)
                             | (step & 0xFFFFFFFF))
    words = np.random.SeedSequence(
        [seed & 0xFFFFFFFF, step & 0xFFFFFFFF, stream]).generate_state(2)
    return g.manual_seed(int(words[0]) << 32 | int(words[1]))


def step_shifts(seed: int, step: int, k: int, B: int) -> List[int]:
    """The shifts `train` draws for step `step` by default: from a
    generator seeded by (seed, step), so a resumed run draws the same
    shifts with no generator state in its checkpoint."""
    return draw_shifts(_step_generator(seed, step), k, B)


def draw_negatives(generator: torch.Generator, B: int, k: int,
                   num_items: int) -> torch.Tensor:
    """[B, k] int32 iid uniform item ids in [1, num_items] on the host, as
    the reference draws them (with its own random bits): the raw draws,
    before `resample_collisions`."""
    return torch.randint(1, num_items + 1, (B, k), generator=generator,
                         dtype=torch.int32)


def step_negatives(seed: int, step: int, B: int, k: int,
                   num_items: int) -> torch.Tensor:
    """The uniform negatives `train` draws for step `step` by default, from
    the generator `step_shifts` seeds: a resumed run draws the same ones."""
    return draw_negatives(_step_generator(seed, step), B, k, num_items)


def resample_collisions(neg: torch.Tensor, pos: torch.Tensor,
                        num_items: int) -> torch.Tensor:
    """A negative equal to its positive moves to the next id, and one past
    num_items wraps to 1 (id 0 is the pad item)."""
    shifted = neg + (neg == pos).to(neg.dtype)
    return torch.where(shifted > num_items, torch.ones_like(shifted),
                       shifted)


def _as_device(x, device) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x.to(device=device, dtype=torch.int32)


def _resample(cfg: Config, mb: dict, keys, seed: int, step: int,
              rows: slice = slice(None), n: Optional[int] = None,
              cand_rows=None) -> dict:
    """DataConfig.neighbor_resample: each step draws a fresh uniform
    subset of the stored histories (u_hist [B, T, S], i_hist [B, C, T, S])
    down to the model's fan-outs, on the device, as the reference's
    _resample does after its gather. `keys` (u_keys, i_keys) are uniform
    draws of the whole batch's histories ([n, ...]; n defaults to mb's
    rows); None draws them from the step's re-sampling generator. This
    rank's keys are rows `rows` of them (default all); with `cand_rows`
    ([B, C] batch rows: the sharded step's in-batch candidates) the item
    side's are those rows' positives' keys, as the unsharded step
    re-samples the positives' histories before its rolls."""
    if not cfg.data.neighbor_resample:
        return mb
    mb = dict(mb)
    sides = [("u_hist", "u_cnt", cfg.data.user_fanout)]
    if "i_hist" in mb:         # a model of sides='user' gathers no items
        sides.append(("i_hist", "i_cnt", cfg.data.item_fanout))
    gen = None
    for j, (hist, cnt, k) in enumerate(sides):
        h = mb[hist]
        rolled = j == 1 and cand_rows is not None
        if keys is not None:
            key = keys[j].to(h.device)
        else:
            if gen is None:
                gen = _step_generator(seed, step, 2, h.device)
            rows_all = n or h.shape[0]
            shape = ((rows_all, 1, *h.shape[2:]) if rolled
                     else (rows_all, *h.shape[1:]))
            key = torch.rand(shape, generator=gen, device=h.device)
        key = key[cand_rows, 0] if rolled else key[rows]
        mb[hist], mb[cnt] = subsample_neighbors(h, mb[cnt], k, key)
    return mb


def _dropout_masks(cfg: Config, seed: int, step: int, n: int, C: int,
                   device) -> List[torch.Tensor]:
    """The scorer's dropout masks of a step, one [n, C, width] bool mask a
    hidden layer, from the step's dropout generator (keep where a uniform
    draw falls below the keep probability)."""
    gen = _step_generator(seed, step, 1, device)
    keep = 1.0 - cfg.model.dropout
    return [torch.rand(n, C, w, generator=gen, device=device) < keep
            for w in cfg.model.mlp_dims]


def _bce_share(logits: torch.Tensor, labels: torch.Tensor,
               weights: Optional[torch.Tensor]) -> torch.Tensor:
    """This rank's share of the whole batch's weighted BCE, sum(l * w) /
    max(sum(w), 1) with the denominator summed over the world (it carries
    no gradient): the shares add up to the loss, and their gradients to
    its gradient."""
    ell = torch.nn.functional.binary_cross_entropy_with_logits(
        logits, labels, reduction="none")
    w = torch.ones_like(ell) if weights is None else weights
    den = w.sum()
    dist.all_reduce(den)
    return (ell * w).sum() / den.clamp_min(1.0)


def _sum_grads(mesh: Mesh, params: Mapping[str, torch.Tensor],
               names: Sequence[str],
               grads: Sequence[Optional[torch.Tensor]]) -> list:
    """The whole batch's gradients from each rank's: dense parameters
    summed over the world, table blocks over the data group (the exchange
    has already summed the rows group's), each group's in one flat
    all-reduce a dtype (bf16 tables' gradients in bf16, as the
    reference's GSPMD step reduces them). A gradient a rank does not
    reach is its zeros: a table only the L2 reaches has one on data block
    0 alone."""
    grads = [torch.zeros_like(params[k]) if g is None else g
             for k, g in zip(names, grads)]
    parts = {}
    for j, k in enumerate(names):
        sharded = bool(state_spec(k, params[k]))
        parts.setdefault((sharded, grads[j].dtype), []).append(j)
    # dense parameters first, then table blocks, in one order on every rank
    for (sharded, _), idx in sorted(parts.items(), key=lambda kv: kv[0][0]):
        group = mesh.data_group if sharded else None
        flat = torch.cat([grads[j].reshape(-1) for j in idx])
        dist.all_reduce(flat, group=group)
        lo = 0
        for j in idx:
            size = grads[j].numel()
            grads[j] = flat[lo:lo + size].view_as(grads[j])
            lo += size
    return grads


def take_overflow(model: torch.nn.Module) -> Optional[torch.Tensor]:
    """The a2a lookups' overflow counts since the last call, summed over
    the model's tables (None where no table recorded one), and reset."""
    total = None
    for m in model.modules():
        if isinstance(m, EmbeddingTables):
            if m.overflow is not None:
                total = m.overflow if total is None else total + m.overflow
            m.overflow = None
    return total


def train_step(state: TrainState, graph: DeviceGraph, batch: Mapping,
               shifts: Optional[Sequence[int]] = None,
               neg_iw: Optional[torch.Tensor] = None,
               with_auc: bool = True, negatives=None,
               dropout_masks: Optional[Sequence[torch.Tensor]] = None,
               resample_keys: Optional[Sequence[torch.Tensor]] = None
               ) -> Tuple[TrainState, Dict]:
    """One step on batch {user, item, slot} [B]: the negatives of
    cfg.data.train_neg_mode, the BCE plus L2 on the tables, gradients and
    the optimizer's update.

    'uniform': `negatives` are the raw [B, k] draws in [1, num_items]
    (drawn from state.generator if None); a draw equal to its positive is
    moved by `resample_collisions`, and [positive | k negatives] are
    scored in the candidates form, each negative with its own item-side
    history, all weights 1. 'inbatch' and 'inbatch_iw': in-batch negatives
    from `shifts` (k ints in [1, B); drawn from state.generator if None),
    a rolled positive equal to the example's own dropping out of the
    weighted BCE, importance-weighted by `neg_iw` with 'inbatch_iw'.

    With cfg.data.neighbor_resample the gathered histories are re-sampled
    to cfg.data's fan-outs (`resample_keys`: the user and item sides'
    uniform keys; drawn on the device if None). With cfg.model.dropout >
    0 the scorer drops hidden activations (`dropout_masks`: one bool mask
    a hidden layer, [B, C, width]; drawn on the device if None); the
    baseline archs have no scorer and ignore it, as the reference's do.

    Under state.mesh, `batch` is this rank's rows of a global batch of
    B x world examples (its rank's block), and every draw above, given
    or drawn, is the global batch's (shifts in [1, B x world), negatives,
    masks and keys of its shape), of which the rank keeps its rows. The
    in-batch rolls cross ranks: the global positives' ids are
    all-gathered and each row scores [positive | rolled positives] as
    candidates. The step equals the unsharded step on the global batch:
    the loss is the global weighted mean, the L2 counts each table row
    once, the gradients are summed (dense over the world, table blocks
    over the data group), and the metrics (with the batch AUC's logits)
    are the global batch's, with `a2a_overflow`, the step's lookups'
    summed overflow.

    Tables and their optimizer state update only on steps with step %
    table_update_every == 0; on the others no table gradient is computed
    at all (the reference's stop_gradient). Returns the state (updated in
    place) and {loss, batch_auc} (or {loss, logits, weights} without AUC),
    as device tensors."""
    cfg, model, mesh = state.cfg, state.model, state.mesh
    dev = state.device
    k = cfg.data.num_train_neg
    u, i, t = (_as_device(batch[key], dev) for key in ("user", "item",
                                                        "slot"))
    B = u.shape[0]
    # this rank's rows of the n-example batch the draws are made for
    n = B * (1 if mesh is None else mesh.size)
    lo = 0 if mesh is None else B * mesh.rank
    rows = slice(lo, lo + B)
    labels = torch.cat([torch.ones(B, 1, device=dev),
                        torch.zeros(B, k, device=dev)], dim=1)
    neg_shift = cand_rows = None
    if cfg.data.train_neg_mode == "uniform":
        if negatives is None:
            negatives = draw_negatives(state.generator, n, k,
                                       model.num_items)
        neg = _as_device(negatives, dev)
        if neg.shape != (n, k):
            raise ValueError(f"negatives of shape {tuple(neg.shape)}; "
                             f"expected {(n, k)}")
        neg = resample_collisions(neg[rows], i[:, None], model.num_items)
        cand = torch.cat([i[:, None], neg], dim=1)
        weights = None
    else:
        if shifts is None:
            shifts = draw_shifts(state.generator, k, n)
        shifts = [int(s) for s in shifts]
        if len(shifts) != k:
            raise ValueError(f"{len(shifts)} shifts for {k} negatives")
        if mesh is None:
            negs = torch.stack([torch.roll(i, -s, 0) for s in shifts], dim=1)
            cand, neg_shift = i[:, None], shifts
        else:
            # the rolls cross ranks: roll the ids before the lookups
            offsets = torch.tensor([0] + shifts, device=dev)
            cand_rows = (torch.arange(lo, lo + B, device=dev)[:, None]
                         + offsets) % n
            cand = all_gather_world(mesh, i)[cand_rows]
            negs = cand[:, 1:]
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
    mb = _resample(cfg, gather_candidate_batch(graph, u, cand, t,
                                               item_side=model.dual),
                   resample_keys, cfg.train.seed, state.step, rows, n,
                   cand_rows)
    drop = {}
    if cfg.model.arch == "score" and cfg.model.dropout > 0:
        if dropout_masks is None:
            dropout_masks = _dropout_masks(cfg, cfg.train.seed, state.step,
                                           n, 1 + k, dev)
        drop = dict(dropout_masks=[m[rows] for m in dropout_masks])
    if mesh is not None:
        take_overflow(model)    # counts of lookups made outside a step
    logits = model.score_candidates(mb, neg_shift=neg_shift, **drop)
    if mesh is None:
        loss = bce_loss(logits, labels, weights)
    else:
        loss = _bce_share(logits, labels, weights)
    if weights is None:     # the monitoring AUC's weights
        weights = torch.ones_like(labels)
    total = loss
    # under a mesh each table row's L2 enters once: on data block 0
    if (full and cfg.train.l2_emb > 0
            and (mesh is None or mesh.data_index == 0)):
        total = loss + table_l2(model, cfg.train.l2_emb)
    params = dict(model.named_parameters())
    # a parameter the step does not reach (a bias table's other side with
    # no L2; every table of the popularity floor on a dense step) gets no
    # gradient here, and the optimizer takes it as zeros, as optax does
    grads = (torch.autograd.grad(total, [params[n] for n in names],
                                 allow_unused=True) if names else ())
    if mesh is not None:
        grads = _sum_grads(mesh, params, names, grads)
    state.opt.step(names, grads)
    state.step += 1
    out = {"loss": loss.detach()}
    logits = logits.detach()
    if mesh is not None:
        dist.all_reduce(out["loss"])        # the shares add up to the loss
        ovf = take_overflow(model)
        out["a2a_overflow"] = (torch.zeros((), dtype=torch.int64, device=dev)
                               if ovf is None else ovf)
        if with_auc:
            logits, weights = (all_gather_world(mesh, x)
                               for x in (logits, weights))
            labels = labels.repeat(mesh.size, 1)
    if with_auc:
        out["batch_auc"] = auc(logits.reshape(-1), labels.reshape(-1),
                               weights.reshape(-1))
    else:
        out.update(logits=logits, weights=weights)
    return state, out


def train_loop(state: TrainState, graph: DeviceGraph,
               batches: Sequence[Mapping],
               shifts_list: Optional[Sequence[Sequence[int]]] = None,
               neg_iw: Optional[torch.Tensor] = None,
               negatives_list: Optional[Sequence] = None
               ) -> Tuple[TrainState, Dict]:
    """K steps, one per batch, each as `train_step` with the j-th shifts or
    raw uniform negatives (the same results as K sequential calls); the
    batch AUC once, from the last step's logits, as the reference's fused
    loop reports it. Returns the state and {loss [K], batch_auc [1]} as
    device tensors, and under a mesh `a2a_overflow` [1], the chunk's
    summed overflow."""
    if not batches:
        raise ValueError("train_loop needs at least one batch")
    losses, overflow = [], []
    for j, batch in enumerate(batches):
        shifts = None if shifts_list is None else shifts_list[j]
        negs = None if negatives_list is None else negatives_list[j]
        state, m = train_step(state, graph, batch, shifts, neg_iw,
                              with_auc=False, negatives=negs)
        losses.append(m["loss"])
        if "a2a_overflow" in m:
            overflow.append(m["a2a_overflow"])
    logits, weights = m["logits"], m["weights"]
    if state.mesh is not None:
        logits, weights = (all_gather_world(state.mesh, x)
                           for x in (logits, weights))
    labels = torch.zeros_like(logits)
    labels[:, 0] = 1.0
    batch_auc = auc(logits.reshape(-1), labels.reshape(-1),
                    weights.reshape(-1))
    out = {"loss": torch.stack(losses), "batch_auc": batch_auc[None]}
    if overflow:
        out["a2a_overflow"] = torch.stack(overflow).sum()[None]
    return state, out


def make_eval_step(model: torch.nn.Module, mesh: Optional[Mesh] = None
                   ) -> Callable:
    """eval_step(graph, batch) scores each positive against its fixed
    negatives: batch {user, item, slot [B], neg [B, N]} -> logits
    [B, 1 + N], the positive first. It runs an inference copy of `model`
    (`eval_step.model`): a snapshot of every weight as it stands now, the
    tables cast once by `params.cast_tables` as serving casts them. In f32
    and in bf16 alike, later training does not reach the copy:
    `eval_step.refresh(model_or_state_dict)` copies the current weights
    into it (tables cast the same way), so one step serves a whole run.

    Under a `mesh` (`eval_step.mesh`, which `evaluate` reads) the copy
    holds this rank's table blocks, as `model` does, and looks them up
    through `model`'s exchange at its exact capacity, which never
    aliases; the graph it is given is then `graph.mesh_graph`'s."""
    tables = [m for m in model.modules() if isinstance(m, EmbeddingTables)]
    fn = tables[0].lookup_fn if tables else None
    lookup_fn = None if fn is None else ShardedLookup(fn.mesh, fn.mode)
    em = build_model(model.cfg, model.num_users, model.num_items, lookup_fn)
    sd = cast_tables(model.state_dict(), model.cfg.compute_dtype)
    assign_weights(em, {k: v.detach().clone() for k, v in sd.items()})
    em.eval()

    @torch.inference_mode()
    def eval_step(graph, batch: Mapping) -> torch.Tensor:
        cand = torch.cat([batch["item"][:, None], batch["neg"]], dim=1)
        mb = gather_candidate_batch(graph, batch["user"], cand,
                                    batch["slot"], item_side=em.dual)
        return em.score_candidates(mb)

    @torch.no_grad()
    def refresh(source) -> None:
        sd = (source.state_dict() if isinstance(source, torch.nn.Module)
              else source)
        for k, t in em.state_dict().items():
            t.copy_(sd[k])

    eval_step.model = em
    eval_step.mesh = mesh
    eval_step.refresh = refresh
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


def evaluate(eval_step: Callable, graph, targets,
             batch_size: int = 256, ks: Sequence[int] = (1, 5, 10),
             max_targets: Optional[int] = None,
             counts: Optional[Dict[str, int]] = None) -> Dict[str, float]:
    """Streaming split evaluation: the pooled AUC and the per-target
    ranking metrics of `targets` (user, item, slot, neg), as the
    reference's evaluate.

    Fixed-size blocks from `data.pipeline.eval_index_batches` (the ragged
    tail padded with weight 0) are scored back to back; each folds into
    the device-resident carry (two F16_BINS histograms and one row of
    ranking sums per block), which is read back once at the end and
    reduced in f64 on the host. `max_targets` scores a subsample drawn
    with a fixed seed (np.random.default_rng(0)), the same every run. A
    `counts` dict receives the blocks scored and the totals of the two
    histograms (`hist_pos`, `hist_neg`: the targets and the negatives
    counted, int32 bin counts summed in int64).

    Under the eval step's mesh (`make_eval_step(model, mesh)`) every rank
    passes the same targets and scores its share of each block
    (batch_size / mesh.size rows, in rank order; the ragged tail keeps
    weight 0), and the carry is all-reduced over the world before the one
    readback, so every rank returns the same metrics."""
    dev = graph.device
    mesh = getattr(eval_step, "mesh", None)
    share = slice(None)
    if mesh is not None:
        if batch_size % mesh.size:
            raise ValueError(f"eval batch_size {batch_size} does not split "
                             f"over a {mesh.size}-rank mesh")
        per = batch_size // mesh.size
        share = slice(mesh.rank * per, (mesh.rank + 1) * per)
    model = getattr(eval_step, "model", None)
    if model is not None:   # eval runs at the graph's stored fan-outs
        check_device(model.cfg, dev, stored_fanouts(graph))
    n = len(targets)
    sel = None
    if max_targets is not None and n > max_targets:
        sel = np.random.default_rng(0).choice(n, max_targets, replace=False)
        n = max_targets
    cols = {k: (getattr(targets, k) if sel is None
                else getattr(targets, k)[sel])
            for k in ("user", "item", "slot", "neg")}
    names = rank_sum_keys(tuple(ks))
    n_blocks = -(-n // batch_size)
    carry = dict(hist_pos=torch.zeros(F16_BINS, dtype=torch.int32,
                                      device=dev),
                 hist_neg=torch.zeros(F16_BINS, dtype=torch.int32,
                                      device=dev),
                 msums=torch.zeros(n_blocks, len(names), device=dev))
    for bi, (idx, w) in enumerate(eval_index_batches(n, batch_size)):
        idx, w = idx[share], w[share]
        batch = {k: _as_device(v[idx], dev) for k, v in cols.items()}
        scores = eval_step(graph, batch)
        _eval_accum(scores, torch.from_numpy(w).to(dev), carry, bi, ks)
    if mesh is not None:
        for v in carry.values():
            dist.all_reduce(v)
    carry = {k: v.cpu().numpy() for k, v in carry.items()}   # one readback
    if counts is not None:
        counts.update(blocks=n_blocks, **{
            k: int(carry[k].sum(dtype=np.int64))
            for k in ("hist_pos", "hist_neg")})
    sums = carry["msums"].astype(np.float64).sum(axis=0)
    by_name = dict(zip(names, sums))
    denom = max(by_name.pop("wsum"), 1.0)
    out = {k: float(v / denom) for k, v in by_name.items()}
    out["auc"] = hist_auc(carry["hist_pos"], carry["hist_neg"])
    return out


def _snapshot(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _append_row(path: Optional[str], row: dict) -> None:
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")


def _stage_batches(it: TargetIterator, k: int, device, negatives=None,
                   rows: slice = slice(None)
                   ) -> List[Dict[str, torch.Tensor]]:
    """The next k host batches (their rows `rows`: a rank's block), and
    with `negatives` (k raw [B, n] uniform draws, whole) each step's under
    the key 'neg', as views of one int32 device array: one host-to-device
    copy a chunk, as the reference's _stack_batches stages its fused
    loop's batches. (A copy from pageable host memory waits for the
    device, so a copy a step would keep the host from running ahead of
    it.)"""
    host = [_batch_rows(next(it), rows) for _ in range(k)]
    if negatives is not None:
        host = [dict(b, neg=n) for b, n in zip(host, negatives)]
    shapes = {key: np.shape(v) for key, v in host[0].items()}
    flat = np.stack([np.concatenate([np.asarray(b[key], np.int32).reshape(-1)
                                     for key in shapes]) for b in host])
    buf = torch.from_numpy(flat).to(device)
    out = [{} for _ in range(k)]
    lo = 0
    for key, shape in shapes.items():
        w = int(np.prod(shape))
        for j in range(k):
            out[j][key] = buf[j, lo:lo + w].view(shape)
        lo += w
    return out


def draw_fns(cfg: Config, num_items: int,
             shifts_fn: Optional[Callable[[int, int], List[int]]] = None,
             negatives_fn: Optional[Callable[[int, int], object]] = None
             ) -> Tuple[Callable, Callable]:
    """(shifts_fn, negatives_fn), each `(step, B)` -> that step's in-batch
    shifts or raw [B, k] uniform negatives: the given ones, else
    `step_shifts` / `step_negatives` of cfg.train.seed."""
    seed, k_neg = cfg.train.seed, cfg.data.num_train_neg
    return (shifts_fn or (lambda s, b: step_shifts(seed, s, k_neg, b)),
            negatives_fn or (
                lambda s, b: step_negatives(seed, s, b, k_neg, num_items)))


def stage_chunk(cfg: Config, it: TargetIterator, k: int, step: int,
                device, num_items: int, rows: slice = slice(None),
                shifts_fn: Optional[Callable[[int, int], List[int]]] = None,
                negatives_fn: Optional[Callable[[int, int], object]] = None
                ) -> Tuple[List[Dict[str, torch.Tensor]], dict]:
    """Steps step .. step + k - 1 staged as `train` stages a chunk: their
    batches on `device` (`_stage_batches`, rows `rows` of each) and
    train_loop's draws for them, {shifts_list} under in-batch negatives
    or {negatives_list} under uniform ones (staged with the batches), from
    `draw_fns`; so `train_loop(state, graph, batches, neg_iw=...,
    **draws)`."""
    shifts_fn, negatives_fn = draw_fns(cfg, num_items, shifts_fn,
                                       negatives_fn)
    B = it.batch_size
    if cfg.data.train_neg_mode == "uniform":
        batches = _stage_batches(
            it, k, device, [negatives_fn(step + j, B) for j in range(k)],
            rows)
        return batches, dict(negatives_list=[b.pop("neg") for b in batches])
    return (_stage_batches(it, k, device, rows=rows),
            dict(shifts_list=[shifts_fn(step + j, B) for j in range(k)]))


def _batch_rows(batch: Mapping, rows: slice) -> dict:
    return {key: v[rows] for key, v in batch.items()}


def join_world(shard_cfg, device="cuda") -> Mesh:
    """The mesh of a sharded config for a process that is already in a
    world or was started by torchrun (`sharding.bringup` from its env);
    otherwise a RuntimeError that says how to start one."""
    torchrun = all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                             "MASTER_ADDR"))
    if not (dist.is_initialized() or torchrun):
        raise RuntimeError(
            f"a sharded config (num_data={shard_cfg.num_data}, num_rows="
            f"{shard_cfg.num_rows}) trains in a world of "
            f"{shard_cfg.num_data * shard_cfg.num_rows} ranks: start it with "
            f"python -m torch.distributed.run --nproc-per-node N -m "
            f"score_tpu_torch.train ..., or pass train(..., mesh=) a "
            f"sharding.bringup mesh")
    return bringup(shard_cfg, device=device)[0]


def train(cfg: Config, ds: Dataset, verbose: bool = True,
          log_path: Optional[str] = None, *, device="cuda",
          mesh: Optional[Mesh] = None,
          parity_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
          parity_shifts_fn: Optional[Callable[[int, int], List[int]]] = None,
          parity_negatives_fn: Optional[Callable[[int, int], object]] = None
          ) -> Dict:
    """Epoch loop with periodic validation, early stop on val AUC, best
    parameters kept, final test metrics: the reference's train(), its log
    lines, JSONL rows and return dict, on `device`.

    Weights start from params.init_params seeded by cfg.train.seed; the
    steps run in chunks of up to 50 through `train_loop`, cut at every val
    and log boundary, each step's in-batch shifts from `step_shifts` or
    its uniform negatives from `step_negatives` (staged with the chunk's
    batches). Val
    runs every min(eval_every_steps, steps_per_epoch) steps and at the
    last, on eval_max_targets targets, through one resident eval step
    refreshed with the current weights. With cfg.train.checkpoint_dir,
    `latest` is saved at every val and `best` when val AUC rises, and a run
    that finds `latest` resumes from it (weights, optimizer state, step,
    iterator position and best val) and takes its best parameters from
    `best`. With cfg.train.profile_dir, a torch.profiler window over
    steps 10-30 writes a Chrome trace there (`profiling.maybe_profile`,
    trace_step10.json). A co-attention config whose stored or configured
    fan-outs the card's kernels do not take is refused before anything
    moves to the device.

    Under a `mesh` (a sharded config without one joins the process's
    world, or torchrun's, through `join_world`, and is refused outside
    any) everything runs on mesh.device: every rank iterates the same
    global batches and stages only its rows of each (its batch block),
    the draws are the global batch's, the graph is row-sharded, val and
    test metrics are the world's (the same on every rank, so every rank
    stops and keeps `best` at the same step), checkpoints are sharded
    (`CheckpointManager(dir, mesh)`), and only rank 0 prints and writes
    `log_path` rows. With lookup_mode 'a2a' each chunk's a2a_overflow,
    summed over the world, is read back: above 0 the run raises
    RuntimeError on every rank (overflow_action 'raise') or warns.

    `parity_state_dict`, `parity_shifts_fn(step, B)` and
    `parity_negatives_fn(step, B)` are for parity tests only: the initial
    weights and each step's shifts or raw [B, k] uniform negatives in
    place of the defaults (a test hands in the JAX package's init and
    draws).

    Returns {best_val_auc, best_step, test, history, params, steps_run} as
    the reference does (params: the best weights as a state_dict on
    `device`; under a mesh this rank's blocks, which
    `sharding.full_tables` gathers whole), plus `timing`: this call's
    first step, its steps, and the seconds spent training, in each val
    and in the test eval; and `state`, the TrainState as the run left
    it."""
    tc, sh = cfg.train, cfg.sharding
    if mesh is None and sh.num_data * sh.num_rows > 1:
        mesh = join_world(sh, device)
    dev = torch.device(device) if mesh is None else mesh.device
    check_trainable(cfg, mesh)
    check_device(cfg, dev, stored_fanouts(ds.graph))
    rows = slice(None)
    if mesh is None:
        graph = device_graph(ds.graph, dev)
    else:
        graph = mesh_graph(ds.graph, mesh, sh.lookup_mode)
        per = tc.batch_size // mesh.size
        rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
        verbose = verbose and mesh.rank == 0
        log_path = log_path if mesh.rank == 0 else None
    it = TargetIterator(ds.train, tc.batch_size, seed=tc.seed)
    if parity_state_dict is None:
        sd = init_params(cfg, ds.num_users, ds.num_items,
                         torch.Generator().manual_seed(tc.seed))
    else:   # the state trains in place: leave the caller's tensors alone
        sd = {k: v.clone() for k, v in parity_state_dict.items()}
    state = init_state(cfg, ds.num_users, ds.num_items, sd, device=dev,
                       steps_per_epoch=it.steps_per_epoch, mesh=mesh)
    neg_iw = None
    if cfg.data.train_neg_mode == "inbatch_iw":
        neg_iw = torch.from_numpy(
            item_importance_weights(ds.train, ds.num_items)).to(dev)
    B = tc.batch_size
    uniform = cfg.data.train_neg_mode == "uniform"
    shifts_fn, negatives_fn = draw_fns(cfg, ds.num_items, parity_shifts_fn,
                                       parity_negatives_fn)
    eval_step = make_eval_step(state.model, mesh)

    steps_per_epoch = it.steps_per_epoch
    total_steps = steps_per_epoch * tc.num_epochs
    eval_every = min(tc.eval_every_steps, max(steps_per_epoch, 1))
    best = {"val_auc": -1.0, "step": -1, "params": None}
    history = []
    bad_evals = 0
    t_start = time.time()

    step = 0
    ckpt = None
    if tc.checkpoint_dir:
        ckpt = CheckpointManager(tc.checkpoint_dir, mesh)
        restored = ckpt.restore("latest", state)
        if restored is not None:
            apply_restore(state, restored)
            it.set_state((restored["it_epoch"], restored["it_pos"]))
            best["val_auc"] = float(restored["best_val"])
            step = int(restored["step"])
            kept = ckpt.restore("best", state)
            if kept is not None:
                best = {"val_auc": float(kept["best_val"]),
                        "step": int(kept["step"]), "params": kept["params"]}
            if verbose:
                print(f"resumed from step {step} "
                      f"(best val auc {best['val_auc']:.4f})", flush=True)
    timing = {"start_step": step, "steps": 0, "train_s": 0.0, "val_s": [],
              "test_s": 0.0}

    def next_boundary(s):
        nxt = [total_steps]
        for period in (eval_every, tc.log_every_steps):
            if period < 10 ** 8:
                nxt.append((s // period + 1) * period)
        return min(nxt)

    prof, profiled = contextlib.ExitStack(), False
    t_mark = time.perf_counter()
    while step < total_steps:
        chunk = min(next_boundary(step) - step, 50)
        if chunk > 1 and not tc.profile_dir:
            batches, draws = stage_chunk(cfg, it, chunk, step, dev,
                                         ds.num_items, rows, shifts_fn,
                                         negatives_fn)
            state, ms = train_loop(state, graph, batches, neg_iw=neg_iw,
                                   **draws)
            m = {"loss": ms["loss"][-1], "batch_auc": ms["batch_auc"][0]}
            if "a2a_overflow" in ms:
                m["a2a_overflow"] = ms["a2a_overflow"].sum()   # the chunk
            step += chunk
        elif uniform:
            state, m = train_step(state, graph, _batch_rows(next(it), rows),
                                  neg_iw=neg_iw,
                                  negatives=negatives_fn(step, B))
            step += 1
        else:
            state, m = train_step(state, graph, _batch_rows(next(it), rows),
                                  shifts_fn(step, B), neg_iw)
            step += 1
        if sh.lookup_mode == "a2a" and "a2a_overflow" in m:
            _check_overflow(cfg, step, int(m["a2a_overflow"]))
        if tc.profile_dir and (mesh is None or mesh.rank == 0):
            # one window over steps 10..30: past the warm-up, short enough
            # to read
            if step >= 10 and not profiled:
                prof.enter_context(maybe_profile(
                    tc.profile_dir, f"trace_step{step}", device=dev))
                profiled = True
            elif step >= 30:
                prof.close()
        if verbose and step % tc.log_every_steps == 0:
            print(f"step {step}/{total_steps} epoch {it.epoch} "
                  f"loss {float(m['loss']):.4f} "
                  f"batch_auc {float(m['batch_auc']):.4f}", flush=True)
        if step % eval_every == 0 or step == total_steps:
            loss = float(m["loss"])        # waits for the steps
            timing["train_s"] += time.perf_counter() - t_mark
            t0 = time.perf_counter()
            eval_step.refresh(state.model)
            val = evaluate(eval_step, graph, ds.val,
                           max_targets=tc.eval_max_targets)
            timing["val_s"].append(time.perf_counter() - t0)
            rec = dict(step=step, split="val", **val, loss=loss,
                       elapsed_s=round(time.time() - t_start, 2))
            history.append(rec)
            _append_row(log_path, rec)
            if verbose:
                print(f"  val @ step {step}: auc {val['auc']:.4f} "
                      f"ndcg@10 {val['ndcg@10']:.4f} hr@10 {val['hr@10']:.4f}",
                      flush=True)
            if ckpt is not None:
                ckpt.save("latest", state, it.get_state(),
                          best["val_auc"], step)
            stop = False
            if val["auc"] > best["val_auc"]:
                best = {"val_auc": val["auc"], "step": step,
                        "params": _snapshot(state.model)}
                bad_evals = 0
                if ckpt is not None:
                    ckpt.save("best", state, it.get_state(),
                              val["auc"], step)
            else:
                bad_evals += 1
                if bad_evals >= tc.early_stop_patience:
                    if verbose:
                        print(f"early stop at step {step} "
                              f"(best val auc {best['val_auc']:.4f} "
                              f"@ {best['step']})")
                    stop = True
            t_mark = time.perf_counter()
            if stop:
                break

    prof.close()
    if ckpt is not None:
        ckpt.wait()   # the last save is on disk before we may exit
    timing["steps"] = step - timing["start_step"]
    final_params = (best["params"] if best["params"] is not None
                    else _snapshot(state.model))
    t0 = time.perf_counter()
    eval_step.refresh(final_params)
    test = evaluate(eval_step, graph, ds.test)
    timing["test_s"] = time.perf_counter() - t0
    if verbose:
        print(f"test: auc {test['auc']:.4f} ndcg@10 {test['ndcg@10']:.4f} "
              f"hr@10 {test['hr@10']:.4f} mrr {test['mrr']:.4f}")
        if timing["steps"]:
            print(f"driver: {timing['steps']} steps in "
                  f"{timing['train_s']:.3f} s "
                  f"({timing['steps'] / timing['train_s']:.2f} steps/s), "
                  f"{len(timing['val_s'])} vals in "
                  f"{sum(timing['val_s']):.3f} s, test eval "
                  f"{timing['test_s']:.3f} s", flush=True)
    _append_row(log_path, dict(step=step, split="test", **test))
    return dict(best_val_auc=best["val_auc"], best_step=best["step"],
                test=test, history=history, params=final_params,
                steps_run=step, timing=timing, state=state)


def _check_overflow(cfg: Config, step: int, overflow: int) -> None:
    """The reference's a2a capacity check on a chunk's overflow (the same
    count on every rank: the lookups sum it over the world), so every rank
    raises together: uniques past a2a_capacity read aliased rows."""
    if overflow <= 0:
        return
    sh = cfg.sharding
    msg = (f"step {step}: a2a_lookup capacity overflow ({overflow} uniques "
           f"dropped) - raise sharding.a2a_capacity (current "
           f"{sh.a2a_capacity}); metrics from this step on are corrupt")
    if sh.overflow_action == "raise":
        raise RuntimeError(msg)
    if dist.get_rank() == 0:
        print("WARNING " + msg, flush=True)


def main(argv=None, device="cuda"):
    """python -m score_tpu_torch.train <preset> [data_dir] [--device D]
    [section.key=value ...]: load the dataset in data_dir (or prep it
    there, from the raw log or a synthesized one) and train; returns
    train()'s result. A sharded preset (configs4) runs under `python -m
    torch.distributed.run --nproc-per-node N` (N = num_data x num_rows)
    or in a world the caller has joined: rank 0 preps the dataset, the
    others load it."""
    args = list(sys.argv[1:] if argv is None else argv)
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1] if i + 1 < len(args) else None
        del args[i:i + 2]
    if not args or args[0] not in PRESETS or device is None:
        print(__doc__)
        print("presets:", ", ".join(PRESETS))
        raise SystemExit(2)
    cfg = PRESETS[args[0]]()
    data_dir = None
    overrides = {}
    for a in args[1:]:
        if "=" in a:
            key, v = a.split("=", 1)
            overrides[key] = v
        else:
            data_dir = a
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    sh = cfg.sharding
    joined = dist.is_initialized()
    mesh = (join_world(sh, device) if sh.num_data * sh.num_rows > 1
            else None)
    lead = mesh is None or mesh.rank == 0
    from .data.prep_datasets import PREP
    from .data.schema import load_dataset
    fresh = not (data_dir
                 and os.path.exists(os.path.join(data_dir, "meta.json")))
    data_dir = data_dir or os.path.join(tempfile.gettempdir(),
                                        "score_tpu_data", cfg.data.dataset)
    try:
        if lead and fresh:
            prep = PREP.get(cfg.data.dataset, PREP["taobao"])
            ds = prep(data_dir, user_fanout=cfg.data.user_fanout,
                      item_fanout=cfg.data.item_fanout,
                      num_eval_neg=cfg.data.num_eval_neg)
        if mesh is not None:
            dist.barrier()              # rank 0's prep is on disk
        if not (lead and fresh):
            ds = load_dataset(data_dir)
        return train(cfg, ds, device=device, mesh=mesh)
    finally:
        if mesh is not None and not joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
