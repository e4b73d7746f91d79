"""Perf sweep over train-step variants on the flagship configs3 model.

Measures steady-state train examples/s for a grid of knobs (batch size,
compute dtype, negative mode, embedding width, stride-K table updates):
one warm-up call of STEPS_PER_CALL steps, then TRAIN_CALLS timed windows,
each a `train.train_loop` call over STEPS_PER_CALL batches staged
beforehand and ending with a host readback of its last loss. Each window
is timed by wall clock and by CUDA events (on the card).

The port's counterpart of the JAX package's scripts/perf_sweep.py: the
same variant names, config rule (`config`) and JSON keys, plus the
CUDA-event rates and `device` and `host`. The JAX variants that set a
lowering switch of the JAX model (`JAX_ONLY`: pallas_coattn, dotfree,
gru_unroll, push_rolls, static_pair, wr_on_summary, cand_kernel and
cand_tile_b) have no counterpart here: asking for one raises ValueError
naming its switch, before anything runs.

Usage: python -m score_tpu_torch.scripts.perf_sweep [variant ...]
           [--device D] [num_users=50000] [num_items=100000]
           [num_events=2000000] [steps=50] [calls=6]
       (no variant = every ported one; one JSON line per variant, an
       `error` line for a variant that raised)
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..config import Config, DataConfig, ModelConfig, TrainConfig, configs3
from ..data import synth
from ..data.pipeline import TargetIterator
from ..data.prep_common import build_dataset
from ..graph import device_graph
from ..params import init_params
from ..train import (init_state, item_importance_weights, stage_chunk,
                     train_loop)
from . import machine
from .ladder import knob_values, split_argv

NUM_SLOTS = 9
FANOUT = 10
EMBED_DIM = 32
SIZES = dict(num_users=50_000, num_items=100_000, num_events=2_000_000,
             steps=50, calls=6)

VARIANTS = {
    "base_2048_f32": dict(batch=2048),
    "b4096_f32": dict(batch=4096),
    "b8192_f32": dict(batch=8192),
    "b2048_bf16": dict(batch=2048, compute_dtype="bfloat16"),
    "b4096_bf16": dict(batch=4096, compute_dtype="bfloat16"),
    "b8192_bf16": dict(batch=8192, compute_dtype="bfloat16"),
    "b4096_bf16_inbatch": dict(batch=4096, compute_dtype="bfloat16",
                               neg_mode="inbatch"),
    "b8192_bf16_inbatch": dict(batch=8192, compute_dtype="bfloat16",
                               neg_mode="inbatch"),
    "b4096_bf16_inbatch_iw": dict(batch=4096, compute_dtype="bfloat16",
                                  neg_mode="inbatch_iw"),
    "b6144_bf16_inbatch_iw": dict(batch=6144, compute_dtype="bfloat16",
                                  neg_mode="inbatch_iw"),
    "b8192_bf16_inbatch_iw": dict(batch=8192, compute_dtype="bfloat16",
                                  neg_mode="inbatch_iw"),
    "b3072_bf16_inbatch_iw": dict(batch=3072, compute_dtype="bfloat16",
                                  neg_mode="inbatch_iw"),
    # embedding width
    "b4096_bf16_iw_d64": dict(batch=4096, compute_dtype="bfloat16",
                              neg_mode="inbatch_iw", embed_dim=64),
    "b4096_bf16_iw_d128": dict(batch=4096, compute_dtype="bfloat16",
                               neg_mode="inbatch_iw", embed_dim=128),
    # stride-K table updates: (K-1)/K of steps skip the table gradients'
    # scatter-adds and the table optimizer
    "b4096_bf16_iw_stride2": dict(batch=4096, compute_dtype="bfloat16",
                                  neg_mode="inbatch_iw", table_stride=2),
    "b4096_bf16_iw_stride4": dict(batch=4096, compute_dtype="bfloat16",
                                  neg_mode="inbatch_iw", table_stride=4),
}

# the JAX script's variants that set a lowering switch of the JAX model,
# by name: the switch each sets
JAX_ONLY = {
    "b2048_pallas": "pallas_coattn",
    "b4096_bf16_pallas": "pallas_coattn",
    "b4096_bf16_iw_dotfree": "dotfree",
    "b6144_bf16_iw_dotfree": "dotfree",
    "b4096_bf16_iw_unroll": "gru_unroll",
    "b4096_bf16_iw_dotfree_unroll": "dotfree, gru_unroll",
    "b4096_bf16_iw_noroll": "push_rolls",
    "b4096_bf16_iw_pushroll": "push_rolls",
    "b4096_bf16_iw_stride2_static": "static_pair",
    "b4096_bf16_iw_s2_wrbase": "wr_on_summary",
    "b4096_bf16_iw_s2_wrsum": "wr_on_summary",
    "b4096_bf16_iw_s2_cand": "cand_kernel, cand_tile_b",
    "b4096_bf16_iw_s2_cand32": "cand_kernel, cand_tile_b",
}


def check_names(names) -> None:
    """ValueError for a JAX-only variant (naming its switch) or an unknown
    name, before anything runs."""
    for n in names:
        if n in JAX_ONLY:
            raise ValueError(
                f"perf_sweep variant {n!r} sets the JAX model's lowering "
                f"switch {JAX_ONLY[n]}, which the port has no counterpart "
                f"of; the port runs {', '.join(VARIANTS)}")
        if n not in VARIANTS:
            raise ValueError(f"unknown perf_sweep variant {n!r}; the port "
                             f"runs {', '.join(VARIANTS)}")


def config(*, batch, compute_dtype="float32", num_train_neg=1,
           neg_mode="uniform", embed_dim=EMBED_DIM, table_stride=1,
           table_lr_boost=1.0) -> Config:
    """The JAX run_variant's config: configs3 with its model, data and
    train sections built anew from these knobs (every field not named at
    its dataclass default, not at configs3's)."""
    cfg = configs3()
    return cfg.replace(
        model=ModelConfig(
            embed_dim=embed_dim, hidden_dim=64, mlp_dims=(128, 64),
            sides="dual", slot_agg="coattn", seq_pool="attn",
            target_aware=True, compute_dtype=compute_dtype),
        data=DataConfig(num_train_neg=num_train_neg, train_neg_mode=neg_mode),
        train=TrainConfig(batch_size=batch, table_update_every=table_stride,
                          table_lr_boost=table_lr_boost))


def _window(state, graph, it, step, cfg, neg_iw, num_items, K, dev):
    """One timed window: K staged steps, then the readback of the last
    loss. Returns (state, wall s, CUDA-event ms or None, last loss)."""
    batches, draws = stage_chunk(cfg, it, K, step, dev, num_items)
    cuda = dev.type == "cuda"
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize(dev)
        start.record()
    t0 = time.time()
    state, ms = train_loop(state, graph, batches, neg_iw=neg_iw, **draws)
    if cuda:
        end.record()
    last = float(ms["loss"][-1])    # data-dependent readback: honest wall
    dt = time.time() - t0
    return state, dt, (start.elapsed_time(end) if cuda else None), last


def run_variant(name, ds, graph, device="cuda", steps=50, calls=6) -> dict:
    """Warm up, then time `calls` windows of `steps` steps of variant
    `name`; print and return its JSON line."""
    knobs_ = VARIANTS[name]
    cfg = config(**knobs_)
    dev = torch.device(device)
    B = cfg.train.batch_size
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(0))
    it = TargetIterator(ds.train, B, seed=0)
    state = init_state(cfg, ds.num_users, ds.num_items, sd, device=dev,
                       steps_per_epoch=it.steps_per_epoch)
    neg_iw = None
    if cfg.data.train_neg_mode == "inbatch_iw":
        neg_iw = torch.from_numpy(item_importance_weights(
            ds.train, ds.num_items)).to(dev)
    step = 0
    state, _, _, last = _window(state, graph, it, step, cfg, neg_iw,
                                ds.num_items, steps, dev)   # warm-up
    step += steps
    rates, cuda_rates = [], []
    for _ in range(calls):
        state, dt, ev_ms, last = _window(state, graph, it, step, cfg, neg_iw,
                                         ds.num_items, steps, dev)
        step += steps
        rates.append(steps * B / dt)
        if ev_ms is not None:
            cuda_rates.append(steps * B / (ev_ms / 1e3))
    rates = np.array(rates)
    out = dict(variant=name, batch=B, dtype=cfg.model.compute_dtype,
               pallas_coattn=False, neg=cfg.data.num_train_neg,
               examples_per_s=float(np.median(rates)),
               rate_min=float(rates.min()), rate_max=float(rates.max()),
               step_ms=float(1000.0 * B / np.median(rates)),
               last_loss=last)
    if cuda_rates:
        cr = np.array(cuda_rates)
        out.update(examples_per_s_cuda=float(np.median(cr)),
                   rate_min_cuda=float(cr.min()),
                   rate_max_cuda=float(cr.max()),
                   step_ms_cuda=float(1000.0 * B / np.median(cr)))
    out.update(neg_mode=cfg.data.train_neg_mode,
               embed_dim=cfg.model.embed_dim,
               table_stride=cfg.train.table_update_every,
               **machine.record(dev))
    print(json.dumps(out), flush=True)
    return out


def main(argv=None, device: str = "cuda") -> list:
    names, kv, device = split_argv(argv, device)
    names = names or list(VARIANTS)
    check_names(names)
    kw = knob_values(kv, SIZES)
    machine.card(device)            # no card: refuse before the prep
    t0 = time.time()
    user, item, ts = synth.synth_events(
        kw["num_users"], kw["num_items"], kw["num_events"],
        num_slots=NUM_SLOTS, seed=0)
    ds = build_dataset(user, item, ts, num_slots=NUM_SLOTS,
                       user_fanout=FANOUT, item_fanout=FANOUT,
                       num_eval_neg=100, min_user=3, min_item=3, seed=0,
                       dataset_name="sweep")
    graph = device_graph(ds.graph, device)
    print(json.dumps(dict(prep_s=round(time.time() - t0, 1))), flush=True)
    out = []
    for n in names:
        try:
            out.append(run_variant(n, ds, graph, device, kw["steps"],
                                   kw["calls"]))
        except Exception as e:  # keep sweeping past a broken variant
            out.append(dict(variant=n, error=repr(e)[:300]))
            print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
