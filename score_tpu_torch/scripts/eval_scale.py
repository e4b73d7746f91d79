"""Reference-scale evaluation run.

Builds the pinned 1e8-event synthetic dataset (the knobs of `prep_bench`:
1e6 users, 4e6 items -> ~2.68M kept, ~10.6M val targets x 100 eval
negatives), trains the bench configs3 step briefly so metrics are
non-degenerate, then runs the FULL val split through the streaming
`train.evaluate` on the device and records wall time and metrics.

What this shows: the split is never device-resident (the negatives alone
are ~4.3 GB, the pooled score vector ~1.1e9 floats); the streaming
path's device residency is {graph, tables, one block, the O(1) carry},
and the pooled AUC comes from the two 65536-bin int32 histograms, whose
totals the record holds beside the counts they must equal. One block's
item side at eval_batch 8192 holds 2.38e9 elements, past 2^31.

The port's counterpart of the JAX package's scripts/eval_scale.py: the
same knobs, model, steps and JSON keys (its residency formula included),
plus `device` and `host`, the final loss, the histogram totals,
`peak_rss_gib` and `eval_staging_s` (the eval's host-to-device block
copies alone). The eval of given weights is `evaluate_weights`.

Usage: python -m score_tpu_torch.scripts.eval_scale [events=100000000]
           [users=1000000] [items=4000000] [slots=9] [train_steps=400]
           [eval_batch=2048] [batch=4096] [out=$TMPDIR/eval_scale.json]
           [--device D]     (cpu=1 is --device cpu)

At the defaults: 71 GiB of host memory at the prep's peak, the val and
test negatives ~8.5 GB after it; ~7 min of prep on an 8-core host.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import torch

from ..config import Config, configs3
from ..data.pipeline import TargetIterator, eval_index_batches
from ..data.prep_common import build_dataset
from ..data.schema import Dataset
from ..graph import device_graph
from ..nn.model import build_model
from ..params import assign_weights, init_params
from ..train import (_as_device, evaluate, init_state,
                     item_importance_weights, make_eval_step, stage_chunk,
                     train_loop)
from . import machine
from .ladder import knob_values, split_argv
from .prep_bench import synth_uniform_zipf

CHUNK = 50          # steps a train_loop call, as the JAX script stacks them
EVAL_NEG = 100
FANOUT = 10


def bench_config(batch: int = 4096, compute_dtype: str = "bfloat16"
                 ) -> Config:
    """configs3 as the benchmark trains it: d=32, hidden 64, MLP 128/64,
    `compute_dtype`, importance-weighted in-batch negatives, batch
    `batch`, tables every 2nd step at 2x lr; every other field at its
    configs3 value."""
    cfg = configs3()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, embed_dim=32, hidden_dim=64,
                                  mlp_dims=(128, 64),
                                  compute_dtype=compute_dtype),
        data=dataclasses.replace(cfg.data, train_neg_mode="inbatch_iw"),
        train=dataclasses.replace(cfg.train, batch_size=batch,
                                  table_update_every=2, table_lr_boost=2.0))


def prep(kw: dict) -> Dataset:
    """The dataset of `kw`'s events, users, items and slots, as the JAX
    script builds it."""
    user, item, ts = synth_uniform_zipf(kw["events"], kw["users"],
                                        kw["items"], kw["slots"])
    return build_dataset(user, item, ts, num_slots=kw["slots"],
                         user_fanout=FANOUT, item_fanout=FANOUT,
                         num_eval_neg=EVAL_NEG, min_user=5, min_item=5,
                         seed=0, dataset_name="evalscale")


def train_steps(cfg: Config, ds: Dataset, steps: int, device, graph
                ) -> tuple:
    """`steps` steps from `params.init_params` at cfg.train.seed, in
    train_loop calls of up to CHUNK steps staged as `train` stages them.
    Returns (the weights without the optimizer state, the last loss, the
    seconds, the readback of the last loss included)."""
    tc = cfg.train
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(tc.seed))
    it = TargetIterator(ds.train, tc.batch_size, seed=tc.seed)
    state = init_state(cfg, ds.num_users, ds.num_items, sd, device=device,
                       steps_per_epoch=it.steps_per_epoch)
    neg_iw = torch.from_numpy(item_importance_weights(
        ds.train, ds.num_items)).to(device)
    t0 = time.time()
    step, loss = 0, float("nan")
    while step < steps:
        k = min(CHUNK, steps - step)
        batches, draws = stage_chunk(cfg, it, k, step, device, ds.num_items)
        state, ms = train_loop(state, graph, batches, neg_iw=neg_iw,
                               **draws)
        step += k
    if steps:
        loss = float(ms["loss"][-1])
    seconds = time.time() - t0
    weights = {k: p.detach() for k, p in state.model.named_parameters()}
    return weights, loss, seconds


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def staging_s(targets, batch_size: int, device) -> float:
    """Seconds to take every eval block's four columns from the host
    split and copy them to `device` as `evaluate` does (pageable
    copies), with no scoring."""
    n = len(targets)
    cols = [getattr(targets, k) for k in ("user", "item", "slot", "neg")]
    _sync(device)
    t0 = time.time()
    for idx, _ in eval_index_batches(n, batch_size):
        for v in cols:
            _as_device(v[idx], device)
    _sync(device)
    return time.time() - t0


def evaluate_weights(cfg: Config, ds: Dataset, state_dict, eval_batch: int,
                     device="cuda", graph=None) -> dict:
    """The streaming eval of ds.val on the weights `state_dict` (by
    parameter name; tables cast to the compute dtype by `make_eval_step`):
    one warm-up `evaluate` on eval_batch targets, then the whole split in
    blocks of eval_batch. Returns {metrics, compile_s (the warm-up),
    wall_s, staging_s (`staging_s`), blocks, hist_pos, hist_neg}.
    `graph`: ds.graph already on the device, else it is moved there."""
    graph = device_graph(ds.graph, device) if graph is None else graph
    model = build_model(cfg, ds.num_users, ds.num_items)
    assign_weights(model, {k: v.to(device) for k, v in state_dict.items()})
    eval_step = make_eval_step(model)
    del model
    t0 = time.time()
    evaluate(eval_step, graph, ds.val, batch_size=eval_batch,
             max_targets=eval_batch)
    compile_s = time.time() - t0
    counts = {}
    t0 = time.time()
    metrics = evaluate(eval_step, graph, ds.val, batch_size=eval_batch,
                       counts=counts)
    wall_s = time.time() - t0
    return dict(metrics=metrics, compile_s=compile_s, wall_s=wall_s,
                staging_s=staging_s(ds.val, eval_batch, device), **counts)


def residency_bytes(ds: Dataset, eval_batch: int, d: int = 32) -> dict:
    """The JAX script's statement of device bytes by construction: graph,
    tables, one block's bf16 item side, the carry, and what is never
    resident (the val negatives) or never materialized (the pooled
    scores)."""
    T, m = ds.graph.num_slots, FANOUT
    g = ds.graph
    return dict(
        graph=int(sum(a.nbytes for a in (g.u2i, g.i2u, g.u2i_cnt,
                                         g.i2u_cnt))),
        tables=int((ds.num_users + ds.num_items + 2) * d * 4),
        block_item_side_bf16=int(eval_batch * (1 + EVAL_NEG) * T * m * d
                                 * 2),
        carry=int(2 * 65536 * 4),
        never_resident_negs=int(len(ds.val) * EVAL_NEG * 4),
        never_materialized_pooled_scores=int(len(ds.val) * (1 + EVAL_NEG)
                                             * 4))


DEFAULTS = dict(events=100_000_000, users=1_000_000, items=4_000_000,
                slots=9, train_steps=400, eval_batch=2048, batch=4096, cpu=0,
                out=os.path.join(tempfile.gettempdir(), "eval_scale.json"))


def run(kw: dict, device="cuda") -> tuple:
    """The whole run at knobs `kw` (DEFAULTS' keys): returns (the JSON
    record, the config, the dataset, the trained weights)."""
    dev = torch.device(device)
    res = dict(events=kw["events"], backend=dev.type,
               **machine.record(dev))
    t0 = time.time()
    ds = prep(kw)
    res["prep_s"] = round(time.time() - t0, 1)
    res["prep_phase_s"] = ds.meta.get("prep_phase_s", {})
    res["num_users"] = ds.num_users
    res["num_items"] = ds.num_items
    res["val_targets"] = len(ds.val)
    print(f"prep {res['prep_s']}s: {ds.num_users:,} users "
          f"{ds.num_items:,} items {len(ds.val):,} val targets", flush=True)

    cfg = bench_config(kw["batch"])
    graph = device_graph(ds.graph, dev)
    weights, loss, train_s = train_steps(cfg, ds, kw["train_steps"], dev,
                                         graph)
    res["train_steps"] = kw["train_steps"]
    res["train_s"] = round(train_s, 1)
    res["train_final_loss"] = loss
    print(f"trained {kw['train_steps']} steps in {res['train_s']}s "
          f"(loss {loss:.4f})", flush=True)

    B = kw["eval_batch"]
    ev = evaluate_weights(cfg, ds, weights, B, dev, graph)
    res["eval_compile_s"] = round(ev["compile_s"], 1)
    res["eval_wall_s"] = round(ev["wall_s"], 1)
    res["eval_metrics"] = {k: round(v, 4) for k, v in ev["metrics"].items()}
    res["eval_targets_per_s"] = round(len(ds.val) / ev["wall_s"], 1)
    res["eval_cand_scores_per_s"] = round(
        len(ds.val) * (1 + EVAL_NEG) / ev["wall_s"], 1)
    res["eval_batch"] = B
    res["eval_blocks"] = ev["blocks"]
    res["eval_staging_s"] = round(ev["staging_s"], 1)
    res["eval_hist_pos"] = ev["hist_pos"]
    res["eval_hist_neg"] = ev["hist_neg"]
    res["eval_expected_pos"] = len(ds.val)
    res["eval_expected_neg"] = len(ds.val) * EVAL_NEG
    print(f"eval {len(ds.val):,} targets in {res['eval_wall_s']}s "
          f"({res['eval_targets_per_s']:,} targets/s, {ev['blocks']} "
          f"blocks of {B}; their copies alone {res['eval_staging_s']}s); "
          f"sum(hist_pos) {ev['hist_pos']:,} of {len(ds.val):,}, "
          f"sum(hist_neg) {ev['hist_neg']:,} of "
          f"{len(ds.val) * EVAL_NEG:,}", flush=True)
    res["residency_bytes"] = residency_bytes(ds, B, cfg.model.embed_dim)
    res["peak_rss_gib"] = machine.peak_rss_gib()
    return res, cfg, ds, weights


def main(argv=None, device: str = "cuda") -> dict:
    _, kv, device = split_argv(argv, device)
    kw = knob_values(kv, DEFAULTS)
    if kw["cpu"]:
        device = "cpu"
    res = run(kw, device)[0]
    print(json.dumps(res), flush=True)
    with open(kw["out"], "w") as f:
        json.dump(res, f, indent=2)
    print(f"wrote {kw['out']}", flush=True)
    return res


if __name__ == "__main__":
    main()
