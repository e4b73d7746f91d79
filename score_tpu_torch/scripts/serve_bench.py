"""Serving-path benchmark: single-request p50 latency against batched
throughput, and the full-catalogue top-k.

`ScoringService.score_batch` stacks R independent (user, candidate-list)
requests into one dispatch in candidates form (the user tower computed
once per user). This records single-request p50, how requests/s scales
with R, and full-catalogue `topk` latency, on configs3 at the
benchmark's width (d=32, hidden 64, MLP 128/64, bf16) with random weights
(`params.init_params`, seed 0) over the benchmark's synthetic dataset.

--catalog runs the reference-scale serving capacity probe instead: a
catalogue of ~2.92M items (at least the 2.68M items of the 1e8-event
prep) resident on the device, full-catalogue `topk` streamed through
ScoringService's fixed-size chunks (357 dispatches of 16 x 8192), and
`topk_batch` for R = 4 and 16 users.

The port's counterpart of the JAX package's scripts/serve_bench.py: the
same modes, knobs and JSON keys, plus `device` and `host`; k=v knobs
also set the sizes (their defaults are the JAX script's constants).

Usage: python -m score_tpu_torch.scripts.serve_bench [out_json]
           [num_users=50000] [num_items=100000] [num_events=2000000]
           [reps=30] [--device D]
       python -m score_tpu_torch.scripts.serve_bench [out_json] --catalog
           [users=1000000] [items=3700000] [events=14000000] [chunk=8192]
           [rows=16] [--device D]

The catalogue's prep holds 9.1 GiB of host memory at its peak and takes
~84 s on an 8-core host.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..config import Config, configs3
from ..data import synth
from ..data.prep_common import build_dataset
from ..params import init_params
from ..serve import ScoringService
from . import machine
from .ladder import knob_values, split_argv

NUM_SLOTS = 9
FANOUT = 10
EMBED_DIM = 32
C = 101          # 1 pos + 100 negs, the eval/serving protocol
MAIN_SIZES = dict(num_users=50_000, num_items=100_000, num_events=2_000_000,
                  reps=30)
CATALOG_SIZES = dict(users=1_000_000, items=3_700_000, events=14_000_000,
                     chunk=8192, rows=16)
# the 1e8-event prep's item count (PREP_BENCH_r3.json, rounded down): the
# catalogue at its default sizes must hold at least this many
MIN_CATALOG_ITEMS = 2_680_000


def serve_config() -> Config:
    """configs3 at the benchmark's width in bf16; every other field at
    its configs3 value."""
    cfg = configs3()
    return cfg.replace(model=dataclasses.replace(
        cfg.model, embed_dim=EMBED_DIM, hidden_dim=64, mlp_dims=(128, 64),
        compute_dtype="bfloat16"))


def service(ds, device, **service_kw) -> ScoringService:
    cfg = serve_config()
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(0))
    return ScoringService(cfg, ds, sd, device=device, **service_kw)


def main(argv=None, device: str = "cuda") -> dict:
    args, kv, device = split_argv(argv, device)
    if "--catalog" in args:
        return catalog_main([a for a in args if a != "--catalog"], kv,
                            device)
    kw = knob_values(kv, MAIN_SIZES)
    reps = kw["reps"]
    res_machine = machine.record(device)
    user, item, ts = synth.synth_events(
        kw["num_users"], kw["num_items"], kw["num_events"],
        num_slots=NUM_SLOTS, seed=0)
    ds = build_dataset(user, item, ts, num_slots=NUM_SLOTS,
                       user_fanout=FANOUT, item_fanout=FANOUT,
                       num_eval_neg=100, min_user=3, min_item=3, seed=0,
                       dataset_name="servebench")
    svc = service(ds, device)

    rng = np.random.default_rng(0)
    results = {}

    # --- single-request p50 ---
    items1 = rng.integers(1, ds.num_items + 1, size=C).astype(np.int32)
    svc.score(7, items1)                      # warm-up
    lat = []
    for _ in range(3 * reps):
        t0 = time.time()
        svc.score(7, items1)
        lat.append(time.time() - t0)
    results["single_p50_ms"] = round(float(np.median(lat)) * 1e3, 2)
    results["single_req_per_s"] = round(1e3 / results["single_p50_ms"], 1)
    print(json.dumps({"single_request": results.copy()}), flush=True)

    # --- batched requests: R users x C candidates in one dispatch ---
    calls = max(reps // 4, 4)
    for R in (16, 64, 256, 1024):
        users = rng.integers(1, ds.num_users + 1, size=R).astype(np.int32)
        cand = rng.integers(1, ds.num_items + 1,
                            size=(R, C)).astype(np.int32)
        svc.score_batch(users, cand)          # warm-up (per bucket)
        best = float("inf")
        for _ in range(2):                    # best of 2 windows
            t0 = time.time()
            for _ in range(calls):
                svc.score_batch(users, cand)
            best = min(best, (time.time() - t0) / calls)
        row = dict(R=R, C=C, ms=round(best * 1e3, 2),
                   req_per_s=round(R / best, 1),
                   cand_per_s=round(R * C / best))
        results[f"batch_R{R}"] = row
        print(json.dumps(row), flush=True)

    # --- full-catalog topk for one user ---
    svc.topk(7, k=10)                         # warm-up
    lat = []
    for _ in range(8):
        t0 = time.time()
        svc.topk(7, k=10)
        lat.append(time.time() - t0)
    results["topk_full_catalog_ms"] = round(float(np.median(lat)) * 1e3, 1)
    results["catalog_items"] = int(ds.num_items)
    print(json.dumps({"topk_full_catalog_ms":
                      results["topk_full_catalog_ms"],
                      "catalog_items": results["catalog_items"]}),
          flush=True)
    results.update(res_machine)

    out = args[0] if args else os.path.join(tempfile.gettempdir(),
                                            "serve_bench.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    return results


def catalog_main(args: list, kv: dict, device) -> dict:
    """Reference-catalogue-scale topk: ~2.92M items resident, chunked."""
    kw = knob_values(kv, CATALOG_SIZES)
    res_machine = machine.record(device)
    t0 = time.time()
    # sized so the post-filter item count lands at or above the 1e8
    # prep's catalogue; min counts 1 keep the synthetic catalogue wide
    # (serving capacity depends on sizes, not content); eval negatives
    # play no part here (num_eval_neg=1)
    user, item, ts = synth.synth_events(
        kw["users"], kw["items"], kw["events"], num_slots=NUM_SLOTS, seed=0)
    ds = build_dataset(user, item, ts, num_slots=NUM_SLOTS,
                       user_fanout=FANOUT, item_fanout=FANOUT,
                       num_eval_neg=1, min_user=1, min_item=1, seed=0,
                       dataset_name="catalog-scale")
    del user, item, ts
    prep_s = time.time() - t0
    print(json.dumps(dict(prep_s=round(prep_s, 1), users=ds.num_users,
                          items=ds.num_items)), flush=True)
    if (all(kw[k] == CATALOG_SIZES[k] for k in ("users", "items", "events"))
            and ds.num_items < MIN_CATALOG_ITEMS):
        raise RuntimeError(f"the catalogue holds {ds.num_items:,} items, "
                           f"below the 1e8 prep's {MIN_CATALOG_ITEMS:,}")

    svc = service(ds, device, candidate_chunk=kw["chunk"],
                  topk_grid_rows=kw["rows"])
    results = dict(catalog_items=int(ds.num_items),
                   catalog_users=int(ds.num_users),
                   candidate_chunk=svc.candidate_chunk,
                   topk_grid_rows=svc.topk_grid_rows,
                   prep_s=round(prep_s, 1))
    t0 = time.time()
    items1, scores1 = svc.topk(7, k=10)       # the first call
    results["topk_first_call_s"] = round(time.time() - t0, 2)
    assert items1.shape == (10,) and np.isfinite(scores1).all()
    lat = []
    for _ in range(3):
        t0 = time.time()
        svc.topk(7, k=10)
        lat.append(time.time() - t0)
    results["topk_warm_s"] = round(float(np.median(lat)), 2)
    results["items_per_s"] = round(ds.num_items / float(np.median(lat)))

    # --- multi-user catalogue topk (topk_batch) ---
    # R users share every [R, chunk] block dispatch, so the batch axis is
    # full (the single-user path pads grid rows with the same user)
    for R in (4, 16):
        users = np.arange(3, 3 + R, dtype=np.int32)
        svc.topk_batch(users, k=10)           # warm-up
        lat = []
        for _ in range(3):
            t0 = time.time()
            bi, bs = svc.topk_batch(users, k=10)
            lat.append(time.time() - t0)
        assert bi.shape == (R, 10) and np.isfinite(bs).all()
        med = float(np.median(lat))
        results[f"topk_batch_R{R}_s"] = round(med, 2)
        results[f"topk_batch_R{R}_per_user_s"] = round(med / R, 3)
        results[f"topk_batch_R{R}_user_items_per_s"] = round(
            R * ds.num_items / med)
        print(json.dumps({k: results[k] for k in results
                          if k.startswith(f"topk_batch_R{R}")}), flush=True)
    results.update(res_machine)
    print(json.dumps(results), flush=True)
    out = args[0] if args else os.path.join(tempfile.gettempdir(),
                                            "serve_catalog.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
