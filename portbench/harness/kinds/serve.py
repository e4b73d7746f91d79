"""The 'serve' traffic kind: a ranking tier's aggregator, closed loop, one
caller.

Set-up draws `distinct_calls` calls of `requests_per_call` requests from
the seed: each request is one user and one item of their history (a kept
event drawn uniformly) followed by `popular_items` distinct items drawn
by the log's item popularity, none of them that item; the slot is the
service's default (all history visible). The graph goes to the host as a
prepped dataset holds it and `ScoringService` takes it from there with
the benchmark's weights. A few calls warm up.

The window calls `ScoringService.score_batch` back to back, cycling
through the calls, each timed from its start to its scores in host
memory, until `seconds` have passed. `correct` compares the scores of a
sample of the calls the window served (`check_calls` of them, drawn from
the seed; each as last served) with the plain reference's, by the widest gap.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import program, work
from ..data import generate, generator, popular_items, popularity_cdf
from ..weights import make as make_weights
from ...reference import model as ref_model

CHECKS = ("score_gap",)
REF_BLOCK = 64          # requests a reference block


def setup(cell) -> None:
    from score_tpu_torch.serve import ScoringService
    cfg, tr, dev, st = cell.config, cell.traffic, cell.device, cell.state
    data = generate(cfg["data"], cell.seed, dev)
    cell.data = data
    g = generator(cell.seed + 1, dev)
    st["w0"] = make_weights(cfg, data.num_users, data.num_items, g, dev)
    calls, R = tr["distinct_calls"], tr["requests_per_call"]
    ev = data.events
    pick = torch.randint(0, ev["user"].numel(), (calls * R,), generator=g,
                         device=dev)
    users, pos = ev["user"][pick], ev["item"][pick]
    others = popular_items(popularity_cdf(data), pos, tr["popular_items"], g)
    items = torch.cat([pos[:, None], others], dim=1)
    st["users"] = users.view(calls, R).cpu().numpy()
    st["items"] = items.view(calls, R, -1).cpu().numpy()
    data.events = {}
    cell.data_ready()
    pc = program.port_config(cfg, R, cell.seed)
    st["svc"] = ScoringService(pc, program.host_dataset(data),
                               program.clone(st["w0"]), device=dev)
    st["slot"] = st["svc"].slot
    st["kept"] = {}
    for j in range(tr["warmup_calls"]):
        _call(cell, j)
    st["kept"] = {}
    program.free(dev)


def _call(cell, j: int) -> float:
    st = cell.state
    c = j % len(st["users"])
    t0 = time.perf_counter()
    out = st["svc"].score_batch(st["users"][c], st["items"][c])
    dt = time.perf_counter() - t0
    st["kept"][c] = out
    return dt


def window(cell, seconds: float) -> Dict[str, float]:
    lat = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        lat.append(_call(cell, len(lat)))
    wall = time.perf_counter() - t0
    R = cell.traffic["requests_per_call"]
    cell.state["attempted"] = R * len(lat)
    return {"serve_requests_per_s": R * len(lat) / wall,
            "serve_p95_ms": 1e3 * p95(lat)}


def p95(values) -> float:
    """The 95th percentile of all values, nearest rank."""
    v = np.sort(np.asarray(values, np.float64))
    return float(v[max(int(np.ceil(0.95 * v.size)) - 1, 0)])


def traced(cell) -> int:
    n = cell.traffic["trace_calls"]
    for j in range(n):
        with cell.span("call"):
            _call(cell, j)
    cell.state["attempted"] = cell.traffic["requests_per_call"] * n
    return n


def trace_work(cell):
    cfg, tr, st = cell.config, cell.traffic, cell.state
    graph = cell.data.graph()
    dev = cell.device
    slots = torch.full((tr["requests_per_call"],), st["slot"],
                       dtype=torch.int32, device=dev)
    nbytes = work.elem_bytes(cfg["model"], training=False)
    total: Dict[str, float] = {}
    n = tr["trace_calls"]
    per = {}
    for c in sorted({j % len(st["users"]) for j in range(n)}):
        per[c] = work.unit_work(
            cfg["model"], graph, torch.from_numpy(st["users"][c]).to(dev),
            torch.from_numpy(st["items"][c]).to(dev), slots, *nbytes)
    for j in range(n):
        for k, v in per[j % len(st["users"])].items():
            total[k] = total.get(k, 0.0) + v
    C = st["items"].shape[-1]
    flops = n * work.forward_flops(cfg["model"], cfg["data"],
                                   tr["requests_per_call"], C)
    return total, flops


def release(cell) -> None:
    cell.state.pop("svc", None)
    program.free(cell.device)


def _ref_scores(cell, c: int, q=None) -> torch.Tensor:
    st, dev = cell.state, cell.device
    users = torch.from_numpy(st["users"][c]).to(dev)
    items = torch.from_numpy(st["items"][c]).to(dev)
    slots = torch.full_like(users, st["slot"])
    return ref_model.blocked_logits(cell.config["model"], st["w0"],
                                    cell.data.graph(), users, items, slots,
                                    REF_BLOCK, q=ref_model.round_to(q))


def sample(cell, served) -> list:
    """`check_calls` of the calls `served`, drawn from the seed."""
    rng = np.random.default_rng((int(cell.seed), 2))
    served = sorted(served)
    n = min(cell.traffic["check_calls"], len(served))
    return [served[i] for i in sorted(rng.choice(len(served), size=n,
                                                 replace=False))]


def check(cell) -> Dict[str, float]:
    kept = cell.state["kept"]
    if not kept:
        return {"score_gap": float("inf")}
    gap = 0.0
    for c in sample(cell, kept):
        out = kept[c]
        ref = _ref_scores(cell, c).cpu().numpy()
        gap = max(gap, float(np.max(np.abs(out.astype(np.float64) - ref))))
    return {"score_gap": gap}


def control(cell, dtype) -> Dict[str, float]:
    gap = 0.0
    for c in sample(cell, range(len(cell.state["users"]))):
        lo = _ref_scores(cell, c, dtype)
        gap = max(gap, float((lo - _ref_scores(cell, c)).abs().max()))
    return {"score_gap": gap}
