"""The 'eval' traffic kind: periodic validation.

Set-up takes `slices` x `targets_per_call` val targets (a random subset
of the val split, drawn from the seed, in random order), draws each one's
`num_eval_neg` negatives on the device, and keeps the columns on the
host, as a prepped split is kept. The port's eval step
(`train.make_eval_step`) is built over a model holding the benchmark's
weights; one call on the last slice warms up.

The window calls `train.evaluate(eval_step, graph, slice, batch_size)` on
consecutive slices (the last one excepted), back to back, until
`seconds` have passed. `correct` compares the metrics of a sample of the
calls (`check_calls`, drawn from the seed) with the plain reference's
metrics of the same targets, by the widest gap over the metrics.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import program, work
from ..data import eval_negatives, generate, generator
from ..weights import make as make_weights
from ...reference import metrics as ref_metrics
from ...reference import model as ref_model

CHECKS = ("metric_gap",)
REF_BLOCK = 512            # targets a reference block


class _Slice:
    """A slice of the host val columns, as `train.evaluate` reads a split."""

    def __init__(self, cols: dict, lo: int, n: int):
        for k, v in cols.items():
            setattr(self, k, v[lo:lo + n])

    def __len__(self) -> int:
        return len(self.user)


def setup(cell) -> None:
    from score_tpu_torch.nn.model import build_model
    from score_tpu_torch.params import assign_weights
    from score_tpu_torch.train import evaluate, make_eval_step
    cfg, tr, dev, st = cell.config, cell.traffic, cell.device, cell.state
    data = generate(cfg["data"], cell.seed, dev)
    cell.data = data
    g = generator(cell.seed + 1, dev)
    st["w0"] = make_weights(cfg, data.num_users, data.num_items, g, dev)
    n = tr["slices"] * tr["targets_per_call"]
    val = data.val
    if val["user"].numel() < n:
        raise ValueError(f"{val['user'].numel()} val targets; the mix "
                         f"reads {n}")
    pick = torch.randperm(val["user"].numel(), generator=g, device=dev)[:n]
    cols = {k: v[pick] for k, v in val.items()}
    cols["neg"] = eval_negatives(data, cols["user"], cols["item"],
                                 cfg["data"]["num_eval_neg"], g)
    st["cols"] = {k: v.cpu().numpy() for k, v in cols.items()}
    del cols, pick
    data.events = {}
    cell.data_ready()
    st["graph"] = program.device_graph(data)
    model = build_model(program.port_config(cfg, tr["batch"], cell.seed),
                        data.num_users, data.num_items)
    assign_weights(model, program.clone(st["w0"]))
    st["eval_step"] = make_eval_step(model)
    del model
    st["evaluate"] = evaluate
    st["outputs"] = {}
    _call(cell, tr["slices"] - 1)
    st["outputs"] = {}
    program.free(dev)


def _call(cell, s: int) -> None:
    st, tr = cell.state, cell.traffic
    part = _Slice(st["cols"], s * tr["targets_per_call"],
                  tr["targets_per_call"])
    st["outputs"][s] = st["evaluate"](st["eval_step"], st["graph"], part,
                                      batch_size=tr["batch"])


def window(cell, seconds: float) -> Dict[str, float]:
    tr = cell.traffic
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        _call(cell, calls % (tr["slices"] - 1))
        calls += 1
    wall = time.perf_counter() - t0
    cell.state["attempted"] = calls * tr["targets_per_call"]
    return {"eval_targets_per_s": calls * tr["targets_per_call"] / wall}


def traced(cell) -> int:
    tr = cell.traffic
    for s in range(tr["trace_calls"]):
        with cell.span("call"):
            _call(cell, s)
    cell.state["attempted"] = tr["trace_calls"] * tr["targets_per_call"]
    return tr["trace_calls"] * tr["targets_per_call"] // tr["batch"]


def _targets(cell, lo: int, n: int):
    """users, candidates [n, 1 + N] (the positive first) and slots of val
    targets lo .. lo + n, on the device."""
    c = {k: torch.from_numpy(v[lo:lo + n]).to(cell.device)
         for k, v in cell.state["cols"].items()}
    return c["user"], torch.cat([c["item"][:, None], c["neg"]], 1), c["slot"]


def trace_work(cell):
    cfg, tr = cell.config, cell.traffic
    graph = cell.data.graph()
    nbytes = work.elem_bytes(cfg["model"], training=False)
    total: Dict[str, float] = {}
    B = tr["batch"]
    blocks = 0
    for s in range(tr["trace_calls"]):
        lo = s * tr["targets_per_call"]
        for b in range(lo, lo + tr["targets_per_call"], B):
            users, cand, slots = _targets(cell, b, B)
            w = work.unit_work(cfg["model"], graph, users, cand, slots,
                               *nbytes)
            for k, v in w.items():
                total[k] = total.get(k, 0.0) + v
            blocks += 1
    C = 1 + cfg["data"]["num_eval_neg"]
    flops = blocks * work.forward_flops(cfg["model"], cfg["data"], B, C)
    return total, flops


def release(cell) -> None:
    for key in ("eval_step", "graph"):
        cell.state.pop(key, None)
    program.free(cell.device)


def sample(cell, done) -> list:
    rng = np.random.default_rng((int(cell.seed), 3))
    done = sorted(done)
    n = min(cell.traffic["check_calls"], len(done))
    return [done[i] for i in sorted(rng.choice(len(done), size=n,
                                               replace=False))]


def _ref_metrics(cell, s: int, q=None) -> Dict[str, float]:
    tr = cell.traffic
    users, cand, slots = _targets(cell, s * tr["targets_per_call"],
                                  tr["targets_per_call"])
    scores = ref_model.blocked_logits(
        cell.config["model"], cell.state["w0"], cell.data.graph(), users,
        cand, slots, REF_BLOCK, q=ref_model.round_to(q))
    return ref_metrics.metrics(scores)


def gap(a: Dict[str, float], b: Dict[str, float]) -> float:
    return max(abs(a[k] - b[k]) for k in b)


def check(cell) -> Dict[str, float]:
    out = cell.state["outputs"]
    if not out:
        return {"metric_gap": float("inf")}
    return {"metric_gap": max(gap(out[s], _ref_metrics(cell, s))
                              for s in sample(cell, out))}


def control(cell, dtype) -> Dict[str, float]:
    done = range(cell.traffic["slices"] - 1)
    return {"metric_gap": max(gap(_ref_metrics(cell, s, dtype),
                                  _ref_metrics(cell, s))
                              for s in sample(cell, done))}
