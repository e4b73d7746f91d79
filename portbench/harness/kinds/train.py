"""The 'train' traffic kind: a training pipeline over the log.

Set-up builds one TrainState (`train.init_state`) from the benchmark's
weights and drives it through the first chunk of the mix: the first
`check_steps` steps as train_loop calls of 1 and check_steps - 1 steps
(so that the optimizer's state after one step and the weights after
check_steps can be read), then the rest of the chunk. The window then
runs whole chunks of `steps_per_chunk` steps, each staged by
`train.stage_chunk` from a `TargetIterator` seeded by the run's seed and
run by `train.train_loop`, until `seconds` have passed, and ends with a
readback of the last chunk's losses. The shifts of every step are drawn
by the benchmark from the seed and handed to the program.

`correct` holds the program's first steps to the plain reference's
(`reference.train`) on the same rows, shifts and weights: the first
gradient as Adam holds it after one step (its first moment over 1 - b1),
by the median leaf's gap, since the worst leaf's is the noise of the
scalar scorer bias; and the weights' change after check_steps, by the
worst leaf. Each step's loss is read and logged beside them. The same
TrainState then trains on through the window, by the same stage_chunk
and train_loop.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import program, work
from ..data import generate, generator
from ..weights import make as make_weights
from ...reference import model as ref_model
from ...reference import train as ref_train

# the numbers compared; loss_gap is read and logged but not compared: at
# 65,536 rows a step the loss averages the fp8 control's rounding away to
# about twice the program's, so no limit would separate them
CHECKS = ("grad_median_gap", "change_gap")


def _shifts(seed: int, batch: int, k: int):
    """The benchmark's in-batch shifts: step s's k distinct shifts in
    [1, batch), from a generator of (seed, s)."""
    def fn(step: int, B: int) -> List[int]:
        g = np.random.default_rng((int(seed), 1, int(step)))
        return [int(x) + 1 for x in g.choice(B - 1, size=k, replace=False)]
    return fn


def setup(cell) -> None:
    from score_tpu_torch.data.pipeline import TargetIterator
    from score_tpu_torch.train import (init_state, item_importance_weights,
                                       stage_chunk, train_loop)
    cfg, tr, dev, st = cell.config, cell.traffic, cell.device, cell.state
    data = generate(cfg["data"], cell.seed, dev)
    cell.data = data
    g = generator(cell.seed + 1, dev)
    st["w0"] = make_weights(cfg, data.num_users, data.num_items, g, dev)
    data.events = {}
    cell.data_ready()
    B, K = tr["batch"], tr["steps_per_chunk"]
    pc = program.port_config(cfg, B, cell.seed)
    st["cfg"], st["graph"] = pc, program.device_graph(data)
    host = program.host_targets(data.train)
    st["iter"] = TargetIterator(host, B, seed=cell.seed)
    st["neg_iw"] = torch.from_numpy(item_importance_weights(
        host, data.num_items)).to(dev)
    state = init_state(pc, data.num_users, data.num_items,
                       program.clone(st["w0"]), device=dev,
                       steps_per_epoch=st["iter"].steps_per_epoch)
    st["state"] = state
    st["shifts_fn"] = _shifts(cell.seed, B, cfg["train"]["num_train_neg"])
    st["stage"], st["loop"] = stage_chunk, train_loop
    n_check = tr["check_steps"]
    losses = []
    ms = _chunk(cell, 1)
    losses.append(ms["loss"])
    b1 = state.opt.b1
    st["prog_grad0"] = {k: (m.float() / (1 - b1)).norm()
                        for k, m in state.opt.mu.items()}
    ms = _chunk(cell, n_check - 1)
    losses.append(ms["loss"])
    st["prog_loss"] = torch.cat(losses)
    st["prog_change"] = {k: (p.detach().float() - st["w0"][k]).norm()
                         for k, p in state.model.named_parameters()}
    _chunk(cell, K - n_check)
    program.free(dev)


def _chunk(cell, k: int, keep: bool = False) -> Dict[str, torch.Tensor]:
    """One train_loop call of k steps; `keep` keeps its staged rows and
    shifts for the traced stretch's work."""
    st = cell.state
    with cell.span("stage_chunk"):
        batches, draws = st["stage"](st["cfg"], st["iter"], k,
                                     st["state"].step, cell.device,
                                     cell.data.num_items,
                                     shifts_fn=st["shifts_fn"])
    if keep:
        st.setdefault("traced", []).append((st["state"].step, batches,
                                            draws["shifts_list"]))
    with cell.span("train_loop"):
        st["state"], ms = st["loop"](st["state"], st["graph"], batches,
                                     neg_iw=st["neg_iw"], **draws)
    return ms


def window(cell, seconds: float) -> Dict[str, float]:
    K, B = cell.traffic["steps_per_chunk"], cell.traffic["batch"]
    steps = 0
    t0 = time.perf_counter()
    while True:
        ms = _chunk(cell, K)
        steps += K
        if time.perf_counter() - t0 >= seconds:
            break
    ms["loss"][-1].item()               # the readback of the last chunk
    wall = time.perf_counter() - t0
    cell.state["attempted"] = B * steps
    return {"train_examples_per_s": B * steps / wall}


def traced(cell) -> int:
    K = cell.traffic["steps_per_chunk"]
    for _ in range(cell.traffic["trace_chunks"]):
        ms = _chunk(cell, K, keep=True)
    with cell.span("readback"):
        ms["loss"][-1].item()
    cell.state["attempted"] = cell.traffic["batch"] * K * \
        cell.traffic["trace_chunks"]
    return K * cell.traffic["trace_chunks"]


def trace_work(cell):
    """Bound seconds by kernel family and model FLOPs of the traced
    steps, from their staged rows and shifts."""
    cfg, st = cell.config, cell.state
    graph = cell.data.graph()
    stride = cfg["train"]["table_update_every"]
    nbytes = work.elem_bytes(cfg["model"], training=True)
    total: Dict[str, float] = {}
    steps = 0
    for first, batches, shifts in st.pop("traced", []):
        for j, b in enumerate(batches):
            w = work.unit_work(cfg["model"], graph, b["user"],
                               b["item"][:, None], b["slot"], *nbytes,
                               shifts=shifts[j], backward=True,
                               table_step=(first + j) % stride == 0)
            for k, v in w.items():
                total[k] = total.get(k, 0.0) + v
            steps += 1
    B = cell.traffic["batch"]
    flops = steps * work.train_flops(cfg["model"], cfg["data"], B,
                                     cfg["train"]["num_train_neg"])
    return total, flops


def release(cell) -> None:
    st = cell.state
    st["prog_loss"] = st["prog_loss"].float().cpu().numpy()
    st["prog_grad0"] = {k: float(v) for k, v in st["prog_grad0"].items()}
    st["prog_change"] = {k: float(v) for k, v in st["prog_change"].items()}
    for key in ("state", "graph", "iter", "neg_iw", "traced"):
        st.pop(key, None)
    program.free(cell.device)


def reference(cell, q=None, half: bool = False) -> dict:
    cfg, tr = cell.config, cell.traffic
    return ref_train.run_steps(
        cfg, cell.state["w0"], cell.data.graph(), cell.data.train,
        cell.data.num_items, tr["batch"], cell.seed,
        [cell.state["shifts_fn"](s, tr["batch"])
         for s in range(tr["check_steps"])],
        tr["check_steps"], q=ref_model.round_to(q), half=half)


def readings(prog: dict, refr: dict) -> Dict[str, float]:
    """The three numbers compared: prog {loss, grad0, change} against the
    reference's."""
    loss = max(abs(float(a) - b) / abs(b) for a, b in zip(prog["loss"],
                                                          refr["loss"]))
    skip = ref_train.quiet_leaves(refr["grad0"])
    grad = ref_train.median_leaf_gap(prog["grad0"], refr["grad0"], skip)
    change, _ = ref_train.leaf_gap(prog["change"], refr["change"], skip)
    return dict(loss_gap=loss, grad_median_gap=grad, change_gap=change)


def all_readings(cell) -> Dict[str, float]:
    """`readings` of the program's first steps against the reference's,
    with the quiet and the worst leaves logged."""
    st = cell.state
    prog = dict(loss=list(st["prog_loss"]), grad0=st["prog_grad0"],
                change=st["prog_change"])
    refr = reference(cell)
    skip = ref_train.quiet_leaves(refr["grad0"])
    worst = [ref_train.leaf_gap(prog[k], refr[k], skip)
             for k in ("grad0", "change")]
    cell.log(f"quiet leaves left out: {skip}; worst leaves: gradient "
             f"{worst[0][1]} {worst[0][0]!r} (not compared), change "
             f"{worst[1][1]} {worst[1][0]!r}")
    return readings(prog, refr)


def check(cell) -> Dict[str, float]:
    got = all_readings(cell)
    cell.log(f"loss_gap {got['loss_gap']!r} (not compared)")
    return {k: got[k] for k in CHECKS}


def control(cell, dtype) -> Dict[str, float]:
    """The reference computed in `dtype` in the program's place."""
    return readings(reference(cell, dtype), reference(cell))


def half_batch(cell) -> Dict[str, float]:
    """The fault of half of each batch left out, planted in the reference
    put in the program's place."""
    return readings(reference(cell, half=True), reference(cell))
