"""Driver entry points of the port: the counterpart of __graft_entry__.py.

    fn, args = entry(device="cpu")     # the configs3 forward, tiny shapes
    logits = fn(*args)

    dryrun_multichip(4, device="cuda")  # 4 ranks, one card each

`entry` gives the flagship model's forward (configs3, full SCoRe) at tiny
shapes. `dryrun_rank(mesh)` runs, in each rank of a world, one configs4
step with psum lookups (the port's counterpart of the reference's GSPMD
step) and then 3 steps with a2a lookups through `train_loop`, both on the
row-sharded graph, and checks that every rank's losses are finite and
equal. `dryrun_multichip(n)` spawns the n ranks over a file store (gloo
on the CPU, NCCL on CUDA devices, one a rank) and runs it in each.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from .config import ShardingConfig, configs3, configs4
from .data import synth
from .data.prep_common import build_dataset
from .graph import device_graph, gather_batch, mesh_graph
from .params import init_params
from .sharding import all_gather_world, bringup, factor_mesh
from .train import init_state, train_loop, train_step


def _tiny_dataset(seed: int = 0):
    """The reference's graft-tiny dataset (128 users, 256 items, 6,000
    events over 6 slots, fan-outs 4)."""
    user, item, ts = synth.synth_events(128, 256, 6000, num_slots=6,
                                        seed=seed)
    return build_dataset(user, item, ts, num_slots=6, user_fanout=4,
                         item_fanout=4, num_eval_neg=5, min_user=2,
                         min_item=2, seed=seed, dataset_name="graft-tiny")


def entry(device="cuda"):
    """(fn, example_args): the configs3 forward on flat (user, item, slot)
    pairs, fn(model, graph, users, items, slots) -> logits [16], on
    `device`, from the port's seeded init."""
    ds = _tiny_dataset()
    cfg = configs3()
    state = init_state(cfg, ds.num_users, ds.num_items,
                       init_params(cfg, ds.num_users, ds.num_items,
                                   torch.Generator().manual_seed(0)),
                       device=device)
    model = state.model.eval()
    graph = device_graph(ds.graph, device)
    B = 16
    users, items, slots = (torch.from_numpy(np.asarray(
        getattr(ds.train, k)[:B], np.int32)).to(device)
        for k in ("user", "item", "slot"))

    @torch.inference_mode()
    def forward(model, graph, users, items, slots):
        return model(gather_batch(graph, users, items, slots))

    return forward, (model, graph, users, items, slots)


def dryrun_rank(mesh, steps: int = 3) -> List[float]:
    """In each rank of `mesh`'s world: configs4 of its shape at configs3's
    widths on the tiny dataset, batch 2 x mesh.size; one step with psum
    lookups, then `steps` steps with a2a lookups through `train_loop` on
    one batch repeated, both on the row-sharded graph. Raises unless every
    loss is finite and equal on every rank; returns [psum loss, a2a
    losses...]."""
    ds = _tiny_dataset()
    B = 2 * mesh.size
    base = configs4(mesh.num_data, mesh.num_rows)
    base = base.replace(train=dataclasses.replace(base.train, batch_size=B))
    per = B // mesh.size
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    batch = {k: torch.from_numpy(np.asarray(getattr(ds.train, k)[:B][rows],
                                            np.int32)).to(mesh.device)
             for k in ("user", "item", "slot")}
    sd = init_params(base, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(0))
    losses = []
    for mode in ("psum", "a2a"):
        cfg = base.replace(sharding=ShardingConfig(
            num_data=mesh.num_data, num_rows=mesh.num_rows,
            lookup_mode=mode))
        graph = mesh_graph(ds.graph, mesh, mode)
        state = init_state(cfg, ds.num_users, ds.num_items,
                           {k: v.clone() for k, v in sd.items()},
                           device=mesh.device, mesh=mesh)
        if mode == "psum":
            state, m = train_step(state, graph, batch)
            losses.append(m["loss"][None])
        else:
            state, m = train_loop(state, graph, [batch] * steps)
            losses.append(m["loss"])
    losses = torch.cat(losses).float()
    every = all_gather_world(mesh, losses[None])
    if not (torch.isfinite(every).all() and (every == every[0]).all()):
        raise AssertionError(f"dryrun losses differ across ranks or are "
                             f"not finite: {every.tolist()}")
    return losses.tolist()


def _rank_main(rank: int, n: int, store: str, device: str) -> None:
    data, rows = factor_mesh(n)
    mesh, _ = bringup(ShardingConfig(num_data=data, num_rows=rows,
                                     lookup_mode="a2a"),
                      init_method=f"file://{store}/store", world_size=n,
                      rank=rank, device=device)
    try:
        losses = dryrun_rank(mesh)
        if rank == 0:
            with open(os.path.join(store, "losses.json"), "w") as f:
                json.dump(losses, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> List[float]:
    """`dryrun_rank` in a world of n_devices ranks, each a process spawned
    here and joined over a file store in a temporary directory (gloo on
    the CPU; NCCL on CUDA, a card a rank, which needs n_devices cards).
    Raises if a rank fails; returns rank 0's losses."""
    import torch.multiprocessing as mp
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() < n_devices:
        raise ValueError(f"{n_devices} NCCL ranks need as many CUDA "
                         f"devices; this host has "
                         f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as store:
        mp.start_processes(_rank_main, args=(n_devices, store, str(device)),
                           nprocs=n_devices, start_method="spawn")
        with open(os.path.join(store, "losses.json")) as f:
            return json.load(f)
