"""Scaling harness: train examples/s on 1 device against an N-rank mesh.

`measure(n, ...)` times the configs3 train step: at n = 1 on the local
path (whole tables and graph on one device), at n > 1 under the world's
(data, rows) mesh of `sharding.factor_mesh(n)` (`sharding.make_mesh`):
the state sharded (`init_state(..., mesh=)`, which runs `shard_state`),
the graph too where the tables are row-sharded (`graph.mesh_graph`,
which runs `shard_graph`), each rank stepping its rows of every global
batch of batch_per_device x n targets through `train_step`.

Run it under `python -m torch.distributed.run --nproc-per-node N`: gloo
on the CPU (`--device cpu`; that validates the harness and the sharded
program, its rates mean nothing of hardware) and NCCL on cards, one card
a rank. It measures n = 1 (on rank 0, the others waiting) and n = N.
Started alone it measures n = 1. NCCL puts no two ranks on one device:
a host with fewer cards than ranks is refused, and a one-card host
measures n = 1 alone, which the output says.

The port's counterpart of the JAX package's scripts/scaling.py: the same
dataset, arguments and printed lines, then one JSON line with the rates,
`device` and `host`.

Usage: python -m score_tpu_torch.scripts.scaling [batch_per_device]
           [steps] [--device D]
       python -m torch.distributed.run --nproc-per-node N -m
           score_tpu_torch.scripts.scaling [batch_per_device] [steps]
           [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist

from ..config import ShardingConfig, configs3
from ..data import synth
from ..data.pipeline import TargetIterator
from ..data.prep_common import build_dataset
from ..graph import device_graph, mesh_graph
from ..params import init_params
from ..sharding import bringup, factor_mesh, make_mesh
from ..train import _batch_rows, init_state, step_shifts, train_step
from . import machine
from .ladder import split_argv


def scaling_dataset():
    """The JAX script's dataset: 2,000 users, 4,000 items, 150,000
    events over 8 slots, fan-out 8."""
    user, item, ts = synth.synth_events(2000, 4000, 150_000, num_slots=8,
                                        seed=0)
    return build_dataset(user, item, ts, num_slots=8, user_fanout=8,
                         item_fanout=8, num_eval_neg=10, min_user=3,
                         min_item=3, seed=0)


def measure(n_devices: int, batch_per_device: int, steps: int, ds,
            device="cuda") -> float:
    """Global train examples/s of configs3 over `steps` timed steps after
    one warm-up step, ending with a readback of the last loss: on
    `device` at n_devices = 1, else under the mesh of the current world
    (of n_devices ranks, every rank calling), each rank on its mesh
    device."""
    cfg = configs3()
    B = batch_per_device * n_devices
    mesh, rows = None, slice(None)
    if n_devices > 1:
        if not dist.is_initialized() or dist.get_world_size() != n_devices:
            raise ValueError(f"measure({n_devices}) runs in a world of "
                             f"{n_devices} ranks")
        data, nrows = factor_mesh(n_devices)
        cfg = cfg.replace(sharding=ShardingConfig(num_data=data,
                                                  num_rows=nrows))
        mesh = make_mesh(data, nrows)
        device = mesh.device
        rows = slice(mesh.rank * batch_per_device,
                     (mesh.rank + 1) * batch_per_device)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=B))
    graph = (device_graph(ds.graph, device) if mesh is None
             else mesh_graph(ds.graph, mesh, cfg.sharding.lookup_mode))
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(0))
    state = init_state(cfg, ds.num_users, ds.num_items, sd, device=device,
                       mesh=mesh)
    it = TargetIterator(ds.train, B, seed=0)
    k = cfg.data.num_train_neg
    uniform = cfg.data.train_neg_mode == "uniform"

    def run_one(step):
        batch = _batch_rows(next(it), rows)
        if uniform:
            return train_step(state, graph, batch)
        return train_step(state, graph, batch, step_shifts(0, step, k, B))

    _, m = run_one(0)
    float(m["loss"])                        # warm-up and readback
    t0 = time.time()
    for s in range(steps):
        _, m = run_one(1 + s)
    float(m["loss"])
    return B * steps / (time.time() - t0)


def main(argv=None, device: str = "cuda") -> dict:
    args, _, device = split_argv(argv, device)
    batch_per_device = int(args[0]) if len(args) > 0 else 256
    steps = int(args[1]) if len(args) > 1 else 20
    torchrun = "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ["WORLD_SIZE"]) if torchrun else 1)
    dev = torch.device(device)
    if dev.type == "cuda" and world > 1:
        cards = torch.cuda.device_count()
        if cards < world:
            raise RuntimeError(
                f"a world of {world} ranks needs a card a rank (NCCL puts "
                f"no two ranks on one device); this host has {cards}")
    joined = dist.is_initialized()
    if torchrun and not joined:
        data, rows = factor_mesh(world)         # env:// from torchrun
        mesh, _ = bringup(ShardingConfig(num_data=data, num_rows=rows),
                          device=dev)
        dev = mesh.device
    rank = dist.get_rank() if dist.is_initialized() else 0
    record = machine.record(dev)
    ds = scaling_dataset()
    points = sorted({1, world})
    results = {}
    try:
        for n in points:
            eps = 0.0
            if n > 1 or rank == 0:
                eps = measure(n, batch_per_device, steps, ds, dev)
            if dist.is_initialized():
                dist.barrier()
            results[n] = eps
            if rank == 0:
                eff = eps / (results[1] * n)
                print(f"devices={n:2d}  examples/s={eps:10,.0f}  "
                      f"parallel-efficiency={eff:.2f}", flush=True)
    finally:
        if torchrun and not joined:
            dist.destroy_process_group()
    out = dict(examples_per_s={str(n): r for n, r in results.items()},
               batch_per_device=batch_per_device, steps=steps, world=world,
               backend=dev.type, **record)
    if rank == 0:
        print(f"backend={dev.type}" + (
            " (gloo ranks on the CPU validate the harness, not hardware)"
            if dev.type == "cpu" and world > 1 else ""))
        if dev.type == "cuda" and world == 1:
            print(f"N>1 not measured: {torch.cuda.device_count()} CUDA "
                  f"device(s) visible and one rank; on N cards run it under "
                  f"python -m torch.distributed.run --nproc-per-node N",
                  flush=True)
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
