"""One rank of a gloo world on the CPU for tests/test_torch_sharding.py:
the port's row-sharded lookups and sharded train steps, on inputs the
test writes, with results the test holds to the JAX package's.

    python tests/_torch_shard_worker.py <rank> <world> <data> <rows> <dir>

Every rank joins the world through a file store in <dir>, reads
<dir>/inputs.npz and runs every check of its world in one go; rank 0
writes <dir>/results.npz. A (2, 2) world runs the psum and a2a lookups
and their table gradients, the a2a capacity and overflow cases, and the
sharded train steps (configs4 at the tests' tiny widths, the draws fed
in; and, against the port's own unsharded step on the whole batch,
steps that draw their own shifts, masks and keys); a (2, 1) world the
'local' data-parallel step. It imports no JAX and nothing of the JAX
package; the file has no test_ prefix, so pytest does not collect it.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from score_tpu_torch.config import ShardingConfig, configs4
from score_tpu_torch.graph import DeviceGraph
from score_tpu_torch.params import init_params
from score_tpu_torch.sharding import (a2a_lookup, all_gather_world, bringup,
                                      full_tables, psum_lookup)
from score_tpu_torch.train import init_state, train_loop, train_step

B = 16                        # the global batch of every step
WIDTHS = dict(embed_dim=8, hidden_dim=8, mlp_dims=(16, 8))
LOOKUP_V, LOOKUP_D = 64, 16
LOOKUP_N_IDS = (16, 40, 18)   # 18 padded with id 0 to 20
CAPACITY_IDS = 256            # over 5 distinct ids; capacity 8 exact
OVERFLOW_IDS, OVERFLOW_CAPACITY = 64, 2
DUP_IDS, DUP_CAPACITY = 64, 8
# the steps held to the JAX package's configs4(2, 2) step: overrides of
# configs4's sections, and the steps taken
JAX_CASES = {
    "uniform": dict(data=dict(train_neg_mode="uniform"), steps=1),
    "inbatch_iw": dict(data=dict(train_neg_mode="inbatch_iw",
                                 num_train_neg=2), steps=1),
    "psum": dict(data=dict(train_neg_mode="inbatch_iw"),
                 sharding=dict(lookup_mode="psum"), steps=2),
    "mf": dict(model=dict(arch="mf"), data=dict(train_neg_mode="uniform"),
               steps=2),
    # the card's timed step: bf16 compute, in-batch IW, stride 2 at 2x;
    # also run unsharded (`plain`) as the yardstick of bf16's rounding
    "bf16": dict(model=dict(compute_dtype="bfloat16"),
                 data=dict(train_neg_mode="inbatch_iw"),
                 train=dict(table_update_every=2, table_lr_boost=2.0),
                 steps=3, plain=True),
    "stride2": dict(data=dict(train_neg_mode="inbatch_iw"),
                    train=dict(table_update_every=2, table_lr_boost=2.0),
                    steps=3),
    "stride2_sgd_l2": dict(data=dict(train_neg_mode="uniform"),
                           train=dict(table_update_every=2,
                                      table_lr_boost=2.0, optimizer="sgd",
                                      learning_rate=0.5, l2_emb=0.1),
                           steps=3),
    "overflow": dict(data=dict(train_neg_mode="uniform"),
                     sharding=dict(a2a_capacity=1), steps=1),
}
# the steps held to the port's unsharded step on the whole batch, each
# drawing its own shifts, masks and keys (torch's draws, which the
# reference cannot take), and the data-parallel 'local' step
PORT_CASES = {
    "draws": dict(data=dict(train_neg_mode="inbatch_iw", num_train_neg=2,
                            user_fanout=3, item_fanout=3,
                            neighbor_resample=True),
                  model=dict(dropout=0.1), steps=2),
    "local": dict(data=dict(train_neg_mode="inbatch_iw"),
                  train=dict(table_update_every=2, table_lr_boost=2.0),
                  sharding=dict(lookup_mode="local"), steps=3),
}


def case_config(make_configs4, case: dict, data: int = 2, rows: int = 2):
    """configs4(data, rows) of either package (its `configs4`) at the
    tiny widths, batch B, with the case's overrides."""
    cfg = make_configs4(data, rows)
    sections = {}
    for name, base in (("model", dict(WIDTHS)), ("data", {}),
                       ("train", dict(batch_size=B)), ("sharding", {})):
        kw = dict(base, **case.get(name, {}))
        sections[name] = dataclasses.replace(getattr(cfg, name), **kw)
    return cfg.replace(**sections)


def _rows(mesh, x):
    """This rank's rows of the whole batch's x [n, ...]."""
    per = x.shape[0] // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def _whole_grad(mesh, g):
    """The whole table's gradient from each rank's block gradient: summed
    over the data group, gathered over the rows group."""
    dist.all_reduce(g, group=mesh.data_group)
    parts = [torch.empty_like(g) for _ in range(mesh.num_rows)]
    dist.all_gather(parts, g, group=mesh.rows_group)
    return torch.cat(parts)


def _block(mesh, table):
    per = table.shape[0] // mesh.num_rows
    return table[mesh.row_index * per:(mesh.row_index + 1) * per]


def _lookup(mesh, fn, table, ids, w, **kw):
    """fn's rows of this rank's ids and the whole table's gradient of
    sum(rows * w): (rows of the whole batch, gradient, overflow)."""
    block = _block(mesh, table).clone().requires_grad_(True)
    out = fn(mesh, block, _rows(mesh, ids), **kw)
    ovf = None
    if isinstance(out, tuple):
        out, ovf = out
    (g,) = torch.autograd.grad((out * _rows(mesh, w)).sum(), [block])
    return all_gather_world(mesh, out.detach()), _whole_grad(mesh, g), ovf


def run_lookups(mesh, inp, res):
    table = torch.from_numpy(inp["lookup.table"])
    for n_ids in LOOKUP_N_IDS:
        ids = torch.from_numpy(inp[f"lookup.ids.{n_ids}"])
        w = torch.from_numpy(inp[f"lookup.w.{n_ids}"])
        for name, fn in (("psum", psum_lookup), ("a2a", a2a_lookup)):
            out, g, _ = _lookup(mesh, fn, table, ids, w)
            res[f"lookup.{name}.{n_ids}.fwd"] = out.numpy()
            res[f"lookup.{name}.{n_ids}.grad"] = g.numpy()
    # exchange bytes, counted from the buffers all_to_all_single sends
    sent = []
    real = dist.all_to_all_single

    def counting(out, x, *a, **kw):
        sent.append(x.numel() * x.element_size())
        return real(out, x, *a, **kw)
    ids = torch.from_numpy(inp["capacity.ids"])
    w = torch.zeros(ids.shape[0], LOOKUP_D)
    dist.all_to_all_single = counting
    try:
        for cap in (0, 8):
            sent.clear()
            out, _, ovf = _lookup(mesh, a2a_lookup, table, ids, w,
                                  capacity=cap, with_overflow=True)
            res[f"capacity.{cap}.fwd"] = out.numpy()
            res[f"capacity.{cap}.overflow"] = np.int64(ovf)
            # the forward's two exchanges, on this rank
            res[f"capacity.{cap}.bytes"] = np.int64(sum(sent[:2]))
    finally:
        dist.all_to_all_single = real
    ids = torch.from_numpy(inp["overflow.ids"])
    w = torch.zeros(ids.shape[0], LOOKUP_D)
    _, _, ovf = _lookup(mesh, a2a_lookup, table, ids, w,
                        capacity=OVERFLOW_CAPACITY, with_overflow=True)
    res["overflow.count"] = np.int64(ovf)
    ids = torch.from_numpy(inp["dup.ids"])
    w = torch.from_numpy(inp["dup.w"])
    out, g, ovf = _lookup(mesh, a2a_lookup, table, ids, w,
                          capacity=DUP_CAPACITY, with_overflow=True)
    res["dup.fwd"], res["dup.grad"] = out.numpy(), g.numpy()
    res["dup.overflow"] = np.int64(ovf)


class Inputs:
    """The test's dataset graph, batches, weights and draws, and the flax
    init of each arch as a state_dict (`sd[arch]`)."""

    def __init__(self, inp):
        self.inp = inp
        self.graph = DeviceGraph(*(torch.from_numpy(inp[f"graph.{k}"])
                                   for k in ("u2i", "u2i_cnt", "i2u",
                                             "i2u_cnt")))
        self.num_users = int(inp["num_users"])
        self.num_items = int(inp["num_items"])
        self.neg_iw = torch.from_numpy(inp["neg_iw"])
        self.sd = {}
        for k in inp:
            if k.startswith("sd."):
                arch, name = k[3:].split(".", 1)
                self.sd.setdefault(arch, {})[name] = torch.from_numpy(inp[k])

    def batch(self, j):
        return {k: torch.from_numpy(self.inp[f"batch.{k}"][j])
                for k in ("user", "item", "slot")}


def _draws(inp, name, j):
    """The fed-in draws of step j: (shifts, raw uniform negatives)."""
    shifts = inp.get(f"draw.{name}.shifts")
    negs = inp.get(f"draw.{name}.neg")
    return (None if shifts is None else [int(s) for s in shifts[j]],
            None if negs is None else torch.from_numpy(negs[j]))


def run_steps(mesh, x: Inputs, cases, res, port_init: bool):
    """Each case's steps on this rank's rows, from the test's flax init of
    its arch (or, `port_init`, the port's own, seed 0); the loss, overflow
    and whole parameters after each step, and with `port_init` or the
    case's `plain` the same from the unsharded step on the whole batch."""
    inp = x.inp
    for name, case in cases.items():
        cfg = case_config(configs4, case, mesh.num_data, mesh.num_rows)
        if port_init:
            sd = init_params(cfg, x.num_users, x.num_items,
                             torch.Generator().manual_seed(0))
        else:
            sd = x.sd[cfg.model.arch]
        plain = port_init or case.get("plain", False)
        runs = [("", mesh)] + ([("plain.", None)] if plain else [])
        for tag, m in runs:
            if m is None and mesh.rank != 0:
                continue
            if m is None:       # the same config, unsharded
                cfg = cfg.replace(sharding=ShardingConfig())
            state = init_state(cfg, x.num_users, x.num_items,
                               {k: v.clone() for k, v in sd.items()},
                               device="cpu", mesh=m)
            for j in range(case["steps"]):
                shifts, negs = _draws(inp, name, j)
                batch = x.batch(j)
                if m is not None:
                    batch = {k: _rows(m, v) for k, v in batch.items()}
                state, met = train_step(state, x.graph, batch, shifts,
                                        x.neg_iw, negatives=negs)
                key = f"step.{name}.{tag}{j}"
                res[f"{key}.loss"] = met["loss"].numpy()
                res[f"{key}.auc"] = met["batch_auc"].numpy()
                if m is not None:
                    res[f"{key}.overflow"] = met["a2a_overflow"].numpy()
                    params = full_tables(m, state)
                else:
                    params = dict(state.model.named_parameters())
                for k, v in params.items():
                    res[f"{key}.param.{k}"] = v.detach().numpy().copy()


def run_loop_overflow(mesh, x: Inputs, res):
    """train_loop's a2a_overflow: the sum of its steps' counts."""
    cfg = case_config(configs4, JAX_CASES["overflow"])
    counts = []
    for loop in (False, True):
        state = init_state(cfg, x.num_users, x.num_items,
                           {k: v.clone() for k, v in x.sd["score"].items()},
                           device="cpu", mesh=mesh)
        batches = [{k: _rows(mesh, v) for k, v in x.batch(j).items()}
                   for j in range(2)]
        if loop:
            _, met = train_loop(state, x.graph, batches, neg_iw=x.neg_iw)
            res["loop.overflow"] = met["a2a_overflow"].numpy()
        else:
            for b in batches:
                state, met = train_step(state, x.graph, b, neg_iw=x.neg_iw)
                counts.append(int(met["a2a_overflow"]))
    res["loop.step_overflows"] = np.array(counts)


def main(rank: int, world: int, data: int, rows: int, work: str) -> None:
    torch.set_num_threads(1)
    mesh, lookup_fn = bringup(
        ShardingConfig(num_data=data, num_rows=rows, lookup_mode="a2a"),
        init_method=f"file://{work}/store", world_size=world, rank=rank,
        device="cpu")
    assert (mesh.num_data, mesh.num_rows, mesh.rank) == (data, rows, rank)
    assert lookup_fn is not None
    inp = dict(np.load(f"{work}/inputs.npz"))
    x = Inputs(inp)
    res = {}
    if rows > 1:
        run_lookups(mesh, inp, res)
        run_steps(mesh, x, JAX_CASES, res, port_init=False)
        run_steps(mesh, x, {k: v for k, v in PORT_CASES.items()
                            if k != "local"}, res, port_init=True)
        run_loop_overflow(mesh, x, res)
    else:
        run_steps(mesh, x, {"local": PORT_CASES["local"]}, res,
                  port_init=True)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        np.savez(f"{work}/results.npz", **res)


if __name__ == "__main__":
    main(*map(int, sys.argv[1:5]), sys.argv[5])
