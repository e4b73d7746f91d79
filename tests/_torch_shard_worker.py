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
steps that draw their own shifts, masks and keys, and bf16-parameter
steps through each exchange), and then the rest of
configs4 (`run_part2`): the row-sharded graph's gathers, `train()` with
sharded checkpoints (restored into the world and into other layouts, a
failed save), mesh serving, a bf16-parameter state's sharded checkpoint
and mesh serving, the overflow policy, `entry.dryrun_rank` and
the CLI's `main`, on the test's dataset saved in <dir>/data; a (2, 1)
world the 'local' data-parallel step and `scripts.scaling.measure` at
N=2 on the test's dataset. It imports no JAX and nothing of
the JAX package; the file has no test_ prefix, so pytest does not collect
it.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from score_tpu_torch import checkpoint as ckpt_mod
from score_tpu_torch import entry
from score_tpu_torch.checkpoint import CheckpointManager, apply_restore
from score_tpu_torch.config import ShardingConfig, configs4
from score_tpu_torch.data.schema import load_dataset
from score_tpu_torch.graph import (DeviceGraph, device_graph, gather_batch,
                                   gather_candidate_batch, mesh_graph)
from score_tpu_torch.params import init_params
from score_tpu_torch.scripts import scaling
from score_tpu_torch.serve import ScoringService
from score_tpu_torch.sharding import (a2a_lookup, all_gather_world, bringup,
                                      full_tables, make_mesh, psum_lookup)
from score_tpu_torch.train import (init_state, item_importance_weights,
                                   main as train_main, train, train_loop,
                                   train_step)

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
    # bf16 parameters (bf16 tables and moments, f32 compute), a table
    # step through each exchange: the gradients pre-reduced, exchanged and
    # summed over the data group in bf16
    "bf16params": dict(model=dict(param_dtype="bfloat16"),
                       data=dict(train_neg_mode="inbatch_iw"),
                       train=dict(table_update_every=2, table_lr_boost=2.0),
                       steps=1),
    "bf16params_psum": dict(model=dict(param_dtype="bfloat16"),
                            data=dict(train_neg_mode="inbatch_iw"),
                            train=dict(table_update_every=2,
                                       table_lr_boost=2.0),
                            sharding=dict(lookup_mode="psum"), steps=1),
}


# train() on configs4(2, 2), held to the JAX package's train() on the
# fake mesh: batch 256 (45 steps an epoch of the test's dataset), val
# every 15 steps on 256 targets, lr 1e-4, in-batch IW
DRIVER_B = 256
DRIVER = dict(data=dict(train_neg_mode="inbatch_iw"),
              train=dict(batch_size=DRIVER_B, num_epochs=1, learning_rate=1e-4,
                         eval_every_steps=15, eval_max_targets=256,
                         early_stop_patience=100, log_every_steps=10 ** 9))
# the overflow policy at a2a_capacity 1 (uniform negatives, as the
# reference's test), no val before the epoch's end
OVERFLOW = dict(data=dict(train_neg_mode="uniform"),
                train=dict(batch_size=DRIVER_B, num_epochs=1,
                           eval_every_steps=10 ** 9, eval_max_targets=256,
                           log_every_steps=10 ** 9),
                sharding=dict(a2a_capacity=1))
CLI_ARGS = ("model.embed_dim=8", "model.hidden_dim=8", "model.mlp_dims=16,8",
            "train.batch_size=512", "train.num_epochs=1",
            "train.eval_max_targets=256", "train.log_every_steps=1000000000")
SERVE_ITEMS, SERVE_USERS, SERVE_WIDTH = 21, 4, 64
SCALING_BATCH, SCALING_STEPS = 16, 2      # a rank's batch; timed steps
DRIVER_METRICS = ("auc", "ndcg@10", "hr@10", "mrr")


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
                for k, v in params.items():     # bf16 as f32, exactly
                    res[f"{key}.param.{k}"] = v.detach().float().numpy(
                    ).copy()


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


def _every_rank(mesh, x) -> np.ndarray:
    """[world, ...]: x (a float array) from every rank."""
    t = torch.as_tensor(np.asarray(x, np.float64))
    return all_gather_world(mesh, t[None]).numpy()


def run_graph(mesh, ds, res):
    """This rank's rows of a batch through the row-sharded graph against
    the whole graph's gathers: gather_batch and gather_candidate_batch,
    every field bit-equal; the sharded fields of every rank gathered."""
    sharded = mesh_graph(ds.graph, mesh, "a2a")
    whole = device_graph(ds.graph, "cpu")
    per = DRIVER_B // mesh.size
    lo = mesh.rank * per
    t = ds.train
    u, i, sl = (torch.from_numpy(np.asarray(getattr(t, k)[lo:lo + per],
                                            np.int32))
                for k in ("user", "item", "slot"))
    cand = torch.stack([i, torch.roll(i, 3), torch.roll(i, 7)], dim=1)
    equal = True
    for name, fn, args in (("batch", gather_batch, (u, i, sl)),
                           ("cand", gather_candidate_batch, (u, cand, sl))):
        got, want = fn(sharded, *args), fn(whole, *args)
        for k in want:
            equal &= got[k].dtype == want[k].dtype and \
                torch.equal(got[k], want[k])
            if k in ("u_hist", "i_hist", "u_cnt", "i_cnt"):
                res[f"graph.{name}.{k}"] = all_gather_world(
                    mesh, got[k].contiguous()).numpy()
    res["graph.equal"] = _every_rank(mesh, float(equal))


def _driver_row(out) -> list:
    row = []
    for r in out["history"]:
        row += [r["step"]] + [r[k] for k in DRIVER_METRICS + ("loss",)]
    row += [out["test"][k] for k in DRIVER_METRICS]
    return row + [out["steps_run"], out["best_step"], out["best_val_auc"]]


def run_driver(mesh, ds, inp, work, res):
    """train() from the JAX init with JAX's shifts, sharded checkpoints in
    <work>/ck; then the checkpoint round trip, layouts and a failed save,
    and mesh serving from `best`."""
    cfg = case_config(configs4, DRIVER, mesh.num_data, mesh.num_rows)
    ck = os.path.join(work, "ck")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                checkpoint_dir=ck))
    shifts = inp["driver.shifts"]
    sd = {k[len("sd.score."):]: torch.from_numpy(v) for k, v in inp.items()
          if k.startswith("sd.score.")}
    out = train(cfg, ds, verbose=False, device="cpu", mesh=mesh,
                parity_state_dict=sd,
                parity_shifts_fn=lambda s, b: [int(x) for x in shifts[s]])
    res["driver.rows"] = _every_rank(mesh, _driver_row(out))
    res["driver.nvals"] = np.int64(len(out["history"]))
    for k, v in full_tables(mesh, out["params"]).items():
        res[f"best.param.{k}"] = v.numpy()
    run_restore(mesh, ds, cfg, out, ck, res)
    run_failed_save(mesh, cfg, out["state"], work, res)
    run_serving(mesh, ds, cfg, inp, ck, res)


def _state_tensors(state) -> dict:
    out = {f"param.{k}": v for k, v in state.model.state_dict().items()}
    for key in state.opt.state_keys:
        out.update({f"{key}.{k}": v
                    for k, v in getattr(state.opt, key).items()})
    return out


def run_restore(mesh, ds, cfg, out, ck, res):
    """`latest` (the run's last val, its last step) restored under the
    mesh into a state from other weights: bit-equal to the live blocks and
    optimizer state; one step from each, bit-equal. Then restored into
    the (1, 4) and (4, 1) layouts, each block against the saved tables
    gathered whole."""
    live = out["state"]
    other = init_params(cfg, ds.num_users, ds.num_items,
                        torch.Generator().manual_seed(7))
    fresh = init_state(cfg, ds.num_users, ds.num_items, other,
                       device="cpu", mesh=mesh)
    restored = CheckpointManager(ck, mesh).restore("latest", fresh)
    apply_restore(fresh, restored)
    a, b = _state_tensors(live), _state_tensors(fresh)
    equal = set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    equal &= fresh.step == live.step == out["steps_run"]
    per = DRIVER_B // mesh.size
    it_batch = {k: torch.from_numpy(np.asarray(
        getattr(ds.train, k)[mesh.rank * per:(mesh.rank + 1) * per],
        np.int32)) for k in ("user", "item", "slot")}
    neg_iw = torch.from_numpy(item_importance_weights(ds.train,
                                                      ds.num_items))
    graph = mesh_graph(ds.graph, mesh, cfg.sharding.lookup_mode)
    losses = []
    for st in (live, fresh):
        st, m = train_step(st, graph, it_batch, [5], neg_iw)
        losses.append(m["loss"].item())
    a, b = _state_tensors(live), _state_tensors(fresh)
    equal &= losses[0] == losses[1] and all(torch.equal(a[k], b[k])
                                            for k in a)
    res["restore.equal"] = _every_rank(mesh, float(equal))
    res["restore.loss"] = np.float64(losses[0])
    before = full_tables(mesh, restored["params"])    # the run's last
    layouts = []
    for data, rows in ((1, 4), (4, 1)):
        m2 = make_mesh(data, rows)
        got = CheckpointManager(ck, m2).restore("latest", torch.device("cpu"))
        ok = True
        for k, v in got["params"].items():
            per_rows = before[k].shape[0] // m2.num_rows
            want = before[k][m2.row_index * per_rows:
                             (m2.row_index + 1) * per_rows] \
                if "table" in k and v.ndim == 2 else before[k]
            ok &= torch.equal(v, want)
        layouts.append(float(ok))
    res["restore.layouts"] = _every_rank(mesh, layouts)


def run_failed_save(mesh, cfg, state, work, res):
    """A save whose write fails on rank 1 raises on every rank, and the
    previous save stays the one restored."""
    mgr = CheckpointManager(os.path.join(work, "crash"), mesh)
    mgr.save("latest", state, (0, 0), 0.5, 7, block=True)
    real = ckpt_mod.torch.save

    def torn_save(obj, f, *a, **kw):
        f.write(b"PK\x03\x04 half a checkpoint")
        raise OSError("disk full")
    if mesh.rank == 1:
        ckpt_mod.torch.save = torn_save
    raised = 0.0
    try:
        mgr.save("latest", state, (0, 2), 0.6, 9, block=True)
    except RuntimeError as e:
        raised = float("checkpoint save failed" in str(e))
    finally:
        ckpt_mod.torch.save = real
    got = mgr.restore("latest", torch.device("cpu"))
    res["crash.rows"] = _every_rank(mesh, [raised, got["step"],
                                           got["best_val"]])


def run_serving(mesh, ds, cfg, inp, ck, res):
    """ScoringService.from_checkpoint('best') under the mesh: score,
    score_batch and topk on every rank."""
    svc = ScoringService.from_checkpoint(cfg, ds, ck, "best", device="cpu",
                                         mesh=mesh)
    score = svc.score(int(inp["serve.user"]), inp["serve.items"])
    batch = svc.score_batch(inp["serve.users"], inp["serve.batch"])
    items, scores = svc.topk(int(inp["serve.user"]), k=10)
    res["serve.score"] = _every_rank(mesh, score)
    res["serve.batch"] = _every_rank(mesh, batch)
    res["serve.topk_items"] = _every_rank(mesh, items)
    res["serve.topk_scores"] = _every_rank(mesh, scores)


def run_bf16_params(mesh, ds, work, res):
    """bf16 parameters under the mesh: configs4 (a2a, in-batch IW) takes
    one step from the port's init; its sharded `latest` restores into a
    state from other weights bit-equal (bf16 blocks and moments), reads
    whole (no mesh) equal to the blocks gathered, and serves under the
    mesh the scores its whole read serves."""
    cfg = case_config(configs4, PORT_CASES["bf16params"], mesh.num_data,
                      mesh.num_rows)
    state = init_state(cfg, ds.num_users, ds.num_items, init_params(
        cfg, ds.num_users, ds.num_items, torch.Generator().manual_seed(0)),
        device="cpu", mesh=mesh)
    per = DRIVER_B // mesh.size
    batch = {k: torch.from_numpy(np.asarray(
        getattr(ds.train, k)[mesh.rank * per:(mesh.rank + 1) * per],
        np.int32)) for k in ("user", "item", "slot")}
    neg_iw = torch.from_numpy(item_importance_weights(ds.train,
                                                      ds.num_items))
    state, _ = train_step(state, mesh_graph(ds.graph, mesh, "a2a"), batch,
                          [5], neg_iw)
    ck = os.path.join(work, "ck_bf16")
    CheckpointManager(ck, mesh).save("latest", state, (0, 0), 0.5,
                                     state.step, block=True)
    fresh = init_state(cfg, ds.num_users, ds.num_items, init_params(
        cfg, ds.num_users, ds.num_items, torch.Generator().manual_seed(7)),
        device="cpu", mesh=mesh)
    apply_restore(fresh, CheckpointManager(ck, mesh).restore("latest",
                                                             fresh))
    a, b = _state_tensors(state), _state_tensors(fresh)
    equal = set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    equal &= sum(v.dtype == torch.bfloat16 for v in a.values()) == 6
    whole = CheckpointManager(ck).restore("latest", torch.device("cpu"))
    equal &= all(torch.equal(whole["params"][k], v)
                 for k, v in full_tables(mesh, state).items())
    users = np.asarray(ds.test.user[:SERVE_USERS], np.int32)
    items = np.random.default_rng(3).integers(
        1, ds.num_items + 1, (SERVE_USERS, SERVE_WIDTH)).astype(np.int32)
    scores = [ScoringService.from_checkpoint(
        cfg, ds, ck, "latest", device="cpu", mesh=m).score_batch(users,
                                                                 items)
        for m in (mesh, None)]
    equal &= np.array_equal(*scores)
    res["bf16ck.equal"] = _every_rank(mesh, float(equal))


def run_overflow(mesh, ds, res):
    """At a2a_capacity 1: 'raise' raises RuntimeError naming a2a_capacity
    on every rank; 'warn' runs the epoch."""
    rows = []
    for action in ("raise", "warn"):
        case = dict(OVERFLOW, sharding=dict(OVERFLOW["sharding"],
                                            overflow_action=action))
        cfg = case_config(configs4, case, mesh.num_data, mesh.num_rows)
        try:
            out = train(cfg, ds, verbose=False, device="cpu", mesh=mesh)
            rows.append(float(out["steps_run"]))
        except RuntimeError as e:
            rows.append(-1.0 if "a2a_capacity" in str(e) else -2.0)
    res["overflow.rows"] = _every_rank(mesh, rows)


def run_part2(mesh, work, inp, res):
    ds = load_dataset(os.path.join(work, "data"))
    run_graph(mesh, ds, res)
    run_driver(mesh, ds, inp, work, res)
    run_bf16_params(mesh, ds, work, res)
    run_overflow(mesh, ds, res)
    res["dryrun.losses"] = _every_rank(mesh, entry.dryrun_rank(mesh))
    out = train_main(["configs4", os.path.join(work, "data"), "--device",
                      "cpu", f"sharding.num_data={mesh.num_data}",
                      f"sharding.num_rows={mesh.num_rows}", *CLI_ARGS])
    res["cli.rows"] = _every_rank(mesh, [out["steps_run"],
                                         out["history"][-1]["loss"],
                                         out["test"]["auc"]])


def run_scaling(mesh, work, res):
    """The scaling harness's measure at N = the world's size."""
    ds = load_dataset(os.path.join(work, "data"))
    res["scaling.examples_per_s"] = _every_rank(mesh, [scaling.measure(
        mesh.size, SCALING_BATCH, SCALING_STEPS, ds, device="cpu")])


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
        run_part2(mesh, work, inp, res)
    else:
        run_steps(mesh, x, {"local": PORT_CASES["local"]}, res,
                  port_init=True)
        run_scaling(mesh, work, res)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        np.savez(f"{work}/results.npz", **res)


if __name__ == "__main__":
    main(*map(int, sys.argv[1:5]), sys.argv[5])
