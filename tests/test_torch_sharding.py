"""The port's row-sharded tables (score_tpu_torch/sharding.py) and its
sharded train step against the JAX package's score_tpu/sharding.py and
configs4 step, as tests/test_sharding.py holds the reference.

Two gloo worlds on the CPU, each rank a process running
tests/_torch_shard_worker.py, both started once for the module: a
(data=2, rows=2) world for the psum and a2a lookups, the a2a capacity and
overflow, and the sharded steps; a (2, 1) world for the 'local'
data-parallel step and the scaling harness at N=2. The JAX references are computed here, meanwhile, on
the fake mesh tests/conftest.py provides (make_mesh(jax.devices()[:4],
data=2, rows=2)); inputs and results pass as .npz files. The (2, 2) world
then runs the rest of configs4 on the test's dataset (saved in its
directory): the row-sharded graph, `train()` with sharded checkpoints
against the JAX package's `train()` on the fake mesh, the checkpoints'
round trips, mesh serving against the JAX package's mesh service, the
overflow policy, `entry.dryrun_rank` and the CLI's `main`.

Tolerances are the reference's: lookups bit-equal in f32; table
gradients rtol 1e-4 / atol 1e-6 (duplicate rows pre-reduced in another
order); a step's loss rtol 1e-5 and every parameter, read whole, rtol
1e-4 / atol 1e-6 (tests/test_sharding.py:285-293); overflow counts
equal."""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from score_tpu import config as jconfig
from score_tpu import sharding as jsh
from score_tpu import train as jtrain
from score_tpu.data.pipeline import TargetIterator
from score_tpu.data.schema import save_dataset
from score_tpu.graph import device_graph
from score_tpu.serve import ScoringService as JaxService
from score_tpu.train import (build_model, init_state,
                             item_importance_weights, make_train_step)
from score_tpu_torch import config as tconfig
from score_tpu_torch import graph as tgraph
from score_tpu_torch import sharding as tsh
from score_tpu_torch.checkpoint import CheckpointManager
from score_tpu_torch.kernels.gather import gather_rows
from score_tpu_torch.nn.model import check_config
from score_tpu_torch.params import from_flax, init_params, to_flax
from score_tpu_torch.serve import ScoringService

import _torch_shard_worker as worker
from _torch_helpers import bounded

torch.set_num_threads(2)

TESTS = Path(__file__).resolve().parent
JOIN_TIMEOUT_S = 120
LOSS_TOL = dict(rtol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-6)


# --- the layout, without a world -------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_factor_mesh(n):
    assert tsh.factor_mesh(n) == jsh.factor_mesh(n)
    data, rows = tsh.factor_mesh(n)
    assert data * rows == n


def test_pad_rows():
    t = torch.ones(10, 4)
    p = tsh.pad_rows(t, 4)
    assert p.shape == (12, 4)
    assert torch.all(p[10:] == 0) and torch.equal(p[:10], t)
    assert tsh.pad_rows(t, 5).shape == (10, 4)


def test_state_spec_rules():
    """The reference's rule on the port's names, as the reference's
    P('rows', None) and P()."""
    assert tsh.state_spec("tables.user_table", torch.ones(8, 4)) == \
        ("rows", None)
    assert tsh.state_spec("tables.table", torch.ones(8, 4)) == \
        ("rows", None)
    assert tsh.state_spec("gru_u.wx", torch.ones(8, 4)) == ()
    assert tsh.state_spec("tables.user_table", torch.ones(())) == ()


def test_graph_spec_rules(tiny_dataset):
    """The reference's graph rule on the port's node-major graph: the
    adjacency and counts are cut on the node axis, as P('rows', None,
    None) and P('rows', None)."""
    g = tgraph.device_graph(tiny_dataset.graph, "cpu")
    for name in ("u2i", "u2i_cnt", "i2u", "i2u_cnt"):
        t = getattr(g, name)
        want = jsh.graph_spec(name, t.numpy())
        assert tsh.graph_spec(name, t) == tuple(want), name
    assert tsh.graph_spec("n", torch.ones(())) == ()


def _fake_mesh(data, rows, rank=0):
    """A Mesh with no groups, for what needs no collective."""
    return tsh.Mesh(data, rows, rank, None, None, torch.device("cpu"))


def test_shard_state_refuses_rows_that_do_not_split(tiny_dataset):
    """Tables of 64-row multiples split over num_rows 2 (into blocks of
    their adam moments too); over 3 they raise, naming pad_rows."""
    from score_tpu_torch.train import init_state as tinit
    ds = tiny_dataset
    cfg = worker.case_config(tconfig.configs4, {}, 1, 2)
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(0))
    state = tinit(cfg, ds.num_users, ds.num_items, dict(sd), device="cpu",
                  mesh=_fake_mesh(1, 2, rank=1))
    ut = state.model.tables.user_table
    V = sd["tables.user_table"].shape[0]
    assert torch.equal(ut.detach(), sd["tables.user_table"][V // 2:])
    assert state.opt.mu["tables.user_table"].shape == (V // 2, 8)
    assert state.model.scorer.out.weight.shape == sd[
        "scorer.out.weight"].shape
    cfg3 = worker.case_config(tconfig.configs4,
                              {"train": dict(batch_size=24)}, 1, 3)
    with pytest.raises(ValueError, match="pad_rows"):
        tinit(cfg3, ds.num_users, ds.num_items, dict(sd), device="cpu",
              mesh=_fake_mesh(1, 3))


def test_check_config_needs_a_mesh_of_the_config_shape():
    """A sharded config trains only under a mesh of its shape: without one
    it is refused, naming the mesh and torchrun, never run unsharded."""
    cfg = tconfig.configs4(2, 2)
    with pytest.raises(NotImplementedError,
                       match="under a mesh.*torch.distributed.run"):
        check_config(cfg)
    with pytest.raises(ValueError, match="mesh"):
        check_config(cfg, _fake_mesh(1, 4))
    check_config(cfg, _fake_mesh(2, 2))
    odd = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=18))
    with pytest.raises(ValueError, match="batch_size"):
        check_config(odd, _fake_mesh(2, 2))


@pytest.mark.parametrize("entry", ["service", "train"])
def test_service_and_train_refuse_configs4(tiny_dataset, entry, monkeypatch):
    """Without a mesh, ScoringService serves configs4's weights whole, on
    one device, as configs3 on the same weights (the reference's
    mesh=None); train() outside any world refuses configs4, naming
    torchrun and train(..., mesh=), and does not run it unsharded."""
    from score_tpu_torch.serve import ScoringService
    from score_tpu_torch.train import train
    ds = tiny_dataset
    cfg = worker.case_config(tconfig.configs4, {})
    if entry == "service":
        sd = init_params(cfg, ds.num_users, ds.num_items,
                         torch.Generator().manual_seed(0))
        cfg3 = cfg.replace(sharding=tconfig.configs3().sharding)
        items = np.arange(1, 22)
        got = ScoringService(cfg, ds, sd, device="cpu").score(3, items)
        want = ScoringService(cfg3, ds, sd, device="cpu").score(3, items)
        np.testing.assert_array_equal(got, want)
    else:
        for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
            monkeypatch.delenv(k, raising=False)
        assert not dist.is_initialized()
        with pytest.raises(RuntimeError,
                           match=r"torch.distributed.run.*mesh="):
            train(cfg, ds, verbose=False, device="cpu")


@pytest.mark.parametrize("local_rank,rank,want", [(None, 5, 1), ("3", 5, 3),
                                                  (None, None, 2)])
def test_bringup_picks_the_card_of_the_local_rank(monkeypatch, local_rank,
                                                  rank, want):
    """A CUDA rank joins over NCCL and takes the card of torchrun's
    LOCAL_RANK, else of its rank (env:// gives it when `rank` is None),
    modulo the host's 4 cards; the CPU joins over gloo and takes none."""
    calls = {}
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setattr(tsh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(tsh.dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend,
                                                           **kw))
    monkeypatch.setattr(tsh.dist, "get_rank",
                        lambda: 6 if rank is None else rank)
    monkeypatch.setattr(tsh.torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tsh.torch.cuda, "set_device",
                        lambda i: calls.update(card=i))
    monkeypatch.setattr(tsh, "make_mesh", lambda data, rows: (data, rows))
    assert tsh.bringup(None, rank=rank, device="cuda") == ((1, 1), None)
    assert calls["backend"] == "nccl" and calls["card"] == want
    assert calls["rank"] == (-1 if rank is None else rank)
    calls.clear()
    tsh.bringup(None, rank=rank, device="cpu")
    assert calls["backend"] == "gloo" and "card" not in calls


def test_world_of_one_lookups_equal_gather_rows(tmp_path):
    """A one-rank gloo world in this process: bringup gives no lookup
    function, as the reference's; the a2a and psum lookups built anyway
    give gather_rows' rows and gradient, and overflow 0."""
    mesh, fn = tsh.bringup(None, init_method=f"file://{tmp_path}/store",
                           world_size=1, rank=0, device="cpu")
    try:
        assert fn is None and mesh.size == 1
        rng = np.random.default_rng(5)
        table = torch.from_numpy(rng.normal(size=(64, 16)).astype(
            np.float32)).requires_grad_(True)
        ids = torch.from_numpy(rng.integers(0, 64, (7, 5)).astype(np.int32))
        w = torch.randn(7, 5, 16)
        want = gather_rows(table, ids)
        (g_want,) = torch.autograd.grad((want * w).sum(), [table])
        for mode in ("a2a", "psum"):
            out = tsh.make_lookup_fn(mesh, mode)(table, ids)
            if mode == "a2a":
                out, ovf = out
                assert int(ovf) == 0
            assert torch.equal(out, want)
            (g,) = torch.autograd.grad((out * w).sum(), [table])
            np.testing.assert_allclose(g.numpy(), g_want.numpy(), **TOL)
        assert tsh.make_lookup_fn(mesh, "local") is None
    finally:
        dist.destroy_process_group()


# --- the two worlds ---------------------------------------------------------

def _inputs(ds, sds, draws) -> dict:
    """Everything the worlds read: lookup ids and cotangents, the graph,
    batches, importance weights, the flax init of each arch as a
    state_dict, and the reference's draws."""
    rng = np.random.default_rng(0)
    V, d = worker.LOOKUP_V, worker.LOOKUP_D
    inp = {"lookup.table": rng.normal(size=(V, d)).astype(np.float32)}
    for n in worker.LOOKUP_N_IDS:
        ids = rng.integers(0, V, n).astype(np.int32)
        w = rng.normal(size=(n, d)).astype(np.float32)
        pad = (-n) % 4          # the reference pads with id 0
        inp[f"lookup.ids.{n}"] = np.concatenate(
            [ids, np.zeros(pad, np.int32)])
        inp[f"lookup.w.{n}"] = np.concatenate([w, np.zeros((pad, d),
                                                            np.float32)])
    inp["capacity.ids"] = (rng.integers(0, 5, worker.CAPACITY_IDS) * 7
                           + 1).astype(np.int32)
    inp["overflow.ids"] = rng.permutation(V)[:worker.OVERFLOW_IDS].astype(
        np.int32)
    inp["dup.ids"] = (rng.integers(0, 6, worker.DUP_IDS) * 9 + 2).astype(
        np.int32)
    inp["dup.w"] = rng.normal(size=(worker.DUP_IDS, d)).astype(np.float32)
    g = tgraph.device_graph(ds.graph, "cpu")
    for k in ("u2i", "u2i_cnt", "i2u", "i2u_cnt"):
        inp[f"graph.{k}"] = getattr(g, k).numpy()
    inp["num_users"], inp["num_items"] = ds.num_users, ds.num_items
    inp["neg_iw"] = item_importance_weights(ds.train, ds.num_items)
    it = TargetIterator(ds.train, worker.B, seed=3)
    batches = [next(it) for _ in range(3)]
    for k in ("user", "item", "slot"):
        inp[f"batch.{k}"] = np.stack([b[k] for b in batches])
    for arch, sd in sds.items():
        inp.update({f"sd.{arch}.{k}": v.numpy() for k, v in sd.items()})
    inp.update(draws)
    users = np.unique(ds.test.user)
    inp["serve.user"] = users[0]
    inp["serve.items"] = rng.choice(np.arange(1, ds.num_items + 1),
                                    worker.SERVE_ITEMS, replace=False)
    inp["serve.users"] = users[1:1 + worker.SERVE_USERS]
    inp["serve.batch"] = rng.integers(
        1, ds.num_items + 1, (worker.SERVE_USERS, worker.SERVE_WIDTH)
    ).astype(np.int32)
    return inp


def _reference_draws(ds, rng) -> dict:
    """The reference step's draws for each case and step
    (score_tpu/train.py:196-229): k shifts, or the raw [B, k] negatives."""
    out = {}
    for name, case in worker.JAX_CASES.items():
        cfg = worker.case_config(jconfig.configs4, case)
        k, B = cfg.data.num_train_neg, worker.B
        shifts, negs = [], []
        for step in range(case["steps"]):
            step_rng = jax.random.fold_in(rng, step)
            if cfg.data.train_neg_mode == "uniform":
                negs.append(jax.random.randint(step_rng, (B, k), 1,
                                               ds.num_items + 1,
                                               dtype=jnp.int32))
            elif k == 1:
                shifts.append(jax.random.randint(step_rng, (k,), 1, B,
                                                 dtype=jnp.int32))
            else:
                shifts.append(jax.random.choice(
                    step_rng, jnp.arange(1, B, dtype=jnp.int32), (k,),
                    replace=False))
        if shifts:
            out[f"draw.{name}.shifts"] = np.stack(shifts)
        if negs:
            out[f"draw.{name}.neg"] = np.stack(negs)
    # the driver's in-batch shift of each step, as score_tpu/train.py
    # draws it: randint(fold_in(PRNGKey(seed), step), (1,), 1, B)
    steps = len(ds.train) // worker.DRIVER_B
    out["driver.shifts"] = np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(rng, s), (1,), 1, worker.DRIVER_B,
        dtype=jnp.int32)) for s in range(steps)])
    return out


def _spawn(work: Path, world: int, data: int, rows: int) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(TESTS.parent), os.environ.get("PYTHONPATH", "")]))
    procs = []
    for rank in range(world):
        log = open(work / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(TESTS / "_torch_shard_worker.py"),
             str(rank), str(world), str(data), str(rows), str(work)],
            cwd=str(TESTS.parent), env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def _join(work: Path, procs: list) -> dict:
    """Wait for every rank (JOIN_TIMEOUT_S from now), then rank 0's
    results; a rank that fails or hangs fails the test with its log."""
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for rank, (p, _) in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {rank} of {work.name} hung past "
                            f"{JOIN_TIMEOUT_S} s:\n"
                            + (work / f"rank{rank}.log").read_text()[-3000:])
            if p.returncode != 0:
                pytest.fail(f"rank {rank} of {work.name} exited "
                            f"{p.returncode}:\n"
                            + (work / f"rank{rank}.log").read_text()[-3000:])
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=JOIN_TIMEOUT_S)
            log.close()
    return dict(np.load(work / "results.npz"))


def _jax_rows_and_grad(fn, table, w):
    """fn(table) and the gradient of sum(fn(table) * w), jitted (the
    reference's shard_map runs op by op otherwise: ~10 s an a2a call)."""
    def loss(t):
        out = fn(t)
        return jnp.sum(out * w), out
    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(table)
    return np.asarray(out), np.asarray(g)


def _jax_lookups(mesh, inp) -> dict:
    """The reference's lookups and gradients on the fake (2, 2) mesh."""
    ref = {}
    table = jnp.asarray(inp["lookup.table"])
    for n in worker.LOOKUP_N_IDS:
        ids = jnp.asarray(inp[f"lookup.ids.{n}"][:n])
        w = jnp.asarray(inp[f"lookup.w.{n}"][:n])
        for name, fn in (("psum", jsh.psum_lookup), ("a2a", jsh.a2a_lookup)):
            (ref[f"lookup.{name}.{n}.fwd"],
             ref[f"lookup.{name}.{n}.grad"]) = _jax_rows_and_grad(
                lambda t: fn(mesh, t, ids), table, w)
    ids = jnp.asarray(inp["capacity.ids"])
    emb, ovf = jax.jit(lambda t: jsh.a2a_lookup(
        mesh, t, ids, capacity=8, with_overflow=True))(table)
    ref["capacity.8.fwd"], ref["capacity.8.overflow"] = (np.asarray(emb),
                                                         int(ovf))
    ids = jnp.asarray(inp["overflow.ids"])
    _, ovf = jax.jit(lambda t: jsh.a2a_lookup(
        mesh, t, ids, capacity=worker.OVERFLOW_CAPACITY,
        with_overflow=True))(table)
    ref["overflow.count"] = int(ovf)
    ids, w = jnp.asarray(inp["dup.ids"]), jnp.asarray(inp["dup.w"])
    _, ref["dup.grad"] = _jax_rows_and_grad(
        lambda t: jsh.a2a_lookup(mesh, t, ids, capacity=worker.DUP_CAPACITY),
        table, w)
    return ref


def _jax_steps(ds, mesh, rng, inp) -> dict:
    """The reference's configs4(2, 2) step for each case (its lookup_mode),
    from the flax init, with its own draws: loss, batch AUC, a2a_overflow
    and params after each step."""
    ref = {}
    jg = device_graph(ds.graph)
    neg_iw = jnp.asarray(inp["neg_iw"])
    for name, case in worker.JAX_CASES.items():
        cfg = worker.case_config(jconfig.configs4, case)
        model = build_model(cfg, ds.num_users, ds.num_items)
        state = init_state(cfg, model, jg, rng)
        sharded = build_model(cfg, ds.num_users, ds.num_items,
                              lookup_fn=jsh.make_lookup_fn(
                                  mesh, cfg.sharding.lookup_mode,
                                  cfg.sharding.a2a_capacity))
        step = make_train_step(sharded, cfg, neg_iw=neg_iw)
        for j in range(case["steps"]):
            batch = {k: jnp.asarray(inp[f"batch.{k}"][j])
                     for k in ("user", "item", "slot")}
            state, m = step(state, jg, batch, rng)
            key = f"step.{name}.{j}"
            ref[f"{key}.loss"] = float(m["loss"])
            ref[f"{key}.auc"] = float(m["batch_auc"])
            ref[f"{key}.overflow"] = int(m["a2a_overflow"])
            for k, v in from_flax(jax.tree.map(np.asarray,
                                               state.params)).items():
                ref[f"{key}.param.{k}"] = v.numpy()
    return ref


def _jax_driver(ds) -> dict:
    """The JAX package's train() on configs4(2, 2) (the fake mesh of its
    first 4 devices). Its init_state runs the model's a2a lookups op by op
    (~50 s here); the params do not depend on the lookup, so it is given
    the same model without one for the init alone (the steps and evals
    run the a2a model, as train() builds it)."""
    real = jtrain.init_state

    def init_state_unsharded(cfg, model, graph, rng, steps_per_epoch=0):
        return real(cfg, model.clone(lookup_fn=None), graph, rng,
                    steps_per_epoch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "init_state", init_state_unsharded)
        return jtrain.train(worker.case_config(jconfig.configs4,
                                               worker.DRIVER),
                            ds, verbose=False)


@pytest.fixture(scope="module")
def worlds(tiny_dataset, tmp_path_factory):
    """Both worlds' results and the JAX references: the worlds start as
    soon as their inputs exist and run while the references compile."""
    ds = tiny_dataset
    rng = jax.random.PRNGKey(0)
    sds = {}
    for arch in ("score", "mf"):
        cfg = worker.case_config(jconfig.configs4, {"model": dict(arch=arch)})
        jstate = init_state(cfg, build_model(cfg, ds.num_users,
                                             ds.num_items),
                            device_graph(ds.graph), rng)
        sds[arch] = from_flax(jax.tree.map(np.asarray, jstate.params))
    inp = _inputs(ds, sds, _reference_draws(ds, rng))
    runs = {}
    try:
        for name, world, data, rows in (("w4", 4, 2, 2), ("w2", 2, 2, 1)):
            work = tmp_path_factory.mktemp(name)
            np.savez(work / "inputs.npz", **inp)
            save_dataset(ds, str(work / "data"))
            runs[name] = (work, _spawn(work, world, data, rows))
        mesh = jsh.make_mesh(jax.devices()[:4], data=2, rows=2)
        ref = _jax_lookups(mesh, inp)
        ref.update(_jax_steps(ds, mesh, rng, inp))
        ref["driver"] = _jax_driver(ds)
    finally:
        out = {name: _join(work, procs) for name, (work, procs)
               in runs.items()}
    return dict(ref=ref, inp=inp, work=runs["w4"][0], mesh=mesh, **out)


def _params(res, key):
    pre = f"{key}.param."
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _close_params(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=f"{what} {k}", **TOL)


@pytest.mark.parametrize("n_ids", worker.LOOKUP_N_IDS)
@pytest.mark.parametrize("mode", ["psum", "a2a"])
def test_sharded_lookup_matches_reference(worlds, mode, n_ids):
    """Each rank's rows of its ids, gathered whole: bit-equal to the
    reference's lookup (and to table[ids])."""
    got = worlds["w4"][f"lookup.{mode}.{n_ids}.fwd"][:n_ids]
    want = worlds["ref"][f"lookup.{mode}.{n_ids}.fwd"]
    np.testing.assert_array_equal(got, want)
    inp = worlds["inp"]
    np.testing.assert_array_equal(
        got, inp["lookup.table"][inp[f"lookup.ids.{n_ids}"][:n_ids]])


@pytest.mark.parametrize("n_ids", worker.LOOKUP_N_IDS)
@pytest.mark.parametrize("mode", ["psum", "a2a"])
def test_sharded_lookup_grads_match_reference(worlds, mode, n_ids):
    """The table gradient of sum(rows * w), each block summed over the
    data group and read whole, against jax.grad of the reference's."""
    np.testing.assert_allclose(worlds["w4"][f"lookup.{mode}.{n_ids}.grad"],
                               worlds["ref"][f"lookup.{mode}.{n_ids}.grad"],
                               **TOL)


def test_a2a_capacity_exact_and_buffers_shrink(worlds):
    """With a capacity at or above each rank's unique ids (<= 5 here) the
    rows stay exact; the two exchange buffers a rank sends shrink from
    the exact worst case (its 64 ids) to the capacity's."""
    res, ref, inp = worlds["w4"], worlds["ref"], worlds["inp"]
    want = inp["lookup.table"][inp["capacity.ids"]]
    np.testing.assert_array_equal(res["capacity.0.fwd"], want)
    np.testing.assert_array_equal(res["capacity.8.fwd"], want)
    np.testing.assert_array_equal(res["capacity.8.fwd"],
                                  ref["capacity.8.fwd"])
    assert int(res["capacity.0.overflow"]) == 0
    assert int(res["capacity.8.overflow"]) == ref["capacity.8.overflow"] == 0
    full, capped = int(res["capacity.0.bytes"]), int(res["capacity.8.bytes"])
    # 64 ids a rank: [2, 64] requests and [2, 64, 16] rows; capacity 8
    assert full == 2 * 64 * 4 + 2 * 64 * 16 * 4
    assert capped == 2 * 8 * 4 + 2 * 8 * 16 * 4


def test_a2a_overflow_count_matches_reference(worlds):
    """Capacity 2 under 16 distinct ids a rank: 14 uniques past it on each
    of 4 ranks, summed over the world, as the reference's psum counts."""
    assert int(worlds["w4"]["overflow.count"]) == \
        worlds["ref"]["overflow.count"] == 4 * (16 - 2)


def test_a2a_dedup_grads_with_duplicates(worlds):
    """Duplicate-heavy ids at capacity 8: the rows exact and the
    pre-reduced gradients on the right rows."""
    res, ref, inp = worlds["w4"], worlds["ref"], worlds["inp"]
    np.testing.assert_array_equal(res["dup.fwd"],
                                  inp["lookup.table"][inp["dup.ids"]])
    assert int(res["dup.overflow"]) == 0
    np.testing.assert_allclose(res["dup.grad"], ref["dup.grad"], **TOL)
    want = np.zeros_like(inp["lookup.table"])
    np.add.at(want, inp["dup.ids"], inp["dup.w"])
    np.testing.assert_allclose(res["dup.grad"], want, rtol=1e-5, atol=1e-5)


def _check_steps(worlds, name):
    res, ref = worlds["w4"], worlds["ref"]
    for j in range(worker.JAX_CASES[name]["steps"]):
        key = f"step.{name}.{j}"
        np.testing.assert_allclose(res[f"{key}.loss"], ref[f"{key}.loss"],
                                   err_msg=key, **LOSS_TOL)
        np.testing.assert_allclose(res[f"{key}.auc"], ref[f"{key}.auc"],
                                   atol=1e-6, err_msg=key)
        assert int(res[f"{key}.overflow"]) == ref[f"{key}.overflow"]
        _close_params(_params(res, key), _params(ref, key), key)


@pytest.mark.parametrize("name", ["uniform", "inbatch_iw", "psum", "mf"])
def test_configs4_step_matches_jax(worlds, name):
    """configs4(2, 2) steps against the reference's on the fake mesh, each
    with the reference's draws: one a2a step with uniform negatives and
    one with two importance-weighted in-batch negatives (rolled ids
    crossing ranks); two psum steps (in-batch IW); two MF steps (uniform).
    Loss, batch AUC, overflow 0 and every parameter read whole."""
    _check_steps(worlds, name)
    assert worlds["ref"][f"step.{name}.0.overflow"] == 0


# how much further from the reference than the port's unsharded bf16
# step a sharded bf16 number may be
BF16_FACTOR = 1.1


def test_configs4_bf16_steps_against_jax(worlds):
    """Three bf16 stride-2 in-batch IW steps (the step the card times)
    against the reference's configs4(2, 2) bf16 steps. XLA's bf16 and
    torch's round differently, so the port's unsharded bf16 step is the
    yardstick: the sharded step's loss, batch AUC and every parameter,
    tables included, read whole, lie within BF16_FACTOR times its
    distance from the reference (plus 1e-6); the loss within rtol 1e-5
    and overflow 0 as in f32. A table row with a wrong gradient fails:
    its distance is the Adam step's, past the yardstick's."""
    res, ref = worlds["w4"], worlds["ref"]
    for j in range(worker.JAX_CASES["bf16"]["steps"]):
        key, plain = f"step.bf16.{j}", f"step.bf16.plain.{j}"
        np.testing.assert_allclose(res[f"{key}.loss"], ref[f"{key}.loss"],
                                   err_msg=key, **LOSS_TOL)
        assert int(res[f"{key}.overflow"]) == ref[f"{key}.overflow"] == 0
        got, want = _params(res, key), _params(ref, key)
        yard = _params(res, plain)
        assert set(got) == set(want) == set(yard), key
        got.update(loss=res[f"{key}.loss"], auc=res[f"{key}.auc"])
        yard.update(loss=res[f"{plain}.loss"], auc=res[f"{plain}.auc"])
        want.update(loss=ref[f"{key}.loss"], auc=ref[f"{key}.auc"])
        for k, w in want.items():
            bound = BF16_FACTOR * np.abs(yard[k] - w).max() + 1e-6
            err = np.abs(got[k] - w).max()
            assert err <= bound, f"{key} {k}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("name", ["stride2", "stride2_sgd_l2"])
def test_stride2_steps_on_shards_match_jax(worlds, name):
    """Full, dense, full steps on row-sharded tables (Adam; and sgd with
    l2_emb=0.1, where an L2 counted once per data replica would double
    the tables' decay): each step against the reference's, and the table
    blocks bit-unchanged on the dense step."""
    _check_steps(worlds, name)
    res = worlds["w4"]
    p0, p1 = _params(res, f"step.{name}.0"), _params(res, f"step.{name}.1")
    for k in p0:
        if "table" in k:
            np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
    assert not np.array_equal(p0["scorer.out.weight"],
                              p1["scorer.out.weight"])


def test_a2a_overflow_surfaces_in_train_metrics(worlds):
    """At a2a_capacity 1 the step's a2a_overflow is the reference's (> 0),
    and train_loop sums its steps' counts."""
    res = worlds["w4"]
    want = worlds["ref"]["step.overflow.0.overflow"]
    assert int(res["step.overflow.0.overflow"]) == want > 0
    assert int(res["loop.overflow"][0]) == int(
        res["loop.step_overflows"].sum()) > 0


@pytest.mark.parametrize("name", ["draws"])
def test_sharded_step_matches_unsharded(worlds, name):
    """Steps that draw their own shifts, dropout masks and re-sampling
    keys (at the global batch's shape, each rank keeping its rows; torch's
    draws, which the reference cannot be fed) against the port's
    unsharded step on the whole batch from the same init."""
    res = worlds["w4"]
    for j in range(worker.PORT_CASES[name]["steps"]):
        key, plain = f"step.{name}.{j}", f"step.{name}.plain.{j}"
        np.testing.assert_allclose(res[f"{key}.loss"], res[f"{plain}.loss"],
                                   err_msg=key, **LOSS_TOL)
        np.testing.assert_allclose(res[f"{key}.auc"], res[f"{plain}.auc"],
                                   atol=1e-6, err_msg=key)
        _close_params(_params(res, key), _params(res, plain), key)


# a bf16-parameter table step under the mesh against the unsharded one:
# the share of a table's entries more than 1 bf16 ulp apart (ulps of the
# larger of the entry and an Adam step, lr x boost; 0.12% measured), and
# every entry's distance in Adam steps (2 lr x boost; 0.07 of it measured)
BF16_TABLE_ULP_SHARE, BF16_TABLE_ADAM_STEPS = 0.02, 1.0


@pytest.mark.parametrize("name", ["bf16params", "bf16params_psum"])
def test_sharded_bf16_params_step_matches_unsharded(worlds, name):
    """configs4(2, 2) with bf16 parameters (f32 compute, in-batch IW,
    stride 2 at 2x): one table step through the a2a and through the psum
    exchange against the port's unsharded step on the whole batch from
    the same init and draws. The loss and the dense leaves within the f32
    tolerance; the tables (read whole, bf16) within
    BF16_TABLE_ULP_SHARE and BF16_TABLE_ADAM_STEPS: the sharded step
    rounds a table's gradient to bf16 where the unsharded one does not
    (each rank's pre-reduced rows before the reverse exchange, the
    owner's sum, the data group's all-reduce), and Adam moves an entry
    whose gradient lands on the other side of 0 by a full step."""
    res = worlds["w4"]
    tc = worker.case_config(tconfig.configs4, worker.PORT_CASES[name]).train
    lr = tc.learning_rate * tc.table_lr_boost
    key, plain = f"step.{name}.0", f"step.{name}.plain.0"
    np.testing.assert_allclose(res[f"{key}.loss"], res[f"{plain}.loss"],
                               **LOSS_TOL)
    got, want = _params(res, key), _params(res, plain)
    assert set(got) == set(want)
    for k, w in want.items():
        if "table" not in k:
            np.testing.assert_allclose(got[k], w, err_msg=k, **TOL)
            continue
        # the values are bf16's, read as f32
        assert np.array_equal(np.asarray(jnp.asarray(
            w, jnp.bfloat16).astype(jnp.float32)), w), k
        d = np.abs(got[k].astype(np.float64) - w)
        m = np.maximum(np.abs(got[k]), np.abs(w)).astype(np.float64)
        ulp = np.exp2(np.floor(np.log2(np.maximum(m, lr))) - 7)
        share = float((d > ulp).mean())
        print(f"{name} {k}: {share:.4f} of entries past 1 ulp, at most "
              f"{d.max():.3e} from the unsharded step's")
        assert share <= BF16_TABLE_ULP_SHARE, k
        assert d.max() <= BF16_TABLE_ADAM_STEPS * 2 * lr, k


def test_bf16_params_sharded_checkpoint_and_mesh_serving(worlds):
    """A bf16-parameter configs4(2, 2) state after one a2a step: its
    sharded `latest` restored into a state from other weights bit-equal
    on every rank (its 6 bf16 tensors: the two tables and their Adam
    moments), read whole equal to the blocks gathered, and served under
    the mesh bit-equal to the whole read's service, on every rank."""
    assert _same_on_every_rank(worlds["w4"]["bf16ck.equal"]) == 1.0


def test_local_data_parallel_step_matches_unsharded(worlds):
    """lookup_mode 'local' over (data=2, rows=1): whole tables on each
    rank, gradients summed over the world; 3 stride-2 in-batch steps
    against the port's unsharded step on the whole batch."""
    res = worlds["w2"]
    for j in range(worker.PORT_CASES["local"]["steps"]):
        key, plain = f"step.local.{j}", f"step.local.plain.{j}"
        np.testing.assert_allclose(res[f"{key}.loss"], res[f"{plain}.loss"],
                                   err_msg=key, **LOSS_TOL)
        _close_params(_params(res, key), _params(res, plain), key)
        assert int(res[f"{key}.overflow"]) == 0


def test_scaling_measure_at_two_ranks(worlds):
    """scripts.scaling.measure(2, ...) in the (2, 1) world: configs3's
    step under the data-parallel mesh of factor_mesh(2), each rank its
    rows of every global batch; every rank returns a finite positive
    rate."""
    rates = worlds["w2"]["scaling.examples_per_s"]
    assert rates.shape == (2, 1), rates
    assert np.isfinite(rates).all() and (rates > 0).all(), rates


# --- the graph, the driver, checkpoints and serving under a mesh -----------

def _same_on_every_rank(rows):
    """rows [world, ...]: every rank's value; all equal, rank 0's back."""
    for r in rows[1:]:
        np.testing.assert_array_equal(r, rows[0])
    return rows[0]


@pytest.mark.parametrize("form", ["batch", "cand"])
def test_sharded_graph_gathers_match_whole_graph(worlds, tiny_dataset,
                                                 form):
    """gather_batch and gather_candidate_batch through the row-sharded
    graph (each side's rows from their owners, one exchange a side) on
    every rank: bit-equal to the whole graph's gathers, in the rank, and
    here for the histories and counts of every rank's rows."""
    res = worlds["w4"]
    assert _same_on_every_rank(res["graph.equal"]) == 1.0
    g = tgraph.device_graph(tiny_dataset.graph, "cpu")
    t = tiny_dataset.train
    B = worker.DRIVER_B
    u, i, sl = (torch.from_numpy(np.asarray(getattr(t, k)[:B], np.int32))
                for k in ("user", "item", "slot"))
    if form == "batch":
        want = tgraph.gather_batch(g, u, i, sl)
    else:   # each rank rolls its own rows' items
        per = B // 4
        cand = torch.cat([torch.stack(
            [c, torch.roll(c, 3), torch.roll(c, 7)], dim=1)
            for c in i.split(per)])
        want = tgraph.gather_candidate_batch(g, u, cand, sl)
    for k in ("u_hist", "u_cnt", "i_hist", "i_cnt"):
        got = res[f"graph.{form}.{k}"]
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want[k].numpy(), err_msg=k)


DRIVER_TOL = 1e-4


def test_sharded_driver_matches_jax(worlds):
    """train() on configs4(2, 2) from the JAX init with JAX's shifts
    against the JAX package's train() on the fake mesh: the same val
    steps, best step and steps run (45), every val row's metrics and loss
    and the test metrics within 1e-4; the same numbers on every rank."""
    row = _same_on_every_rank(worlds["w4"]["driver.rows"])
    want = worlds["ref"]["driver"]
    n = int(worlds["w4"]["driver.nvals"])
    assert n == len(want["history"]) == 3
    keys = ("step",) + worker.DRIVER_METRICS + ("loss",)
    for j, w in enumerate(want["history"]):
        got = dict(zip(keys, row[j * len(keys):(j + 1) * len(keys)]))
        assert got["step"] == w["step"]
        for k in keys[1:]:
            assert abs(got[k] - w[k]) <= DRIVER_TOL, (w["step"], k)
    test = row[n * len(keys):n * len(keys) + len(worker.DRIVER_METRICS)]
    for k, v in zip(worker.DRIVER_METRICS, test):
        assert abs(v - want["test"][k]) <= DRIVER_TOL, k
    steps_run, best_step, best_auc = row[-3:]
    assert steps_run == want["steps_run"] == 45
    assert best_step == want["best_step"]
    assert abs(best_auc - want["best_val_auc"]) <= DRIVER_TOL


def test_sharded_latest_restores_bit_equal(worlds):
    """`latest` restored under the mesh into a state from other weights:
    every block and optimizer state bit-equal to the live ones, and one
    train_step from each bit-equal (loss and params), on every rank; and
    restored into the (1, 4) and (4, 1) layouts, each rank's rows
    bit-equal to the saved tables'."""
    res = worlds["w4"]
    assert _same_on_every_rank(res["restore.equal"]) == 1.0
    assert np.isfinite(res["restore.loss"])
    np.testing.assert_array_equal(res["restore.layouts"],
                                  np.ones((4, 2)))


def test_sharded_failed_save_keeps_previous(worlds):
    """A save whose write fails on one rank raises on every rank; the
    previous save (step 7, best val 0.5) is the one restored, and the
    failed save's partial files are never committed."""
    rows = worlds["w4"]["crash.rows"]
    np.testing.assert_array_equal(rows, np.tile([1.0, 7.0, 0.5], (4, 1)))


def test_best_restored_whole_serves_as_full_tables(worlds, tiny_dataset):
    """`best` restored whole here (mesh=None, every file read) equals the
    run's best weights gathered whole, and the service on it (configs4
    served whole) scores bit-equal to a service on those weights."""
    res, ds = worlds["w4"], tiny_dataset
    best = {k[len("best.param."):]: torch.from_numpy(v)
            for k, v in res.items() if k.startswith("best.param.")}
    restored = CheckpointManager(str(worlds["work"] / "ck")).restore(
        "best", torch.device("cpu"))
    assert set(restored["params"]) == set(best)
    for k, v in best.items():
        assert torch.equal(restored["params"][k], v), k
    cfg = worker.case_config(tconfig.configs4, worker.DRIVER)
    inp = worlds["inp"]
    a = ScoringService(cfg, ds, restored["params"], device="cpu")
    b = ScoringService(cfg, ds, best, device="cpu")
    np.testing.assert_array_equal(
        a.score_batch(inp["serve.users"], inp["serve.batch"]),
        b.score_batch(inp["serve.users"], inp["serve.batch"]))


SERVE_TOL = 1e-4


def test_mesh_serving_matches_jax_mesh_service(worlds, tiny_dataset):
    """ScoringService.from_checkpoint('best', mesh=) in the (2, 2) world:
    score (21 items), score_batch 4 x 64 and topk k=10 the same on every
    rank, and within 1e-4 of the JAX package's ScoringService(mesh=,
    lookup_fn=a2a) on the same weights."""
    res, ds, inp = worlds["w4"], tiny_dataset, worlds["inp"]
    best = {k[len("best.param."):]: torch.from_numpy(v)
            for k, v in res.items() if k.startswith("best.param.")}
    mesh = worlds["mesh"]
    jcfg = worker.case_config(jconfig.configs4, worker.DRIVER)
    ref = JaxService(jcfg, ds, to_flax(best), mesh=mesh,
                     lookup_fn=jsh.make_lookup_fn(mesh, "a2a"))
    user = int(inp["serve.user"])
    np.testing.assert_allclose(_same_on_every_rank(res["serve.score"]),
                               ref.score(user, inp["serve.items"]),
                               rtol=SERVE_TOL, atol=SERVE_TOL)
    np.testing.assert_allclose(
        _same_on_every_rank(res["serve.batch"]),
        ref.score_batch(inp["serve.users"], inp["serve.batch"]),
        rtol=SERVE_TOL, atol=SERVE_TOL)
    items = _same_on_every_rank(res["serve.topk_items"])
    scores = _same_on_every_rank(res["serve.topk_scores"])
    wi, ws = ref.topk(user, k=10)
    np.testing.assert_allclose(np.sort(scores), np.sort(ws),
                               rtol=SERVE_TOL, atol=SERVE_TOL)
    assert set(items.astype(int)) == set(np.asarray(wi).tolist())


def test_overflow_action_raises_or_warns_on_every_rank(worlds, tiny_dataset):
    """At a2a_capacity 1 (tests/test_sharding.py's policy test):
    overflow_action 'raise' raises RuntimeError naming a2a_capacity on
    every rank, none hangs; 'warn' runs all 45 steps of the epoch."""
    rows = worlds["w4"]["overflow.rows"]
    steps = len(tiny_dataset.train) // worker.DRIVER_B
    np.testing.assert_array_equal(rows, np.tile([-1.0, steps], (4, 1)))


def test_dryrun_and_cli_in_the_world(worlds, tiny_dataset):
    """entry.dryrun_rank: one psum step and 3 a2a steps through
    train_loop, finite and equal on every rank; the CLI's main(['configs4',
    <dir>, '--device', 'cpu', ...]) in the world: the planned 22 steps of
    batch 512, finite loss and test AUC, the same on every rank."""
    losses = _same_on_every_rank(worlds["w4"]["dryrun.losses"])
    assert losses.shape == (4,) and np.isfinite(losses).all()
    steps, loss, auc = _same_on_every_rank(worlds["w4"]["cli.rows"])
    assert steps == len(tiny_dataset.train) // 512
    assert np.isfinite(loss) and 0.0 <= auc <= 1.0


@pytest.mark.parametrize("data,rows", [(1, 1), (1, 4), (2, 8)])
def test_restore_reads_only_the_files_of_its_rows(worlds, monkeypatch,
                                                  data, rows):
    """The (2, 2) world's `best` restored here into other layouts (a mesh
    needs no collective to restore): each rank's tables and optimizer
    state are its rows of the whole, and it opens only the dense file and
    the rows files that hold them; an unsharded checkpoint of the same
    weights restores into the layout alike."""
    import score_tpu_torch.checkpoint as tckpt
    ck = str(worlds["work"] / "ck")
    whole = CheckpointManager(ck).restore("best", torch.device("cpu"))
    flat = CheckpointManager(str(worlds["work"] / "flat"))
    state = SimpleNamespace(
        model=SimpleNamespace(state_dict=lambda: whole["params"]),
        opt=SimpleNamespace(state=lambda: whole["opt_state"]))
    bounded(flat.save, "best", state, (0, 0), whole["best_val"],
            whole["step"], block=True)
    opened = []
    real = tckpt.torch.load
    monkeypatch.setattr(tckpt.torch, "load", lambda f, **kw: (
        opened.append(os.path.basename(f)), real(f, **kw))[1])
    for r in range(data * rows):
        mesh = _fake_mesh(data, rows, rank=r)
        for src in (ck, flat.directory):
            opened.clear()
            got = CheckpointManager(src, mesh).restore("best", "cpu")
            for k, v in whole["params"].items():
                per = v.shape[0] // rows
                want = (v[mesh.row_index * per:(mesh.row_index + 1) * per]
                        if tsh.state_spec(k, v) else v)
                assert torch.equal(got["params"][k], want), (src, r, k)
                mu = whole["opt_state"]["mu"][k]
                want_mu = (mu[mesh.row_index * per:
                              (mesh.row_index + 1) * per]
                           if tsh.state_spec(k, v) else mu)
                assert torch.equal(got["opt_state"]["mu"][k], want_mu)
            assert got["step"] == whole["step"]
            if src == ck:       # saved over 2 row blocks
                lo = mesh.row_index * 2 // rows
                hi = max(lo, ((mesh.row_index + 1) * 2 - 1) // rows)
                want_files = {"dense.pt"} | {f"rows-{j}-of-2.pt"
                                             for j in range(lo, hi + 1)}
                assert set(opened) == want_files, (r, opened)
