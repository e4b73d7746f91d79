"""The port's row-sharded tables (score_tpu_torch/sharding.py) and its
sharded train step against the JAX package's score_tpu/sharding.py and
configs4 step, as tests/test_sharding.py holds the reference.

Two gloo worlds on the CPU, each rank a process running
tests/_torch_shard_worker.py, both started once for the module: a
(data=2, rows=2) world for the psum and a2a lookups, the a2a capacity and
overflow, and the sharded steps; a (2, 1) world for the 'local'
data-parallel step. The JAX references are computed here, meanwhile, on
the fake mesh tests/conftest.py provides (make_mesh(jax.devices()[:4],
data=2, rows=2)); inputs and results pass as .npz files.

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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from score_tpu import config as jconfig
from score_tpu import sharding as jsh
from score_tpu.data.pipeline import TargetIterator
from score_tpu.graph import device_graph
from score_tpu.train import (build_model, init_state,
                             item_importance_weights, make_train_step)
from score_tpu_torch import config as tconfig
from score_tpu_torch import graph as tgraph
from score_tpu_torch import sharding as tsh
from score_tpu_torch.kernels.gather import gather_rows
from score_tpu_torch.nn.model import check_config
from score_tpu_torch.params import from_flax, init_params

import _torch_shard_worker as worker

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
    cfg = tconfig.configs4(2, 2)
    with pytest.raises(NotImplementedError, match="part 2"):
        check_config(cfg)
    with pytest.raises(ValueError, match="mesh"):
        check_config(cfg, _fake_mesh(1, 4))
    check_config(cfg, _fake_mesh(2, 2))
    odd = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=18))
    with pytest.raises(ValueError, match="batch_size"):
        check_config(odd, _fake_mesh(2, 2))


@pytest.mark.parametrize("entry", ["service", "train"])
def test_service_and_train_refuse_configs4(tiny_dataset, entry):
    """Serving and the driver under a mesh are sharding part 2: configs4
    is refused, not run unsharded."""
    from score_tpu_torch.serve import ScoringService
    from score_tpu_torch.train import train
    ds = tiny_dataset
    cfg = worker.case_config(tconfig.configs4, {})
    with pytest.raises(NotImplementedError, match="part 2"):
        if entry == "service":
            sd = init_params(cfg, ds.num_users, ds.num_items,
                             torch.Generator().manual_seed(0))
            ScoringService(cfg, ds, sd, device="cpu")
        else:
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
                p.wait()
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
            runs[name] = (work, _spawn(work, world, data, rows))
        mesh = jsh.make_mesh(jax.devices()[:4], data=2, rows=2)
        ref = _jax_lookups(mesh, inp)
        ref.update(_jax_steps(ds, mesh, rng, inp))
    finally:
        out = {name: _join(work, procs) for name, (work, procs)
               in runs.items()}
    return dict(ref=ref, inp=inp, **out)


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
