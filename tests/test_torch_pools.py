"""configs3 with the mean and max co-attention pools, through the port's
model, scoring service and train step, against the JAX package on
`tiny_dataset` with the same weights (flax tree <-> state_dict through
score_tpu_torch.params). The flax model takes the JAX package's non-Pallas
route for these pools (the jnp reference on the tiled per-pair form); the
port runs its per-pair kernels' plain versions on the CPU.

Tolerances as tests/test_torch_model.py and tests/test_torch_train.py:
scores f32 1e-4, bf16 rtol 2e-2 / atol 2e-3 (both sides round to bf16 at
their own places); the loss 1e-5 and params and Adam moments after 3
steps rtol 1e-4 / atol 1e-6 in f32 (the same math, summed in another
order, magnified by Adam's division by sqrt(nu) on small gradients)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_tpu.config import configs3
from score_tpu.data.pipeline import TargetIterator
from score_tpu.graph import device_graph, gather_candidate_batch
from score_tpu.serve import ScoringService as JaxService
from score_tpu.train import (build_model, init_state,
                             item_importance_weights, make_train_step)
from score_tpu_torch import graph as tgraph
from score_tpu_torch import train as ttrain
from score_tpu_torch.kernels import coattn as tpair
from score_tpu_torch.kernels import coattn_cand as tcand
from score_tpu_torch.nn.model import ScoreModel
from score_tpu_torch.params import (from_flax, init_params,
                                    opt_state_from_optax, to_flax)
from score_tpu_torch.serve import ScoringService

torch.set_num_threads(2)

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-3)}
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-6)


def _cfg(pool, dtype="float32"):
    cfg = configs3()
    return cfg.replace(model=dataclasses.replace(
        cfg.model, coattn_pool=pool, compute_dtype=dtype))


def _weights(cfg, ds, seed=0):
    """init_params, then every zero-initialised leaf made non-zero and the
    tables widened so attention is far from uniform."""
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for k, v in sd.items():
        std = 0.5 if "table" in k else 0.3 if not v.any() else None
        if std is not None:
            sd[k] = torch.from_numpy(
                rng.normal(0, std, v.shape).astype(np.float32))
    return sd


def _jax_params(sd):
    return jax.tree.map(jnp.asarray, to_flax(sd))


def _requests(ds, B, C, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.linspace(0, len(ds.train) - 1, B).astype(np.int64)
    cand = rng.integers(1, ds.num_items + 1, (B, C)).astype(np.int32)
    return ds.train.user[idx], ds.train.slot[idx], cand


def _port_scores(model, ds, users, slots, cand):
    with torch.inference_mode():
        tb = tgraph.gather_candidate_batch(
            tgraph.device_graph(ds.graph, "cpu"), torch.from_numpy(users),
            torch.from_numpy(cand), torch.from_numpy(slots))
        return model.score_candidates(tb).numpy()


@pytest.mark.parametrize("pool", ["max", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_candidates_matches_flax(tiny_dataset, pool, dtype):
    ds = tiny_dataset
    cfg = _cfg(pool, dtype)
    sd = _weights(cfg, ds)
    users, slots, cand = _requests(ds, B=6, C=5)
    jm = build_model(cfg, ds.num_users, ds.num_items)
    mb = gather_candidate_batch(device_graph(ds.graph), jnp.asarray(users),
                                jnp.asarray(cand), jnp.asarray(slots))
    want = np.asarray(jm.apply({"params": _jax_params(sd)}, mb,
                               method=jm.score_candidates))
    tm = ScoreModel(cfg.model, ds.num_users, ds.num_items)
    tm.load_state_dict(sd)
    before = (tpair.cross_coattn_pair.launches,
              tcand.cross_coattn_cand.launches)
    got = _port_scores(tm, ds, users, slots, cand)
    # CPU tensors run the plain versions: no kernel launch is counted
    assert (tpair.cross_coattn_pair.launches,
            tcand.cross_coattn_cand.launches) == before
    assert got.shape == want.shape == (6, 5) and np.std(want) > 1e-2
    np.testing.assert_allclose(got, want, **TOL[dtype])


def test_params_round_trip_max_pool_tree(tiny_dataset):
    """A flax tree built with coattn_pool='max' has configs3's leaves:
    from_flax / to_flax round-trip it exactly."""
    ds = tiny_dataset
    cfg = _cfg("max")
    jm = build_model(cfg, ds.num_users, ds.num_items)
    tree = init_state(cfg, jm, device_graph(ds.graph),
                      jax.random.PRNGKey(0)).params
    sd = from_flax(jax.tree.map(np.asarray, tree))
    assert set(sd) == set(ScoreModel(cfg.model, ds.num_users,
                                     ds.num_items).state_dict())
    back = to_flax(sd)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_service_max_matches_jax(tiny_dataset):
    ds = tiny_dataset
    cfg = _cfg("max")
    sd = _weights(cfg, ds, seed=3)
    port = ScoringService(cfg, ds, sd, device="cpu", candidate_chunk=16)
    ref = JaxService(cfg, ds, _jax_params(sd), candidate_chunk=16)
    items = np.array([1, 4, 9, 33, 0], np.int32)
    np.testing.assert_allclose(port.score(3, items), ref.score(3, items),
                               **TOL["float32"])
    rng = np.random.default_rng(4)
    users = np.array([3, 5], np.int32)
    batch = rng.integers(1, ds.num_items + 1, (2, 40)).astype(np.int32)
    np.testing.assert_allclose(port.score_batch(users, batch),
                               ref.score_batch(users, batch),
                               **TOL["float32"])
    pi, ps = port.topk(3, k=7)
    np.testing.assert_allclose(ref.score(3, pi), ps, **TOL["float32"])


def test_pair_form_sum_matches_candidates_route():
    """The per-pair form computes the sum pool too: cross_coattn_pair at
    pool='sum' gives the candidates form's cu and ci on the same inputs
    (all-masked slots on both sides included), with and without the
    target terms. The model routes the sum pool to the candidates
    kernels; this holds the two forms to one function."""
    rng = np.random.default_rng(5)
    B, C, T, n, m, d = 5, 7, 4, 6, 6, 8

    def r(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32))
    mu = torch.from_numpy(rng.random((B, T, n)) > 0.3)
    mi = torch.from_numpy(rng.random((B, C, T, m)) > 0.3)
    mu[:, 0] = False
    mi[:, :, T - 1] = False
    args = (r(B, T, n, d), r(B, C, T, m, d), mu, mi, r(d, d) * 0.3,
            r(B, d), r(B, C, d))
    for ta in (True, False):
        got = tpair.cross_coattn_pair(*args, pool="sum", target_aware=ta)
        want = tcand.cross_coattn_cand(*args, target_aware=ta)
        for g, w in zip(got, want):
            assert g.shape == w.shape == (B, C, T, d)
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _train_cfg(pool):
    cfg = configs3()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, coattn_pool=pool, embed_dim=8,
                                  hidden_dim=8, mlp_dims=(16, 8)),
        data=dataclasses.replace(cfg.data, train_neg_mode="inbatch_iw"),
        train=dataclasses.replace(cfg.train, batch_size=64,
                                  table_update_every=2, table_lr_boost=2.0))


def _close_tree(got_sd, want_tree, what):
    want = from_flax(jax.tree.map(np.asarray, want_tree))
    assert set(got_sd) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got_sd[k].detach().numpy(), w.numpy(),
                                   err_msg=f"{what} {k}", **TRAIN_TOL)


@pytest.mark.parametrize("pool", ["mean", "max"])
def test_three_stride2_steps_match_make_train_step(tiny_dataset, pool):
    """Full, dense, full steps from the same flax params and optax state,
    batches and shifts (the reference's own draw): losses, batch AUCs,
    then params, Adam moments and count."""
    ds = tiny_dataset
    cfg = _train_cfg(pool)
    B = cfg.train.batch_size
    jgraph = device_graph(ds.graph)
    jmodel = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    jstate = init_state(cfg, jmodel, jgraph, rng)
    # non-zero co-attention weights: at their zero init every pool scores
    # the same (a zero relation matrix)
    draw = np.random.default_rng(1)
    jstate = jstate.replace(params=jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(draw.normal(0, 0.3, x.shape).astype(
            np.float32)) if "coattn" in jax.tree_util.keystr(path) else x,
        jstate.params))
    neg_iw = item_importance_weights(ds.train, ds.num_items)
    st = ttrain.init_state(
        cfg, ds.num_users, ds.num_items,
        from_flax(jax.tree.map(np.asarray, jstate.params)), device="cpu",
        opt_state=opt_state_from_optax(jax.device_get(jstate.opt_state)))
    tg = tgraph.device_graph(ds.graph, "cpu")
    jstep = make_train_step(jmodel, cfg, neg_iw=jnp.asarray(neg_iw))
    it = TargetIterator(ds.train, B, seed=3)
    for step in range(3):
        batch = next(it)
        jstate, jm = jstep(jstate, jgraph,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           rng)
        shifts = np.asarray(jax.random.randint(
            jax.random.fold_in(rng, step), (1,), 1, B, dtype=jnp.int32))
        st, m = ttrain.train_step(st, tg, batch, [int(shifts[0])],
                                  torch.from_numpy(neg_iw))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   **LOSS_TOL)
        np.testing.assert_allclose(m["batch_auc"].item(),
                                   float(jm["batch_auc"]), atol=1e-6)
    assert st.opt.count == 3
    _close_tree(dict(st.model.named_parameters()), jstate.params, "param")
    jopt = opt_state_from_optax(jax.device_get(jstate.opt_state))
    for name in ("mu", "nu"):
        _close_tree(getattr(st.opt, name), to_flax(jopt[name]), name)
