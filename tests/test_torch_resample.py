"""Per-step neighbour re-sampling (DataConfig.neighbor_resample) in the
port against the JAX package's: `graph.subsample_neighbors` given JAX's
own uniform keys gives the reference's sample bit for bit; its draws are
uniform without replacement; a train step that re-samples a stored
fan-out of 6 down to 3, with uniform and with in-batch negatives,
agrees with make_train_step when it is handed the keys the reference
draws (jax.random.uniform of split(fold_in(fold_in(rng, step), 2)) over
the gathered histories' shapes). And the up-front refusal on "cuda" of a
graph stored wider than the co-attention kernels take, which eval and
serving run at.

Tolerances: the sample's valid prefix and the counts exact (which
invalid entries fill a row's tail is free, and the counts mask them);
in the train steps the loss to 1e-5 and Adam's moments to rtol 1e-4 /
atol 1e-6, as tests/test_torch_train.py holds them, and the parameters
to rtol 1e-4 / atol 1e-2 of one table step (lr x boost): an entry whose
first gradient nearly cancels takes a first step g / (|g| + eps) with
|g| near eps, which turns f32 summation noise in g into a visible step.
Here item-table entry [177, 1] has an L2 gradient of 2.29e-7 and a data
gradient within 0.7% of its negative; g is 1.58e-9 on one side and
1.47e-9 on the other, and the first steps differ by 1.56e-5 (0.8% of
2e-3), while the moments after three steps agree to 4e-5 relative.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_tpu.config import configs3
from score_tpu.data.pipeline import TargetIterator
from score_tpu.graph import device_graph, gather_candidate_batch
from score_tpu.graph import gather_batch as jax_gather_batch
from score_tpu.graph import subsample_neighbors as jax_subsample
from score_tpu.train import (build_model, init_state, item_importance_weights,
                             make_train_step)
from score_tpu_torch import graph as tgraph
from score_tpu_torch import train as ttrain
from score_tpu_torch.data import synth
from score_tpu_torch.data.prep_common import build_dataset
from score_tpu_torch.params import (from_flax, init_params,
                                    opt_state_from_optax)
from score_tpu_torch.serve import ScoringService

torch.set_num_threads(2)

B = 64
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-6)


def _valid_prefix_equal(got_h, got_c, want_h, want_c):
    got_h, want_h = np.asarray(got_h), np.asarray(want_h)
    np.testing.assert_array_equal(np.asarray(got_c), np.asarray(want_c))
    assert got_h.shape == want_h.shape
    j = np.arange(got_h.shape[-1])
    valid = j < np.asarray(want_c)[..., None]
    np.testing.assert_array_equal(got_h[valid], want_h[valid])


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("side", ["user", "item"])
def test_subsample_bit_exact_with_jax_keys(tiny_dataset, side, k):
    """The user side [B, T, S] and the item side [B, C, T, S] of a
    gathered batch (stored fan-out 6, counts 0-6), each row's valid
    prefix and its count exact."""
    ds = tiny_dataset
    jg = device_graph(ds.graph)
    rng = np.random.default_rng(k)
    users = rng.integers(1, ds.num_users + 1, 32).astype(np.int32)
    cand = rng.integers(1, ds.num_items + 1, (32, 3)).astype(np.int32)
    slots = np.full(32, ds.graph.num_slots, np.int32)
    mb = gather_candidate_batch(jg, *map(jnp.asarray, (users, cand, slots)))
    hist, cnt = ((mb["u_hist"], mb["u_cnt"]) if side == "user"
                 else (mb["i_hist"], mb["i_cnt"]))
    counts = np.array(cnt)
    assert counts.min() < k < counts.max()       # short and long rows
    key = jax.random.PRNGKey(11 + k)
    want_h, want_c = jax_subsample(hist, cnt, k, key)
    keys = torch.from_numpy(np.array(jax.random.uniform(key, hist.shape)))
    got_h, got_c = tgraph.subsample_neighbors(
        torch.from_numpy(np.array(hist)), torch.from_numpy(counts), k,
        keys)
    assert got_h.dtype == torch.int32 and got_c.dtype == torch.int32
    _valid_prefix_equal(got_h.numpy(), got_c.numpy(), want_h, want_c)


def test_subsample_uniform_and_exact():
    """The reference's test (tests/test_train.py:517-540) on the port:
    fewer valid neighbours than k keeps them all; more draws a uniform
    k-subset without replacement; counts clamp to k; rows no wider than
    k come back as they are."""
    hist = torch.arange(1, 13, dtype=torch.int32).reshape(1, 12)
    gen = torch.Generator().manual_seed(0)
    h2, c2 = tgraph.subsample_neighbors(
        hist, torch.tensor([3], dtype=torch.int32), 8,
        torch.rand(1, 12, generator=gen))
    assert h2.shape == (1, 8) and int(c2[0]) == 3
    assert set(h2[0, :3].tolist()) == {1, 2, 3}
    counts = np.zeros(13)
    draws = 400
    cnt = torch.tensor([12], dtype=torch.int32)
    for _ in range(draws):
        h3, c3 = tgraph.subsample_neighbors(hist, cnt, 4,
                                            torch.rand(1, 12, generator=gen))
        assert int(c3[0]) == 4
        sel = h3[0].numpy()
        assert len(set(sel.tolist())) == 4      # no replacement
        counts[sel] += 1
    np.testing.assert_allclose(counts[1:] / draws, 4 / 12, atol=0.08)
    same = tgraph.subsample_neighbors(hist, cnt, 12, torch.rand(1, 12))
    assert same[0] is hist and same[1] is cnt


def test_gather_batch_matches_jax(tiny_dataset):
    ds = tiny_dataset
    users, items = ds.train.user[:9], ds.train.item[:9]
    slots = ds.train.slot[:9]
    want = jax_gather_batch(device_graph(ds.graph),
                            *map(jnp.asarray, (users, items, slots)))
    got = tgraph.gather_batch(tgraph.device_graph(ds.graph, "cpu"),
                              *map(torch.from_numpy, (users, items, slots)))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)


def _cfg(neg_mode):
    cfg = configs3()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, embed_dim=8, hidden_dim=8,
                                  mlp_dims=(16, 8)),
        data=dataclasses.replace(cfg.data, user_fanout=3, item_fanout=3,
                                 neighbor_resample=True,
                                 train_neg_mode=neg_mode, num_train_neg=1),
        train=dataclasses.replace(cfg.train, batch_size=B,
                                  table_update_every=2, table_lr_boost=2.0))


@pytest.mark.parametrize("neg_mode", ["uniform", "inbatch_iw"])
def test_resampling_steps_match_make_train_step(tiny_dataset, neg_mode):
    """Three stride-2 steps re-sampling the stored fan-out 6 down to 3,
    the port handed the reference's keys, shifts or raw negatives:
    losses, params, Adam moments and count."""
    ds = tiny_dataset
    assert ds.graph.u2i.shape[-1] == 6 > 3
    cfg = _cfg(neg_mode)
    jg = device_graph(ds.graph)
    jm = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    jstate = init_state(cfg, jm, jg, rng)
    neg_iw = item_importance_weights(ds.train, ds.num_items)
    jstep = make_train_step(jm, cfg, neg_iw=jnp.asarray(neg_iw))
    st = ttrain.init_state(
        cfg, ds.num_users, ds.num_items,
        from_flax(jax.tree.map(np.asarray, jstate.params)), device="cpu",
        opt_state=opt_state_from_optax(jax.device_get(jstate.opt_state)))
    tg = tgraph.device_graph(ds.graph, "cpu")
    it = TargetIterator(ds.train, B, seed=3)
    C = 2 if neg_mode == "uniform" else 1
    T, S = ds.graph.num_slots, 6
    for step in range(3):
        batch = next(it)
        step_rng = jax.random.fold_in(rng, step)
        r1, r2 = jax.random.split(jax.random.fold_in(step_rng, 2))
        keys = [torch.from_numpy(np.array(jax.random.uniform(r, shape)))
                for r, shape in ((r1, (B, T, S)), (r2, (B, C, T, S)))]
        kw = dict(resample_keys=keys)
        if neg_mode == "uniform":
            kw["negatives"] = np.array(jax.random.randint(
                step_rng, (B, 1), 1, ds.num_items + 1, dtype=jnp.int32))
        else:
            kw["shifts"] = [int(x) for x in np.asarray(jax.random.randint(
                step_rng, (1,), 1, B, dtype=jnp.int32))]
            kw["neg_iw"] = torch.from_numpy(neg_iw)
        jstate, jmet = jstep(jstate, jg,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             rng)
        st, m = ttrain.train_step(st, tg, batch, **kw)
        np.testing.assert_allclose(m["loss"].item(), float(jmet["loss"]),
                                   **LOSS_TOL)
    jopt = opt_state_from_optax(jax.device_get(jstate.opt_state))
    assert st.step == st.opt.count == jopt["count"] == 3
    want = from_flax(jax.tree.map(np.asarray, jstate.params))
    got = dict(st.model.named_parameters())
    step = cfg.train.learning_rate * cfg.train.table_lr_boost
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-2 * step,
                                   err_msg=f"param {k}")
    for tree, ref, what in ((st.opt.mu, jopt["mu"], "mu"),
                            (st.opt.nu, jopt["nu"], "nu")):
        for k, w in ref.items():
            np.testing.assert_allclose(tree[k].detach().numpy(), w.numpy(),
                                       err_msg=f"{what} {k}", **TOL)


def test_resampling_step_draws_from_seed_and_step(tiny_dataset):
    """Without keys a step draws them from (seed, step): two states at
    one step take bit-equal steps; the samples differ from a step with
    other keys; the loss stays finite."""
    ds = tiny_dataset
    cfg = _cfg("inbatch_iw")
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(0))
    neg_iw = torch.from_numpy(item_importance_weights(ds.train, ds.num_items))
    tg = tgraph.device_graph(ds.graph, "cpu")
    batch = next(TargetIterator(ds.train, B, seed=1))
    out = []
    for keys in (None, None, "other"):
        st = ttrain.init_state(cfg, ds.num_users, ds.num_items,
                               {k: v.clone() for k, v in sd.items()},
                               device="cpu")
        kw = {}
        if keys == "other":
            g = torch.Generator().manual_seed(99)
            T = ds.graph.num_slots
            kw["resample_keys"] = [torch.rand(B, T, 6, generator=g),
                                   torch.rand(B, 1, T, 6, generator=g)]
        st, m = ttrain.train_step(st, tg, batch, [5], neg_iw, **kw)
        assert torch.isfinite(m["loss"])
        out.append(m["loss"])
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], out[2])


def _wide_dataset():
    """tiny_dataset's recipe stored at a fan-out of 65, one past the wide
    co-attention kernels' MAX_WIDE_ROWS."""
    user, item, ts = synth.synth_events(300, 600, 20000, num_slots=8, seed=0)
    return build_dataset(user, item, ts, num_slots=8, user_fanout=65,
                         item_fanout=65, num_eval_neg=20, min_user=3,
                         min_item=3, seed=0, dataset_name="tiny-wide")


def test_stored_fanout_past_the_kernels_refused_up_front_on_cuda():
    """A config that trains at fan-outs of 10 by re-sampling a graph
    stored at 65: eval and serving run at the stored width, past what the
    card's co-attention kernels take, so `ScoringService`, `train()` and
    `evaluate` refuse it on "cuda" before they touch the device. On the
    CPU it serves and evaluates."""
    ds = _wide_dataset()
    assert ds.graph.u2i.shape[-1] == 65
    cfg = configs3()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, embed_dim=8, hidden_dim=8,
                                  mlp_dims=(16, 8)),
        data=dataclasses.replace(cfg.data, user_fanout=10, item_fanout=10,
                                 neighbor_resample=True),
        train=dataclasses.replace(cfg.train, batch_size=B, num_epochs=1))
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="co-attention"):
        ScoringService(cfg, ds, sd, device="cuda")
    with pytest.raises(NotImplementedError, match="co-attention"):
        ttrain.train(cfg, ds, verbose=False, device="cuda")
    svc = ScoringService(cfg, ds, sd, device="cpu")
    assert np.isfinite(svc.score(int(ds.test.user[0]),
                                 np.arange(1, 6, dtype=np.int32))).all()

    # a graph that says it lives on the card (none is here)
    adj = SimpleNamespace(device=torch.device("cuda"), shape=(0, 8, 65))
    with pytest.raises(NotImplementedError, match="co-attention"):
        ttrain.evaluate(ttrain.make_eval_step(svc.model),
                        SimpleNamespace(u2i=adj, i2u=adj, device=adj.device),
                        ds.val)
