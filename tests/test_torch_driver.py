"""The port's `train()` driver and `topk_batch` against the JAX package's,
on `tiny_dataset`, f32, on the CPU.

The driver runs configs3 as bench.py trains it (in-batch importance-weighted
negatives, tables every 2nd step at a 2x table lr) at batch 128 for up to 3
epochs (273 steps), val every 10 steps on 256 targets, early-stop patience
2: the run stops early, at step 240, with its best at 220. Both start from
the JAX package's init (its `init_state` params, through
`params.from_flax`), and the port replays JAX's shifts
(jax.random.randint(fold_in(PRNGKey(seed), step), (1,), 1, B), as
score_tpu/train.py:199 draws them). They must agree on the val steps, the
early-stop and best steps, and every val row's auc, ndcg@10, hr@10, mrr and
loss, and the test metrics, each within 1e-4 absolute: the same math in f32,
summed in another order.

The learning rate is 1e-4. At the default 1e-3 (2e-3 on the tables) the
two f32 runs part after the second table update, though each step's
gradients agree from the same weights: Adam's update mu / sqrt(nu) flips
sign on entries whose gradient crosses zero, so last-bit differences
grow until the val metrics differ in the third decimal within the first
epoch. At 1e-4 they stay far inside the tolerance over the 240 steps.

`topk_batch` holds the same score multisets as the JAX package's on the same
weights, scores within 1e-4; its pending scores stay under its byte bound.
"""

import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_tpu import config as jconfig
from score_tpu.graph import device_graph
from score_tpu.serve import ScoringService as JaxService
from score_tpu.train import build_model, init_state
from score_tpu.train import train as jax_train
from score_tpu_torch import config as tconfig
from score_tpu_torch.params import from_flax, init_params, to_flax
from score_tpu_torch.serve import ScoringService
from score_tpu_torch.train import train as port_train

torch.set_num_threads(2)

B = 128
TOL = 1e-4
METRICS = ("auc", "ndcg@10", "hr@10", "mrr")


def _cfg(module):
    cfg = module.configs3()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, train_neg_mode="inbatch_iw"),
        train=dataclasses.replace(
            cfg.train, batch_size=B, learning_rate=1e-4, num_epochs=3,
            eval_every_steps=10, early_stop_patience=2, eval_max_targets=256,
            log_every_steps=10 ** 9, table_update_every=2,
            table_lr_boost=2.0))


@pytest.fixture(scope="module")
def runs(tiny_dataset):
    """One JAX train() and one port train() from the same init and shifts."""
    ds = tiny_dataset
    jcfg, tcfg = _cfg(jconfig), _cfg(tconfig)
    rng = jax.random.PRNGKey(jcfg.train.seed)
    model = build_model(jcfg, ds.num_users, ds.num_items)
    params = init_state(jcfg, model, device_graph(ds.graph), rng).params
    sd = from_flax(jax.tree.map(np.asarray, params))

    def shifts_fn(step, b):
        s = jax.random.randint(jax.random.fold_in(rng, step), (1,), 1,
                               max(b, 2), dtype=jnp.int32)
        return [int(x) for x in np.asarray(s)]

    want = jax_train(jcfg, ds, verbose=False)
    got = port_train(tcfg, ds, verbose=False, device="cpu",
                     parity_state_dict=sd, parity_shifts_fn=shifts_fn)
    return got, want


def test_driver_val_steps_and_early_stop_match_jax(runs, tiny_dataset):
    got, want = runs
    assert [r["step"] for r in got["history"]] == \
        [r["step"] for r in want["history"]]
    assert got["steps_run"] == want["steps_run"]
    assert got["best_step"] == want["best_step"]
    total = 3 * (len(tiny_dataset.train) // B)
    assert got["best_step"] < got["steps_run"] < total     # it stopped early
    assert abs(got["best_val_auc"] - want["best_val_auc"]) <= TOL


@pytest.mark.parametrize("key", METRICS + ("loss",))
def test_driver_val_rows_match_jax(runs, key):
    got, want = runs
    for g, w in zip(got["history"], want["history"]):
        assert g["split"] == w["split"] == "val"
        assert abs(g[key] - w[key]) <= TOL, (g["step"], key, g[key], w[key])


@pytest.mark.parametrize("key", METRICS)
def test_driver_test_metrics_match_jax(runs, key):
    got, want = runs
    assert abs(got["test"][key] - want["test"][key]) <= TOL, key


def _weights(cfg, ds):
    """init_params with the zero-initialised attention weights made
    non-zero, so the co-attention and pooling matter to the scores."""
    gen = torch.Generator().manual_seed(5)
    sd = init_params(cfg, ds.num_users, ds.num_items, gen)
    for k in ("coattn.wr", "coattn.wtu", "coattn.wti", "pool_u.w",
              "pool_i.w"):
        sd[k] = torch.randn(sd[k].shape, generator=gen) * 0.3
    return sd


KNOBS = dict(candidate_chunk=64, topk_grid_rows=4)


@pytest.mark.parametrize("R,n_cand", [(1, None), (2, None), (3, 300),
                                      (6, 200)])
def test_topk_batch_matches_jax(tiny_dataset, R, n_cand):
    """g = 4, 2, 1 and 1 chunks a user a dispatch; the full catalogue
    (573 items: a ragged last dispatch) or a candidate list."""
    ds = tiny_dataset
    tcfg = tconfig.configs3()
    jcfg = jconfig.configs3()
    sd = _weights(tcfg, ds)
    port = ScoringService(tcfg, ds, sd, device="cpu", **KNOBS)
    ref = JaxService(jcfg, ds, to_flax(sd), **KNOBS)
    users = np.unique(ds.test.user)[:R]
    cand = None
    if n_cand is not None:
        cand = np.random.default_rng(R).choice(
            np.arange(1, ds.num_items + 1), n_cand, replace=False)
    gi, gs = port.topk_batch(users, k=10, candidates=cand)
    wi, ws = ref.topk_batch(users, k=10, candidates=cand)
    assert gi.shape == gs.shape == (R, 10)
    assert (gi >= 1).all()                       # no grid pad got in
    for r in range(R):
        assert np.all(np.diff(gs[r]) <= 0)
        np.testing.assert_allclose(np.sort(gs[r]), np.sort(ws[r]),
                                   rtol=TOL, atol=TOL)
        assert set(gi[r]) == set(np.asarray(wi[r]))


def test_topk_batch_pending_scores_bounded_by_bytes(tiny_dataset):
    """The scores on the device waiting for a merge never exceed
    `topk_pending_bytes` plus one dispatch, at any R (the reference bounds
    the count instead, 64 // g dispatches, whose bytes grow with R), and
    the bound does not change the result."""
    ds = tiny_dataset
    cfg = tconfig.configs3()
    svc = ScoringService(cfg, ds, _weights(cfg, ds), device="cpu",
                         candidate_chunk=16, topk_grid_rows=4)
    live = {"bytes": 0, "peak": 0, "dispatches": 0, "largest": 0}
    dispatch = svc._dispatch

    def release(nb):
        live["bytes"] -= nb

    def spy(users, items):
        out = dispatch(users, items)
        nb = out.numel() * out.element_size()
        live["bytes"] += nb
        live["peak"] = max(live["peak"], live["bytes"])
        live["dispatches"] += 1
        live["largest"] = max(live["largest"], nb)
        weakref.finalize(out, release, nb)
        return out

    users = np.unique(ds.test.user)
    for R in (1, 3, 64):
        svc._dispatch = dispatch
        svc.topk_pending_bytes = 1 << 40
        want = svc.topk_batch(users[:R], k=5)
        svc._dispatch = spy
        svc.topk_pending_bytes = 3 * 16 * 16 * 4
        live.update(peak=0, dispatches=0, largest=0)
        got = svc.topk_batch(users[:R], k=5)
        assert live["bytes"] == 0                   # every score released
        assert live["dispatches"] > 3               # it had to merge
        assert live["peak"] <= svc.topk_pending_bytes + live["largest"], R
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


def test_topk_batch_refuses_out_of_range_ids(tiny_dataset):
    """Ids index the device tables unchecked, so topk_batch refuses bad
    ones before any dispatch, as score_batch does."""
    ds = tiny_dataset
    cfg = tconfig.configs3()
    svc = ScoringService(cfg, ds, _weights(cfg, ds), device="cpu", **KNOBS)
    with pytest.raises(ValueError, match="user ids"):
        svc.topk_batch([1, ds.num_users + 1])
    with pytest.raises(ValueError, match="item ids"):
        svc.topk_batch([1], candidates=[1, ds.num_items + 1])
