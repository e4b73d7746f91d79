"""The port's eval metrics and streaming `evaluate` against the JAX
package's (score_tpu/metrics.py, score_tpu/train.py:evaluate).

The metric functions are compared on scores with negative values, -0 and
exact ties: the histogram keys and counts exactly (they count bits and
items), the ranking sums to 1e-6 (f32 sums of the same terms), the AUC to
1e-12 (the same f64 sum).

`evaluate` runs configs3 with the max pool in f32 on `tiny_dataset.val`
(20 fixed negatives per target) from the same weights, batch 64 so the
last block is padded. Ranking metrics and GAUC agree to 1e-4: both count
ties among the same scores, which differ in their last bits (sums in
another order), and a near-tie may resolve the other way. The AUC agrees
to 1e-3: it is taken at float16 resolution, so a last-bit difference can
also move a score across a bucket edge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_tpu import metrics as jmetrics
from score_tpu.config import configs3
from score_tpu.graph import device_graph
from score_tpu.train import build_model
from score_tpu.train import evaluate as jax_evaluate
from score_tpu.train import make_eval_step as jax_make_eval_step
from score_tpu_torch import graph as tgraph
from score_tpu_torch import metrics as tmetrics
from score_tpu_torch import train as ttrain
from score_tpu_torch.nn.model import ScoreModel
from score_tpu_torch.params import init_params, to_flax

torch.set_num_threads(2)


def _scores(seed, B=300, N=20):
    """Positive and negative scores with negatives, -0, +0 and exact ties
    (scores on a coarse grid), and a 0/1 weight per target."""
    rng = np.random.default_rng(seed)
    pos = np.round(rng.normal(size=B) * 4) / 4
    neg = np.round(rng.normal(size=(B, N)) * 4) / 4
    pos[:10] = -0.0
    neg[:10, :3] = 0.0                         # -0 against +0: a tie
    neg[10:20, 5] = pos[10:20]                 # exact ties with the positive
    pos[20] = 7e4                              # beyond the f16 clip
    w = (rng.random(B) > 0.2).astype(np.float32)
    return pos.astype(np.float32), neg.astype(np.float32), w


@pytest.mark.parametrize("weighted", [True, False])
def test_ranking_sums_and_metrics_match_jax(weighted):
    pos, neg, w = _scores(1)
    w = w if weighted else None
    got = tmetrics.ranking_sums(
        torch.from_numpy(pos), torch.from_numpy(neg), ks=(1, 5, 10),
        weights=None if w is None else torch.from_numpy(w))
    want = jmetrics.ranking_sums(jnp.asarray(pos), jnp.asarray(neg),
                                 ks=(1, 5, 10),
                                 weights=None if w is None else jnp.asarray(w))
    assert tuple(got) == tuple(want) == tmetrics.rank_sum_keys((1, 5, 10))
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=1e-6, err_msg=k)
    got_m = tmetrics.ranking_metrics(torch.from_numpy(pos),
                                     torch.from_numpy(neg), ks=(3,))
    want_m = jmetrics.ranking_metrics(jnp.asarray(pos), jnp.asarray(neg),
                                      ks=(3,))
    for k in want_m:
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]),
                                   rtol=1e-6, err_msg=k)


def test_f16_bucket_matches_jax_and_keeps_order():
    pos, neg, _ = _scores(2)
    x = np.concatenate([pos, neg.reshape(-1),
                        [-0.0, 0.0, -6.5e4, 6.5e4, 1e-8, -1e-8]]
                       ).astype(np.float32)
    got = tmetrics.f16_bucket(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmetrics.f16_bucket(
        jnp.asarray(x))))
    assert got.dtype == np.int32 and got.min() >= 0 and got.max() < 1 << 16
    assert got[-6] == got[-5]                  # -0 and +0: one bucket
    order = np.argsort(x, kind="stable")
    assert (np.diff(got[order]) >= 0).all()    # order kept


def test_score_hists_and_hist_auc_match_jax():
    pos, neg, w = _scores(3)
    hp = torch.zeros(tmetrics.F16_BINS, dtype=torch.int32)
    hn = torch.zeros_like(hp)
    for lo in (0, 150):                        # two blocks accumulate
        sl = slice(lo, lo + 150)
        tmetrics.score_hists(torch.from_numpy(pos[sl]),
                             torch.from_numpy(neg[sl]),
                             torch.from_numpy(w[sl]), hp, hn)
    jp = jnp.zeros(jmetrics.F16_BINS, jnp.int32)
    jn = jnp.zeros_like(jp)
    jp, jn = jmetrics.score_hists(jnp.asarray(pos), jnp.asarray(neg),
                                  jnp.asarray(w), jp, jn)
    np.testing.assert_array_equal(hp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(hn.numpy(), np.asarray(jn))
    assert hp.sum().item() == int(w.sum())
    np.testing.assert_allclose(tmetrics.hist_auc(hp.numpy(), hn.numpy()),
                               jmetrics.hist_auc(jp, jn), rtol=1e-12)
    assert tmetrics.hist_auc(np.zeros(4), np.ones(4)) == 0.5


@pytest.fixture(scope="module")
def eval_setup(tiny_dataset):
    ds = tiny_dataset
    cfg = configs3()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, coattn_pool="max"))
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(7))
    rng = np.random.default_rng(7)
    for k, v in sd.items():                   # far from uniform attention
        std = 0.5 if "table" in k else 0.3 if not v.any() else None
        if std is not None:
            sd[k] = torch.from_numpy(
                rng.normal(0, std, v.shape).astype(np.float32))
    jm = build_model(cfg, ds.num_users, ds.num_items)
    jparams = jax.tree.map(jnp.asarray, to_flax(sd))
    tm = ScoreModel(cfg.model, ds.num_users, ds.num_items)
    tm.load_state_dict(sd)
    return ds, jm, jparams, tm


@pytest.mark.parametrize("max_targets", [None, 150])
def test_evaluate_matches_jax(eval_setup, max_targets):
    ds, jm, jparams, tm = eval_setup
    assert ds.val.neg.shape[1] == 20 and len(ds.val) % 64 != 0
    want = jax_evaluate(jax_make_eval_step(jm), jparams,
                        device_graph(ds.graph), ds.val, batch_size=64,
                        max_targets=max_targets)
    got = ttrain.evaluate(ttrain.make_eval_step(tm),
                          tgraph.device_graph(ds.graph, "cpu"), ds.val,
                          batch_size=64, max_targets=max_targets)
    assert set(got) == set(want)
    assert 0.5 < want["auc"] < 1.0            # the weights rank something
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-3 if k == "auc"
                                   else 1e-4, err_msg=k)


def _val_batch(ds, n=8):
    return {k: torch.from_numpy(getattr(ds.val, k)[:n])
            for k in ("user", "item", "slot", "neg")}


def test_eval_step_casts_tables_once_for_bf16(eval_setup):
    """With bf16 compute the eval copy's tables are bf16 (the serving
    cast), its other weights copies of the model's own, and its scores
    those of the model itself (rounding commutes with the row gather)."""
    ds, _, _, tm = eval_setup
    cfg = dataclasses.replace(tm.cfg, compute_dtype="bfloat16")
    m16 = ScoreModel(cfg, ds.num_users, ds.num_items)
    m16.load_state_dict(tm.state_dict())
    step = ttrain.make_eval_step(m16)
    em = step.model
    assert em.tables.user_table.dtype == torch.bfloat16
    assert em.scorer.out.weight.data_ptr() != m16.scorer.out.weight.data_ptr()
    assert torch.equal(em.scorer.out.weight, m16.scorer.out.weight)
    g = tgraph.device_graph(ds.graph, "cpu")
    batch = _val_batch(ds)
    got = step(g, batch)
    with torch.inference_mode():
        cand = torch.cat([batch["item"][:, None], batch["neg"]], 1)
        want = m16.score_candidates(tgraph.gather_candidate_batch(
            g, batch["user"], cand, batch["slot"]))
    assert got.shape == (8, 21)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_step_is_a_snapshot(eval_setup, dtype):
    """An eval step made before a train step scores the model as it was,
    in f32 as in bf16: training changes the model, not the step's copy;
    a step made after it sees the update."""
    ds, _, _, tm = eval_setup
    cfg = configs3()
    cfg = cfg.replace(
        model=dataclasses.replace(tm.cfg, compute_dtype=dtype),
        data=dataclasses.replace(cfg.data, train_neg_mode="inbatch_iw"),
        train=dataclasses.replace(cfg.train, batch_size=32))
    state = ttrain.init_state(cfg, ds.num_users, ds.num_items,
                              tm.state_dict(), device="cpu")
    g = tgraph.device_graph(ds.graph, "cpu")
    batch = _val_batch(ds)
    step = ttrain.make_eval_step(state.model)
    before = step(g, batch)
    idx = np.arange(32)
    train_batch = {k: torch.from_numpy(getattr(ds.train, k)[idx])
                   for k in ("user", "item", "slot")}
    neg_iw = torch.from_numpy(ttrain.item_importance_weights(
        ds.train, ds.num_items))
    state, _ = ttrain.train_step(state, g, train_batch, [5], neg_iw)
    torch.testing.assert_close(step(g, batch), before, rtol=0, atol=0)
    after = ttrain.make_eval_step(state.model)(g, batch)
    assert not torch.equal(after, before)
