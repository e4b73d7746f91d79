"""The preset ladder's rungs configs0-2 (and configs3 with uniform
negatives) in the port against the JAX package, on `tiny_dataset` with the
same weights (flax tree <-> state_dict through score_tpu_torch.params):
the model's flat and candidates forms, in-batch rolls, three stride-2
train steps with uniform negatives (the port fed the reference's raw
draws), the collision rule, the scoring service, and the reference's
golden configs0 floor through the port's `train()`.

Tolerances: the forward in f32 1e-4 and in bf16 rtol 2e-2 / atol 2e-3,
as tests/test_torch_model.py holds configs3; in the train steps the loss
to 1e-5, and after them every parameter and Adam moment to 1e-4 relative
to itself or to its leaf's largest value: a table entry whose gradient
nearly cancels (its rows summed in another order) keeps an absolute error
of ~1e-6, which Adam's mu / sqrt(nu) carries into the update."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_tpu.config import configs0, configs1, configs2, configs3
from score_tpu.data.pipeline import TargetIterator
from score_tpu.graph import device_graph, gather_batch, gather_candidate_batch
from score_tpu.serve import ScoringService as JaxService
from score_tpu.train import build_model, init_state, make_train_step
from score_tpu_torch import graph as tgraph
from score_tpu_torch import train as ttrain
from score_tpu_torch.data import synth
from score_tpu_torch.data.prep_common import build_dataset
from score_tpu_torch.nn.model import ScoreModel
from score_tpu_torch.params import (from_flax, init_params,
                                    opt_state_from_optax, to_flax)
from score_tpu_torch.serve import ScoringService

torch.set_num_threads(2)

RUNGS = {"configs0": configs0, "configs1": configs1, "configs2": configs2,
         "configs3": configs3}
FWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
           "bfloat16": dict(rtol=2e-2, atol=2e-3)}
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = 1e-4
B = 64


def _cfg(rung, dtype="float32", **data_kw):
    cfg = RUNGS[rung]()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, embed_dim=8, hidden_dim=8,
                                  mlp_dims=(16, 8), compute_dtype=dtype),
        data=dataclasses.replace(cfg.data, **data_kw),
        train=dataclasses.replace(cfg.train, batch_size=B,
                                  table_update_every=2, table_lr_boost=2.0))


def _weights(cfg, ds, seed=0):
    """init_params, then every zero-initialised leaf made non-zero and the
    tables widened so the attention is far from uniform."""
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


def _requests(ds, n, C, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.linspace(0, len(ds.train) - 1, n).astype(np.int64)
    cand = rng.integers(1, ds.num_items + 1, (n, C)).astype(np.int32)
    return ds.train.user[idx], ds.train.slot[idx], cand


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rung", ["configs0", "configs1", "configs2"])
def test_rung_forward_matches_flax(tiny_dataset, rung, dtype):
    """The flat (u, i) form, the candidates form at C = 1 + 20 and the
    in-batch rolls (`neg_shift`, C = 1 + 2), same weights; the port's
    tree has exactly the flax tree's leaves."""
    ds = tiny_dataset
    cfg = _cfg(rung, dtype)
    sd = _weights(cfg, ds)
    jm = build_model(cfg, ds.num_users, ds.num_items)
    jparams = _jax_params(sd)
    jg = device_graph(ds.graph)
    tm = ScoreModel(cfg.model, ds.num_users, ds.num_items)
    tm.load_state_dict(sd)
    tg = tgraph.device_graph(ds.graph, "cpu")
    users, slots, cand = _requests(ds, 6, 21)
    u, s, c = (torch.from_numpy(a) for a in (users, slots, cand))

    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0), gather_batch(
        jg, jnp.ones(2, jnp.int32), jnp.ones(2, jnp.int32),
        jnp.full(2, ds.graph.num_slots, jnp.int32)))["params"]
    assert jax.tree.map(jnp.shape, init) == jax.tree.map(jnp.shape, jparams)

    def jax_cands(mb):
        return np.asarray(jm.apply({"params": jparams}, mb,
                                   method=jm.score_candidates))

    mb = gather_candidate_batch(jg, *map(jnp.asarray, (users, cand, slots)))
    with torch.inference_mode():
        got = tm.score_candidates(tgraph.gather_candidate_batch(
            tg, u, c, s, item_side=tm.dual))
        assert got.dtype == torch.float32 and got.shape == (6, 21)
        want = jax_cands(mb)
        assert np.std(want) > 1e-2
        np.testing.assert_allclose(got.numpy(), want, **FWD_TOL[dtype])

        shifts = [1, 4]
        jmb = gather_candidate_batch(jg, *map(jnp.asarray, (
            users, cand[:, :1], slots)))
        jmb["neg_shift"] = jnp.asarray(shifts, jnp.int32)
        got = tm.score_candidates(tgraph.gather_candidate_batch(
            tg, u, c[:, :1], s, item_side=tm.dual), neg_shift=shifts)
        assert got.shape == (6, 3)
        np.testing.assert_allclose(got.numpy(), jax_cands(jmb),
                                   **FWD_TOL[dtype])

        items = c[:, 0]
        want = np.asarray(jm.apply({"params": jparams}, gather_batch(
            jg, *map(jnp.asarray, (users, cand[:, 0], slots)))))
        u_hist, u_cnt = tgraph.gather_side(tg.u2i, tg.u2i_cnt, u)
        i_hist, i_cnt = tgraph.gather_side(tg.i2u, tg.i2u_cnt, items)
        got = tm(dict(user=u, item=items, slot=s, u_hist=u_hist,
                      u_cnt=u_cnt, i_hist=i_hist, i_cnt=i_cnt,
                      slot_valid=tgraph.slot_valid_mask(s, tg.num_slots)))
        np.testing.assert_allclose(got.numpy(), want, **FWD_TOL[dtype])


def test_coattn_needs_both_sides(tiny_dataset):
    """Co-attention on the user side alone is refused, as the reference
    asserts."""
    cfg = _cfg("configs3")
    with pytest.raises(ValueError):
        ScoreModel(dataclasses.replace(cfg.model, sides="user"),
                   tiny_dataset.num_users, tiny_dataset.num_items)


@pytest.mark.parametrize("neg, pos, want", [
    ([[5, 3]], [[5]], [[6, 3]]),        # a hit moves +1
    ([[9, 9]], [[9]], [[1, 1]]),        # a hit at num_items wraps to 1
    ([[1, 8, 9]], [[2]], [[1, 8, 9]]),  # no hit: unchanged
])
def test_resample_collisions(neg, pos, want):
    got = ttrain.resample_collisions(torch.tensor(neg, dtype=torch.int32),
                                     torch.tensor(pos, dtype=torch.int32), 9)
    assert got.dtype == torch.int32
    assert got.tolist() == want


@pytest.mark.parametrize("rung", list(RUNGS))
def test_three_uniform_steps_match_make_train_step(tiny_dataset, rung):
    """Full, dense, full steps (stride 2, 2x table lr) with uniform
    negatives, the port given the reference's raw draws
    randint(fold_in(rng, step), (B, k), 1, num_items + 1); step 1's batch
    has positives equal to their draws, so collisions are resampled."""
    ds = tiny_dataset
    cfg = _cfg(rung, num_train_neg=2)
    assert cfg.data.train_neg_mode == "uniform"
    jg = device_graph(ds.graph)
    jm = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    jstate = init_state(cfg, jm, jg, rng)
    st = ttrain.init_state(
        cfg, ds.num_users, ds.num_items,
        from_flax(jax.tree.map(np.asarray, jstate.params)), device="cpu",
        opt_state=opt_state_from_optax(jax.device_get(jstate.opt_state)))
    jstep = make_train_step(jm, cfg)
    tg = tgraph.device_graph(ds.graph, "cpu")
    it = TargetIterator(ds.train, B, seed=3)
    hits = 0
    for step in range(3):
        batch = next(it)
        raw = np.array(jax.random.randint(
            jax.random.fold_in(rng, step), (B, 2), 1, ds.num_items + 1,
            dtype=jnp.int32))
        if step == 1:
            batch["item"] = batch["item"].copy()
            batch["item"][:8] = raw[:8, 1]
        hits += int((raw == batch["item"][:, None]).sum())
        jstate, jmet = jstep(jstate, jg,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             rng)
        st, m = ttrain.train_step(st, tg, batch, negatives=raw)
        np.testing.assert_allclose(m["loss"].item(), float(jmet["loss"]),
                                   **LOSS_TOL)
        np.testing.assert_allclose(m["batch_auc"].item(),
                                   float(jmet["batch_auc"]), atol=1e-6)
    assert hits >= 8
    jopt = opt_state_from_optax(jax.device_get(jstate.opt_state))
    assert st.step == st.opt.count == jopt["count"] == 3
    want = from_flax(jax.tree.map(np.asarray, jstate.params))
    got = dict(st.model.named_parameters())
    assert set(got) == set(want)
    for name, tree, ref in (("param", got, want), ("mu", st.opt.mu,
                                                   jopt["mu"]),
                            ("nu", st.opt.nu, jopt["nu"])):
        for k, w in ref.items():
            w = w.numpy()
            np.testing.assert_allclose(
                tree[k].detach().numpy(), w, rtol=TOL,
                atol=TOL * np.abs(w).max(), err_msg=f"{name} {k}")


@pytest.mark.parametrize("rung", list(RUNGS))
def test_service_score_batch_matches_jax(tiny_dataset, rung):
    ds = tiny_dataset
    cfg = _cfg(rung)
    sd = _weights(cfg, ds, seed=3)
    port = ScoringService(cfg, ds, sd, device="cpu")
    ref = JaxService(cfg, ds, _jax_params(sd))
    users, _, items = _requests(ds, 3, 20, seed=4)
    got = port.score_batch(users, items)
    assert got.shape == (3, 20)
    np.testing.assert_allclose(got, ref.score_batch(users, items),
                               **FWD_TOL["float32"])


def test_configs0_checkpoint_serves_with_bf16_shared_table(tiny_dataset,
                                                           tmp_path):
    """A configs0 tree through `train()`'s checkpoints: `from_checkpoint`
    restores it, and a bf16 service casts the one shared table to bf16
    and scores as a service on the weights `train()` returned."""
    ds = tiny_dataset
    cfg = _cfg("configs0", "bfloat16")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=256, num_epochs=1, log_every_steps=10 ** 9,
        eval_max_targets=64, checkpoint_dir=str(tmp_path)))
    out = ttrain.train(cfg, ds, verbose=False, device="cpu")
    svc = ScoringService.from_checkpoint(cfg, ds, str(tmp_path), device="cpu")
    assert svc.model.tables.table.dtype == torch.bfloat16
    users, _, items = _requests(ds, 3, 20, seed=5)
    np.testing.assert_array_equal(
        svc.score_batch(users, items),
        ScoringService(cfg, ds, out["params"],
                       device="cpu").score_batch(users, items))


GOLDEN_VAL_AUC_FLOOR = 0.60


def test_golden_configs0_run_through_the_port():
    """tests/test_train.py's golden run (its dataset recipe and config:
    configs0 with its uniform negatives, batch 128, lr 1e-2, 2 epochs)
    through the port's train() on the CPU, held to the same floors."""
    user, item, ts = synth.synth_events(400, 800, 40000, num_slots=8,
                                        seed=42)
    ds = build_dataset(user, item, ts, num_slots=8, user_fanout=6,
                       item_fanout=6, num_eval_neg=20, min_user=3,
                       min_item=3, seed=42, dataset_name="golden-ccmr")
    cfg = configs0()
    cfg = cfg.replace(train=cfg.train.__class__(
        batch_size=128, learning_rate=1e-2, num_epochs=2,
        eval_every_steps=100, early_stop_patience=10, seed=0,
        log_every_steps=10 ** 9))
    out = ttrain.train(cfg, ds, verbose=False, device="cpu")
    assert out["best_val_auc"] > GOLDEN_VAL_AUC_FLOOR, out["best_val_auc"]
    assert out["test"]["auc"] > GOLDEN_VAL_AUC_FLOOR - 0.05, out["test"]
    assert out["history"][-1]["loss"] < 0.69
