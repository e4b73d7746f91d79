"""Scorer dropout in the port against the JAX package's, on `tiny_dataset`
at a tiny width: flax's Dropout after each hidden ReLU, given the
reference's own masks. torch draws other bits than JAX, so the masks are
read from the reference (`capture_intermediates` on the scorer's drop_i
outputs: an element is kept where the output is non-zero; where the ReLU
output is 0 the mask does not matter) and fed to the port. Then the
scorer, one step's loss and gradients, and three train steps agree, in
f32 and bf16; eval and serving of a dropout model are deterministic; and
the port's own masks, drawn on the device from (seed, step), are the same
for the same step and drop the configured share.

Tolerances: the scorer and the loss as tests/test_torch_model.py holds
the forward (f32 1e-4; bf16 rtol 2e-2 / atol 2e-3); the f32 gradients
and the three steps' params and moments as tests/test_torch_train.py
holds them (rtol 1e-4 / atol 1e-6), the bf16 gradients to 2e-2 of each
gradient's largest value (one bf16 rounding of activations of order 1)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_tpu.config import configs3
from score_tpu.data.pipeline import TargetIterator
from score_tpu.graph import device_graph, gather_candidate_batch
from score_tpu.nn.scorer import Scorer as JaxScorer
from score_tpu.nn.scorer import bce_loss as jax_bce
from score_tpu.train import (_table_l2, build_model, init_state,
                             item_importance_weights, make_train_step)
from score_tpu_torch import graph as tgraph
from score_tpu_torch import train as ttrain
from score_tpu_torch.nn.scorer import Scorer
from score_tpu_torch.params import (from_flax, init_params,
                                    opt_state_from_optax, to_flax)
from score_tpu_torch.serve import ScoringService

torch.set_num_threads(2)

B = 64
FWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
           "bfloat16": dict(rtol=2e-2, atol=2e-3)}
TOL = dict(rtol=1e-4, atol=1e-6)
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfg(dtype="float32", rate=0.1, **data_kw):
    cfg = configs3()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, embed_dim=8, hidden_dim=8,
                                  mlp_dims=(16, 8), compute_dtype=dtype,
                                  dropout=rate),
        data=dataclasses.replace(cfg.data, train_neg_mode="inbatch_iw",
                                 **data_kw),
        train=dataclasses.replace(cfg.train, batch_size=B,
                                  table_update_every=2, table_lr_boost=2.0))


def _is_drop(module, _name):
    return module.name is not None and module.name.startswith("drop_")


def _masks(inter, scope=("scorer",)):
    """The kept elements of each drop_i output the reference captured."""
    node = inter["intermediates"]
    for key in scope:
        node = node[key]
    return [torch.from_numpy(np.asarray(node[f"drop_{i}"]["__call__"][0])
                             != 0) for i in range(len(node))]


@pytest.mark.parametrize("rate", [0.1, 0.5, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scorer_dropout_matches_flax(dtype, rate):
    """The scorer alone in training mode with the reference's masks; a
    rate of 1 drops every hidden activation. In eval mode it runs no
    dropout, as flax's deterministic call."""
    rng = np.random.default_rng(0)
    feats = [rng.normal(size=(6, 5, 7)).astype(np.float32),
             rng.normal(size=(6, 5, 3)).astype(np.float32)]
    jm = JaxScorer(mlp_dims=(16, 8), dropout=rate, dtype=dtype)
    jx = [jnp.asarray(f) for f in feats]
    params = jm.init(jax.random.PRNGKey(0), jx)
    want, inter = jm.apply(params, jx, train=True,
                           rngs={"dropout": jax.random.PRNGKey(1)},
                           capture_intermediates=_is_drop,
                           mutable=["intermediates"])
    masks = _masks(inter, ())
    if rate < 1.0:   # some kept, some dropped: the masks matter
        assert 0 < float(torch.cat([m.flatten() for m in masks]).float()
                         .mean()) < 1
    tm = Scorer(10, (16, 8), _DT[dtype], dropout=rate)
    tm.load_state_dict(from_flax(jax.tree.map(np.asarray,
                                              params["params"])))
    tx = [torch.from_numpy(f) for f in feats]
    tm.train()
    with torch.no_grad():
        got = tm(tx, dropout_masks=masks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **FWD_TOL[dtype])
    tm.eval()
    with torch.no_grad():
        np.testing.assert_allclose(
            tm(tx).numpy(), np.asarray(jm.apply(params, jx)),
            **FWD_TOL[dtype])


def test_bf16_keep_division_is_flax_s():
    """In bf16 flax divides by the keep probability rounded to bf16; a
    multiply by 1 / keep_prob (torch's F.dropout) gives other bf16
    values at rate 0.1."""
    x = torch.linspace(0.01, 4.0, 4001).bfloat16()
    s = Scorer(1, (1,), torch.bfloat16, dropout=0.1)
    s.train()
    got = s._drop(x, torch.ones_like(x, dtype=torch.bool))
    want = np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16) / 0.9)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    mult = (x * (1 / 0.9)).float().numpy()
    assert (mult != want.astype(np.float32)).any()


class Setup:
    def __init__(self, ds, cfg):
        self.ds, self.cfg = ds, cfg
        self.jg = device_graph(ds.graph)
        self.jm = build_model(cfg, ds.num_users, ds.num_items)
        self.rng = jax.random.PRNGKey(0)
        jstate = init_state(cfg, self.jm, self.jg, self.rng)
        # the tables widened and the zero-initialised attention weights
        # made non-zero, so the scores, and what dropout does to them, are
        # far from 0
        sd = from_flax(jax.tree.map(np.asarray, jstate.params))
        gen = np.random.default_rng(0)
        for k, v in sd.items():
            std = 0.5 if "table" in k else 0.3 if not v.any() else None
            if std is not None:
                sd[k] = torch.from_numpy(
                    gen.normal(0, std, v.shape).astype(np.float32))
        self.jstate = jstate.replace(
            params=jax.tree.map(jnp.asarray, to_flax(sd)))
        self.neg_iw = item_importance_weights(ds.train, ds.num_items)
        self.tg = tgraph.device_graph(ds.graph, "cpu")

    def port_state(self):
        sd = from_flax(jax.tree.map(np.asarray, self.jstate.params))
        return ttrain.init_state(
            self.cfg, self.ds.num_users, self.ds.num_items, sd, device="cpu",
            opt_state=opt_state_from_optax(
                jax.device_get(self.jstate.opt_state)))

    def shifts(self, step):
        s = jax.random.randint(jax.random.fold_in(self.rng, step), (1,), 1,
                               B, dtype=jnp.int32)
        return [int(x) for x in np.asarray(s)]

    def ref_masks(self, params, batch, step):
        """The masks the reference's step `step` draws: its dropout key
        fold_in(fold_in(rng, step), 1) on the same inputs."""
        u, i, t = (jnp.asarray(batch[k]) for k in ("user", "item", "slot"))
        mb = gather_candidate_batch(self.jg, u, i[:, None], t)
        mb["neg_shift"] = jnp.asarray(self.shifts(step), jnp.int32)
        key = jax.random.fold_in(jax.random.fold_in(self.rng, step), 1)
        _, inter = self.jm.apply({"params": params}, mb, train=True,
                                 method=self.jm.score_candidates,
                                 rngs={"dropout": key},
                                 capture_intermediates=_is_drop,
                                 mutable=["intermediates"])
        return mb, key, _masks(inter)


def _one_step(s, batch):
    """The reference's loss and gradients of a full step (L2 on the
    tables) at step 0, with the masks its dropout key draws, and the
    port's, given those masks: (jax loss, jax grads, port loss, port
    grads, the port's first hidden layer's weight gradient with every
    element kept)."""
    mb, key, masks = s.ref_masks(s.jstate.params, batch, 0)
    shifts = s.shifts(0)
    item = jnp.asarray(batch["item"])[:, None]
    negs = jnp.roll(item, -shifts[0], axis=0)
    w = jnp.concatenate([jnp.ones((B, 1)), (negs != item).astype(
        jnp.float32) * jnp.asarray(s.neg_iw)[negs]], axis=1)
    labels = jnp.concatenate([jnp.ones((B, 1)), jnp.zeros((B, 1))], axis=1)
    l2 = s.cfg.train.l2_emb

    def loss_fn(params):
        logits = s.jm.apply({"params": params}, mb, train=True,
                            method=s.jm.score_candidates,
                            rngs={"dropout": key})
        loss = jax_bce(logits, labels, w)
        return loss + l2 * _table_l2(params), loss

    jgrads, jloss = jax.grad(loss_fn, has_aux=True)(s.jstate.params)
    model = s.port_state().model
    tb = tgraph.gather_candidate_batch(
        s.tg, torch.from_numpy(batch["user"]),
        torch.from_numpy(batch["item"])[:, None],
        torch.from_numpy(batch["slot"]))
    tw, tl = (torch.from_numpy(np.array(a)) for a in (w, labels))

    def port_loss(ms):
        return ttrain.bce_loss(model.score_candidates(
            tb, neg_shift=shifts, dropout_masks=ms), tl, tw)
    loss = port_loss(masks)
    grads = torch.autograd.grad(loss + l2 * ttrain.table_l2(model),
                                list(model.parameters()))
    w0 = model.scorer.mlp_0.weight
    kept, = torch.autograd.grad(port_loss([torch.ones_like(m)
                                           for m in masks]), [w0])
    names = [n for n, _ in model.named_parameters()]
    return (float(jloss), from_flax(jax.tree.map(np.asarray, jgrads)),
            loss.item(), {n: g.numpy() for n, g in zip(names, grads)},
            kept.numpy())


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_step_loss_and_grads_with_reference_masks(tiny_dataset, dtype):
    """Loss and every gradient of a full step with the reference's masks
    at rate 0.1. In f32 the gradients agree leaf by leaf. In bf16 each
    gradient is held to the exact one, the reference's f32 gradient: the
    port's may lie no farther from it than 3e-2 (relative L2), or than
    the reference's own bf16 gradient does. (With dropout the
    reference's bf16 backward lies 1-11% from its f32 one, the port's
    1-2.6%: without dropout both lie 0.2-2% from it.)"""
    ds = tiny_dataset
    batch = next(TargetIterator(ds.train, B, seed=3))
    s = Setup(ds, _cfg(dtype))
    jloss, jgrads, loss, grads, kept = _one_step(s, batch)
    np.testing.assert_allclose(loss, jloss, **FWD_TOL[dtype])
    # the masks act: with every element kept the gradients are others
    assert _rel(kept, grads["scorer.mlp_0.weight"]) > 0.1
    assert set(grads) == set(jgrads)
    if dtype == "float32":
        for n, g in grads.items():
            np.testing.assert_allclose(g, jgrads[n].numpy(), err_msg=n,
                                       **TOL)
        return
    exact = _one_step(Setup(ds, _cfg("float32")), batch)[1]
    for n, g in grads.items():
        want = exact[n].numpy()
        ref = _rel(jgrads[n].numpy(), want)
        assert _rel(g, want) <= max(3e-2, ref), (n, _rel(g, want), ref)


def test_three_steps_with_reference_masks_match_make_train_step(
        tiny_dataset):
    """train_step given the masks make_train_step draws (f32, rate 0.1):
    params, Adam moments, count after full, dense, full steps."""
    s = Setup(tiny_dataset, _cfg())
    jstep = make_train_step(s.jm, s.cfg, neg_iw=jnp.asarray(s.neg_iw))
    jstate = jax.tree.map(jnp.copy, s.jstate)
    st = s.port_state()
    it = TargetIterator(s.ds.train, B, seed=5)
    for step in range(3):
        batch = next(it)
        _, _, masks = s.ref_masks(jstate.params, batch, step)
        jstate, jm = jstep(jstate, s.jg,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           s.rng)
        st, m = ttrain.train_step(st, s.tg, batch, s.shifts(step),
                                  torch.from_numpy(s.neg_iw),
                                  dropout_masks=masks)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5, atol=1e-5)
    jopt = opt_state_from_optax(jax.device_get(jstate.opt_state))
    assert st.step == st.opt.count == jopt["count"] == 3
    want = from_flax(jax.tree.map(np.asarray, jstate.params))
    for tree, ref, what in ((dict(st.model.named_parameters()), want,
                             "param"), (st.opt.mu, jopt["mu"], "mu"),
                            (st.opt.nu, jopt["nu"], "nu")):
        for k, w in ref.items():
            np.testing.assert_allclose(tree[k].detach().numpy(), w.numpy(),
                                       err_msg=f"{what} {k}", **TOL)


def _state(ds, cfg, seed=0):
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(seed))
    return sd, ttrain.init_state(cfg, ds.num_users, ds.num_items,
                                 {k: v.clone() for k, v in sd.items()},
                                 device="cpu")


def test_port_masks_follow_seed_and_step(tiny_dataset):
    """Without masks a step draws them from (seed, step): two states at
    the same step take bit-equal steps, the next step draws others, and
    the hidden layers drop about the configured share."""
    ds = tiny_dataset
    cfg = _cfg(rate=0.3)
    neg_iw = torch.from_numpy(item_importance_weights(ds.train, ds.num_items))
    tg = tgraph.device_graph(ds.graph, "cpu")
    batch = next(TargetIterator(ds.train, B, seed=1))
    (_, a), (_, b) = _state(ds, cfg), _state(ds, cfg)
    a, ma = ttrain.train_step(a, tg, batch, [3], neg_iw)
    b, mb = ttrain.train_step(b, tg, batch, [3], neg_iw)
    assert torch.equal(ma["loss"], mb["loss"])
    a, ma = ttrain.train_step(a, tg, batch, [3], neg_iw)
    assert not torch.equal(ma["loss"], mb["loss"])
    gen = ttrain._step_generator(cfg.train.seed, 0, 1)
    keep = torch.rand(B, 1, 16, generator=gen) < 0.7
    assert 0.6 < keep.float().mean().item() < 0.8
    # and the generator of the step's dropout is not the host draws'
    assert not torch.equal(
        torch.rand(8, generator=ttrain._step_generator(0, 0, 1)),
        torch.rand(8, generator=ttrain._step_generator(0, 0)))


def test_eval_and_serving_run_no_dropout(tiny_dataset):
    """A dropout model's eval and serving are deterministic and equal to
    the same weights' scores without dropout."""
    ds = tiny_dataset
    cfg = _cfg(rate=0.5)
    sd, st = _state(ds, cfg)
    tg = tgraph.device_graph(ds.graph, "cpu")
    step = ttrain.make_eval_step(st.model)
    one = ttrain.evaluate(step, tg, ds.val, max_targets=64)
    assert one == ttrain.evaluate(step, tg, ds.val, max_targets=64)
    plain = _cfg(rate=0.0)
    _, st0 = _state(ds, plain)
    assert one == ttrain.evaluate(ttrain.make_eval_step(st0.model), tg,
                                  ds.val, max_targets=64)
    users = ds.test.user[:3]
    items = np.arange(1, 21, dtype=np.int32)[None].repeat(3, 0)
    svc = ScoringService(cfg, ds, sd, device="cpu")
    got = svc.score_batch(users, items)
    np.testing.assert_array_equal(got, svc.score_batch(users, items))
    np.testing.assert_array_equal(
        got, ScoringService(plain, ds, sd, device="cpu").score_batch(
            users, items))


def test_baseline_ignores_dropout(tiny_dataset):
    """The roster's archs have no scorer: dropout leaves their step as it
    is, as the reference's baselines ignore it."""
    from score_tpu_torch.config import PRESETS
    ds = tiny_dataset
    outs = []
    for rate in (0.0, 0.5):
        cfg = PRESETS["baseline_mf"]()
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=rate),
                          train=dataclasses.replace(cfg.train, batch_size=B))
        _, st = _state(ds, cfg)
        batch = next(TargetIterator(ds.train, B, seed=2))
        negs = torch.randint(1, ds.num_items + 1, (B, 1),
                             generator=torch.Generator().manual_seed(0),
                             dtype=torch.int32)
        st, m = ttrain.train_step(st, tgraph.device_graph(ds.graph, "cpu"),
                                  batch, negatives=negs)
        outs.append((m["loss"], [p.detach().clone()
                                 for p in st.model.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
