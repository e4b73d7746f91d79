"""The port's configs3 train step against the JAX package's, on
`tiny_dataset` at a tiny width in f32, the rest as bench.py trains:
in-batch importance-weighted negatives (one rolled negative), Adam,
tables updated every 2nd step at a 2x table learning rate, L2 on the
tables. Both start from the same flax params and optax state, take the
same batches, and the port is handed JAX's own shifts
(jax.random.randint(fold_in(rng, step), (1,), 1, B), as the reference
draws them).

Tolerances (f32): the loss to 1e-5 and the gradients to rtol 1e-4 /
atol 1e-6 (the same math, summed in another order); parameters and Adam
moments after 3 steps to rtol 1e-4 / atol 1e-6 (Adam divides by sqrt(nu),
which magnifies the gradients' last-bit differences on small
gradients)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_tpu.config import configs3
from score_tpu.data.pipeline import TargetIterator
from score_tpu.graph import device_graph, gather_candidate_batch
from score_tpu.metrics import auc as jax_auc
from score_tpu.nn.scorer import bce_loss as jax_bce
from score_tpu.train import (_table_l2, build_model, init_state,
                             item_importance_weights, make_train_step)
from score_tpu_torch import graph as tgraph
from score_tpu_torch import train as ttrain
from score_tpu_torch.metrics import auc
from score_tpu_torch.config import configs4
from score_tpu_torch.params import (from_flax, init_params,
                                    opt_state_from_optax, to_flax)
from score_tpu_torch.serve import ScoringService

torch.set_num_threads(2)

B = 64
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-6)


def _cfg(**train_kw):
    cfg = configs3()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, embed_dim=8, hidden_dim=8,
                                  mlp_dims=(16, 8)),
        data=dataclasses.replace(cfg.data, train_neg_mode="inbatch_iw"),
        train=dataclasses.replace(
            cfg.train, batch_size=B, table_update_every=2,
            table_lr_boost=2.0, **train_kw))


def _batches(ds, n, seed=3):
    it = TargetIterator(ds.train, B, seed=seed)
    return [next(it) for _ in range(n)]


class Setup:
    """The JAX side's model, state, step and graph, and the same start for
    the port (from the JAX state's params and optax state)."""

    def __init__(self, ds, cfg):
        self.ds, self.cfg = ds, cfg
        self.jgraph = device_graph(ds.graph)
        self.jmodel = build_model(cfg, ds.num_users, ds.num_items)
        self.rng = jax.random.PRNGKey(0)
        self.jstate = init_state(cfg, self.jmodel, self.jgraph, self.rng)
        self.neg_iw_np = item_importance_weights(ds.train, ds.num_items)
        self.tgraph = tgraph.device_graph(ds.graph, "cpu")

    def port_state(self, jstate=None):
        jstate = self.jstate if jstate is None else jstate
        sd = from_flax(jax.tree.map(np.asarray, jstate.params))
        return ttrain.init_state(
            self.cfg, self.ds.num_users, self.ds.num_items, sd,
            device="cpu", opt_state=opt_state_from_optax(
                jax.device_get(jstate.opt_state)))

    def shifts(self, step):
        """The reference's draw for k == 1 (score_tpu/train.py:199)."""
        s = jax.random.randint(jax.random.fold_in(self.rng, step), (1,), 1,
                               B, dtype=jnp.int32)
        return [int(x) for x in np.asarray(s)]


@pytest.fixture(scope="module")
def setup(tiny_dataset):
    return Setup(tiny_dataset, _cfg())


def _close_tree(got_sd, want_tree, tol, what):
    want = from_flax(jax.tree.map(np.asarray, want_tree))
    assert set(got_sd) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got_sd[k].detach().numpy(), w.numpy(),
                                   err_msg=f"{what} {k}", **tol)


def test_first_step_loss_and_grads_match_jax(setup):
    """Loss and all 19 gradients of step 0 (a full step: tables included,
    with their L2 term) against jax.grad of the reference loss."""
    s = setup
    batch = _batches(s.ds, 1)[0]
    shifts = s.shifts(0)
    u, i, t = (jnp.asarray(batch[k]) for k in ("user", "item", "slot"))
    mb = gather_candidate_batch(s.jgraph, u, i[:, None], t)
    mb["neg_shift"] = jnp.asarray(shifts, jnp.int32)
    negs = jnp.roll(i, -shifts[0])[:, None]
    w = jnp.concatenate([jnp.ones((B, 1)), (negs != i[:, None]).astype(
        jnp.float32) * jnp.asarray(s.neg_iw_np)[negs]], axis=1)
    labels = jnp.concatenate([jnp.ones((B, 1)), jnp.zeros((B, 1))], axis=1)
    l2 = s.cfg.train.l2_emb

    def loss_fn(params):
        logits = s.jmodel.apply({"params": params}, mb, train=True,
                                method=s.jmodel.score_candidates)
        loss = jax_bce(logits, labels, w)
        return loss + l2 * _table_l2(params), loss

    jgrads, jloss = jax.grad(loss_fn, has_aux=True)(s.jstate.params)

    st = s.port_state()
    model = st.model
    tu, it, tt = (torch.from_numpy(batch[k]) for k in ("user", "item",
                                                       "slot"))
    tb = tgraph.gather_candidate_batch(s.tgraph, tu, it[:, None], tt)
    logits = model.score_candidates(tb, neg_shift=shifts)
    tnegs = torch.roll(it, -shifts[0])[:, None]
    tw = torch.cat([torch.ones(B, 1), (tnegs != it[:, None]).float()
                    * torch.from_numpy(s.neg_iw_np)[tnegs.long()]], 1)
    tlabels = torch.cat([torch.ones(B, 1), torch.zeros(B, 1)], 1)
    loss = ttrain.bce_loss(logits, tlabels, tw)
    total = loss + l2 * ttrain.table_l2(model)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    _close_tree(dict(zip(names, grads)), jgrads, TOL, "grad")
    # every table row that a lookup touched has a gradient beyond its L2
    assert (grads[names.index("tables.item_table")].abs() > 0).any()


def test_three_stride2_steps_match_make_train_step(setup):
    """Params, Adam moments and count after full, dense, full steps. The
    third step's table update needs optax's shared count (3), not a
    per-parameter one (2)."""
    s = setup
    jstep = make_train_step(s.jmodel, s.cfg, neg_iw=jnp.asarray(s.neg_iw_np))
    # the step donates its state: step a copy, keep the shared start
    jstate = jax.tree.map(jnp.copy, s.jstate)
    st = s.port_state()
    neg_iw = torch.from_numpy(s.neg_iw_np)
    for step, batch in enumerate(_batches(s.ds, 3)):
        jstate, jm = jstep(jstate, s.jgraph,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           s.rng)
        st, m = ttrain.train_step(st, s.tgraph, batch, s.shifts(step),
                                  neg_iw)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   **LOSS_TOL)
        np.testing.assert_allclose(m["batch_auc"].item(),
                                   float(jm["batch_auc"]), atol=1e-6)
    assert st.step == 3 and st.opt.count == 3
    jopt = opt_state_from_optax(jax.device_get(jstate.opt_state))
    assert jopt["count"] == 3
    _close_tree(dict(st.model.named_parameters()), jstate.params, TOL,
                "param")
    for name in ("mu", "nu"):
        _close_tree(getattr(st.opt, name),
                    to_flax(jopt[name]), TOL, name)


def test_restored_odd_count_resumes_stride(setup):
    """A state restored after the reference's step 0 (Adam count 1) resumes
    at step 1: the next stride-2 step is dense and the one after updates
    the tables, as make_train_step does from the same state. Tables,
    dense params and moments after two more steps match."""
    s = setup
    jstep = make_train_step(s.jmodel, s.cfg, neg_iw=jnp.asarray(s.neg_iw_np))
    jstate = jax.tree.map(jnp.copy, s.jstate)
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in _batches(s.ds, 3, seed=7)]
    jstate, _ = jstep(jstate, s.jgraph, batches[0], s.rng)
    st = s.port_state(jstate)
    neg_iw = torch.from_numpy(s.neg_iw_np)
    for step in (1, 2):
        jstate, _ = jstep(jstate, s.jgraph, batches[step], s.rng)
        st, _ = ttrain.train_step(
            st, s.tgraph, {k: np.array(v) for k, v in
                           batches[step].items()}, s.shifts(step), neg_iw)
    jopt = opt_state_from_optax(jax.device_get(jstate.opt_state))
    _close_tree(dict(st.model.named_parameters()), jstate.params, TOL,
                "param")
    for name in ("mu", "nu"):
        _close_tree(getattr(st.opt, name), to_flax(jopt[name]), TOL, name)
    assert st.step == st.opt.count == jopt["count"] == 3


@pytest.mark.parametrize("entry", ["init_state", "ScoringService"])
@pytest.mark.parametrize("case", ["configs4", "param_dtype"])
def test_refuses_sharded_and_non_f32_params(tiny_dataset, entry, case):
    """configs4 must not run as configs3 on one device, and bf16 master
    weights are not ported (the table-gradient kernel takes f32)."""
    ds = tiny_dataset
    if case == "configs4":       # otherwise as the port trains configs3
        base = configs4()
        base = cfg = base.replace(data=dataclasses.replace(
            base.data, train_neg_mode="inbatch_iw"))
    else:
        base = _cfg()
        cfg = base.replace(model=dataclasses.replace(
            base.model, param_dtype="bfloat16"))
    w = init_params(base, ds.num_users, ds.num_items,
                    torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError):
        if entry == "init_state":
            ttrain.init_state(cfg, ds.num_users, ds.num_items, w,
                              device="cpu")
        else:
            ScoringService(cfg, ds, w, device="cpu")


def test_train_loop_matches_sequential_steps(setup):
    s = setup
    neg_iw = torch.from_numpy(s.neg_iw_np)
    batches = _batches(s.ds, 4, seed=5)
    shifts = [s.shifts(j) for j in range(4)]
    a, b = s.port_state(), s.port_state()
    losses = []
    for batch, sh in zip(batches, shifts):
        a, m = ttrain.train_step(a, s.tgraph, batch, sh, neg_iw)
        losses.append(m["loss"])
    b, mb = ttrain.train_loop(b, s.tgraph, batches, shifts, neg_iw)
    assert mb["loss"].shape == (4,) and b.step == a.step == 4
    torch.testing.assert_close(mb["loss"], torch.stack(losses), rtol=0,
                               atol=0)
    torch.testing.assert_close(mb["batch_auc"][0], m["batch_auc"], rtol=0,
                               atol=0)
    for (k, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), k


def test_tables_bit_unchanged_on_dense_steps(setup):
    """Tables and their moments change exactly on steps with step % 2 == 0
    and are bit-unchanged otherwise; dense params change every step."""
    s = setup
    st = s.port_state()
    neg_iw = torch.from_numpy(s.neg_iw_np)
    batch = _batches(s.ds, 1)[0]

    def snap(sd, tables):
        return {k: v.detach().clone() for k, v in sd.items()
                if ttrain.is_table(k) == tables}

    for step in range(4):
        sd = dict(st.model.named_parameters())
        prev_t, prev_d = snap(sd, True), snap(sd, False)
        prev_mu, prev_nu = snap(st.opt.mu, True), snap(st.opt.nu, True)
        st, m = ttrain.train_step(st, s.tgraph, batch, [1 + step], neg_iw)
        assert torch.isfinite(m["loss"])
        sd = dict(st.model.named_parameters())
        update = step % 2 == 0
        for before, now in ((prev_t, sd), (prev_mu, st.opt.mu),
                            (prev_nu, st.opt.nu)):
            same = all(torch.equal(v, now[k]) for k, v in before.items())
            assert same != update, (step, update)
        assert any(not torch.equal(v, sd[k]) for k, v in prev_d.items())


def test_table_lr_boost_scales_table_updates_only(tiny_dataset):
    ds = tiny_dataset
    batch = _batches(ds, 1)[0]
    neg_iw = torch.from_numpy(item_importance_weights(ds.train, ds.num_items))
    outs = {}
    for boost in (1.0, 2.0):
        cfg = _cfg()
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, table_lr_boost=boost, table_update_every=1))
        w = init_params(cfg, ds.num_users, ds.num_items,
                        torch.Generator().manual_seed(0))
        st = ttrain.init_state(cfg, ds.num_users, ds.num_items, w,
                               device="cpu")
        st, _ = ttrain.train_step(st, tgraph.device_graph(ds.graph, "cpu"),
                                  batch, [3], neg_iw)
        outs[boost] = {k: (p.detach() - w[k])
                       for k, p in st.model.named_parameters()}
    for k, du in outs[1.0].items():
        db = outs[2.0][k]
        if ttrain.is_table(k):
            torch.testing.assert_close(db, 2.0 * du, rtol=1e-5, atol=1e-7)
        else:
            torch.testing.assert_close(db, du, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("over", [dict(data=dict(train_neg_mode="uniform")),
                                  dict(model=dict(dropout=0.1)),
                                  dict(train=dict(optimizer="sgd")),
                                  dict(train=dict(lr_schedule="cosine"))])
def test_refuses_what_is_not_ported(tiny_dataset, over):
    cfg = _cfg()
    cfg = cfg.replace(**{sec: dataclasses.replace(getattr(cfg, sec), **kw)
                         for sec, kw in over.items()})
    w = init_params(_cfg(), tiny_dataset.num_users, tiny_dataset.num_items,
                    torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError):
        ttrain.init_state(cfg, tiny_dataset.num_users,
                          tiny_dataset.num_items, w, device="cpu")


@pytest.mark.parametrize("case", ["ties", "weights", "one_class", "random"])
def test_auc_matches_jax(case):
    rng = np.random.default_rng(len(case))
    n = 200
    scores = rng.normal(size=n).astype(np.float32)
    labels = (rng.random(n) > 0.6).astype(np.float32)
    weights = np.ones(n, np.float32)
    if case == "ties":
        scores = np.round(scores * 2) / 2          # many tied scores
    elif case == "weights":
        weights = (rng.random(n) > 0.3) * rng.random(n).astype(np.float32)
        scores[:20] = scores[20:40]                # ties across the mask
    elif case == "one_class":
        labels[:] = 1.0
    got = auc(torch.from_numpy(scores), torch.from_numpy(labels),
              torch.from_numpy(weights.astype(np.float32)))
    want = jax_auc(jnp.asarray(scores), jnp.asarray(labels),
                   jnp.asarray(weights.astype(np.float32)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    if case == "one_class":
        assert got.item() == 0.5
