"""The port's optimizers and learning-rate schedules (score_tpu_torch/
optim.py) against the JAX package's make_optimizer, on `tiny_dataset` at
a tiny width in f32: configs3 with in-batch importance-weighted
negatives, tables every 2nd step at a 2x table learning rate, as
tests/test_torch_train.py trains it with Adam. Each of adam, adamw,
adagrad and sgd under a constant rate, a linear warmup from 0 and a
warmup-cosine decay takes 3 steps (full, dense, full) beside
make_train_step from the same flax params and optax state; then the
optimizer states through `params.opt_state_from_optax` and through the
port's checkpoints.

Tolerances are tests/test_torch_train.py's: the loss to 1e-5, params and
every optimizer-state leaf to rtol 1e-4 / atol 1e-6 (the same math, the
gradients summed in another order); counts and steps equal. Schedule
values agree to 1e-6 of the peak rate: the host's f32 arithmetic against
XLA's cos and fused multiply-adds, a few ulps apart."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from score_tpu.config import configs3
from score_tpu.data.pipeline import TargetIterator
from score_tpu.graph import device_graph
from score_tpu.train import (build_model, init_state, item_importance_weights,
                             make_optimizer, make_train_step)
from score_tpu_torch import graph as tgraph
from score_tpu_torch import optim as toptim
from score_tpu_torch import train as ttrain
from score_tpu_torch.checkpoint import CheckpointManager, apply_restore
from score_tpu_torch.params import (from_flax, init_params,
                                    opt_state_from_optax, to_flax)

from _torch_helpers import bounded

torch.set_num_threads(2)

B = 64
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-6)
# the optimizers as the tests run them: adamw's decay large enough to show
# in 3 steps (lr * wd = 5e-4 a step), adagrad and sgd at rates that move
# the parameters as far as Adam's 1e-3 does
OPTIMIZERS = {"adam": {}, "adamw": dict(weight_decay=0.5),
              "adagrad": dict(learning_rate=1e-2),
              "sgd": dict(learning_rate=0.5)}
# a warmup over 2 steps (lr 0, lr / 2, lr); a cosine after 1 warmup step
# over the run's 2 epochs of 2 steps (decay_steps 0: inferred)
SCHEDULES = {"constant": {}, "warmup": dict(warmup_steps=2),
             "cosine": dict(lr_schedule="cosine", warmup_steps=1,
                            num_epochs=2)}
STEPS_PER_EPOCH = 2


def _cfg(opt="adam", sched="constant", **train_kw):
    cfg = configs3()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, embed_dim=8, hidden_dim=8,
                                  mlp_dims=(16, 8)),
        data=dataclasses.replace(cfg.data, train_neg_mode="inbatch_iw"),
        train=dataclasses.replace(
            cfg.train, batch_size=B, table_update_every=2,
            table_lr_boost=2.0, optimizer=opt, **OPTIMIZERS[opt],
            **SCHEDULES[sched], **train_kw))


def _shifts(rng, step):
    s = jax.random.randint(jax.random.fold_in(rng, step), (1,), 1, B,
                           dtype=jnp.int32)
    return [int(x) for x in np.asarray(s)]


def _close(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(),
                                   err_msg=f"{what} {k}", **TOL)


@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_three_stride2_steps_match_make_train_step(tiny_dataset, opt, sched):
    """Params, every optimizer-state leaf, count and step after full,
    dense, full steps, from the reference's init and optax state."""
    ds = tiny_dataset
    cfg = _cfg(opt, sched)
    jg = device_graph(ds.graph)
    jm = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    jstate = init_state(cfg, jm, jg, rng, steps_per_epoch=STEPS_PER_EPOCH)
    neg_iw = item_importance_weights(ds.train, ds.num_items)
    st = ttrain.init_state(
        cfg, ds.num_users, ds.num_items,
        from_flax(jax.tree.map(np.asarray, jstate.params)), device="cpu",
        opt_state=opt_state_from_optax(jax.device_get(jstate.opt_state),
                                       step=int(jstate.step)),
        steps_per_epoch=STEPS_PER_EPOCH)
    assert type(st.opt).name == opt
    jstep = make_train_step(jm, cfg, neg_iw=jnp.asarray(neg_iw))
    tg = tgraph.device_graph(ds.graph, "cpu")
    it = TargetIterator(ds.train, B, seed=3)
    for step in range(3):
        batch = next(it)
        jstate, jmet = jstep(jstate, jg,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             rng)
        st, m = ttrain.train_step(st, tg, batch, _shifts(rng, step),
                                  torch.from_numpy(neg_iw))
        np.testing.assert_allclose(m["loss"].item(), float(jmet["loss"]),
                                   **LOSS_TOL)
    jopt = opt_state_from_optax(jax.device_get(jstate.opt_state),
                                step=int(jstate.step))
    assert st.step == st.opt.count == jopt["count"] == int(jstate.step) == 3
    _close(dict(st.model.named_parameters()),
           from_flax(jax.tree.map(np.asarray, jstate.params)), "param")
    mine = st.opt.state()
    assert set(mine) - {"name"} == set(jopt)
    for key in type(st.opt).state_keys:
        _close(mine[key], jopt[key], key)


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_warmup_first_step_moves_nothing(tiny_dataset, opt):
    """A schedule reads the count before its increment (0 at the first
    step), so a warmup from 0 leaves every parameter bit-unchanged on
    step 0, while Adam's moments and Adagrad's sums (and the count) move;
    step 1 moves the parameters."""
    ds = tiny_dataset
    cfg = _cfg(opt, "cosine")
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(0))
    st = ttrain.init_state(cfg, ds.num_users, ds.num_items,
                           {k: v.clone() for k, v in sd.items()},
                           device="cpu", steps_per_epoch=STEPS_PER_EPOCH)
    tg = tgraph.device_graph(ds.graph, "cpu")
    neg_iw = torch.from_numpy(item_importance_weights(ds.train, ds.num_items))
    it = TargetIterator(ds.train, B, seed=0)
    state0 = {k: {n: t.clone() for n, t in getattr(st.opt, k).items()}
              for k in type(st.opt).state_keys}
    st, _ = ttrain.train_step(st, tg, next(it), [5], neg_iw)
    for k, p in st.model.named_parameters():
        assert torch.equal(p.detach(), sd[k]), k
    assert st.opt.count == 1
    for key, before in state0.items():
        assert any(not torch.equal(v, getattr(st.opt, key)[n])
                   for n, v in before.items()), key
    st, _ = ttrain.train_step(st, tg, next(it), [7], neg_iw)
    assert any(not torch.equal(p.detach(), sd[k])
               for k, p in st.model.named_parameters())


@pytest.mark.parametrize("kw", [
    dict(warmup_steps=10), dict(lr_schedule="cosine", decay_steps=53),
    dict(lr_schedule="cosine", warmup_steps=5, decay_steps=53),
    dict(lr_schedule="cosine", warmup_steps=3, num_epochs=3)])
def test_schedule_matches_optax(kw):
    """The host's f32 learning rate against the reference's schedule at
    every count of the run and past it, the count an int32 as optax's
    state holds it; a cosine reaches 0 at its horizon and stays there, and
    a warmup starts at 0 (without one, a cosine starts at the peak)."""
    spe = 7
    cfg = configs3()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                learning_rate=3e-3, **kw))
    sched = toptim.make_optimizer(cfg, {"w": torch.zeros(1)}, spe).schedule
    want = jax.jit(_optax_schedule(cfg, spe))
    horizon = cfg.train.decay_steps or spe * cfg.train.num_epochs
    assert sched(0) == (0.0 if cfg.train.warmup_steps
                        else float(np.float32(3e-3)))
    for count in range(horizon + 5):
        w = float(want(jnp.asarray(count, jnp.int32)))
        np.testing.assert_allclose(sched(count), w, rtol=0, atol=3e-9,
                                   err_msg=f"count {count}")
        if cfg.train.lr_schedule == "cosine" and count >= horizon:
            assert sched(count) == 0.0
    assert sched(horizon - 1) > 0.0


@pytest.mark.parametrize("decay", [0.9, 0.999])
def test_adam_bias_correction_is_optax_f32(decay):
    """Adam's bias correction 1 - decay**count against optax's, computed
    as optax computes it (an int32 count, f32 arithmetic under jit), bit
    for bit at every count from 1 to 4000. An f64 power rounded once to
    f32 differs at some of them (with b2 = 0.999 at every count 2-9)."""
    counts = np.arange(1, 4001, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda c: 1 - decay ** c))(counts))
    assert want.dtype == np.float32
    opt = toptim.Adam({"w": torch.zeros(1)}, 1e-3)
    got = np.empty_like(want)
    for j, c in enumerate(counts):
        opt.count = int(c)
        got[j] = opt._bias_correction(decay)
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, (f"{bad.size} counts differ, first "
                           f"{counts[bad[:5]]}: {got[bad[:5]]} vs "
                           f"{want[bad[:5]]}")


def test_constant_rate_keeps_no_schedule():
    opt = toptim.make_optimizer(configs3(), {"w": torch.zeros(1)}, 5)
    assert opt.schedule is None and opt.learning_rate() == 1e-3


def _optax_schedule(cfg, spe):
    """score_tpu/train.py:make_optimizer's schedule, built as it builds
    it."""
    tc = cfg.train
    lr = tc.learning_rate
    if tc.lr_schedule == "cosine":
        return optax.warmup_cosine_decay_schedule(
            init_value=0.0 if tc.warmup_steps else lr, peak_value=lr,
            warmup_steps=tc.warmup_steps,
            decay_steps=tc.decay_steps or max(spe * tc.num_epochs, 1))
    return optax.linear_schedule(0.0, lr, tc.warmup_steps)


def _small_tree(cfg, ds):
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(1))
    return sd, jax.tree.map(jnp.asarray, to_flax(sd))


@pytest.mark.parametrize("sched", ["constant", "cosine"])
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_opt_state_from_optax(tiny_dataset, opt, sched):
    """Each optimizer's optax state after two updates -> the port's
    state: its leaves (Adam's moments, Adagrad's sums from 0.1), the
    count from ScaleByAdamState or ScaleByScheduleState; sgd and adagrad
    at a constant rate keep none, and take the train state's step."""
    ds = tiny_dataset
    cfg = _cfg(opt, sched)
    sd, tree = _small_tree(cfg, ds)
    tx = make_optimizer(cfg, STEPS_PER_EPOCH)
    ostate = tx.init(tree)
    grads = jax.tree.map(lambda v: jnp.full_like(v, 0.5), tree)
    for _ in range(2):
        _, ostate = tx.update(grads, ostate, tree)
    keeps_count = opt in ("adam", "adamw") or sched != "constant"
    if not keeps_count:
        with pytest.raises(ValueError, match="step="):
            opt_state_from_optax(ostate)
    got = opt_state_from_optax(jax.device_get(ostate), step=2)
    if keeps_count:
        assert opt_state_from_optax(jax.device_get(ostate))["count"] == 2
        with pytest.raises(ValueError, match="count"):
            opt_state_from_optax(jax.device_get(ostate), step=3)
    keys = toptim.OPTIMIZERS[opt].state_keys
    assert set(got) == {"count", *keys} and got["count"] == 2
    if opt == "adagrad":   # 0.1 + 2 * 0.25
        assert all(torch.allclose(v, torch.full_like(v, 0.6))
                   for v in got["sum_of_squares"].values())
    st = ttrain.init_state(cfg, ds.num_users, ds.num_items, sd,
                           device="cpu", opt_state=got,
                           steps_per_epoch=STEPS_PER_EPOCH)
    assert st.step == st.opt.count == 2
    for key in keys:
        _close(getattr(st.opt, key), got[key], key)


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_fresh_state_matches_optax_init(tiny_dataset, opt):
    """A fresh optimizer's count and state are optax's init: Adam's
    moments 0, Adagrad's sums at initial_accumulator_value 0.1."""
    ds = tiny_dataset
    cfg = _cfg(opt, "warmup")
    sd, tree = _small_tree(cfg, ds)
    want = opt_state_from_optax(
        jax.device_get(make_optimizer(cfg).init(tree)), step=0)
    st = ttrain.init_state(cfg, ds.num_users, ds.num_items, sd, device="cpu")
    mine = st.opt.state()
    assert mine.pop("name") == opt and mine.pop("count") == 0 == st.step
    assert set(mine) == set(want) - {"count"}
    for key, tree_ in mine.items():
        for k, v in want[key].items():
            assert torch.equal(tree_[k], v), (key, k)


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_checkpoint_round_trip(tiny_dataset, tmp_path, opt):
    """A checkpoint names its optimizer and holds its count and state;
    restored into a fresh state, the next step gives bit-equal weights
    to the original's. Another optimizer's state is refused."""
    ds = tiny_dataset
    cfg = _cfg(opt, "cosine")
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(2))
    tg = tgraph.device_graph(ds.graph, "cpu")
    neg_iw = torch.from_numpy(item_importance_weights(ds.train, ds.num_items))

    def fresh():
        return ttrain.init_state(cfg, ds.num_users, ds.num_items,
                                 {k: v.clone() for k, v in sd.items()},
                                 device="cpu",
                                 steps_per_epoch=STEPS_PER_EPOCH)
    batches = [next(TargetIterator(ds.train, B, seed=s)) for s in range(4)]
    a = fresh()
    for j in range(3):
        a, _ = ttrain.train_step(a, tg, batches[j], [j + 1], neg_iw)
    mgr = CheckpointManager(str(tmp_path))
    bounded(mgr.save, "latest", a, (0, 3), 0.5, 3, block=True)
    restored = mgr.restore("latest", torch.device("cpu"))
    assert restored["opt_state"]["name"] == opt
    assert restored["opt_state"]["count"] == 3
    b = apply_restore(fresh(), restored)
    assert b.step == b.opt.count == 3
    for key in type(a.opt).state_keys:
        for k, v in getattr(a.opt, key).items():
            assert torch.equal(getattr(b.opt, key)[k], v), (key, k)
    a, _ = ttrain.train_step(a, tg, batches[3], [4], neg_iw)
    b, _ = ttrain.train_step(b, tg, batches[3], [4], neg_iw)
    for (k, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), k
    other = "sgd" if opt != "sgd" else "adam"
    st = ttrain.init_state(_cfg(other), ds.num_users, ds.num_items, sd,
                           device="cpu")
    with pytest.raises(ValueError, match=opt):
        apply_restore(st, restored)


def test_adam_checkpoint_without_a_name_restores_as_adam(tiny_dataset,
                                                         tmp_path):
    """A file as the port wrote it before it had other optimizers: its
    opt_state {count, mu, nu} names none. It restores into Adam as it
    did; adagrad refuses it."""
    ds = tiny_dataset
    cfg = _cfg("adam")
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    mu = {k: torch.randn(v.shape, generator=gen) for k, v in sd.items()}
    nu = {k: torch.rand(v.shape, generator=gen) for k, v in sd.items()}
    torch.save({"params": sd, "opt_state": {"count": 5, "mu": mu, "nu": nu},
                "step": 5, "it_epoch": 0, "it_pos": 5, "best_val": 0.5},
               tmp_path / "latest.pt")
    restored = CheckpointManager(str(tmp_path)).restore("latest", "cpu")
    st = apply_restore(ttrain.init_state(cfg, ds.num_users, ds.num_items,
                                         sd, device="cpu"), restored)
    assert type(st.opt) is toptim.Adam and st.step == st.opt.count == 5
    for k in sd:
        assert torch.equal(st.opt.mu[k], mu[k])
        assert torch.equal(st.opt.nu[k], nu[k])
    ada = ttrain.init_state(_cfg("adagrad"), ds.num_users, ds.num_items, sd,
                            device="cpu")
    with pytest.raises(ValueError, match="adam"):
        apply_restore(ada, restored)
