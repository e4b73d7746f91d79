"""The baseline roster in the port against the JAX package: the eight
`baseline_*` presets (MF, popularity, SVD++ and DELF; GRU4Rec, Caser,
SASRec and RRN as ScoreModel's flag sets) on `tiny_dataset` with the same
weights (flax tree <-> state_dict through score_tpu_torch.params): the
model's flat and candidates forms, three stride-2 train steps with
uniform negatives (the port fed the reference's raw draws), the scoring
service, the Caser and SASRec encoders' causality and weight bridge, and
in-batch negatives on a baseline arch.

Tolerances: the forward and serving in f32 1e-4 and in bf16 rtol 2e-2 /
atol 2e-3 (PERF.md §2); in the train steps the loss to 1e-5, and after
them every parameter and Adam moment to rtol 1e-4 / atol 1e-5, the count
exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_tpu.config import BASELINE_PRESETS
from score_tpu.data.pipeline import TargetIterator
from score_tpu.graph import device_graph, gather_batch, gather_candidate_batch
from score_tpu.nn import baselines as jbase
from score_tpu.serve import ScoringService as JaxService
from score_tpu.train import build_model, init_state, make_train_step
from score_tpu_torch import graph as tgraph
from score_tpu_torch import train as ttrain
from score_tpu_torch.nn import baselines as tbase
from score_tpu_torch.nn.model import build_model as tbuild_model
from score_tpu_torch.params import (from_flax, init_params,
                                    opt_state_from_optax, to_flax)
from score_tpu_torch.serve import ScoringService

torch.set_num_threads(2)

PRESETS = list(BASELINE_PRESETS)
ARCHS = ["baseline_mf", "baseline_pop", "baseline_svdpp", "baseline_delf"]
FWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
           "bfloat16": dict(rtol=2e-2, atol=2e-3)}
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
B = 64


def _cfg(name, dtype="float32", **train_kw):
    """The preset at its own widths, batch B, tables every 2nd step at 2x
    lr."""
    cfg = BASELINE_PRESETS[name]()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype=dtype),
        train=dataclasses.replace(cfg.train, batch_size=B,
                                  table_update_every=2, table_lr_boost=2.0,
                                  **train_kw))


def _weights(cfg, ds, seed=0):
    """init_params, then every zero-initialised leaf (biases, MF's scalar
    bias, the LayerNorm biases) made non-zero and the tables widened."""
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
@pytest.mark.parametrize("name", PRESETS)
def test_forward_matches_flax(tiny_dataset, name, dtype):
    """The candidates form at C = 21 and the flat (u, i) form, same
    weights; the port's tree has exactly the flax tree's leaves and
    shapes; the scores come back in f32. The archs (MF, popularity, SVD++,
    DELF) ignore the compute dtype, so in bf16 they are held at f32's
    tolerance."""
    ds = tiny_dataset
    cfg = _cfg(name, dtype)
    sd = _weights(cfg, ds)
    jm = build_model(cfg, ds.num_users, ds.num_items)
    jparams = _jax_params(sd)
    jg = device_graph(ds.graph)
    tm = tbuild_model(cfg, ds.num_users, ds.num_items)
    tm.load_state_dict(sd)
    assert tm.dual == (cfg.model.arch == "delf"
                       or (cfg.model.arch == "score"
                           and cfg.model.sides == "dual"))
    tg = tgraph.device_graph(ds.graph, "cpu")
    users, slots, cand = _requests(ds, 6, 21)
    u, s, c = (torch.from_numpy(a) for a in (users, slots, cand))
    # the archs ignore compute_dtype: from f32 tables they compute in f32
    tol = FWD_TOL["float32" if cfg.model.arch != "score" else dtype]

    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0), gather_batch(
        jg, jnp.ones(2, jnp.int32), jnp.ones(2, jnp.int32),
        jnp.full(2, ds.graph.num_slots, jnp.int32)))["params"]
    assert jax.tree.map(jnp.shape, init) == jax.tree.map(jnp.shape, jparams)

    with torch.inference_mode():
        got = tm.score_candidates(tgraph.gather_candidate_batch(
            tg, u, c, s, item_side=tm.dual))
        assert got.dtype == torch.float32 and got.shape == (6, 21)
        want = np.asarray(jm.apply(
            {"params": jparams},
            gather_candidate_batch(jg, *map(jnp.asarray,
                                            (users, cand, slots))),
            method=jm.score_candidates))
        assert np.std(want) > 1e-2
        np.testing.assert_allclose(got.numpy(), want, **tol)

        items = c[:, 0]
        want = np.asarray(jm.apply({"params": jparams}, gather_batch(
            jg, *map(jnp.asarray, (users, cand[:, 0], slots)))))
        u_hist, u_cnt = tgraph.gather_side(tg.u2i, tg.u2i_cnt, u)
        i_hist, i_cnt = tgraph.gather_side(tg.i2u, tg.i2u_cnt, items)
        got = tm(dict(user=u, item=items, slot=s, u_hist=u_hist,
                      u_cnt=u_cnt, i_hist=i_hist, i_cnt=i_cnt,
                      slot_valid=tgraph.slot_valid_mask(s, tg.num_slots)))
        np.testing.assert_allclose(got.numpy(), want, **tol)


STEP_CASES = ([(name, 1e-5) for name in PRESETS]
              # with no L2 the bias tables' other sides (and SVD++'s implicit
              # user table) get no gradient at all
              + [(name, 0.0) for name in ("baseline_mf", "baseline_pop",
                                          "baseline_svdpp")])


@pytest.mark.parametrize("name,l2", STEP_CASES)
def test_three_uniform_steps_match_make_train_step(tiny_dataset, name, l2):
    """Full, dense, full steps (stride 2, 2x table lr) with two uniform
    negatives, the port given the reference's raw draws; params, Adam
    moments and the one shared count against optax's, parameters the step
    does not reach included (their gradient is zero; the popularity
    floor's dense step reaches no parameter, and its count advances)."""
    ds = tiny_dataset
    cfg = _cfg(name, l2_emb=l2)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_train_neg=2))
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
    for step in range(3):
        batch = next(it)
        raw = np.array(jax.random.randint(
            jax.random.fold_in(rng, step), (B, 2), 1, ds.num_items + 1,
            dtype=jnp.int32))
        jstate, jmet = jstep(jstate, jg,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             rng)
        st, m = ttrain.train_step(st, tg, batch, negatives=raw)
        np.testing.assert_allclose(m["loss"].item(), float(jmet["loss"]),
                                   **LOSS_TOL)
    jopt = opt_state_from_optax(jax.device_get(jstate.opt_state))
    assert st.step == st.opt.count == jopt["count"] == 3
    want = from_flax(jax.tree.map(np.asarray, jstate.params))
    got = dict(st.model.named_parameters())
    assert set(got) == set(want)
    for what, tree, ref in (("param", got, want), ("mu", st.opt.mu,
                                                   jopt["mu"]),
                            ("nu", st.opt.nu, jopt["nu"])):
        for k, w in ref.items():
            if k.endswith("mha.key.bias"):
                continue
            np.testing.assert_allclose(tree[k].detach().numpy(), w.numpy(),
                                       err_msg=f"{what} {k}", **STEP_TOL)
    # The attention's key bias adds q . b_k to every logit of a query, which
    # the softmax cancels: its gradient is zero in exact arithmetic, and
    # each side's is its own roundoff. Both must show it so: first moments
    # below 1e-7, and the bias within the 3 steps' largest Adam travel of
    # where it started (its start is zero).
    for k in [k for k in want if k.endswith("mha.key.bias")]:
        for mu, p in ((st.opt.mu[k], got[k]),
                      (jopt["mu"][k], torch.from_numpy(np.asarray(want[k])))):
            assert mu.abs().max().item() < 1e-7, k
            assert p.abs().max().item() <= 3 * cfg.train.learning_rate, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", PRESETS)
def test_service_matches_jax(tiny_dataset, name, dtype):
    """score, score_batch and a full-catalogue topk against the
    reference's service on the same weights; in bf16 both cast every 2-D
    table, the [rows, 1] bias tables too."""
    ds = tiny_dataset
    cfg = _cfg(name, dtype)
    sd = _weights(cfg, ds, seed=3)
    port = ScoringService(cfg, ds, sd, device="cpu")
    ref = JaxService(cfg, ds, _jax_params(sd))
    if dtype == "bfloat16":
        tables = {k: v.dtype for k, v in port.model.state_dict().items()
                  if "table" in k}
        assert set(tables.values()) == {torch.bfloat16}, tables
    tol = FWD_TOL[dtype]
    users, _, items = _requests(ds, 3, 20, seed=4)
    got = port.score_batch(users, items)
    assert got.shape == (3, 20) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref.score_batch(users, items), **tol)
    np.testing.assert_allclose(port.score(int(users[0]), items[0]),
                               ref.score(int(users[0]), items[0]), **tol)
    top_i, top_s = port.topk(int(users[1]), k=10)
    _, ref_s = ref.topk(int(users[1]), k=10)
    assert np.all(np.diff(top_s) <= 0)
    np.testing.assert_allclose(top_s, ref_s, **tol)
    np.testing.assert_allclose(ref.score(int(users[1]), top_i), top_s, **tol)


def _encoder_pair(kind, d, f, seed):
    """A flax encoder with its init, and the port's with those weights."""
    jenc = (jbase.CaserEncoder(features=f) if kind == "caser"
            else jbase.SelfAttnEncoder(features=f))
    xs = jnp.ones((2, 6, d), jnp.float32)
    params = jenc.init(jax.random.PRNGKey(seed), xs,
                       jnp.ones((2, 6), bool))["params"]
    tenc = (tbase.CaserEncoder(d, f) if kind == "caser"
            else tbase.SelfAttnEncoder(d, f))
    tenc.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    return jenc, params, tenc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["caser", "selfattn"])
def test_encoder_causal_and_matches_flax(rng, kind, dtype):
    """tests/test_baselines.py's causality checks (:95, :158) on the
    port's encoders: corrupting slots 4.. leaves slots 0-3 unchanged; and
    the encoder agrees with flax's on the same weights, with a ragged
    mask, and from a bf16 input computes and returns f32 as flax's
    promotion does (so within f32's tolerance there too)."""
    B, T, d, f = 3, 6, 8, 16
    jenc, params, tenc = _encoder_pair(kind, d, f, seed=1)
    xs = rng.normal(size=(B, T, d)).astype(np.float32)
    mask = np.ones((B, T), bool)
    tdt = getattr(torch, dtype)
    x1 = torch.from_numpy(xs).to(tdt)
    h1 = tenc(x1, torch.from_numpy(mask))
    assert h1.shape == (B, T, f) and h1.dtype == torch.float32
    xs2 = xs.copy()
    xs2[:, 4:] = 99.0          # corrupt the future
    h2 = tenc(torch.from_numpy(xs2).to(tdt), torch.from_numpy(mask))
    torch.testing.assert_close(h1[:, :4], h2[:, :4], rtol=1e-5, atol=1e-5)

    mask[1, 3:] = False        # a ragged history, and one with none
    mask[2, :] = False
    got = tenc(x1, torch.from_numpy(mask))
    want = jenc.apply({"params": params}, jnp.asarray(xs, dtype),
                      jnp.asarray(mask))
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL["float32"])
    assert not got[2].any() and not got[1, 3:].any()


@pytest.mark.parametrize("kind", ["caser", "selfattn"])
def test_encoder_weights_round_trip(kind):
    """from_flax maps the Conv, attention and LayerNorm leaves onto the
    port's layouts (strict load) and to_flax gives the flax tree back bit
    for bit; the 3-D kernels take their own permutations, not .T."""
    _, params, tenc = _encoder_pair(kind, 8, 16, seed=2)
    sd = tenc.state_dict()
    if kind == "caser":
        assert sd["hconv_3.weight"].shape == (16, 8, 3)    # conv1d layout
    else:
        assert sd["mha.query.weight"].shape == (2, 8, 16)  # [h, hd, in]
        assert sd["mha.out.weight"].shape == (16, 2, 8)    # [out, h, hd]
        assert sd["ln1.scale"].shape == (16,)
    back = to_flax(sd)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(leaf))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_flax(dtype):
    """SASRec's LayerNorm against flax's on rows whose variance (~1e-6)
    is of the order of epsilon, where flax's 1e-6 and torch's default
    1e-5 give outputs ~2x apart; a bf16 input is normalised in f32 and
    comes back f32, as flax does. (flax's one-pass variance E[x^2] -
    E[x]^2, which the port uses too, differs from the two-pass one only
    by roundoff, so no input separates the two without also separating
    two summation orders.)"""
    import flax.linen as fnn
    import torch.nn.functional as F
    rng = np.random.default_rng(0)
    x = (1e-3 * rng.normal(size=(4, 6, 32))).astype(np.float32)
    scale, bias = rng.normal(size=(2, 32)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    want = np.asarray(fnn.LayerNorm().apply(
        {"params": {"scale": scale, "bias": bias}}, xj))
    ln = tbase.LayerNorm(32)
    ln.load_state_dict({"scale": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = ln(xt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    torch_default = F.layer_norm(xt.float(), (32,), torch.from_numpy(scale),
                                 torch.from_numpy(bias))
    assert not np.allclose(torch_default.numpy(), want, rtol=1e-4,
                           atol=1e-4)


@pytest.mark.parametrize("name", ARCHS)
def test_inbatch_negatives_on_a_baseline_arch_raise(tiny_dataset, name):
    """The baseline archs ignore in-batch shifts, so their [B, 1] logits
    meet [B, 2] labels: the reference's step raises ValueError, and the
    port's init_state raises ValueError before any step."""
    ds = tiny_dataset
    cfg = _cfg(name)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               train_neg_mode="inbatch"))
    jg = device_graph(ds.graph)
    jm = build_model(cfg, ds.num_users, ds.num_items)
    jstate = init_state(cfg, jm, jg, jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(getattr(ds.train, k)[:B])
             for k in ("user", "item", "slot")}
    with pytest.raises(ValueError):
        make_train_step(jm, cfg)(jstate, jg, batch, jax.random.PRNGKey(0))
    w = init_params(cfg, ds.num_users, ds.num_items,
                    torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="in-batch"):
        ttrain.init_state(cfg, ds.num_users, ds.num_items, w, device="cpu")


@pytest.mark.parametrize("name", PRESETS)
def test_driver_trains_and_serves_from_checkpoint(tiny_dataset, name,
                                                  tmp_path):
    """The preset through the port's `train()` as the CLI runs it (bf16,
    its uniform negatives, one epoch, checkpoints on): the loss falls
    below its start and every val row is finite; `from_checkpoint` of
    `best` serves bit-equal to a service on the weights `train()`
    returned, its 2-D tables (the [rows, 1] bias tables too) in bf16."""
    ds = tiny_dataset
    cfg = BASELINE_PRESETS[name]()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"),
        train=dataclasses.replace(
            cfg.train, batch_size=64, num_epochs=1, eval_every_steps=60,
            eval_max_targets=128, log_every_steps=10 ** 9,
            checkpoint_dir=str(tmp_path)))
    out = ttrain.train(cfg, ds, verbose=False, device="cpu")
    rows = out["history"]
    assert rows and all(np.isfinite([r["auc"], r["loss"]]).all()
                        for r in rows)
    assert rows[-1]["loss"] < 0.69, rows[-1]
    svc = ScoringService.from_checkpoint(cfg, ds, str(tmp_path), device="cpu")
    assert {v.dtype for k, v in svc.model.state_dict().items()
            if "table" in k} == {torch.bfloat16}
    users, _, items = _requests(ds, 3, 20, seed=5)
    np.testing.assert_array_equal(
        svc.score_batch(users, items),
        ScoringService(cfg, ds, out["params"],
                       device="cpu").score_batch(users, items))
