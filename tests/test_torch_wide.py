"""configs3 past the tuned kernels' 32 lanes: the port's co-attention at
d = 64 with n = m = 40 neighbour rows against the JAX package, a d = 64
model against the flax one, the up-front refusal of what the card's
kernels do not take, and the kernel loader's per-entry cache.

On the CPU the wrappers (and `cross_coattn_wide`, which they call past
d, n, m = 32 on the card) run the plain versions; tests/test_torch_cuda.py
holds the wide CUDA kernels to those on the card.

Tolerances: f32 rtol 1e-4 / atol 1e-4, as tests/test_torch_pools.py uses
(the same math, summed in another order); gradients relative to each
gradient's largest value, as tests/test_torch_cuda.py holds the kernels'
backward to the plain one."""

import ctypes
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_tpu.config import configs3 as jax_configs3
from score_tpu.graph import device_graph, gather_batch, gather_candidate_batch
from score_tpu.kernels.coattn_cand import cross_coattn_cand_ref
from score_tpu.nn.coattn import cross_coattn_ref
from score_tpu.train import build_model
from score_tpu_torch import graph as tgraph
from score_tpu_torch.config import configs3
from score_tpu_torch.kernels import _build
from score_tpu_torch.kernels import coattn as tpair
from score_tpu_torch.kernels import coattn_cand as tcand
from score_tpu_torch.kernels import coattn_wide as twide
from score_tpu_torch.nn.model import ScoreModel, check_device
from score_tpu_torch.params import from_flax, init_params
from score_tpu_torch.serve import ScoringService
from score_tpu_torch.train import init_state

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
B, C, T, N, M, D = 2, 3, 2, 40, 40, 64


@pytest.fixture
def rng(request):
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def _inputs(rng):
    """Candidates-form inputs at d = 64, n = m = 40, with an all-masked
    slot on each side and a candidate with no valid row."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    mu = rng.random((B, T, N)) > 0.35
    mi = rng.random((B, C, T, M)) > 0.35
    mu[0, 0] = False
    mi[B - 1, :, 1] = False
    mi[0, C - 1] = False
    return [f(B, T, N, D), f(B, C, T, M, D), mu, mi, f(D, D) * 0.2,
            f(B, D), f(B, C, D)]


def _tiled(args):
    """The reference's per-pair form: the user side tiled C times."""
    Eu, Ei, mu, mi, Wr, eu, ei = args
    rep = lambda x: np.repeat(x, C, axis=0)
    flat = lambda x: x.reshape((B * C,) + x.shape[2:])
    return [jnp.asarray(a) for a in (rep(Eu), flat(Ei), rep(mu), flat(mi),
                                     Wr, rep(eu), flat(ei))]


@pytest.mark.parametrize("pool", tpair.POOLS)
def test_wide_forward_matches_jax(rng, pool):
    """Each pool through the wrappers, the wide wrapper and the plain
    version against `cross_coattn_ref` on the tiled form, and the sum pool
    also against `cross_coattn_cand_ref` in the candidates form."""
    args = _inputs(rng)
    ts = [torch.from_numpy(a) for a in args]
    want = [np.asarray(w).reshape(B, C, T, D)
            for w in cross_coattn_ref(*_tiled(args), pool=pool)]
    outs = [tpair.cross_coattn_pair(*ts, pool=pool),
            twide.cross_coattn_wide(*ts, pool=pool),
            tpair.cross_coattn_pair_plain(*ts, pool=pool)]
    if pool == "sum":
        outs.append(tcand.cross_coattn_cand(*ts))
        cand = cross_coattn_cand_ref(*(jnp.asarray(a) for a in args))
        for g, w in zip(outs[-1], cand):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    for out in outs:
        for g, w in zip(out, want):
            assert g.shape == (B, C, T, D) and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, **TOL)
    assert (outs[0][0][0, :, 0] == 0).all()
    assert (outs[0][1][0, C - 1] == 0).all()


@pytest.mark.parametrize("pool", ["sum", "mean"])
def test_wide_backward_matches_jax_vjp(rng, pool):
    """The backward wrappers (tuned-kernel routing and the wide one) and the
    plain VJP against `jax.vjp` of the reference, the user side's
    gradients summed over the tiled copies."""
    args = _inputs(rng)
    dcu, dci = (rng.normal(size=(B, C, T, D)).astype(np.float32)
                for _ in range(2))
    ts = [torch.from_numpy(a) for a in args + [dcu, dci]]
    j = _tiled(args)
    _, vjp = jax.vjp(lambda Eu, Ei, Wr, eu, ei: cross_coattn_ref(
        Eu, Ei, j[2], j[3], Wr, eu, ei, pool=pool), j[0], j[1], j[4], j[5],
        j[6])
    g = [jnp.asarray(x.reshape((B * C,) + x.shape[2:])) for x in (dcu, dci)]
    rEu, rEi, rWr, reu, rei = (np.asarray(x) for x in vjp(tuple(g)))
    user = lambda x: x.reshape((B, C) + x.shape[1:]).sum(axis=1)
    want = (user(rEu), rEi.reshape(B, C, T, M, D), user(reu),
            rei.reshape(B, C, D), rWr)
    outs = [tpair.cross_coattn_pair_bwd(*ts, pool=pool),
            twide.cross_coattn_wide_bwd(*ts, pool=pool)]
    if pool == "sum":
        outs.append(tcand.cross_coattn_cand_bwd(*ts))
    for out in outs:
        for name, got, w in zip(("dEu", "dEi", "deu", "dei", "dWr"), out,
                                want):
            scale = max(np.abs(w).max(), 1.0)
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=name)


def test_d64_model_matches_flax(tiny_dataset):
    """configs3 at d = 64 (hidden 64, MLP 128/64): the flax model's
    weights, carried over by `params.from_flax`; the port's
    scores against the flax model's on the same candidates."""
    ds = tiny_dataset
    kw = dict(embed_dim=64, hidden_dim=64, mlp_dims=(128, 64))
    jcfg = jax_configs3()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **kw))
    jm = build_model(jcfg, ds.num_users, ds.num_items)
    graph = device_graph(ds.graph)
    # the reference's init_state without its optimizer, jitted (eager flax
    # takes seconds a call here)
    dummy = gather_batch(graph, jnp.ones((2,), jnp.int32),
                         jnp.ones((2,), jnp.int32),
                         jnp.full((2,), graph.num_slots, jnp.int32))
    tree = jax.jit(jm.init)(jax.random.PRNGKey(0), dummy)["params"]
    # the zero-initialised leaves made non-zero and the tables widened, so
    # attention is far from uniform
    r = np.random.default_rng(5)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, x: (
            r.normal(0, 0.5, x.shape).astype(np.float32)
            if "table" in jax.tree_util.keystr(path) else
            np.asarray(x) if np.asarray(x).any() else
            r.normal(0, 0.3, x.shape).astype(np.float32)), tree)
    sd = from_flax(tree)
    users = ds.train.user[:4]
    slots = ds.train.slot[:4]
    cand = r.integers(1, ds.num_items + 1, (4, 5)).astype(np.int32)
    mb = gather_candidate_batch(graph, jnp.asarray(users),
                                jnp.asarray(cand), jnp.asarray(slots))
    want = np.asarray(jax.jit(lambda p, b: jm.apply(
        {"params": p}, b, method=jm.score_candidates))(
            jax.tree.map(jnp.asarray, tree), mb))
    cfg = configs3()
    tm = ScoreModel(dataclasses.replace(cfg.model, **kw), ds.num_users,
                    ds.num_items)
    tm.load_state_dict(sd)
    with torch.inference_mode():
        tb = tgraph.gather_candidate_batch(
            tgraph.device_graph(ds.graph, "cpu"), torch.from_numpy(users),
            torch.from_numpy(cand), torch.from_numpy(slots))
        got = tm.score_candidates(tb).numpy()
    assert got.shape == want.shape == (4, 5) and np.std(want) > 1e-2
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("field,value", [("embed_dim", 129),
                                         ("user_fanout", 65),
                                         ("item_fanout", 65)])
def test_wide_config_refused_up_front_on_cuda_only(tiny_dataset, field,
                                                   value):
    """Past the wide kernels' limits, `ScoringService` and `init_state`
    refuse the config on a CUDA device before they touch it (no card is
    needed to see that); on the CPU the plain path has no limit."""
    ds = tiny_dataset
    cfg = configs3()
    sec = "model" if field == "embed_dim" else "data"
    cfg = cfg.replace(**{sec: dataclasses.replace(getattr(cfg, sec),
                                                  **{field: value})})
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(0))
    for build in (lambda dev: ScoringService(cfg, ds, sd, device=dev),
                  lambda dev: init_state(cfg, ds.num_users, ds.num_items,
                                         sd, device=dev)):
        with pytest.raises(NotImplementedError, match="co-attention"):
            build("cuda")
    check_device(cfg, "cpu")
    ScoringService(cfg, ds, sd, device="cpu")
    # at the limits the card takes the config
    at = cfg.replace(model=dataclasses.replace(cfg.model, embed_dim=128),
                     data=dataclasses.replace(cfg.data, user_fanout=64,
                                              item_fanout=64))
    check_device(at, "cuda")
    # and a rung with no co-attention has no such limit
    check_device(cfg.replace(model=dataclasses.replace(
        cfg.model, slot_agg="attn")), "cuda")


class _Entry:
    """A stand-in C function that records every attribute set on it."""

    def __init__(self):
        object.__setattr__(self, "sets", [])

    def __setattr__(self, key, value):
        self.sets.append(key)
        object.__setattr__(self, key, value)


def test_load_caches_each_entry(monkeypatch):
    """A second `load` of one (name, entry) returns the same function and
    sets neither its restype nor its argtypes again."""
    lib = type("Lib", (), {})()
    lib.fake_fn = _Entry()
    lib.other_fn = _Entry()
    monkeypatch.setitem(_build._libs, "fake", lib)
    monkeypatch.setattr(_build, "_fns", {})
    first = _build.load("fake", "fake_fn", (ctypes.c_void_p,))
    assert first is lib.fake_fn and first.sets == ["restype", "argtypes"]
    assert first.argtypes == [ctypes.c_void_p]
    assert _build.load("fake", "fake_fn", (ctypes.c_int,)) is first
    assert first.sets == ["restype", "argtypes"]
    assert first.argtypes == [ctypes.c_void_p]
    other = _build.load("fake", "other_fn", (ctypes.c_int,))
    assert other is lib.other_fn and other.sets == ["restype", "argtypes"]


def test_launch_stream_guard_and_error(monkeypatch):
    """`launch` passes the device's raw current stream last, enters the
    device guard only off the current device, and raises with the
    library's error string only when the entry returns an error code."""
    calls, guards = [], []

    def entry(*args):
        calls.append(args)
        return args[0]

    class _Guard:
        def __init__(self, index):
            guards.append(index)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    lib = type("Lib", (), {})()
    lib.fake_error_string = lambda err: b"fake failure"
    monkeypatch.setitem(_build._libs, "fake", lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "device", _Guard)
    _build.launch("fake", entry, 0, 0, 7)
    assert calls == [(0, 7, 1000)] and guards == []
    _build.launch("fake", entry, 1, 0, 8)
    assert calls[-1] == (0, 8, 1001) and guards == [1]
    with pytest.raises(RuntimeError, match=r"fake failure \(3\)"):
        _build.launch("fake", entry, 0, 3)


def _tf32(x):
    """Round f32 to tf32 (10 explicit mantissa bits), to nearest with ties
    away from zero, as the card's cvt.rna.tf32.f32."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)   # round to nearest even


def _split(x, fmt):
    hi = fmt(x)
    return hi, fmt(x - hi)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_wide_forward_split_error(seed, dtype):
    """The wide forward's relation matrix M = (Eu Wr) Ei^T on the tensor
    cores (every pool's in bf16, the max pool's in f32), its operand
    splits emulated in torch (products exact, sums in
    float64), within the bound `csrc/coattn_wide.cu`'s note states of the
    float64 value, at d = 128 and n = m = 64. bf16 inputs: Eu and Ei are
    exact in bf16; Wr and EuW (f32) are split into bf16 hi + lo, two
    products each, and each split leaves at most 2^-16 |x|, so M is within
    2^-15 sum_l (|EuW_jl Ei_kl| + sum_e |Eu_je Wr_el Ei_kl|). f32 inputs:
    3xTF32, every operand split into tf32 hi + lo and lo * lo dropped,
    2^-20 of the same sums. (The card's f32 sums add the usual d 2^-24 of
    any f32 dot product on top.) The hi parts alone, one pass as plain
    bf16 or TF32 would take, miss the bound."""
    rng = np.random.default_rng(seed)
    n = m = 64
    d = 128
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    Eu, Ei, Wr = f(n, d), f(m, d), f(d, d) * 0.3
    if dtype == "bfloat16":
        Eu, Ei = _bf16(Eu), _bf16(Ei)
        wh, wl = _split(Wr, _bf16)
        euw = (Eu.double() @ wh.double() + Eu.double() @ wl.double()).float()
        ah, al = _split(euw, _bf16)
        M = ah.double() @ Ei.double().T + al.double() @ Ei.double().T
        one_pass = (Eu.double() @ wh.double()).float()
        one_pass = _bf16(one_pass).double() @ Ei.double().T
        bound = 2.0 ** -15
    else:
        eh, el = _split(Eu, _tf32)
        wh, wl = _split(Wr, _tf32)
        euw = (eh.double() @ wh.double() + eh.double() @ wl.double()
               + el.double() @ wh.double()).float()
        ah, al = _split(euw, _tf32)
        ih, il = _split(Ei, _tf32)
        M = (ah.double() @ ih.double().T + ah.double() @ il.double().T
             + al.double() @ ih.double().T)
        one_pass = (eh.double() @ wh.double()).float()
        one_pass = _tf32(one_pass).double() @ ih.double().T
        bound = 2.0 ** -20
    exact_euw = Eu.double() @ Wr.double()
    want = exact_euw @ Ei.double().T
    scale = (exact_euw.abs() @ Ei.double().abs().T
             + Eu.double().abs() @ Wr.double().abs() @ Ei.double().abs().T)
    err = (M - want).abs()
    assert (err <= bound * scale).all(), float((err / scale).max())
    # the lo parts are needed: the hi parts alone miss the bound
    assert ((one_pass - want).abs() > bound * scale).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wide_forward_f32_dot_error(seed):
    """The wide forward's f32 sum-pool scores without a relation matrix:
    su_j = EuW_j . Es and si_k = Ei_k . (Em Wr), Em Wr as EuW's column
    sums, with EuW from 3xTF32 products (emulated in torch, products
    exact, sums in float64) rounded to f32, and the dots in float64:
    within 2^-20 of the float64 value scaled by the same dots of absolute
    values through |Eu| |Wr|, at d = 128 and n = m = 64, as
    `csrc/coattn_wide.cu`'s note states. The hi parts alone miss it."""
    rng = np.random.default_rng(seed)
    n = m = 64
    d = 128
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    Eu, Ei, Wr = f(n, d), f(m, d), f(d, d) * 0.3
    eh, el = _split(Eu, _tf32)
    wh, wl = _split(Wr, _tf32)
    euw = (eh.double() @ wh.double() + eh.double() @ wl.double()
           + el.double() @ wh.double()).float().double()
    es = Ei.double().sum(0)
    exact = Eu.double() @ Wr.double()
    mag = Eu.double().abs() @ Wr.double().abs()
    one_pass = (eh.double() @ wh.double()).float().double()
    for scores, want, scale in (
            (lambda e: e @ es, exact @ es, mag @ es.abs()),
            (lambda e: Ei.double() @ e.sum(0), Ei.double() @ exact.sum(0),
             Ei.double().abs() @ mag.sum(0))):
        err = (scores(euw) - want).abs()
        assert (err <= 2.0 ** -20 * scale).all(), float((err / scale).max())
        assert ((scores(one_pass) - want).abs() > 2.0 ** -20 * scale).any()
