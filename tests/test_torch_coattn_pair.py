"""The port's per-pair co-attention (kernels/coattn.py) against the JAX
package: the plain forward against `cross_coattn_ref` and
`cross_coattn_pallas` (interpreted, as tests/test_kernels.py runs it), the
plain fused VJP against `_coattn_bwd_pallas` (interpreted) and `jax.vjp`
of the reference, and the max pool's recompute VJP against `jax.vjp` on
inputs with exactly tied maxima.

The port takes the candidates form (the user side shared by C
candidates); the JAX functions take the user side tiled C times, so the
port's user-side gradients are compared with the tiled ones summed over
the candidates. On the CPU the wrappers run their plain versions;
tests/test_torch_cuda.py holds the tests of the CUDA kernels themselves.

Tolerances: forward f32 1e-5 (the same math, summed in another order);
gradients rtol 5e-4 / atol 5e-5, as tests/test_kernels.py holds the
Pallas backward to the reference (f32 reductions in another order on
O(1)-O(10) gradients)."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_tpu.kernels.coattn import _coattn_bwd_pallas, cross_coattn_pallas
from score_tpu.nn.coattn import cross_coattn_ref
from score_tpu_torch.kernels import coattn as tpair

torch.set_num_threads(2)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
GRADS = ("dEu", "dEi", "deu", "dei", "dWr")


@pytest.fixture
def rng(request):
    """Inputs seeded by the test's own name, whatever order tests run in."""
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def _inputs(rng, B, C, T, n, m, d):
    """Candidates-form inputs with fully masked slots on both sides and a
    candidate with no valid row."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    mu = rng.random((B, T, n)) > 0.35
    mi = rng.random((B, C, T, m)) > 0.35
    mu[0, 0] = False
    mi[B - 1, :, 1 % T] = False
    mi[0, C - 1] = False
    return [f(B, T, n, d), f(B, C, T, m, d), mu, mi, f(d, d) * 0.3,
            f(B, d), f(B, C, d)]


def _tiled(args):
    """The JAX package's per-pair form of candidates-form inputs: the user
    side tiled C times, [B*C, ...]."""
    Eu, Ei, mu, mi, Wr, eu, ei = args
    B, C = Ei.shape[:2]
    rep = lambda x: np.repeat(x, C, axis=0)
    flat = lambda x: x.reshape((B * C,) + x.shape[2:])
    return [jnp.asarray(a) for a in (rep(Eu), flat(Ei), rep(mu), flat(mi),
                                     Wr, rep(eu), flat(ei))]


def _port(args, **kw):
    return tpair.cross_coattn_pair(*(torch.from_numpy(a) for a in args),
                                   **kw)


# tests/test_kernels.py's grid (B, T, n, m, d), flat pairs (C == 1)
SHAPES = [(2, 3, 5, 6, 8), (4, 8, 10, 10, 16), (3, 7, 9, 11, 32)]


@pytest.mark.parametrize("B,T,n,m,d", SHAPES)
@pytest.mark.parametrize("pool", tpair.POOLS)
@pytest.mark.parametrize("ta", [True, False])
def test_pair_plain_matches_ref(rng, B, T, n, m, d, pool, ta):
    args = _inputs(rng, B, 1, T, n, m, d)
    cu, ci = _port(args, pool=pool, target_aware=ta)
    want = cross_coattn_ref(*_tiled(args), pool=pool, target_aware=ta)
    for g, w in zip((cu, ci), want):
        assert g.shape == (B, 1, T, d) and g.dtype == torch.float32
        np.testing.assert_allclose(g[:, 0].numpy(), np.asarray(w),
                                   **FWD_TOL)


@pytest.mark.parametrize("pool", tpair.POOLS)
def test_pair_candidates_match_pallas_on_tiled(rng, pool):
    """C = 3 candidates against the Pallas kernel on the user side tiled 3
    times, as score_tpu/nn/coattn.py feeds it."""
    B, C, T, n, m, d = 3, 3, 4, 5, 6, 8
    args = _inputs(rng, B, C, T, n, m, d)
    cu, ci = _port(args, pool=pool, target_aware=True)
    want = cross_coattn_pallas(*_tiled(args), pool, True, True)
    for g, w in zip((cu, ci), want):
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(w).reshape(B, C, T, d),
                                   **FWD_TOL)
    # all-masked rows: exact zeros
    assert (cu[0, :, 0] == 0).all() and (ci[0, C - 1] == 0).all()


def _sum_user_side(g, B, C):
    """Tiled [B*C, ...] user-side gradient -> candidates form [B, ...]."""
    g = np.asarray(g)
    return g.reshape((B, C) + g.shape[1:]).sum(axis=1)


@pytest.mark.parametrize("pool", ["sum", "mean"])
@pytest.mark.parametrize("C,ta,tile_g", [(2, True, 8),     # multi-tile dWr
                                         (1, False, 64)])
def test_pair_bwd_plain_matches_pallas_and_vjp(rng, pool, C, ta, tile_g):
    B, T, n, m, d = 3, 4, 5, 6, 8
    args = _inputs(rng, B, C, T, n, m, d)
    dcu, dci = (rng.normal(size=(B, C, T, d)).astype(np.float32)
                for _ in range(2))
    got = tpair.cross_coattn_pair_bwd(
        *(torch.from_numpy(a) for a in args + [dcu, dci]), pool=pool,
        target_aware=ta)
    j = _tiled(args)
    g = [jnp.asarray(x.reshape((B * C,) + x.shape[2:])) for x in (dcu, dci)]
    pEu, pEi, pWr, peu, pei = _coattn_bwd_pallas(
        *j, *g, pool=pool, target_aware=ta, tile_g=tile_g, interpret=True)
    _, vjp = jax.vjp(lambda Eu, Ei, Wr, eu, ei: cross_coattn_ref(
        Eu, Ei, j[2], j[3], Wr, eu, ei, pool=pool, target_aware=ta),
        j[0], j[1], j[4], j[5], j[6])
    rEu, rEi, rWr, reu, rei = vjp(tuple(g))
    shape_i = (B, C, T, m, d)
    for name, got_g, p, r in (
            ("dEu", got[0], _sum_user_side(pEu, B, C),
             _sum_user_side(rEu, B, C)),
            ("dEi", got[1], np.asarray(pEi).reshape(shape_i),
             np.asarray(rEi).reshape(shape_i)),
            ("deu", got[2], _sum_user_side(peu, B, C),
             _sum_user_side(reu, B, C)),
            ("dei", got[3], np.asarray(pei).reshape(B, C, d),
             np.asarray(rei).reshape(B, C, d)),
            ("dWr", got[4], np.asarray(pWr), np.asarray(rWr))):
        assert got_g.dtype == torch.float32, name
        np.testing.assert_allclose(got_g.numpy(), p, err_msg=name,
                                   **GRAD_TOL)
        np.testing.assert_allclose(got_g.numpy(), r, err_msg=name,
                                   **GRAD_TOL)
    assert (got[0][0, 0] == 0).all() and (got[1][0, C - 1] == 0).all()


def _leaves(args):
    """Torch leaves of the differentiable inputs (Eu, Ei, Wr, eu, ei)."""
    ts = [torch.from_numpy(a) for a in args]
    for i in (0, 1, 4, 5, 6):
        ts[i].requires_grad_(True)
    return ts


@pytest.mark.parametrize("pool", ["sum", "mean"])
def test_pair_function_matches_autograd_of_plain(rng, pool):
    """The autograd Function (the fused VJP) against torch autograd
    through the plain forward."""
    args = _inputs(rng, 4, 3, 3, 5, 6, 8)
    dcu, dci = (torch.from_numpy(rng.normal(size=(4, 3, 3, 8)).astype(
        np.float32)) for _ in range(2))
    grads = []
    for fn in (tpair.cross_coattn_pair, tpair.cross_coattn_pair_plain):
        ts = _leaves(args)
        cu, ci = fn(*ts, pool=pool, target_aware=True)
        grads.append(torch.autograd.grad(
            (cu * dcu).sum() + (ci * dci).sum(),
            [ts[i] for i in (0, 1, 4, 5, 6)]))
    for name, g, w in zip(("dEu", "dEi", "dWr", "deu", "dei"), *grads):
        torch.testing.assert_close(g, w, msg=name, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ta", [True, False])
def test_max_vjp_splits_tied_maxima_as_jax(rng, ta):
    """The max pool's backward (autograd through the plain forward, with
    amax) against jax.vjp of the reference, on inputs whose relation
    matrix has exactly tied maxima: a neighbour row repeated on each side
    (slots that repeat a neighbour id give such rows). amax splits the
    gradient among the tied entries, as JAX's reduce_max VJP does;
    max(dim) would give it all to one and fail here."""
    B, C, T, n, m, d = 3, 2, 3, 5, 6, 8
    args = _inputs(rng, B, C, T, n, m, d)
    args[0][:, :, 1] = args[0][:, :, 0]          # Eu row 1 == row 0
    args[1][..., 2, :] = args[1][..., 0, :]      # Ei row 2 == row 0
    args[2][:, 1:, :2] = True                    # both user rows valid
    args[3][:, :, 1:, [0, 2]] = True             # both item rows valid
    M = np.einsum("btnd,de,bctme->bctnm", args[0], args[4], args[1])
    assert (M[:, :, 1:, 0, 0] == M[:, :, 1:, 0, 2]).all()   # the ties
    assert (M[:, :, 1:, 0, :] == M[:, :, 1:, 1, :]).all()
    dcu, dci = (rng.normal(size=(B, C, T, d)).astype(np.float32)
                for _ in range(2))
    ts = _leaves(args)
    cu, ci = tpair.cross_coattn_pair(*ts, pool="max", target_aware=ta)
    got = torch.autograd.grad(
        (cu * torch.from_numpy(dcu)).sum() + (ci * torch.from_numpy(
            dci)).sum(), [ts[i] for i in (0, 1, 4, 5, 6)], allow_unused=True)
    j = _tiled(args)
    _, vjp = jax.vjp(lambda Eu, Ei, Wr, eu, ei: cross_coattn_ref(
        Eu, Ei, j[2], j[3], Wr, eu, ei, pool="max", target_aware=ta),
        j[0], j[1], j[4], j[5], j[6])
    rEu, rEi, rWr, reu, rei = vjp(tuple(
        jnp.asarray(x.reshape((B * C,) + x.shape[2:])) for x in (dcu, dci)))
    want = (_sum_user_side(rEu, B, C), np.asarray(rEi).reshape(args[1].shape),
            np.asarray(rWr), _sum_user_side(reu, B, C),
            np.asarray(rei).reshape(B, C, d))
    for name, g, w in zip(("dEu", "dEi", "dWr", "deu", "dei"), got, want):
        if g is None:                       # no target terms: no gradient
            assert not ta and not w.any(), name
            continue
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **GRAD_TOL)


def test_pair_refuses_unknown_pool_and_max_backward_kernel(rng):
    args = [torch.from_numpy(a) for a in _inputs(rng, 2, 1, 2, 3, 3, 4)]
    with pytest.raises(ValueError):
        tpair.cross_coattn_pair(*args, pool="median")
    g = torch.zeros(2, 1, 2, 4)
    with pytest.raises(ValueError):
        tpair.cross_coattn_pair_bwd(*args, g, g, pool="max")
