"""The port's backward kernels' plain versions, and the autograd Functions
around its kernels, against the JAX package: the fused co-attention VJP
`_cand_bwd` (run interpreted, as tests/test_kernels.py runs it) and
jax.vjp of `cross_coattn_cand_ref`; the gather's gradient against
jax.grad of jnp.take.

On the CPU the wrappers run their plain versions; tests/test_torch_cuda.py
holds the tests of the CUDA kernels themselves. Tolerance 1e-5 in f32
(the same VJP, summed in another order); integer-valued gradients of the
gather are exact."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_tpu.kernels.coattn_cand import _cand_bwd, cross_coattn_cand_ref
from score_tpu.nn import coattn as jcoattn
from score_tpu_torch.kernels import coattn_cand as tcand
from score_tpu_torch.kernels import gather as tgather
from score_tpu_torch.nn import coattn as tcoattn
from score_tpu_torch.params import from_flax

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
GRADS = ("dEu", "dEi", "deu", "dei", "dWr")


@pytest.fixture
def rng(request):
    """Inputs seeded by the test's own name, whatever order tests run in."""
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def _cand_inputs(rng, B, C, T, n, m, d):
    """Random inputs with fully masked slots on both sides, and output
    gradients."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    mu = rng.random((B, T, n)) > 0.3
    mi = rng.random((B, C, T, m)) > 0.3
    mu[0, 0] = False
    mi[0, :, 1 % T] = False
    mi[B - 1, C - 1] = False                     # a candidate with no rows
    return (f(B, T, n, d), f(B, C, T, m, d), mu, mi, f(d, d) * 0.3,
            f(B, d), f(B, C, d), f(B, C, T, d), f(B, C, T, d))


CAND_GRID = [(5, 2, 3, 4, 6, 8, True),       # training's C = 2
             (5, 2, 3, 4, 6, 8, False),
             (3, 1, 4, 6, 5, 8, True),       # C == 1, B not tile-divisible
             (3, 12, 2, 4, 3, 16, True),     # C > 8
             (7, 12, 2, 10, 10, 8, False)]


@pytest.mark.parametrize("B,C,T,n,m,d,ta", CAND_GRID)
def test_cand_bwd_plain_matches_pallas_and_vjp(rng, B, C, T, n, m, d, ta):
    args = _cand_inputs(rng, B, C, T, n, m, d)
    got = tcand.cross_coattn_cand_bwd(*(torch.from_numpy(a) for a in args),
                                      target_aware=ta)
    j = [jnp.asarray(a) for a in args]
    dEu, dEi, dWr, deu, dei = _cand_bwd(*j, target_aware=ta, tile_b=4,
                                        interpret=True)
    _, vjp = jax.vjp(lambda Eu, Ei, Wr, eu, ei: cross_coattn_cand_ref(
        Eu, Ei, j[2], j[3], Wr, eu, ei, target_aware=ta),
        j[0], j[1], j[4], j[5], j[6])
    rEu, rEi, rWr, reu, rei = vjp((j[7], j[8]))
    for name, g, p, r in zip(GRADS, got, (dEu, dEi, deu, dei, dWr),
                             (rEu, rEi, reu, rei, rWr)):
        assert g.dtype == torch.float32 and g.shape == p.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(p), err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)
    # masked rows get exact zeros
    assert (got[0][0, 0] == 0).all() and (got[1][0, :, 1 % T] == 0).all()
    assert (got[1][B - 1, C - 1] == 0).all()


def _leaves(args):
    """Torch leaves of the differentiable inputs (Eu, Ei, Wr, eu, ei)."""
    ts = [torch.from_numpy(a) for a in args[:7]]
    for i in (0, 1, 4, 5, 6):
        ts[i].requires_grad_(True)
    return ts


@pytest.mark.parametrize("ta", [True, False])
def test_cand_function_matches_autograd_of_plain(rng, ta):
    """The autograd Function (fused VJP) against torch autograd through
    the plain forward, on the CPU."""
    args = _cand_inputs(rng, 4, 2, 3, 5, 6, 8)
    dcu, dci = (torch.from_numpy(a) for a in args[7:])
    grads = []
    for fn in (tcand.cross_coattn_cand, tcand.cross_coattn_cand_plain):
        ts = _leaves(args)
        cu, ci = fn(*ts, target_aware=ta)
        grads.append(torch.autograd.grad(
            (cu * dcu).sum() + (ci * dci).sum(),
            [ts[i] for i in (0, 1, 4, 5, 6)], allow_unused=True))
    for name, g, w in zip(GRADS, *grads):
        if w is None:                       # no target terms: no gradient
            assert not ta and (g == 0).all(), name
            continue
        torch.testing.assert_close(g, w, msg=name, **TOL)


@pytest.mark.parametrize("C", [2, 3])
@pytest.mark.parametrize("ta", [True, False])
def test_coattention_rolls_match_flax(rng, C, ta):
    """CrossCoAttention with in-batch shifts, forward and the gradients of
    its inputs and weights, against the flax module (which materialises
    the same rolled item side)."""
    B, T, n, m, d = 5, 3, 4, 6, 8
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    Eu, Ei = f(B, T, n, d), f(B, 1, T, m, d)
    mu = rng.random((B, T, n)) > 0.3
    mi = rng.random((B, C, T, m)) > 0.3
    eu, ei = f(B, d), f(B, C, d)
    shifts = [1, 3][:C - 1]
    tree = {"wr": f(d, d, scale=0.3)}
    if ta:
        tree.update(wtu=f(d, d, scale=0.3), wti=f(d, d, scale=0.3))
    gcu, gci = f(B, C, T, d), f(B, C, T, d)
    mod = jcoattn.CrossCoAttention(pool="sum", target_aware=ta)

    def jloss(params, Eu_, Ei_, eu_, ei_):
        cu, ci = mod.apply({"params": params}, Eu_, Ei_, jnp.asarray(mu),
                           jnp.asarray(mi), eu_, ei_,
                           i_shifts=jnp.asarray(shifts, jnp.int32))
        return jnp.sum(cu * gcu) + jnp.sum(ci * gci)

    jtree = jax.tree.map(jnp.asarray, tree)
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        jtree, *(jnp.asarray(a) for a in (Eu, Ei, eu, ei)))
    tmod = tcoattn.CrossCoAttention(d, target_aware=ta)
    tmod.load_state_dict(from_flax(tree))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (Eu, Ei, eu, ei)]
    cu, ci = tmod(xs[0], xs[1], torch.from_numpy(mu), torch.from_numpy(mi),
                  xs[2], xs[3], i_shifts=shifts)
    loss = (cu * torch.from_numpy(gcu)).sum() + (ci * torch.from_numpy(
        gci)).sum()
    names = [k for k, _ in tmod.named_parameters()]
    tg = torch.autograd.grad(loss, list(tmod.parameters()) + xs,
                             allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(jloss(
        jtree, *(jnp.asarray(a) for a in (Eu, Ei, eu, ei)))), **TOL)
    wgrads = from_flax(jax.tree.map(np.asarray, jg[0]))
    for k, g in zip(names, tg):
        np.testing.assert_allclose(g.numpy(), wgrads[k].numpy(), err_msg=k,
                                   **TOL)
    for name, g, w in zip(("Eu", "Ei", "eu", "ei"), tg[len(names):], jg[1:]):
        w = np.asarray(w)
        if g is None:
            assert not ta and not w.any(), name
            continue
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


@pytest.mark.parametrize("V,W,n_ids", [(40, 8, 3000), (7, 32, 500),
                                       (300, 9, 64)])
def test_gather_grad_matches_jax_take(rng, V, W, n_ids):
    """Heavily duplicated ids (row 0 most of all, as masked slots give it),
    integer-valued output gradients: the scatter-add is exact."""
    table = rng.normal(size=(V, W)).astype(np.float32)
    ids = rng.integers(0, V, (n_ids // 4, 4)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.4] = 0
    dout = rng.integers(-8, 9, ids.shape + (W,)).astype(np.float32)
    want = jax.grad(lambda tb: jnp.sum(jnp.take(tb, jnp.asarray(ids),
                                                axis=0) * dout))(
        jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    out = tgather.gather_rows(t, torch.from_numpy(ids))
    (got,) = torch.autograd.grad((out * torch.from_numpy(dout)).sum(), [t])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    direct = tgather.scatter_add_rows(torch.from_numpy(ids),
                                      torch.from_numpy(dout), V)
    np.testing.assert_array_equal(direct.numpy(), np.asarray(want))


def test_gather_function_matches_autograd_of_plain(rng):
    table = rng.normal(size=(50, 16)).astype(np.float32)
    ids = torch.from_numpy(rng.integers(0, 50, (6, 9, 5)).astype(np.int32))
    dout = torch.from_numpy(rng.normal(size=(6, 9, 5, 16)).astype(np.float32))
    grads = []
    for fn in (tgather.gather_rows, tgather.gather_rows_plain):
        t = torch.from_numpy(table).requires_grad_(True)
        grads.append(torch.autograd.grad((fn(t, ids) * dout).sum(), [t])[0])
    torch.testing.assert_close(grads[0], grads[1], **TOL)


def test_gather_refuses_low_precision_trainable_table():
    """A table that trains must have a dtype the scatter-add takes: an
    f16 one is refused, and gathers fine without a gradient; a bf16 one
    (param_dtype bf16) trains, its gradient bf16."""
    t = torch.zeros(4, 8, dtype=torch.float16, requires_grad=True)
    ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        tgather.gather_rows(t, ids)
    with torch.no_grad():                    # serving: no gradient, fine
        assert tgather.gather_rows(t, ids).shape == (3, 8)
    b = torch.zeros(4, 8, dtype=torch.bfloat16, requires_grad=True)
    (g,) = torch.autograd.grad(tgather.gather_rows(b, ids).sum(), [b])
    assert g.dtype == torch.bfloat16
    assert g[0].eq(3).all() and g[1:].eq(0).all()
