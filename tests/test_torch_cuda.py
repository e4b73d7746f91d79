"""The port's CUDA kernels against their plain versions, on the card: the
gather and its scatter-add, and the candidates-form (sum pool) and
per-pair (sum, mean, max) co-attention, forward and backward.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it also runs on a host that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the gather is exact, and so is the scatter-add on
integer-valued sources (sums of integers are exact in any order); on
random sources it agrees to 1e-5 relative (f32 atomics add in no fixed
order). The co-attention forward and backward are f32 inside, so f32
outputs agree to 1e-4 (another summation order) and bf16 outputs to 2e-2
(one bf16 rounding of values of order 1)."""

import numpy as np
import pytest
import torch

from score_tpu_torch.kernels import coattn as tpair
from score_tpu_torch.kernels import coattn_cand as tcand
from score_tpu_torch.kernels import gather as tgather

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("W,dtype", [(32, torch.float32), (32, torch.bfloat16),
                                     (90, torch.int32), (9, torch.int32),
                                     (7, torch.bfloat16)])
def test_gather_kernel(cuda, W, dtype):
    """Row widths of 64/128 B (16-B vectors), 360 and 36 B (4-B words) and
    14 B (2-B halves), with 3-d ids."""
    rng = np.random.default_rng(W)
    table = torch.from_numpy(rng.normal(size=(1000, W)) * 1000).to(dtype)
    ids = torch.from_numpy(rng.integers(0, 1000, (3, 7, 11)).astype(np.int32))
    before = tgather.gather_rows.launches
    got = tgather.gather_rows(table.to(cuda), ids.to(cuda))
    torch.cuda.synchronize()
    assert tgather.gather_rows.launches == before + 1
    assert torch.equal(got.cpu(), tgather.gather_rows_plain(table, ids))


def _cand_inputs(rng, B, C, T, n, m, d, dtype, device):
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    mu = torch.from_numpy(rng.random((B, T, n)) > 0.3)
    mi = torch.from_numpy(rng.random((B, C, T, m)) > 0.3)
    mu[0, 0] = False                 # all-masked slots on both sides
    mi[0, :, T - 1] = False
    args = (f(B, T, n, d).to(dtype), f(B, C, T, m, d).to(dtype), mu, mi,
            f(d, d) * 0.3, f(B, d).to(dtype), f(B, C, d).to(dtype))
    return [a.to(device) for a in args]


def _unaligned(x):
    """The same values in a contiguous view whose data pointer is one
    element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:].copy_(x.reshape(-1))
    return buf[1:].view(x.shape)


# (B, C, T, n, m, d, target_aware, unaligned). The kernel takes a block of
# up to 32 candidates per b (or, when one tile holds all C, several b's),
# at least 264 blocks where B * C allows, and stages EuW = Eu @ Wr when
# that tile holds >= n candidates (else it forms v per candidate); rows of
# d * itemsize % 16 != 0 or unaligned inputs take its scalar path.
CAND_CASES = [
    (4, 2, 3, 5, 6, 8, True, False),
    (4, 2, 3, 5, 6, 8, False, False),
    (3, 4, 2, 4, 3, 16, True, False),
    (5, 1, 4, 6, 5, 8, True, False),
    (3, 101, 9, 10, 10, 32, True, False),
    (2, 5, 2, 32, 17, 32, True, False),
    (8, 45, 3, 10, 10, 32, True, False),      # ragged tiles of 2, per-c v
    (40, 50, 3, 6, 6, 32, False, False),      # ragged tiles of 8, EuW
    (1, 256, 9, 10, 10, 32, True, False),     # score(u, 101)'s bucket
    (1, 4096, 9, 10, 10, 32, True, False),    # one user, a full chunk
    (20, 200, 3, 5, 7, 7, True, False),       # 14 / 28 B rows, EuW
    (30, 70, 4, 10, 10, 7, False, False),     # the same, per-c v
    (20, 200, 3, 5, 9, 24, True, False),      # 48 / 96 B rows, EuW
    (8, 45, 3, 10, 10, 24, True, False),      # the same, per-c v
    (264, 32, 6, 32, 5, 16, True, False),     # n = 32, EuW in 2 t chunks
    (6, 40, 3, 4, 32, 24, True, False),       # m = 32
    (529, 2, 3, 4, 4, 8, True, False),        # 2 b's a block, the last 1
    (1000, 3, 2, 5, 6, 16, False, False),     # 3 b's a block, the last 1
    (40, 50, 3, 6, 6, 32, True, True),        # unaligned views, EuW
    (8, 45, 3, 10, 10, 32, True, True),       # unaligned views, per-c v
]


@pytest.mark.parametrize(
    "B,C,T,n,m,d,ta,unaligned", CAND_CASES,
    ids=["-".join(map(str, c[:7])) + ("-unaligned" if c[7] else "")
         for c in CAND_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cand_kernel(cuda, B, C, T, n, m, d, ta, unaligned, dtype):
    """The last candidate of the last b has every item row masked: its ci
    must be exact zeros, as must the all-masked slots."""
    args = _cand_inputs(np.random.default_rng(C), B, C, T, n, m, d, dtype,
                        cuda)
    args[3][B - 1, C - 1] = False
    if unaligned:
        args = [_unaligned(a) if i in (0, 1, 5, 6) else a
                for i, a in enumerate(args)]
        assert all(args[i].data_ptr() % 16 for i in (0, 1, 5, 6))
    before = tcand.cross_coattn_cand.launches
    got = tcand.cross_coattn_cand(*args, target_aware=ta)
    torch.cuda.synchronize()
    assert tcand.cross_coattn_cand.launches == before + 1
    want = tcand.cross_coattn_cand_plain(*args, target_aware=ta)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (B, C, T, d)
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
    assert (got[0][0, :, 0] == 0).all() and (got[1][0, :, T - 1] == 0).all()
    assert (got[1][B - 1, C - 1] == 0).all()


def test_cand_kernel_refuses_wide_rows(cuda):
    args = _cand_inputs(np.random.default_rng(0), 1, 1, 1, 33, 4, 8,
                        torch.float32, cuda)
    with pytest.raises(ValueError):
        tcand.cross_coattn_cand(*args)


@pytest.mark.parametrize("V,W,shape", [(1000, 32, (64, 9, 10)),
                                       (300, 8, (4096,)),
                                       (50, 6, (7, 11)),      # float2 rows
                                       (64, 9, (513,))])      # float rows
def test_scatter_add_kernel(cuda, V, W, shape):
    """Duplicated ids (40% of them the pad row 0) and zero rows."""
    rng = np.random.default_rng(V + W)
    ids = rng.integers(0, V, shape).astype(np.int32)
    ids[rng.random(shape) < 0.4] = 0
    ints = rng.integers(-8, 9, shape + (W,)).astype(np.float32)
    ints[ids == 0] = 0.0                       # masked slots: zero rows
    noise = rng.normal(size=shape + (W,)).astype(np.float32)
    noise[ids == 0] = 0.0
    ids_t = torch.from_numpy(ids)
    for src, exact in ((ints, True), (noise, False)):
        src_t = torch.from_numpy(src)
        before = tgather.scatter_add_rows.launches
        got = tgather.scatter_add_rows(ids_t.to(cuda), src_t.to(cuda), V)
        torch.cuda.synchronize()
        assert tgather.scatter_add_rows.launches == before + 1
        want = tgather.scatter_add_rows_plain(ids_t, src_t, V)
        if exact:
            assert torch.equal(got.cpu(), want)
        else:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                       atol=1e-5)


def test_gather_backward_launches_scatter_add(cuda):
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.normal(size=(100, 32)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 100, (8, 5)).astype(np.int32))
    dout = torch.from_numpy(rng.integers(-4, 5, (8, 5, 32)).astype(
        np.float32))
    t = table.to(cuda).requires_grad_(True)
    before = (tgather.gather_rows.launches, tgather.scatter_add_rows.launches)
    (g,) = torch.autograd.grad((tgather.gather_rows(t, ids.to(cuda))
                                * dout.to(cuda)).sum(), [t])
    torch.cuda.synchronize()
    assert (tgather.gather_rows.launches,
            tgather.scatter_add_rows.launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert torch.equal(g.cpu(), tgather.scatter_add_rows_plain(ids, dout,
                                                               100))


# (B, C, T, n, m, d, target_aware) of the shared backward: d = 7 and 20
# end Wr's padded rows in a partial 4-float vector; n = 16 with m = 3
# builds the MAXK 16 instance, n = m = 1 the narrowest; _cand_inputs masks
# every user row of (b=0, t=0) and every item row of (b=0, c, t=T-1).
BWD_NEW_CASES = [(5, 2, 3, 6, 5, 7, True),
                 (6, 3, 2, 9, 10, 20, False),
                 (4, 2, 3, 16, 3, 32, True),
                 (7, 2, 4, 1, 1, 16, True)]


@pytest.mark.parametrize("B,C,T,n,m,d,ta",
                         [(4, 2, 3, 5, 6, 8, True),
                          (4, 2, 3, 5, 6, 8, False),
                          (37, 2, 9, 10, 10, 32, True),     # ragged B
                          (5, 1, 4, 6, 5, 16, True),
                          (3, 12, 2, 4, 3, 16, False),
                          (2, 3, 2, 32, 17, 32, True)] + BWD_NEW_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cand_bwd_kernel(cuda, B, C, T, n, m, d, ta, dtype):
    rng = np.random.default_rng(B * C)
    args = _cand_inputs(rng, B, C, T, n, m, d, dtype, cuda)
    grads = [torch.from_numpy(rng.normal(size=(B, C, T, d)).astype(
        np.float32)).to(dtype).to(cuda) for _ in range(2)]
    before = tcand.cross_coattn_cand_bwd.launches
    got = tcand.cross_coattn_cand_bwd(*args, *grads, target_aware=ta)
    torch.cuda.synchronize()
    assert tcand.cross_coattn_cand_bwd.launches == before + 1
    want = tcand.cross_coattn_cand_bwd_plain(*args, *grads, target_aware=ta)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(("dEu", "dEi", "deu", "dei", "dWr"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        scale = max(w.float().abs().max().item(), 1.0)
        torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                   atol=tol * scale, msg=name)
    assert (got[0][0, 0] == 0).all() and (got[1][0, :, T - 1] == 0).all()
    again = tcand.cross_coattn_cand_bwd(*args, *grads, target_aware=ta)
    assert torch.equal(again[4], got[4])     # dWr is the same run to run


# (B, C, T, n, m, d, target_aware, variant) of the per-pair forward. Its
# kernel takes the sum and mean pools on 4-lane groups and the max pool on
# m16n8k16 (bf16) or m16n8k8 (tf32) tiles of 16 or 32 rows and columns;
# rows of d * itemsize % 16 != 0 and unaligned views take its scalar path.
# Variants: "ties" repeats one user row and one item row everywhere (exact
# ties in every row and column max), "one-row" / "one-column" leave one
# valid user row / item row in each unit, "masked" masks every user row of
# the last b and every item row of its last candidate (exact zeros),
# "unaligned" offsets the row inputs' views by one element.
PAIR_CASES = [
    (4, 2, 3, 5, 6, 8, True, ""),
    (4, 2, 3, 5, 6, 8, False, ""),
    (3, 4, 2, 4, 3, 16, True, ""),
    (5, 1, 4, 6, 5, 8, True, ""),
    (3, 101, 9, 10, 10, 32, True, ""),      # eval's 1 + 100
    (2, 5, 2, 32, 17, 32, True, ""),        # MAXK 32
    (2, 3, 2, 12, 16, 32, False, ""),       # MAXK 16
    (4, 3, 3, 10, 10, 32, True, "ties"),
    (4, 3, 3, 10, 10, 32, True, "one-row"),
    (4, 3, 3, 10, 10, 32, False, "one-column"),
    (5, 3, 2, 10, 10, 32, True, "masked"),
    (20, 5, 3, 10, 10, 7, True, ""),         # 14 / 28 B rows
    (8, 45, 3, 10, 10, 32, True, "unaligned"),
    (6, 4, 2, 11, 11, 32, True, ""),
    (4, 3, 2, 16, 16, 32, True, ""),
    (4, 3, 2, 17, 9, 32, True, ""),          # 2 m-tiles
    (3, 2, 2, 9, 17, 32, False, ""),         # 4 n-tiles
    (2, 3, 2, 32, 32, 32, True, ""),
    (1, 256, 9, 10, 10, 32, True, ""),       # score(u, 101)'s bucket
    (7, 1, 4, 10, 10, 32, True, ""),         # C = 1
    (1, 1, 3, 10, 10, 16, True, ""),
]


@pytest.mark.parametrize(
    "B,C,T,n,m,d,ta,variant", PAIR_CASES,
    ids=["-".join(map(str, c[:7])) + (f"-{c[7]}" if c[7] else "")
         for c in PAIR_CASES])
@pytest.mark.parametrize("pool", ["sum", "mean", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_kernel(cuda, B, C, T, n, m, d, ta, variant, pool, dtype):
    args = _cand_inputs(np.random.default_rng(C + n), B, C, T, n, m, d,
                        dtype, cuda)
    if variant == "ties":
        args[0][:] = args[0][:, :, :1]
        args[1][:] = args[1][:, :, :, :1]
    elif variant == "one-row":
        args[2][:] = False
        args[2][..., 2] = True
    elif variant == "one-column":
        args[3][:] = False
        args[3][..., 3] = True
    elif variant == "masked":
        args[2][B - 1] = False
        args[3][B - 1, C - 1] = False
    elif variant == "unaligned":
        args = [_unaligned(a) if i in (0, 1, 5, 6) else a
                for i, a in enumerate(args)]
        assert all(args[i].data_ptr() % 16 for i in (0, 1, 5, 6))
    args[2][0, 0] = False            # _cand_inputs' all-masked slots
    args[3][0, :, T - 1] = False
    before = tpair.cross_coattn_pair.launches
    got = tpair.cross_coattn_pair(*args, pool=pool, target_aware=ta)
    torch.cuda.synchronize()
    assert tpair.cross_coattn_pair.launches == before + 1
    want = tpair.cross_coattn_pair_plain(*args, pool=pool, target_aware=ta)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (B, C, T, d)
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
    assert (got[0][0, :, 0] == 0).all() and (got[1][0, :, T - 1] == 0).all()
    if variant == "masked":
        assert (got[0][B - 1] == 0).all() and (got[1][B - 1, C - 1] == 0).all()


@pytest.mark.parametrize("B,C,T,n,m,d,ta",
                         [(4, 2, 3, 5, 6, 8, True),
                          (37, 2, 9, 10, 10, 32, True),     # ragged B
                          (3, 12, 2, 4, 3, 16, False),
                          (2, 3, 2, 32, 17, 32, True)] + BWD_NEW_CASES)
@pytest.mark.parametrize("pool", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_bwd_kernel(cuda, B, C, T, n, m, d, ta, pool, dtype):
    rng = np.random.default_rng(B * C + n)
    args = _cand_inputs(rng, B, C, T, n, m, d, dtype, cuda)
    grads = [torch.from_numpy(rng.normal(size=(B, C, T, d)).astype(
        np.float32)).to(dtype).to(cuda) for _ in range(2)]
    before = tpair.cross_coattn_pair_bwd.launches
    got = tpair.cross_coattn_pair_bwd(*args, *grads, pool=pool,
                                      target_aware=ta)
    torch.cuda.synchronize()
    assert tpair.cross_coattn_pair_bwd.launches == before + 1
    want = tpair.cross_coattn_pair_bwd_plain(*args, *grads, pool=pool,
                                             target_aware=ta)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(("dEu", "dEi", "deu", "dei", "dWr"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        scale = max(w.float().abs().max().item(), 1.0)
        torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                   atol=tol * scale, msg=name)
    assert (got[0][0, 0] == 0).all() and (got[1][0, :, T - 1] == 0).all()
    again = tpair.cross_coattn_pair_bwd(*args, *grads, pool=pool,
                                        target_aware=ta)
    assert torch.equal(again[4], got[4])     # dWr is the same run to run


@pytest.mark.parametrize("pool", ["mean", "max"])
def test_pair_function_launches_forward_and_backward(cuda, pool):
    """Training through the autograd Function: the forward kernel, then the
    backward kernel (mean) or the recompute VJP (max), against autograd
    through the plain forward on the same inputs."""
    rng = np.random.default_rng(11)
    args = _cand_inputs(rng, 6, 2, 3, 5, 6, 8, torch.float32, cuda)
    dcu, dci = (torch.from_numpy(rng.normal(size=(6, 2, 3, 8)).astype(
        np.float32)).to(cuda) for _ in range(2))
    grads = []
    before = (tpair.cross_coattn_pair.launches,
              tpair.cross_coattn_pair_bwd.launches)
    for fn in (tpair.cross_coattn_pair, tpair.cross_coattn_pair_plain):
        ts = [a.clone().requires_grad_(i in (0, 1, 4, 5, 6))
              for i, a in enumerate(args)]
        cu, ci = fn(*ts, pool=pool, target_aware=True)
        grads.append(torch.autograd.grad(
            (cu * dcu).sum() + (ci * dci).sum(),
            [ts[i] for i in (0, 1, 4, 5, 6)]))
    torch.cuda.synchronize()
    assert (tpair.cross_coattn_pair.launches,
            tpair.cross_coattn_pair_bwd.launches) == (
                before[0] + 1, before[1] + (pool == "mean"))
    for g, w in zip(*grads):
        scale = max(w.abs().max().item(), 1.0)
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * scale)
