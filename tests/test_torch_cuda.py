"""The port's CUDA kernels against their plain versions, on the card: the
gather and its scatter-add, and the candidates-form (sum pool) and
per-pair (sum, mean, max) co-attention, forward and backward, both on the
tuned kernels (d, n, m <= 32) and on the wide ones past that. And
checkpoints on the card: a saved state restores onto the card bit-equal,
and a resumed `train()` agrees with a straight one.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it also runs on a host that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the gather is exact, and so is the scatter-add on
integer-valued sources (sums of integers are exact in any order); on
random sources it agrees to 1e-5 relative (f32 atomics add in no fixed
order), and its bf16 form to 1 bf16 ulp of the exact sum rounded once.
The co-attention forward and backward are f32 inside, so f32 outputs
agree to 1e-4 (another summation order) and bf16 outputs to 2e-2 (one
bf16 rounding of values of order 1)."""

import dataclasses

import numpy as np
import pytest
import torch

from score_tpu_torch.kernels import coattn as tpair
from score_tpu_torch.kernels import coattn_cand as tcand
from score_tpu_torch.kernels import coattn_wide as twide
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


@pytest.mark.parametrize("W,dtype,n_ids,offset", [
    (1, torch.int32, 5000, 0),        # 4 B rows: a lane a row
    (9, torch.int32, 8192, 0),        # 36 B: 9 words, groups of 16 lanes
    (90, torch.int32, 8192, 0),       # 360 B: 45 8-B vectors, 32 lanes
    (90, torch.int32, 8192, 1),       # the same in an offset view: 4-B
    (1, torch.bfloat16, 3000, 0),     # 2 B rows
    (32, torch.float32, 4100, 3),     # 128 B rows, offset view: 4-B words
    (64, torch.float32, 4097, 0),     # 256 B rows, a ragged last pass
    (90, torch.int32, 0, 0),          # no ids
    (32, torch.bfloat16, 1, 0),       # one id
])
def test_gather_kernel_layouts(cuda, W, dtype, n_ids, offset):
    """Row lengths and alignments that pick each vector width and group
    size of the kernel; bit-exact against the plain version."""
    rng = np.random.default_rng(W + n_ids)
    V = 3000
    flat = torch.from_numpy(rng.integers(-2**30, 2**30, V * W + offset))
    flat = flat.to(torch.int32) if dtype == torch.int32 else \
        (flat.float() / 2**20).to(dtype)
    table = flat.to(cuda)[offset:].view(V, W)
    assert table.is_contiguous()
    ids = torch.from_numpy(rng.integers(0, V, (n_ids,)).astype(np.int32))
    before = tgather.gather_rows.launches
    got = tgather.gather_rows(table, ids.to(cuda))
    torch.cuda.synchronize()
    assert tgather.gather_rows.launches == before + (n_ids > 0)
    assert got.shape == (n_ids, W) and got.dtype == dtype
    assert torch.equal(got.cpu(), tgather.gather_rows_plain(table.cpu(),
                                                            ids))


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
    """Past the wide kernels' limits (n or m = 65 rows, d = 129) every
    co-attention wrapper raises before it launches anything."""
    for n, m, d in ((65, 4, 8), (4, 65, 8), (4, 4, 129)):
        args = _cand_inputs(np.random.default_rng(0), 1, 1, 1, n, m, d,
                            torch.float32, cuda)
        grads = [torch.zeros(1, 1, 1, d, device=cuda)] * 2
        with pytest.raises(ValueError):
            tcand.cross_coattn_cand(*args)
        with pytest.raises(ValueError):
            tcand.cross_coattn_cand_bwd(*args, *grads)
        with pytest.raises(ValueError):
            tpair.cross_coattn_pair(*args, pool="max")
        with pytest.raises(ValueError):
            tpair.cross_coattn_pair_bwd(*args, *grads, pool="mean")


# (B, C, T, n, m, d, target_aware, variant) past the tuned kernels' 32:
# the wide kernels (csrc/coattn_wide.cu). d = 33 and 100 in bf16 (66, 200
# B rows) and "unaligned" take the scalar loads; "masked" masks every user
# row of the last b and every item row of its last candidate. C = 600 at
# B = 1 splits each (b, t)'s candidates over several warps.
_WIDE_BASE = [
    (3, 2, 3, 10, 10, 33, True, ""),
    (3, 2, 3, 10, 10, 64, True, ""),
    (3, 2, 3, 10, 10, 64, False, "masked"),
    (2, 3, 2, 10, 10, 100, True, ""),
    (2, 3, 2, 10, 10, 128, True, ""),
    (2, 2, 2, 40, 40, 32, True, ""),
    (2, 2, 2, 64, 64, 32, True, "masked"),
    (2, 2, 2, 64, 40, 128, True, ""),
    (3, 2, 3, 10, 10, 64, True, "unaligned"),
    (1, 600, 2, 10, 10, 64, True, ""),
]
# The forward's edges: one row a side; 16 user rows (one m-tile) against
# 17 item rows (three 8-row tiles); d = 65 (a chunk of 32 components with
# one past d); one candidate; every row masked; candidate 0's item rows
# all masked ("itemmasked": its max-pool scores are 0 plus the target
# terms); n = m = 64 at d = 128 (four m-tiles, eight item tiles).
WIDE_CASES = _WIDE_BASE + [
    (3, 2, 3, 1, 1, 64, True, ""),
    (2, 2, 2, 16, 17, 64, True, ""),
    (2, 3, 2, 10, 10, 65, True, ""),
    (3, 1, 3, 10, 10, 64, True, ""),
    (3, 2, 3, 10, 10, 64, True, "allmasked"),
    (3, 2, 3, 10, 10, 64, True, "itemmasked"),
    (2, 2, 2, 64, 64, 128, True, ""),
]
WIDE_IDS = ["-".join(map(str, c[:7])) + (f"-{c[7]}" if c[7] else "")
            for c in WIDE_CASES]


def _wide_inputs(B, C, T, n, m, d, variant, dtype, device):
    args = _cand_inputs(np.random.default_rng(C + n + d), B, C, T, n, m, d,
                        dtype, device)
    if variant == "masked":
        args[2][B - 1] = False
        args[3][B - 1, C - 1] = False
    elif variant == "allmasked":
        args[2][:] = False
        args[3][:] = False
    elif variant == "itemmasked":
        args[3][:, 0] = False
    elif variant == "unaligned":
        args = [_unaligned(a) if i in (0, 1, 5, 6) else a
                for i, a in enumerate(args)]
        assert all(args[i].data_ptr() % 16 for i in (0, 1, 5, 6))
    return args


def _wide_counts():
    return (twide.cross_coattn_wide.launches,
            twide.cross_coattn_wide_bwd.launches,
            tcand.cross_coattn_cand.launches,
            tcand.cross_coattn_cand_bwd.launches,
            tpair.cross_coattn_pair.launches,
            tpair.cross_coattn_pair_bwd.launches)


@pytest.mark.parametrize("B,C,T,n,m,d,ta,variant", WIDE_CASES, ids=WIDE_IDS)
@pytest.mark.parametrize("pool", ["sum", "mean", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_kernel(cuda, B, C, T, n, m, d, ta, variant, pool, dtype):
    """The wide forward through `cross_coattn_pair` (and, for the sum pool,
    `cross_coattn_cand`): its counter moves, the tuned kernels' do not."""
    args = _wide_inputs(B, C, T, n, m, d, variant, dtype, cuda)
    want = tpair.cross_coattn_pair_plain(*args, pool=pool, target_aware=ta)
    calls = [lambda: tpair.cross_coattn_pair(*args, pool=pool,
                                             target_aware=ta)]
    if pool == "sum":
        calls.append(lambda: tcand.cross_coattn_cand(*args, target_aware=ta))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for call in calls:
        before = _wide_counts()
        got = call()
        torch.cuda.synchronize()
        assert _wide_counts() == (before[0] + 1,) + before[1:]
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == (B, C, T, d)
            assert torch.isfinite(g).all()
            torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                       atol=tol)
        assert (got[0][0, :, 0] == 0).all()
        assert (got[1][0, :, T - 1] == 0).all()
        if variant == "masked":
            assert (got[0][B - 1] == 0).all()
            assert (got[1][B - 1, C - 1] == 0).all()
        if variant == "allmasked":
            assert all((g == 0).all() for g in got)
        if variant == "itemmasked":
            assert (got[1][:, 0] == 0).all()


@pytest.mark.parametrize("pool", ["sum", "mean", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_forward_bit_equal(cuda, pool, dtype):
    """Two runs of the wide forward give the same bits: a warp sums its
    rows in a fixed order, with no atomics."""
    args = _wide_inputs(64, 3, 9, 10, 10, 64, "", dtype, cuda)
    first = tpair.cross_coattn_pair(*args, pool=pool)
    again = tpair.cross_coattn_pair(*args, pool=pool)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(again, first))


# More backward shapes: one candidate, five (three chunks of the kernel's
# two), one slot, d = 96 (a quarter of the lanes' components past d), n =
# m = 64 at d = 64 and d = 128 (one warp a block), C = 5 there (the dWr
# accumulator in device memory), every row masked, and no target.
WIDE_BWD_CASES = _WIDE_BASE[:-1] + [
    (3, 1, 3, 10, 10, 64, True, ""),
    (3, 5, 3, 10, 10, 64, True, ""),
    (5, 2, 1, 10, 10, 64, True, ""),
    (2, 2, 2, 10, 10, 96, True, ""),
    (2, 2, 2, 64, 64, 64, True, ""),
    (2, 2, 2, 64, 64, 128, True, ""),
    (1, 5, 2, 64, 64, 128, True, ""),
    (3, 2, 3, 10, 10, 64, True, "allmasked"),
    (3, 3, 3, 10, 10, 64, False, ""),
]
WIDE_BWD_IDS = ["-".join(map(str, c[:7])) + (f"-{c[7]}" if c[7] else "")
                for c in WIDE_BWD_CASES]


@pytest.mark.parametrize("B,C,T,n,m,d,ta,variant", WIDE_BWD_CASES,
                         ids=WIDE_BWD_IDS)
@pytest.mark.parametrize("pool", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_bwd_kernel(cuda, B, C, T, n, m, d, ta, variant, pool, dtype):
    """The wide backward through `cross_coattn_pair_bwd` (and, for the sum
    pool, `cross_coattn_cand_bwd`), relative to each gradient's largest
    value as the tuned backward's tests; all five gradients bit-equal run
    to run."""
    args = _wide_inputs(B, C, T, n, m, d, variant, dtype, cuda)
    rng = np.random.default_rng(B * C + d)
    grads = [torch.from_numpy(rng.normal(size=(B, C, T, d)).astype(
        np.float32)).to(dtype).to(cuda) for _ in range(2)]
    want = tpair.cross_coattn_pair_bwd_plain(*args, *grads, pool=pool,
                                             target_aware=ta)
    calls = [lambda: tpair.cross_coattn_pair_bwd(*args, *grads, pool=pool,
                                                 target_aware=ta)]
    if pool == "sum":
        calls.append(lambda: tcand.cross_coattn_cand_bwd(*args, *grads,
                                                         target_aware=ta))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for call in calls:
        before = _wide_counts()
        got = call()
        torch.cuda.synchronize()
        assert _wide_counts() == (before[0], before[1] + 1) + before[2:]
        for name, g, w in zip(("dEu", "dEi", "deu", "dei", "dWr"), got,
                              want):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            assert torch.isfinite(g).all(), name
            scale = max(w.float().abs().max().item(), 1.0)
            torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                       atol=tol * scale, msg=name)
        assert (got[0][0, 0] == 0).all() and (got[1][0, :, T - 1] == 0).all()
        if variant == "masked":
            assert (got[0][B - 1] == 0).all()
            assert (got[1][B - 1, C - 1] == 0).all()
        if variant == "allmasked":
            assert all((g == 0).all() for g in got)
        again = call()
        assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("pool", ["sum", "mean", "max"])
def test_wide_function_launches_forward_and_backward(cuda, pool):
    """configs3's co-attention at d = 64 through the model's module: the
    wide forward, then the wide backward (sum, mean) or the recompute VJP
    (max), against autograd through the plain forward."""
    from score_tpu_torch.nn.coattn import CrossCoAttention
    rng = np.random.default_rng(12)
    B, C, T, n, m, d = 5, 2, 3, 10, 10, 64
    args = _cand_inputs(rng, B, C, T, n, m, d, torch.float32, cuda)
    mod = CrossCoAttention(d, pool=pool).to(cuda)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape) * 0.3))
    dcu, dci = (torch.from_numpy(rng.normal(size=(B, C, T, d)).astype(
        np.float32)).to(cuda) for _ in range(2))
    Eu, Ei, mu, mi, _, eu, ei = args
    xs = [x.clone().requires_grad_(True) for x in (Eu, Ei, eu, ei)]
    before = _wide_counts()
    cu, ci = mod(xs[0], xs[1], mu, mi, xs[2], xs[3])
    got = torch.autograd.grad((cu * dcu).sum() + (ci * dci).sum(),
                              xs + list(mod.parameters()))
    torch.cuda.synchronize()
    assert _wide_counts() == (before[0] + 1, before[1] + (pool != "max")) \
        + before[2:]
    ys = [x.detach().clone().requires_grad_(True) for x in xs]
    W = {k: v.detach().clone().requires_grad_(True)
         for k, v in mod.named_parameters()}
    cu, ci = tpair.cross_coattn_pair_plain(
        ys[0], ys[1], mu, mi, W["wr"], ys[2] @ W["wti"].T,
        ys[3] @ W["wtu"].T, pool=pool)
    want = torch.autograd.grad((cu * dcu).sum() + (ci * dci).sum(),
                               ys + [W[k] for k, _ in
                                     mod.named_parameters()])
    for g, w in zip(got, want):
        scale = max(w.abs().max().item(), 1.0)
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * scale)


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


def _segments(rng, V, W, lengths, ids_fn=None):
    """Integer-valued and random sources over ids of each length (40% of
    them the pad row 0, whose rows are zeros, unless ids_fn gives them)."""
    ids, ints, noise = [], [], []
    for n in lengths:
        i = (ids_fn(n) if ids_fn else rng.integers(0, V, n)).astype(np.int32)
        if ids_fn is None:
            i[rng.random(n) < 0.4] = 0
        a = rng.integers(-8, 9, (n, W)).astype(np.float32)
        b = rng.normal(size=(n, W)).astype(np.float32)
        a[i == 0] = 0.0
        b[i == 0] = 0.0
        ids.append(torch.from_numpy(i))
        ints.append(torch.from_numpy(a))
        noise.append(torch.from_numpy(b))
    return ids, ints, noise


def _check_grouped(cuda, V, ids, srcs, exact, views=None):
    """One launch for the group, against index_add_ in segment order:
    exact, or within 1e-5 relative to the table's largest value (rows
    that take thousands of adds round in another order)."""
    views = views or (lambda x: x.to(cuda))
    before = tgather.scatter_add_rows.launches
    got = tgather.scatter_add_rows([i.to(cuda) for i in ids],
                                   [views(x) for x in srcs], V)
    torch.cuda.synchronize()
    assert tgather.scatter_add_rows.launches == before + 1
    want = tgather.scatter_add_rows_plain(ids, srcs, V)
    if exact:
        assert torch.equal(got.cpu(), want)
    else:
        scale = max(want.abs().max().item(), 1.0)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("segs", [1, 2, 3, 4])
@pytest.mark.parametrize("W", [1, 2, 3, 32, 128])
def test_grouped_scatter_add_kernel(cuda, segs, W):
    """Segments of several lengths into one table, at each float4, float2
    and float row width."""
    rng = np.random.default_rng(segs * 1000 + W)
    lengths = [4096 * 9 * 10 // 40, 4096 // 40, 700, 5][:segs]
    ids, ints, noise = _segments(rng, 900, W, lengths)
    _check_grouped(cuda, 900, ids, ints, exact=True)
    _check_grouped(cuda, 900, ids, noise, exact=False)


@pytest.mark.parametrize("case", ["empty", "offset", "one id", "zipf"])
def test_grouped_scatter_add_kernel_edges(cuda, case):
    """An empty segment among others; sources in offset views (4-byte
    aligned only: the scalar vectors); every id the same row; Zipf ids,
    a few rows taking most adds."""
    rng = np.random.default_rng(len(case))
    V, W = 5000, 32
    views, ids_fn = None, None
    lengths = [20000, 0, 4096]
    if case == "offset":
        views = lambda x: _unaligned(x.to(cuda))
    elif case == "one id":     # few rows: one sum of all, in any order
        ids_fn = lambda n: np.full(n, 77)
        lengths = [2000, 0, 300]
    elif case == "zipf":       # the top row takes about a quarter
        ids_fn = lambda n: np.minimum(rng.zipf(1.3, n), V - 1)
        lengths = [8000, 0, 2000]
    ids, ints, noise = _segments(rng, V, W, lengths, ids_fn)
    _check_grouped(cuda, V, ids, ints, exact=True, views=views)
    _check_grouped(cuda, V, ids, noise, exact=False, views=views)
    with pytest.raises(ValueError):     # one launch takes at most four
        tgather.scatter_add_rows([i.to(cuda) for i in ids + ids],
                                 [x.to(cuda) for x in ints + ints], V)


def test_grouped_lookup_one_scatter_a_table(cuda):
    """EmbeddingTables.lookup: two lookups into each of two tables, and
    three into a shared one, take one scatter-add a table in the backward,
    equal (integer-valued gradients) to index_add of every lookup."""
    from score_tpu_torch.nn.embed import EmbeddingTables
    rng = np.random.default_rng(3)
    U, I, d = 500, 900, 32
    for shared in (False, True):
        tables = EmbeddingTables(U, I, d, shared=shared).to(cuda)
        with torch.no_grad():
            for p in tables.parameters():
                p.copy_(torch.from_numpy(rng.normal(size=p.shape)))
        users = [torch.from_numpy(rng.integers(0, U + 1, s).astype(
            np.int32)).to(cuda) for s in ((64,), (64, 2, 3, 4))][:2 - shared]
        items = [torch.from_numpy(rng.integers(0, I + 1, s).astype(
            np.int32)).to(cuda) for s in ((64, 1), (64, 3, 5))]
        before = (tgather.gather_rows.launches,
                  tgather.scatter_add_rows.launches)
        outs = [x for part in tables.lookup(users, items) for x in part]
        douts = [torch.from_numpy(rng.integers(-8, 9, o.shape).astype(
            np.float32)).to(cuda) for o in outs]
        params = list(tables.parameters())
        grads = torch.autograd.grad(
            sum((o * g).sum() for o, g in zip(outs, douts)), params)
        torch.cuda.synchronize()
        assert (tgather.gather_rows.launches,
                tgather.scatter_add_rows.launches) == (
            before[0] + len(outs), before[1] + len(params))
        rows = [torch.where(u > 0, u + I, 0) if shared else u for u in users]
        want = [torch.zeros_like(p) for p in params]
        for k, (r, g) in enumerate(zip(rows + items, douts)):
            # the parameters: table, or user_table and item_table
            tgt = want[0] if shared or k < len(rows) else want[1]
            tgt.index_add_(0, r.reshape(-1).long(), g.reshape(-1, d))
        for g, w in zip(grads, want):
            assert torch.equal(g, w)


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


def _bf16_exact(ids, srcs, V):
    """The exact sum of bf16 segments (in f64) rounded once to bf16: what
    the bf16 scatter-add gives, up to f32's order effects."""
    W = srcs[0].shape[-1]
    exact = torch.zeros(V, W, dtype=torch.float64)
    for i, x in zip(ids, srcs):
        exact.index_add_(0, i.reshape(-1).long(), x.reshape(-1, W).double())
    return exact


def _bf16_ulps(got, exact):
    """|got - exact| in bf16 ulps of the larger magnitude."""
    got = got.double()
    m = torch.maximum(got.abs(), exact.abs()).clamp_min(2.0 ** -126)
    return (got - exact).abs() / torch.exp2(torch.floor(torch.log2(m)) - 7)


@pytest.mark.parametrize("case", ["empty", "one row", "repeats", "wide"])
@pytest.mark.parametrize("W", [1, 2, 3, 32])
def test_bf16_scatter_add_kernel(cuda, case, W):
    """The bf16 form: bf16 segments summed in f32 and rounded once into a
    bf16 table, one launch (a bf16 one) for the group. Against the f64
    sum rounded to bf16, every entry within 1 bf16 ulp; against the plain
    version (index_add_ in f32, one rounding) bit-equal on integer-valued
    sources. Cases: every segment empty (a zero table), one row taking
    every id, 90% of the ids on 8 hot rows among pad ids, and a table
    with an empty segment among others (W = 1, 2, 3 and 32: the 1-, 2-
    and 4-element vectors)."""
    rng = np.random.default_rng(W * 10 + len(case))
    V = 700
    lengths = {"empty": [0, 0], "one row": [3000, 40],
               "repeats": [9000, 0, 512], "wide": [4096 * 9, 4096, 0, 300]
               }[case]
    ids, ints, noise = [], [], []
    for n in lengths:
        if case == "one row":
            i = np.full(n, 5)
        elif case == "repeats":
            i = np.where(rng.random(n) < 0.9, rng.integers(1, 9, n),
                         rng.integers(0, V, n))
            i[rng.random(n) < 0.3] = 0
        else:
            i = rng.integers(0, V, n)
        a = rng.integers(-8, 9, (n, W)).astype(np.float32)
        b = rng.normal(size=(n, W)).astype(np.float32)
        a[i == 0] = b[i == 0] = 0.0
        ids.append(torch.from_numpy(i.astype(np.int32)))
        ints.append(torch.from_numpy(a).to(torch.bfloat16))
        noise.append(torch.from_numpy(b).to(torch.bfloat16))
    for srcs, exact in ((ints, True), (noise, False)):
        before = (tgather.scatter_add_rows.launches,
                  tgather.scatter_add_rows.launches_bf16)
        got = tgather.scatter_add_rows([i.to(cuda) for i in ids],
                                       [x.to(cuda) for x in srcs], V)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == (V, W)
        launched = 0 if case == "empty" else 1
        assert (tgather.scatter_add_rows.launches,
                tgather.scatter_add_rows.launches_bf16) == (
            before[0] + launched, before[1] + launched)
        want = tgather.scatter_add_rows_plain(ids, srcs, V)
        assert want.dtype == torch.bfloat16
        if exact:
            assert torch.equal(got.cpu(), want)
        assert _bf16_ulps(got.cpu(), _bf16_exact(ids, srcs, V)).max() <= 1


def test_bf16_table_lookup_backward(cuda):
    """A grouped lookup into a bf16 table that requires a gradient: the
    gathers and one bf16 scatter-add, its gradient bf16, within 1 bf16 ulp
    of the f64 sum of the rows' bf16 cotangents (f32 compute: the
    cotangents cast to bf16 before the scatter), and bit-equal to the
    CPU's plain path on integer-valued cotangents."""
    rng = np.random.default_rng(5)
    V, d = 300, 32
    table = torch.from_numpy(rng.normal(0, 0.01, (V, d))).to(torch.bfloat16)
    ids = [torch.from_numpy(rng.integers(0, 40, s).astype(np.int32))
           for s in ((64, 1), (64, 9, 10))]
    for ints in (True, False):
        douts = [torch.from_numpy(
            (rng.integers(-8, 9, (*i.shape, d)) if ints
             else rng.normal(size=(*i.shape, d))).astype(np.float32))
            for i in ids]
        grads = {}
        for dev in (cuda, torch.device("cpu")):
            t = table.to(dev).requires_grad_(True)
            before = (tgather.gather_rows.launches,
                      tgather.scatter_add_rows.launches_bf16)
            outs = tgather.gather_rows_grouped(t, [i.to(dev) for i in ids])
            loss = sum((o.float() * g.to(dev)).sum()
                       for o, g in zip(outs, douts))
            (grads[dev.type],) = torch.autograd.grad(loss, [t])
            if dev.type == "cuda":
                torch.cuda.synchronize()
                assert (tgather.gather_rows.launches,
                        tgather.scatter_add_rows.launches_bf16) == (
                    before[0] + 2, before[1] + 1)
        got = grads["cuda"].cpu()
        assert got.dtype == torch.bfloat16
        if ints:
            assert torch.equal(got, grads["cpu"])
        cots = [g.to(torch.bfloat16) for g in douts]
        assert _bf16_ulps(got, _bf16_exact(ids, cots, V)).max() <= 1


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
    elif variant == "allmasked":
        args[2][:] = False
        args[3][:] = False
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


def _small_dataset():
    from score_tpu_torch.data import synth
    from score_tpu_torch.data.prep_common import build_dataset
    user, item, ts = synth.synth_events(300, 600, 20000, num_slots=8, seed=0)
    return build_dataset(user, item, ts, num_slots=8, user_fanout=6,
                         item_fanout=6, num_eval_neg=20, min_user=3,
                         min_item=3, seed=0)


def _small_cfg(**train_kw):
    from score_tpu_torch.config import configs3
    cfg = configs3()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, train_neg_mode="inbatch_iw"),
        train=dataclasses.replace(cfg.train, **{
            "batch_size": 256, "table_update_every": 2,
            "table_lr_boost": 2.0, **train_kw}))


def test_checkpoint_restores_on_card_bit_equal(cuda, tmp_path):
    """Weights, Adam moments and count saved from the card, after three
    steps, restore onto the card, into a state from another init, equal
    bit for bit."""
    from score_tpu_torch.checkpoint import CheckpointManager, apply_restore
    from score_tpu_torch.data.pipeline import TargetIterator
    from score_tpu_torch.graph import device_graph
    from score_tpu_torch.params import init_params
    from score_tpu_torch.train import (init_state, item_importance_weights,
                                       train_step)
    ds, cfg = _small_dataset(), _small_cfg()

    def state(seed):
        sd = init_params(cfg, ds.num_users, ds.num_items,
                         torch.Generator().manual_seed(seed))
        return init_state(cfg, ds.num_users, ds.num_items, sd, device=cuda)

    st = state(0)
    graph = device_graph(ds.graph, cuda)
    neg_iw = torch.from_numpy(item_importance_weights(
        ds.train, ds.num_items)).to(cuda)
    it = TargetIterator(ds.train, 256)
    for _ in range(3):
        st, _ = train_step(st, graph, next(it), neg_iw=neg_iw)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save("latest", st, it.get_state(), 0.5, st.step, block=True)
    other = state(1)
    restored = mgr.restore("latest", other)
    assert restored["params"]["coattn.wr"].device.type == "cuda"
    apply_restore(other, restored)
    assert other.step == st.step == other.opt.count == 3
    for k, v in st.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    for name in ("mu", "nu"):
        for k, v in getattr(st.opt, name).items():
            assert torch.equal(getattr(other.opt, name)[k], v), (name, k)


def test_resumed_driver_on_card_matches_straight(cuda, tmp_path):
    """train() for 2 epochs straight, against 1 epoch then a second train()
    resuming from its checkpoints, both on the card. The scatter-add's f32
    atomics add in no fixed order, so two runs differ in the last bits and
    Adam lets that grow over 90 steps (bit-exact resume is a CPU test,
    tests/test_torch_checkpoint.py). Every val row and the test metrics
    agree to within three targets' worth of each ranking metric (3 / the
    targets evaluated: one target changes HR@10, NDCG@10 or MRR by at most
    1 / that), and AUC and loss to 1e-3."""
    from score_tpu_torch.train import train
    ds = _small_dataset()
    cfg = _small_cfg(learning_rate=1e-4, num_epochs=2, eval_every_steps=15,
                     early_stop_patience=100, log_every_steps=10 ** 9,
                     eval_max_targets=256)
    straight = train(cfg, ds, verbose=False, device=cuda)
    ck = str(tmp_path / "ck")
    first = train(cfg.replace(train=dataclasses.replace(
        cfg.train, num_epochs=1, checkpoint_dir=ck)), ds, verbose=False,
        device=cuda)
    second = train(cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=ck)), ds, verbose=False, device=cuda)
    assert second["timing"]["start_step"] == first["steps_run"]
    rows = first["history"] + second["history"]
    assert [r["step"] for r in rows] == \
        [r["step"] for r in straight["history"]]

    def close(got, want, n_targets, keys):
        for key in keys:
            tol = 1e-3 if key in ("auc", "loss") else 3 / n_targets
            assert abs(got[key] - want[key]) <= tol, (got.get("step"), key)

    for got, want in zip(rows, straight["history"]):
        close(got, want, 256, ("auc", "ndcg@10", "hr@10", "mrr", "loss"))
    close(second["test"], straight["test"], len(ds.test),
          ("auc", "ndcg@10", "hr@10", "mrr"))


@pytest.mark.parametrize("rung", ["configs0", "configs1", "configs2",
                                  "configs3"])
def test_uniform_step_on_card_matches_cpu(cuda, rung):
    """One full step (tables included) of each rung with its preset's
    uniform negatives, f32, on the card and on the CPU from the same
    weights (the zero-initialised attention weights made non-zero), batch
    and raw negatives, some of them equal to their positive: the loss to
    1e-5 and the parameters to rtol 1e-4 / atol 1e-5, as chip_smoke.py
    holds 3 steps (the scatter-add's atomics sum in no fixed order)."""
    from score_tpu_torch.config import PRESETS
    from score_tpu_torch.data.pipeline import TargetIterator
    from score_tpu_torch.graph import device_graph
    from score_tpu_torch.params import init_params
    from score_tpu_torch.train import draw_negatives, init_state, train_step
    ds = _small_dataset()
    cfg = PRESETS[rung]()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=256))
    assert cfg.data.train_neg_mode == "uniform"
    gen = torch.Generator().manual_seed(0)
    sd = init_params(cfg, ds.num_users, ds.num_items, gen)
    for k in sd:
        if k.startswith("coattn.") or k.endswith(".w"):
            sd[k] = torch.randn(sd[k].shape, generator=gen) * 0.3
    batch = next(TargetIterator(ds.train, 256))
    negs = draw_negatives(gen, 256, cfg.data.num_train_neg, ds.num_items)
    negs[:16, 0] = torch.from_numpy(batch["item"][:16])   # collisions
    out = {}
    for device in (cuda, torch.device("cpu")):
        st = init_state(cfg, ds.num_users, ds.num_items, sd, device=device)
        st, m = train_step(st, device_graph(ds.graph, device), batch,
                           negatives=negs)
        out[device.type] = (m["loss"].item(), {
            k: v.detach().cpu() for k, v in st.model.named_parameters()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-6)
    for k, want in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], want, rtol=1e-4,
                                   atol=1e-5, msg=k)


def test_shared_table_gather_and_scatter(cuda):
    """configs0's one shared table of round_up(1 + items + users) rows:
    user ids offset by num_items, gathered by the kernel against
    index_select of the offset ids, and the table's gradient by the
    scatter-add kernel against index_add of the same rows."""
    from score_tpu_torch.nn.embed import EmbeddingTables, round_up
    U, I, d = 5000, 9000, 32
    tables = EmbeddingTables(U, I, d, shared=True).to(cuda)
    assert tables.table.shape == (round_up(1 + I + U), d)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        tables.table.copy_(torch.from_numpy(
            rng.normal(size=tables.table.shape).astype(np.float32)))
    users = torch.from_numpy(rng.integers(0, U + 1, (4096,)).astype(
        np.int32)).to(cuda)
    items = torch.from_numpy(rng.integers(0, I + 1, (512, 9, 10)).astype(
        np.int32)).to(cuda)
    before = (tgather.gather_rows.launches, tgather.scatter_add_rows.launches)
    eu, ei = tables.user_emb(users), tables.item_emb(items)
    rows = torch.where(users > 0, users + I, 0).long()
    assert torch.equal(eu, torch.index_select(tables.table, 0, rows))
    assert torch.equal(ei, torch.index_select(
        tables.table, 0, items.reshape(-1).long()).view(512, 9, 10, d))
    du = torch.from_numpy(rng.integers(-8, 9, (4096, d)).astype(
        np.float32)).to(cuda)
    di = torch.from_numpy(rng.integers(-8, 9, (512, 9, 10, d)).astype(
        np.float32)).to(cuda)
    grad, = torch.autograd.grad((eu * du).sum() + (ei * di).sum(),
                                [tables.table])
    torch.cuda.synchronize()
    assert (tgather.gather_rows.launches,
            tgather.scatter_add_rows.launches) == (before[0] + 2,
                                                   before[1] + 2)
    want = torch.zeros_like(tables.table).index_add_(0, rows, du)
    want.index_add_(0, items.reshape(-1).long(), di.reshape(-1, d))
    assert torch.equal(grad, want)    # integer-valued sums: exact


@pytest.mark.parametrize("W", [1, 16])
def test_roster_tables_gather_and_scatter(cuda, W):
    """The roster's narrow tables as its models look them up: a bias table
    one element wide (4-byte f32 rows; 2-byte rows once serving casts it
    to bf16) and the presets' 16-wide tables. Users [4096] and items
    [4096, 2] ([positive | negative]) gathered by the kernel against
    index_select, the f32 tables' gradients by the scatter-add kernel
    against index_add (integer-valued sums: exact), and the bf16 cast's
    gather bit-equal to the plain version's."""
    from score_tpu_torch.nn.embed import EmbeddingTables
    U, I = 50000, 90553
    tables = EmbeddingTables(U, I, W).to(cuda)
    rng = np.random.default_rng(W)
    with torch.no_grad():
        for t in (tables.user_table, tables.item_table):
            t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(
                np.float32)))
    users = torch.from_numpy(rng.integers(0, U + 1, (4096,)).astype(
        np.int32)).to(cuda)
    items = torch.from_numpy(rng.integers(0, I + 1, (4096, 2)).astype(
        np.int32)).to(cuda)
    before = (tgather.gather_rows.launches, tgather.scatter_add_rows.launches)
    (eu,), (ei,) = tables.lookup([users], [items])
    assert torch.equal(eu, tgather.gather_rows_plain(tables.user_table,
                                                     users))
    assert torch.equal(ei, tgather.gather_rows_plain(tables.item_table,
                                                     items))
    du = torch.from_numpy(rng.integers(-8, 9, (4096, W)).astype(
        np.float32)).to(cuda)
    di = torch.from_numpy(rng.integers(-8, 9, (4096, 2, W)).astype(
        np.float32)).to(cuda)
    gu, gi = torch.autograd.grad((eu * du).sum() + (ei * di).sum(),
                                 [tables.user_table, tables.item_table])
    torch.cuda.synchronize()
    assert (tgather.gather_rows.launches,
            tgather.scatter_add_rows.launches) == (before[0] + 2,
                                                   before[1] + 2)
    assert torch.equal(gu, torch.zeros_like(gu).index_add_(
        0, users.long(), du))
    assert torch.equal(gi, torch.zeros_like(gi).index_add_(
        0, items.reshape(-1).long(), di.reshape(-1, W)))
    served = tables.item_table.detach().bfloat16()
    ids = torch.from_numpy(rng.integers(0, I + 1, (16, 4096)).astype(
        np.int32)).to(cuda)
    assert torch.equal(tgather.gather_rows(served, ids),
                       tgather.gather_rows_plain(served, ids))


@pytest.mark.parametrize("name", ["baseline_pop", "baseline_mf",
                                  "baseline_svdpp", "baseline_delf",
                                  "baseline_gru4rec", "baseline_caser",
                                  "baseline_sasrec", "baseline_rrn"])
def test_roster_forward_and_step_on_card_match_cpu(cuda, name):
    """Each baseline preset at its own widths, f32: the candidates form
    (1 + 20 candidates) and then one full step (tables included) with its
    uniform negatives, on the card and on the CPU from the same weights
    (every zero-initialised leaf made non-zero), batch and raw negatives:
    the scores to 1e-4, the loss to 1e-5 and the parameters to rtol 1e-4
    / atol 1e-5, as test_uniform_step_on_card_matches_cpu holds the
    ladder; no co-attention kernel launches."""
    from score_tpu_torch.config import PRESETS
    from score_tpu_torch.data.pipeline import TargetIterator
    from score_tpu_torch.graph import device_graph, gather_candidate_batch
    from score_tpu_torch.params import init_params
    from score_tpu_torch.train import draw_negatives, init_state, train_step
    ds = _small_dataset()
    cfg = PRESETS[name]()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=256))
    gen = torch.Generator().manual_seed(0)
    sd = init_params(cfg, ds.num_users, ds.num_items, gen)
    for k, v in sd.items():
        if not v.any():
            sd[k] = torch.randn(v.shape, generator=gen) * 0.3
    batch = next(TargetIterator(ds.train, 256))
    negs = draw_negatives(gen, 256, cfg.data.num_train_neg, ds.num_items)
    cand = torch.cat([torch.from_numpy(batch["item"][:64, None]),
                      torch.randint(1, ds.num_items + 1, (64, 20),
                                    generator=gen, dtype=torch.int32)], 1)
    pair = (tpair.cross_coattn_pair.launches,
            tcand.cross_coattn_cand.launches)
    out = {}
    for device in (cuda, torch.device("cpu")):
        # a state on the CPU trains its weights in place: give it a copy
        st = init_state(cfg, ds.num_users, ds.num_items,
                        {k: v.clone() for k, v in sd.items()}, device=device)
        graph = device_graph(ds.graph, device)
        with torch.no_grad():
            scores = st.model.score_candidates(gather_candidate_batch(
                graph, *(torch.from_numpy(batch[k][:64]).to(device)
                         if k != "item" else cand.to(device)
                         for k in ("user", "item", "slot")),
                item_side=st.model.dual))
        st, m = train_step(st, graph, batch, negatives=negs)
        out[device.type] = (scores.cpu(), m["loss"].item(), {
            k: v.detach().cpu() for k, v in st.model.named_parameters()})
    assert pair == (tpair.cross_coattn_pair.launches,
                    tcand.cross_coattn_cand.launches)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-5,
                               atol=1e-6)
    for k, want in out["cpu"][2].items():
        if k.endswith("mha.key.bias"):
            # SASRec's key bias adds one constant to a query's logits, which
            # the softmax cancels: its gradient is zero in exact arithmetic,
            # roundoff on each device; each stays within one Adam step
            for got in (out["cuda"][2][k], want):
                assert (got - sd[k]).abs().max() <= cfg.train.learning_rate
            continue
        torch.testing.assert_close(out["cuda"][2][k], want, rtol=1e-4,
                                   atol=1e-5, msg=k)


@pytest.mark.parametrize("shape", [(64, 2), (64,)])
def test_stored_width_adjacency_gather(cuda, shape):
    """Re-sampling gathers the stored fan-out: int32 adjacency rows of
    T x S = 9 x 20 = 180 ints (720 B), bit-exact against the plain
    version."""
    rng = np.random.default_rng(180)
    table = torch.from_numpy(rng.integers(0, 2**30, (5000, 180)).astype(
        np.int32))
    ids = torch.from_numpy(rng.integers(0, 5000, shape).astype(np.int32))
    before = tgather.gather_rows.launches
    got = tgather.gather_rows(table.to(cuda), ids.to(cuda))
    torch.cuda.synchronize()
    assert tgather.gather_rows.launches == before + 1
    assert torch.equal(got.cpu(), tgather.gather_rows_plain(table, ids))


def _trainer_steps(cfg, ds, device, batches, masks=None, keys=None):
    """3 steps of `cfg` on `device` from init_params(seed 0) with the
    attention weights made non-zero; returns the losses and the params on
    the CPU."""
    from score_tpu_torch.graph import device_graph
    from score_tpu_torch.params import init_params
    from score_tpu_torch.train import (init_state, item_importance_weights,
                                       train_step)
    gen = torch.Generator().manual_seed(0)
    sd = init_params(cfg, ds.num_users, ds.num_items, gen)
    for k in sd:
        if k.startswith("coattn.") or k.endswith(".w"):
            sd[k] = torch.randn(sd[k].shape, generator=gen) * 0.3
    st = init_state(cfg, ds.num_users, ds.num_items, sd, device=device,
                    steps_per_epoch=3)
    graph = device_graph(ds.graph, device)
    neg_iw = torch.from_numpy(item_importance_weights(ds.train, ds.num_items))
    losses = []
    for j, b in enumerate(batches):
        st, m = train_step(
            st, graph, b, [17 + j], neg_iw.to(device),
            dropout_masks=None if masks is None else masks[j],
            resample_keys=None if keys is None else keys[j])
        losses.append(m["loss"].item())
    return losses, {k: v.detach().cpu()
                    for k, v in st.model.named_parameters()}


def _card_vs_cpu(card, cpu):
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5, atol=1e-6)
    for k, want in cpu[1].items():
        torch.testing.assert_close(card[1][k], want, rtol=1e-4, atol=1e-5,
                                   msg=k)


@pytest.mark.parametrize("opt", [dict(optimizer="adam", warmup_steps=2),
                                 dict(optimizer="adamw", weight_decay=1e-4,
                                      lr_schedule="cosine", warmup_steps=1),
                                 dict(optimizer="adagrad",
                                      learning_rate=1e-2,
                                      lr_schedule="cosine"),
                                 dict(optimizer="sgd", learning_rate=0.5)])
def test_optimizer_steps_on_card_match_cpu(cuda, opt):
    """3 stride-2 steps of each optimizer and schedule, f32, batch 256, on
    the card and on the CPU: the losses to 1e-5 and the parameters to
    rtol 1e-4 / atol 1e-5, as chip_smoke.py holds its 3 steps."""
    from score_tpu_torch.data.pipeline import TargetIterator
    ds = _small_dataset()
    cfg = _small_cfg(**opt)
    it = TargetIterator(ds.train, 256)
    batches = [next(it) for _ in range(3)]
    _card_vs_cpu(_trainer_steps(cfg, ds, cuda, batches),
                 _trainer_steps(cfg, ds, torch.device("cpu"), batches))


def test_dropout_masks_on_card(cuda):
    """Scorer dropout 0.1 drawing its masks on the card: two runs draw
    the same masks (their first steps' losses are bit-equal; the later
    steps' tables come from the scatter-add's f32 atomics, which add in
    no fixed order); the first hidden layer drops about 10%; and with
    masks made on the host, 3 steps on the card agree with the CPU's."""
    from score_tpu_torch.data.pipeline import TargetIterator
    from score_tpu_torch.train import _step_generator
    ds = _small_dataset()
    cfg = _small_cfg()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.1))
    it = TargetIterator(ds.train, 256)
    batches = [next(it) for _ in range(3)]
    a = _trainer_steps(cfg, ds, cuda, batches)
    b = _trainer_steps(cfg, ds, cuda, batches)
    assert a[0][0] == b[0][0]
    g = _step_generator(cfg.train.seed, 0, 1, cuda)
    keep = torch.rand(4096, 2, 128, generator=g, device=cuda) < 0.9
    assert abs(1 - keep.float().mean().item() - 0.1) < 0.01
    gen = torch.Generator().manual_seed(5)
    masks = [[torch.rand(256, 2, w, generator=gen) < 0.9
              for w in cfg.model.mlp_dims] for _ in range(3)]
    _card_vs_cpu(
        _trainer_steps(cfg, ds, cuda, batches,
                       [[m.to(cuda) for m in ms] for ms in masks]),
        _trainer_steps(cfg, ds, torch.device("cpu"), batches, masks))


def test_resampling_steps_on_card_match_cpu(cuda):
    """Re-sampling the stored fan-out 6 down to 3 from the same keys: 3
    steps on the card and on the CPU agree; two runs drawing the keys on
    the card draw the same ones (their first steps' losses are
    bit-equal)."""
    from score_tpu_torch.data.pipeline import TargetIterator
    ds = _small_dataset()
    cfg = _small_cfg()
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, user_fanout=3, item_fanout=3, neighbor_resample=True))
    it = TargetIterator(ds.train, 256)
    batches = [next(it) for _ in range(3)]
    gen = torch.Generator().manual_seed(6)
    T = ds.graph.num_slots
    keys = [[torch.rand(256, T, 6, generator=gen),
             torch.rand(256, 1, T, 6, generator=gen)] for _ in range(3)]
    _card_vs_cpu(_trainer_steps(cfg, ds, cuda, batches, keys=keys),
                 _trainer_steps(cfg, ds, torch.device("cpu"), batches,
                                keys=keys))
    a = _trainer_steps(cfg, ds, cuda, batches)
    b = _trainer_steps(cfg, ds, cuda, batches)
    assert a[0][0] == b[0][0]


@pytest.mark.parametrize("mode", ["a2a", "psum"])
def test_sharded_lookup_in_a_one_rank_nccl_world(cuda, tmp_path, mode):
    """The a2a (at its exact capacity and at one below the unique count)
    and psum lookups in a one-rank NCCL world, its exchanges over NCCL:
    rows bit-equal to gather_rows, the table gradient within 1e-5
    relative to the largest value of the plain scatter-add's (f32 atomics
    add in no fixed order); the gather and scatter-add kernels launched,
    and the overflow the uniques past the capacity."""
    import torch.distributed as dist
    from score_tpu_torch import sharding
    mesh, fn = sharding.bringup(None, init_method=f"file://{tmp_path}/st",
                                world_size=1, rank=0, device="cuda")
    try:
        assert fn is None and mesh.device.type == "cuda"
        rng = np.random.default_rng(11)
        table = torch.from_numpy(rng.normal(size=(1000, 32)).astype(
            np.float32)).to(cuda).requires_grad_(True)
        ids = torch.from_numpy(rng.integers(0, 1000, (64, 9, 10)).astype(
            np.int32)).to(cuda)
        w = torch.randn(64, 9, 10, 32, device=cuda)
        want = tgather.gather_rows(table.detach(), ids)
        g_want = tgather.scatter_add_rows_plain(ids.cpu(), w.cpu(), 1000)
        n_uniq = int(torch.unique(ids).numel())
        for capacity in ((0, n_uniq - 1) if mode == "a2a" else (0,)):
            before = (tgather.gather_rows.launches,
                      tgather.scatter_add_rows.launches)
            if mode == "a2a":
                out, ovf = sharding.a2a_lookup(mesh, table, ids, capacity,
                                               with_overflow=True)
                assert int(ovf) == (1 if capacity else 0)
            else:
                out = sharding.psum_lookup(mesh, table, ids)
            (g,) = torch.autograd.grad((out * w).sum(), [table])
            torch.cuda.synchronize()
            assert tgather.gather_rows.launches > before[0]
            assert tgather.scatter_add_rows.launches > before[1]
            if capacity:
                continue        # aliased rows: only the count is right
            assert torch.equal(out, want)
            scale = max(g_want.abs().max().item(), 1.0)
            torch.testing.assert_close(g.cpu(), g_want, rtol=1e-5,
                                       atol=1e-5 * scale)
    finally:
        dist.destroy_process_group()
