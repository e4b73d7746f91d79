"""The GRU's two routes (score_tpu_torch/kernels/gru.py), on the CPU.

`gru_fwd_plain` is the op-by-op loop that `nn.encoder.GRU.forward` ran
before the recurrence had a kernel, moved verbatim: it and the module's
CPU output are held bit for bit to that loop, kept here as it was, in bf16
and f32, forward and gradients. The route is a pure function of what the
module can observe (device, dtype, widths, whether a gradient is needed),
tested here; the module's grad-mode reading is tested by a spy. The
kernel itself runs only on a card (tests/test_torch_cuda.py)."""

import zlib

import numpy as np
import pytest
import torch

from score_tpu_torch.kernels import gru
from score_tpu_torch.nn.encoder import GRU


def _loop_before(module: GRU, xs: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """GRU.forward as it was before the kernel, verbatim."""
    B, T, d = xs.shape
    dt = xs.dtype
    Wx, Wh, b = module.wx.to(dt), module.wh.to(dt), module.b.to(dt)
    # the input projection of every step in one product
    gx_all = (xs.reshape(B * T, d) @ Wx + b).reshape(B, T, -1)
    f = Wh.shape[0]
    h = torch.zeros(B, f, dtype=dt, device=xs.device)
    hs = []
    for t in range(T):
        gx_zr, gx_c = gx_all[:, t].split([2 * f, f], dim=-1)
        gh_zr, gh_c = (h @ Wh).split([2 * f, f], dim=-1)
        z, r = gru._sigmoid(gx_zr + gh_zr).chunk(2, dim=-1)  # one call
        c = torch.tanh(gx_c + r * gh_c)
        h = torch.where(mask[:, t, None], (1.0 - z) * h + z * c, h)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _mask(kind: str, B: int, T: int, rng) -> torch.Tensor:
    t = np.arange(T)[None]
    k = rng.integers(1, T + 1, (B, 1))
    masks = {"all": np.ones((B, T), bool), "prefix": t < k,
             "leading": t >= k - 1, "interior": rng.random((B, T)) < 0.6,
             "none": np.zeros((B, T), bool)}
    if kind == "mixed":
        rows = np.arange(B)[:, None] % 5
        mixed = np.select([rows == i for i in range(5)], list(masks.values()))
        return torch.from_numpy(mixed.astype(bool))
    return torch.from_numpy(masks[kind])


def _module(d: int, f: int, rng) -> GRU:
    m = GRU(d, f)
    with torch.no_grad():
        for p, scale in ((m.wx, d ** -0.5), (m.wh, f ** -0.5), (m.b, 0.1)):
            p.copy_(torch.from_numpy(rng.normal(size=p.shape) * scale))
    return m


@pytest.mark.parametrize("kind", ["all", "prefix", "leading", "interior",
                                  "none", "mixed"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_is_the_loop_before_bit_for_bit(kind, dtype):
    """gru_fwd_plain and the module on the CPU give the old loop's states
    bit for bit, and the same gradients of the weights and inputs."""
    rng = np.random.default_rng(zlib.crc32(f"{kind} {dtype}".encode()))
    B, T, d, f = 37, 9, 16, 24
    m = _module(d, f, rng)
    xs = torch.from_numpy(rng.normal(size=(B, T, d))).to(dtype)
    mask = _mask(kind, B, T, rng)
    want = _loop_before(m, xs, mask)
    launches = (gru.gru_fwd.launches, gru.gru_fwd.plain_calls)
    got = m(xs, mask)
    dt = dtype
    plain = gru.gru_fwd_plain(xs, mask, m.wx.to(dt), m.wh.to(dt),
                              m.b.to(dt))
    assert (gru.gru_fwd.launches, gru.gru_fwd.plain_calls) == launches
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(plain, want)
    if kind == "none":
        assert not got.any()
    # gradients through the module and through the old loop
    g = torch.from_numpy(rng.normal(size=(B, T, f))).to(dtype)
    grads = []
    for fn in (lambda x: m(x, mask), lambda x: _loop_before(m, x, mask)):
        m.zero_grad()
        x = xs.clone().requires_grad_(True)
        (fn(x) * g).sum().backward()
        grads.append([x.grad, m.wx.grad, m.wh.grad, m.b.grad])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device,dtype,d,f,needs_grad,want", [
    ("cuda", torch.bfloat16, 32, 64, False, True),   # serving and eval
    ("cuda", torch.bfloat16, 16, 16, False, True),
    ("cuda", torch.bfloat16, 128, 128, False, True),
    ("cuda", torch.bfloat16, 128, 16, False, True),
    ("cuda", torch.bfloat16, 32, 64, True, False),   # training
    ("cpu", torch.bfloat16, 32, 64, False, False),
    ("cpu", torch.float32, 32, 64, False, False),
    ("cuda", torch.float32, 32, 64, False, False),   # f32 compute
    ("cuda", torch.float16, 32, 64, False, False),
    ("cuda", torch.bfloat16, 24, 64, False, False),  # off the 16 grid
    ("cuda", torch.bfloat16, 32, 40, False, False),
    ("cuda", torch.bfloat16, 144, 64, False, False),  # past 128
    ("cuda", torch.bfloat16, 32, 256, False, False),
    ("cuda", torch.bfloat16, 8, 64, False, False),
])
def test_route(device, dtype, d, f, needs_grad, want):
    assert gru.uses_kernel(device, dtype, d, f, needs_grad) is want


@pytest.mark.parametrize("mode,want", [
    ("grad", True),            # a training step: the weights need grads
    ("no_grad", False),
    ("inference_mode", False),
    ("frozen", False),         # grad mode on, nothing requires a grad
    ("input_grad", True),      # frozen weights, an input that needs one
])
def test_module_reads_the_grad_mode(monkeypatch, mode, want):
    """The module passes the route whether autograd needs anything of this
    call: grad mode on and xs or a weight requiring a gradient."""
    seen = []

    def spy(*args):
        seen.append(args)
        return False                     # the CPU runs the plain path

    monkeypatch.setattr(gru, "uses_kernel", spy)
    rng = np.random.default_rng(3)
    m = _module(16, 32, rng)
    xs = torch.from_numpy(rng.normal(size=(5, 4, 16))).to(torch.bfloat16)
    mask = _mask("mixed", 5, 4, rng)
    if mode in ("frozen", "input_grad"):
        m.requires_grad_(False)
    if mode == "input_grad":
        xs.requires_grad_(True)
    if mode == "no_grad":
        with torch.no_grad():
            m(xs, mask)
    elif mode == "inference_mode":
        with torch.inference_mode():
            m(xs, mask)
    else:
        m(xs, mask)
    assert seen == [("cpu", torch.bfloat16, 16, 32, want)]


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("f", [16, 32, 64, 128])
@pytest.mark.parametrize("T", [1, 9, 200])
def test_launch_shape_fits_shared_memory(T, d, f):
    """Every width the route sends to the kernel has a launch whose block
    fits the H100's 227 KB, with 1-8 warps and chunks of 1..T steps."""
    warps, tc = gru.launch_shape(T, d, f)
    assert 1 <= warps <= 8 and 1 <= tc <= T
    assert gru.smem_bytes(d, f, warps, tc) <= 232448


def test_launch_shape_at_the_serving_width():
    """d=32, f=64, T=9: two blocks of 8 warps an SM, chunks of 3 steps."""
    assert gru.launch_shape(9, 32, 64) == (8, 3)
    assert 2 * (gru.smem_bytes(32, 64, 8, 3) + 1024) <= 233472
    assert 2 * (gru.smem_bytes(32, 64, 8, 4) + 1024) > 233472


def test_kernel_wrapper_refuses_the_cpu():
    """The wrapper launches on a CUDA device or raises: no fallback."""
    xs = torch.zeros(4, 9, 32, dtype=torch.bfloat16)
    mask = torch.ones(4, 9, dtype=torch.bool)
    Wx = torch.zeros(32, 192, dtype=torch.bfloat16)
    Wh = torch.zeros(64, 192, dtype=torch.bfloat16)
    b = torch.zeros(192, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        gru.gru_fwd(xs, mask, Wx, Wh, b)
