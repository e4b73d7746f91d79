"""The GRU recurrence over T slots, forward only, for the encoders'
inference path.

Counterpart of the cell that score_tpu/nn/encoder.py:GRU runs under
`lax.scan`, where XLA fuses each step's elementwise ops into the two gate
products (there is no Pallas kernel). `gru_fwd` launches the hand-written
kernel in `score_tpu_torch/csrc/gru.cu`: one launch for all T steps, with
the input projection and the gates in registers; its source note says
what bounds it on the H100 and how the design meets that.
`gru_fwd_plain` is the op-by-op version (~14 torch kernels a step): the
path of the CPU, of f32 compute, of other widths and of training.
`uses_kernel` is the rule `nn.encoder.GRU` routes by, from what it can
observe of its input; there is no fallback from one path to the other.

`gru_fwd.launches` counts the kernel's launches and `gru_fwd.plain_calls`
the GRU calls on a CUDA device that took the op-by-op path.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

MAX_WIDTH = 128       # d and f: multiples of 16 up to this
_SMEM_LIMIT = 232448  # shared memory a block may use on the H100
_SM_SMEM = 233472     # an SM's, of which each resident block reserves 1 KB
_BLOCK_RESERVED = 1024
_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_longlong,)
             + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))


class _Logistic(torch.autograd.Function):
    """The logistic function in bf16 as the reference's lowering computes
    it, 1 / (1 + exp(-x)) with every op rounded to bf16 (torch.sigmoid
    rounds once, and differs in the last bit on many inputs); its
    gradient g * y * (1 - y), JAX's rule and torch.sigmoid's kernel."""

    @staticmethod
    def forward(ctx, x):
        y = torch.exp(-x).add_(1.0).reciprocal_()
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.ops.aten.sigmoid_backward(g, y)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        return _Logistic.apply(x)
    return torch.sigmoid(x)


def gru_fwd_plain(xs: torch.Tensor, mask: torch.Tensor, Wx: torch.Tensor,
                  Wh: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """xs [B, T, d], mask [B, T] bool, Wx [d, 3f], Wh [f, 3f], b [3f], all
    in xs's dtype -> hs [B, T, f], op by op (differentiable)."""
    B, T, d = xs.shape
    dt = xs.dtype
    # the input projection of every step in one product
    gx_all = (xs.reshape(B * T, d) @ Wx + b).reshape(B, T, -1)
    f = Wh.shape[0]
    h = torch.zeros(B, f, dtype=dt, device=xs.device)
    hs = []
    for t in range(T):
        gx_zr, gx_c = gx_all[:, t].split([2 * f, f], dim=-1)
        gh_zr, gh_c = (h @ Wh).split([2 * f, f], dim=-1)
        z, r = _sigmoid(gx_zr + gh_zr).chunk(2, dim=-1)  # one call
        c = torch.tanh(gx_c + r * gh_c)
        h = torch.where(mask[:, t, None], (1.0 - z) * h + z * c, h)
        hs.append(h)
    return torch.stack(hs, dim=1)


def uses_kernel(device_type: str, dtype: torch.dtype, d: int, f: int,
                needs_grad: bool) -> bool:
    """Whether a GRU call takes the kernel: on a CUDA device, in bf16, at
    d and f multiples of 16 up to MAX_WIDTH, with no gradient to keep."""
    return (device_type == "cuda" and dtype == torch.bfloat16
            and not needs_grad
            and all(w % 16 == 0 and 16 <= w <= MAX_WIDTH for w in (d, f)))


def smem_bytes(d: int, f: int, warps: int, tc: int) -> int:
    """Shared memory of a block of the kernel (gru.cu's layout): [Wx; Wh]
    as bf16 fragments and b in f32, then each warp's two x chunk buffers
    of 16 rows x tc steps and its output staging, rows padded by 16 B."""
    weights = (d + f) * 3 * f * 2 + 3 * f * 4
    warp = 2 * 16 * (tc * d * 2 + 16) + 16 * (f * 2 + 16)
    return weights + warps * warp


def launch_shape(T: int, d: int, f: int) -> Tuple[int, int]:
    """(warps a block, steps a chunk) of a launch: 8 warps and the longest
    chunk, up to T steps, with which two such blocks share an SM's shared
    memory (16 warps an SM hide the products' and gates' latency: on an
    H100 at the serving shape, chunks of 3 steps so took 0.355 ms, all 9
    at one block an SM 0.417); else the longest chunk one block of 8 warps
    holds; else fewer warps."""
    for blocks, warps in ((2, 8), (1, 8), (1, 4), (1, 2), (1, 1)):
        limit = min(_SMEM_LIMIT, _SM_SMEM // blocks - _BLOCK_RESERVED)
        for tc in range(T, 0, -1):
            if smem_bytes(d, f, warps, tc) <= limit:
                return warps, tc
    raise ValueError(f"gru_fwd: no launch fits d={d}, f={f}")


def gru_fwd(xs: torch.Tensor, mask: torch.Tensor, Wx: torch.Tensor,
            Wh: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel: xs [N, T, d] bf16, mask [N, T] bool, Wx [d, 3f], Wh
    [f, 3f], b [3f] bf16, all on one CUDA device -> hs [N, T, f] bf16, as
    `gru_fwd_plain` computes it with f32 gates (see gru.cu)."""
    N, T, d = xs.shape
    f = Wh.shape[0]
    index = xs.get_device()
    if not xs.is_cuda or any(t.get_device() != index
                             for t in (mask, Wx, Wh, b)):
        raise ValueError("gru_fwd: all tensors must be on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (xs, Wx, Wh, b)):
        raise ValueError("gru_fwd: xs, Wx, Wh and b must be bfloat16")
    if mask.dtype != torch.bool or tuple(mask.shape) != (N, T):
        raise ValueError(f"gru_fwd: mask must be bool [{N}, {T}], got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if (tuple(Wx.shape) != (d, 3 * f) or tuple(Wh.shape) != (f, 3 * f)
            or tuple(b.shape) != (3 * f,)):
        raise ValueError(f"gru_fwd: Wx {tuple(Wx.shape)}, Wh "
                         f"{tuple(Wh.shape)}, b {tuple(b.shape)} do not fit "
                         f"d={d}, f={f}")
    if not uses_kernel("cuda", xs.dtype, d, f, False):
        raise ValueError(f"gru_fwd: d={d} and f={f} must be multiples of 16 "
                         f"up to {MAX_WIDTH}")
    xs = xs.contiguous()
    if xs.data_ptr() % 16:
        xs = xs.clone()
    mask, Wx, Wh, b = (t.contiguous() for t in (mask, Wx, Wh, b))
    hs = xs.new_empty((N, T, f))
    if hs.numel() == 0:
        return hs
    warps, tc = launch_shape(T, d, f)
    _build.launch("gru", _build.load("gru", "gru_fwd", _ARGTYPES), index,
                  xs.data_ptr(), mask.data_ptr(), Wx.data_ptr(),
                  Wh.data_ptr(), b.data_ptr(), hs.data_ptr(), N, T, d, f,
                  warps, tc)
    gru_fwd.launches += 1
    return hs


gru_fwd.launches = 0
gru_fwd.plain_calls = 0
