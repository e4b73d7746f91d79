"""Candidates-form co-attention (sum pool), forward and backward.

Counterpart of score_tpu/kernels/coattn_cand.py:cross_coattn_cand, whose
forward is `_cand_fwd` and whose VJP is `_cand_bwd`. On CUDA tensors
`cross_coattn_cand` launches the hand-written kernel in
`score_tpu_torch/csrc/coattn_cand.cu`, and its backward
`cross_coattn_cand_bwd` the one in `score_tpu_torch/csrc/coattn_cand_bwd.cu`
(each source note says what bounds it on the H100 and how the design meets
that); past d, n or m = 32 they launch the wide kernels of
`kernels/coattn_wide.py` instead. On CPU tensors they run the plain
versions:
`cross_coattn_cand_plain`, a torch copy of the JAX package's
`cross_coattn_cand_ref`, and `cross_coattn_cand_bwd_plain`, the same VJP
formulas written out in torch. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .coattn_wide import (_DTYPE_CODE, MAX_WIDE_DIM, MAX_WIDE_ROWS,
                          cross_coattn_wide, cross_coattn_wide_bwd)

_NEG = -1e9
_ARGTYPES = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 16 + (ctypes.c_int,) * 8
                 + (ctypes.c_void_p,))
MAX_DIM = 32          # the tuned kernels: d, n and m at most one warp wide


def _smax(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    s = torch.where(mask > 0, s, _NEG)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s) * mask
    return e / e.sum(dim=-1, keepdim=True).clamp_min(1e-20)


def cross_coattn_cand_plain(Eu, Ei, mu, mi, Wr, eu, ei,
                            target_aware: bool = True):
    """Plain (non-reassociated) candidates-form co-attention, f32 inside.
    Eu [B,T,n,d], Ei [B,C,T,m,d], mu [B,T,n], mi [B,C,T,m], Wr [d,d],
    eu [B,d], ei [B,C,d] -> cu, ci [B,C,T,d] in Eu's dtype."""
    d = Eu.shape[-1]
    scale = 1.0 / float(d) ** 0.5
    out_dt = Eu.dtype
    Eu, Ei = Eu.float(), Ei.float()
    muf, mif = mu.float(), mi.float()
    EuW = torch.einsum("btnd,de->btne", Eu, Wr.float())
    EuW_sum = (EuW * muf[..., None]).sum(dim=2)                  # [B,T,d]
    Ei_sum = (Ei * mif[..., None]).sum(dim=3)                    # [B,C,T,d]
    su = torch.einsum("btnd,bctd->bctn", EuW, Ei_sum) * scale
    si = torch.einsum("bctmd,btd->bctm", Ei, EuW_sum) * scale
    if target_aware:
        su = su + torch.einsum("btnd,bcd->bctn", Eu, ei.float()) * scale
        si = si + torch.einsum("bctmd,bd->bctm", Ei, eu.float()) * scale
    a = _smax(su, muf[:, None])
    b = _smax(si, mif)
    cu = torch.einsum("bctn,btnd->bctd", a, Eu)
    ci = torch.einsum("bctm,bctmd->bctd", b, Ei)
    return cu.to(out_dt), ci.to(out_dt)


def cross_coattn_cand_bwd_plain(Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci,
                                target_aware: bool = True):
    """The VJP of `cross_coattn_cand_plain`, written out as the fused
    kernels compute it (score_tpu/kernels/coattn_cand.py:_cand_bwd_kernel),
    f32 inside. Returns dEu [B,T,n,d], dEi [B,C,T,m,d], deu [B,d] and
    dei [B,C,d] in the inputs' dtypes (deu and dei are zeros when not
    target-aware) and dWr [d,d] in f32. The masks get no gradient."""
    d = Eu.shape[-1]
    scale = 1.0 / float(d) ** 0.5
    f32 = torch.float32
    Eu32, Ei32, Wr32 = Eu.float(), Ei.float(), Wr.float()
    muf, mif = mu.to(f32), mi.to(f32)
    g_cu, g_ci = dcu.float(), dci.float()
    Em = (Eu32 * muf[..., None]).sum(dim=2)                      # [B,T,d]
    Es = (Ei32 * mif[..., None]).sum(dim=3)                      # [B,C,T,d]
    w = Em @ Wr32
    v = Es @ Wr32.T
    if target_aware:
        w = w + eu.float()[:, None]
        v = v + ei.float()[:, :, None]
    a = _smax(torch.einsum("btnd,bctd->bctn", Eu32, v) * scale, muf[:, None])
    b = _smax(torch.einsum("bctmd,btd->bctm", Ei32, w) * scale, mif)
    da = torch.einsum("btnd,bctd->bctn", Eu32, g_cu)
    db = torch.einsum("bctmd,bctd->bctm", Ei32, g_ci)
    dsu = a * (da - (a * da).sum(dim=-1, keepdim=True))
    dsi = b * (db - (b * db).sum(dim=-1, keepdim=True))
    dv = scale * torch.einsum("bctn,btnd->bctd", dsu, Eu32)
    dw = scale * torch.einsum("bctm,bctmd->btd", dsi, Ei32)
    dEu = (torch.einsum("bctn,bctd->btnd", a, g_cu)
           + scale * torch.einsum("bctn,bctd->btnd", dsu, v)
           + muf[..., None] * (dw @ Wr32.T)[:, :, None])
    dEi = (b[..., None] * g_ci[:, :, :, None]
           + scale * dsi[..., None] * w[:, None, :, None]
           + mif[..., None] * (dv @ Wr32)[:, :, :, None])
    dWr = (torch.einsum("bctd,bcte->de", dv, Es)
           + torch.einsum("btd,bte->de", Em, dw))
    if target_aware:
        deu, dei = dw.sum(dim=1), dv.sum(dim=2)
    else:
        deu, dei = torch.zeros_like(eu), torch.zeros_like(ei)
    return (dEu.to(Eu.dtype), dEi.to(Ei.dtype), deu.to(eu.dtype),
            dei.to(ei.dtype), dWr)


def tuned(name, n: int, m: int, d: int) -> bool:
    """Which hand-written kernels take this shape on the card: True for
    the tuned ones (d, n, m <= MAX_DIM), False for the wide ones
    (kernels/coattn_wide.py: d <= MAX_WIDE_DIM, n, m <= MAX_WIDE_ROWS);
    ValueError beyond."""
    if d <= MAX_DIM and n <= MAX_DIM and m <= MAX_DIM:
        return True
    if d <= MAX_WIDE_DIM and n <= MAX_WIDE_ROWS and m <= MAX_WIDE_ROWS:
        return False
    raise ValueError(f"{name}: needs d <= {MAX_WIDE_DIM} and n, m <= "
                     f"{MAX_WIDE_ROWS}, got d={d} n={n} m={m}")


def _check(name, Eu, Ei, mu, mi, Wr, eu, ei, *grads):
    """Raise unless the inputs are what the CUDA kernels take (their sizes
    `tuned` checks); return (B, C, T, n, m, d)."""
    B, T, n, d = Eu.shape
    C, m = Ei.shape[1], Ei.shape[3]
    dev = Eu.device
    if dev.type != "cuda" or any(x.device != dev
                                 for x in (Ei, mu, mi, Wr, eu, ei, *grads)):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if Eu.dtype not in _DTYPE_CODE or any(x.dtype != Eu.dtype
                                          for x in (Ei, eu, ei, *grads)):
        raise ValueError(f"{name}: Eu, Ei, eu, ei and the output gradients "
                         f"must share one dtype, float32 or bfloat16")
    if mu.dtype != torch.bool or mi.dtype != torch.bool:
        raise ValueError(f"{name}: masks must be bool")
    if min(d, n, m) < 1:
        raise ValueError(f"{name}: needs d, n, m >= 1, got d={d} n={n} "
                         f"m={m}")
    shapes = {"Ei": (Ei.shape, (B, C, T, m, d)),
              "mu": (mu.shape, (B, T, n)), "mi": (mi.shape, (B, C, T, m)),
              "Wr": (Wr.shape, (d, d)), "eu": (eu.shape, (B, d)),
              "ei": (ei.shape, (B, C, d))}
    for i, g in enumerate(grads):
        shapes[f"d{'cu' if i == 0 else 'ci'}"] = (g.shape, (B, C, T, d))
    for key, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"{name}: {key} has shape {tuple(got)}, "
                             f"expected {want}")
    return B, C, T, n, m, d


def _cand_fwd_launch(Eu, Ei, mu, mi, Wr, eu, ei, target_aware):
    """The forward itself: the CUDA kernel, or the plain version on the
    CPU."""
    if Eu.device.type == "cpu":
        return cross_coattn_cand_plain(Eu, Ei, mu, mi, Wr, eu, ei,
                                       target_aware)
    B, C, T, n, m, d = _check("cross_coattn_cand", Eu, Ei, mu, mi, Wr, eu,
                              ei)
    if not tuned("cross_coattn_cand", n, m, d):
        return cross_coattn_wide(Eu, Ei, mu, mi, Wr, eu, ei, "sum",
                                 target_aware)
    dev = Eu.device
    args = [x.contiguous() for x in (Eu, Ei, mu, mi)]
    Wr32 = Wr.float().contiguous()
    eu_c, ei_c = eu.contiguous(), ei.contiguous()
    cu = torch.empty(B, C, T, d, dtype=Eu.dtype, device=dev)
    ci = torch.empty_like(cu)
    if cu.numel() == 0:
        return cu, ci
    _build.launch("coattn_cand",
                  _build.load("coattn_cand", "cand_fwd", _ARGTYPES),
                  dev.index, *(x.data_ptr() for x in args), Wr32.data_ptr(),
                  eu_c.data_ptr(), ei_c.data_ptr(), cu.data_ptr(),
                  ci.data_ptr(), B, C, T, n, m, d, int(target_aware),
                  _DTYPE_CODE[Eu.dtype])
    cross_coattn_cand.launches += 1
    return cu, ci


def cross_coattn_cand_bwd(Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci,
                          target_aware: bool = True):
    """Fused backward of `cross_coattn_cand`: from dcu, dci [B,C,T,d] (the
    output gradients, in Eu's dtype) -> dEu, dEi, deu, dei in the inputs'
    dtype and dWr [d,d] in f32, as `cross_coattn_cand_bwd_plain`. The
    forward is recomputed from the inputs, computed in f32."""
    if Eu.device.type == "cpu":
        return cross_coattn_cand_bwd_plain(Eu, Ei, mu, mi, Wr, eu, ei, dcu,
                                           dci, target_aware)
    B, C, T, n, m, d = _check("cross_coattn_cand_bwd", Eu, Ei, mu, mi, Wr,
                              eu, ei, dcu, dci)
    if not tuned("cross_coattn_cand_bwd", n, m, d):
        return cross_coattn_wide_bwd(Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci,
                                     "sum", target_aware)
    dev = Eu.device
    dWr = torch.zeros(d, d, dtype=torch.float32, device=dev)
    if B * C * T == 0:
        return (torch.zeros_like(Eu), torch.zeros_like(Ei),
                torch.zeros_like(eu), torch.zeros_like(ei), dWr)
    ins = [x.contiguous() for x in (Eu, Ei, mu, mi)]
    Wr32 = Wr.float().contiguous()
    rest = [x.contiguous() for x in (eu, ei, dcu, dci)]
    dEu, dEi = torch.empty_like(ins[0]), torch.empty_like(ins[1])
    deu, dei = torch.empty_like(rest[0]), torch.empty_like(rest[1])
    dei_acc = torch.empty(B, C, d, dtype=torch.float32, device=dev)
    parts = _build.load("coattn_cand_bwd", "cand_bwd_num_partials",
                        (ctypes.c_int,))(B)
    dWr_part = torch.empty(parts, d, d, dtype=torch.float32, device=dev)
    _build.launch("coattn_cand_bwd",
                  _build.load("coattn_cand_bwd", "cand_bwd", _BWD_ARGTYPES),
                  dev.index, *(x.data_ptr() for x in ins), Wr32.data_ptr(),
                  *(x.data_ptr() for x in rest),
                  *(x.data_ptr() for x in (dEu, dEi, deu, dei, dei_acc,
                                           dWr_part, dWr)),
                  B, C, T, n, m, d, int(target_aware), _DTYPE_CODE[Eu.dtype])
    cross_coattn_cand_bwd.launches += 1
    return dEu, dEi, deu, dei, dWr


class _CrossCoattnCand(torch.autograd.Function):
    """The fused forward, with the fused backward as its VJP."""

    @staticmethod
    def forward(ctx, Eu, Ei, mu, mi, Wr, eu, ei, target_aware):
        ctx.save_for_backward(Eu, Ei, mu, mi, Wr, eu, ei)
        ctx.target_aware = target_aware
        return _cand_fwd_launch(Eu, Ei, mu, mi, Wr, eu, ei, target_aware)

    @staticmethod
    def backward(ctx, dcu, dci):
        Eu, Ei, mu, mi, Wr, eu, ei = ctx.saved_tensors
        dEu, dEi, deu, dei, dWr = cross_coattn_cand_bwd(
            Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci, ctx.target_aware)
        return dEu, dEi, None, None, dWr.to(Wr.dtype), deu, dei, None


def cross_coattn_cand(Eu, Ei, mu, mi, Wr, eu, ei, target_aware: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused candidates-form co-attention (sum pool).

    Eu [B,T,n,d] (the user side, shared by the C candidates and read once
    per (b, t)), Ei [B,C,T,m,d], bool mu [B,T,n] and mi [B,C,T,m],
    Wr [d,d], target-projected eu [B,d] and ei [B,C,d] -> cu, ci [B,C,T,d]
    in Eu's dtype (f32 or bf16), computed in f32. Differentiable in Eu, Ei,
    Wr, eu and ei through `cross_coattn_cand_bwd`."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (Eu, Ei, Wr, eu, ei)):
        return _CrossCoattnCand.apply(Eu, Ei, mu, mi, Wr, eu, ei,
                                      target_aware)
    return _cand_fwd_launch(Eu, Ei, mu, mi, Wr, eu, ei, target_aware)


cross_coattn_cand.launches = 0
cross_coattn_cand_bwd.launches = 0
