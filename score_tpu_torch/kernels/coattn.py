"""Per-pair co-attention (sum, mean and max pools), forward and backward.

Counterpart of score_tpu/kernels/coattn.py:cross_coattn_pallas, whose
forward is `_coattn_fwd_pallas` and whose VJP is `_coattn_bwd_pallas` for
the sum and mean pools and a recompute VJP of the jnp reference for max.

The public function takes the candidates form: the user side Eu is shared
by the C candidates and read in place, where the JAX package tiles it C
times (score_tpu/nn/coattn.py); with C == 1 it is `cross_coattn_pallas`
itself. On CUDA tensors `cross_coattn_pair` launches the hand-written
kernel in `score_tpu_torch/csrc/coattn_pair.cu`, and its backward
`cross_coattn_pair_bwd` (sum and mean) the one in
`score_tpu_torch/csrc/coattn_pair_bwd.cu`; each source note says what
bounds it on the H100 and how the design meets that; past d, n or m =
32 both launch the wide kernels of `kernels/coattn_wide.py`. The max pool's
backward, as in the JAX package, is autograd through the plain forward
(`amax`, which splits the gradient evenly among tied maxima, as JAX's
`reduce_max` VJP does). On CPU tensors the wrappers run the plain
versions: `cross_coattn_pair_plain`, a torch copy of
`score_tpu.nn.coattn.cross_coattn_ref` in the candidates form, and
`cross_coattn_pair_bwd_plain`, the fused VJP formulas of
`_coattn_bwd_kernel` written out in torch. There is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .coattn_cand import _DTYPE_CODE, _NEG, _check, _smax, tuned
from .coattn_wide import cross_coattn_wide, cross_coattn_wide_bwd

POOLS = ("sum", "mean", "max")
_POOL_CODE = {p: i for i, p in enumerate(POOLS)}
_ARGTYPES = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,)
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 16 + (ctypes.c_int,) * 9
                 + (ctypes.c_void_p,))


def _check_pool(pool: str, allowed=POOLS) -> None:
    if pool not in allowed:
        raise ValueError(f"pool must be one of {allowed}, got {pool!r}")


def cross_coattn_pair_plain(Eu, Ei, mu, mi, Wr, eu, ei, pool: str = "sum",
                            target_aware: bool = True):
    """Per-pair co-attention as score_tpu.nn.coattn.cross_coattn_ref, in
    the candidates form and in f32 inside. Eu [B,T,n,d], Ei [B,C,T,m,d],
    bool mu [B,T,n] and mi [B,C,T,m], Wr [d,d], eu [B,d], ei [B,C,d] ->
    cu, ci [B,C,T,d] in Eu's dtype. C == 1 is the reference's flat form."""
    _check_pool(pool)
    d = Eu.shape[-1]
    scale = 1.0 / float(d) ** 0.5
    out_dt = Eu.dtype
    Eu, Ei = Eu.float(), Ei.float()
    muf, mif = mu.float(), mi.float()
    EuW = torch.einsum("btnd,de->btne", Eu, Wr.float())
    if pool in ("sum", "mean"):
        # the pooled scores through masked opposite-side sums: no [n, m]
        # relation matrix (the reference's sum-pool identity)
        EuW_sum = (EuW * muf[..., None]).sum(dim=2)              # [B,T,d]
        Ei_sum = (Ei * mif[..., None]).sum(dim=3)                # [B,C,T,d]
        if pool == "mean":
            EuW_sum = EuW_sum / muf.sum(dim=-1, keepdim=True).clamp_min(1.0)
            Ei_sum = Ei_sum / mif.sum(dim=-1, keepdim=True).clamp_min(1.0)
        su = torch.einsum("btnd,bctd->bctn", EuW, Ei_sum) * scale
        si = torch.einsum("bctmd,btd->bctm", Ei, EuW_sum) * scale
    else:
        M = torch.einsum("btnd,bctmd->bctnm", EuW, Ei) * scale
        pair = mu[:, None, :, :, None] & mi[..., None, :]
        Mm = torch.where(pair, M, _NEG)
        su = Mm.amax(dim=-1)                 # amax: ties share the gradient
        si = Mm.amax(dim=-2)
        # rows with no valid opposite entry: 0 before the softmax
        su = torch.where(mi.any(dim=-1, keepdim=True), su, 0.0)
        si = torch.where(mu.any(dim=-1, keepdim=True)[:, None], si, 0.0)
    if target_aware:
        su = su + torch.einsum("btnd,bcd->bctn", Eu, ei.float()) * scale
        si = si + torch.einsum("bctmd,bd->bctm", Ei, eu.float()) * scale
    a = _smax(su, muf[:, None])
    b = _smax(si, mif)
    cu = torch.einsum("bctn,btnd->bctd", a, Eu)
    ci = torch.einsum("bctm,bctmd->bctd", b, Ei)
    return cu.to(out_dt), ci.to(out_dt)


def cross_coattn_pair_bwd_plain(Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci,
                                pool: str = "sum", target_aware: bool = True):
    """The VJP of `cross_coattn_pair_plain` for the sum and mean pools,
    written out as score_tpu/kernels/coattn.py:_coattn_bwd_kernel computes
    it, in the candidates form (the user side's gradients summed over the
    candidates) and f32 inside. Returns dEu [B,T,n,d], dEi [B,C,T,m,d],
    deu [B,d] and dei [B,C,d] in the inputs' dtypes (zeros when not
    target-aware) and dWr [d,d] in f32. The masks get no gradient."""
    _check_pool(pool, ("sum", "mean"))
    d = Eu.shape[-1]
    scale = 1.0 / float(d) ** 0.5
    Eu32, Ei32, Wr32 = Eu.float(), Ei.float(), Wr.float()
    muf, mif = mu.float(), mi.float()
    g_cu, g_ci = dcu.float(), dci.float()
    # forward recompute
    EuW = Eu32 @ Wr32                                            # [B,T,n,d]
    Si = (Ei32 * mif[..., None]).sum(dim=3)                      # [B,C,T,d]
    Su = (EuW * muf[..., None]).sum(dim=2)                       # [B,T,d]
    if pool == "mean":
        cnti = mif.sum(dim=-1, keepdim=True).clamp_min(1.0)
        cntu = muf.sum(dim=-1, keepdim=True).clamp_min(1.0)
        Si, Su = Si / cnti, Su / cntu
    su = torch.einsum("btnd,bctd->bctn", EuW, Si) * scale
    si = torch.einsum("bctmd,btd->bctm", Ei32, Su) * scale
    if target_aware:
        su = su + torch.einsum("btnd,bcd->bctn", Eu32, ei.float()) * scale
        si = si + torch.einsum("bctmd,bd->bctm", Ei32, eu.float()) * scale
    a = _smax(su, muf[:, None])
    b = _smax(si, mif)
    # weighted-sum VJPs
    da = torch.einsum("btnd,bctd->bctn", Eu32, g_cu)
    db = torch.einsum("bctmd,bctd->bctm", Ei32, g_ci)
    dEu = torch.einsum("bctn,bctd->btnd", a, g_cu)
    dEi = b[..., None] * g_ci[:, :, :, None]
    # softmax VJPs (masked rows give a = 0, so dsu = 0)
    dsu = a * (da - (a * da).sum(dim=-1, keepdim=True))
    dsi = b * (db - (b * db).sum(dim=-1, keepdim=True))
    # score VJPs
    dEuW = scale * torch.einsum("bctn,bctd->btnd", dsu, Si)
    dSi = scale * torch.einsum("bctn,btnd->bctd", dsu, EuW)
    dEi = dEi + scale * dsi[..., None] * Su[:, None, :, None]
    dSu = scale * torch.einsum("bctm,bctmd->btd", dsi, Ei32)
    if target_aware:
        dEu = dEu + scale * torch.einsum("bctn,bcd->btnd", dsu, ei.float())
        dEi = dEi + scale * dsi[..., None] * eu.float()[:, None, None, None]
        dei = scale * torch.einsum("bctn,btnd->bcd", dsu, Eu32)
        deu = scale * torch.einsum("bctm,bctmd->bd", dsi, Ei32)
    else:
        deu, dei = torch.zeros_like(eu), torch.zeros_like(ei)
    # opposite-side sum VJPs
    if pool == "mean":
        dSi, dSu = dSi / cnti, dSu / cntu
    dEi = dEi + mif[..., None] * dSi[:, :, :, None]
    dEuW = dEuW + muf[..., None] * dSu[:, :, None]
    # EuW = Eu Wr
    dEu = dEu + dEuW @ Wr32.T
    dWr = torch.einsum("btnd,btne->de", Eu32, dEuW)
    return (dEu.to(Eu.dtype), dEi.to(Ei.dtype), deu.to(eu.dtype),
            dei.to(ei.dtype), dWr)


def _pair_fwd_launch(Eu, Ei, mu, mi, Wr, eu, ei, pool, target_aware):
    """The forward itself: the CUDA kernel, or the plain version on the
    CPU."""
    if Eu.device.type == "cpu":
        return cross_coattn_pair_plain(Eu, Ei, mu, mi, Wr, eu, ei, pool,
                                       target_aware)
    B, C, T, n, m, d = _check("cross_coattn_pair", Eu, Ei, mu, mi, Wr, eu,
                              ei)
    if not tuned("cross_coattn_pair", n, m, d):
        return cross_coattn_wide(Eu, Ei, mu, mi, Wr, eu, ei, pool,
                                 target_aware)
    dev = Eu.device
    args = [x.contiguous() for x in (Eu, Ei, mu, mi)]
    Wr32 = Wr.float().contiguous()
    eu_c, ei_c = eu.contiguous(), ei.contiguous()
    cu = torch.empty(B, C, T, d, dtype=Eu.dtype, device=dev)
    ci = torch.empty_like(cu)
    if cu.numel() == 0:
        return cu, ci
    _build.launch("coattn_pair",
                  _build.load("coattn_pair", "pair_fwd", _ARGTYPES),
                  dev.index, *(x.data_ptr() for x in args), Wr32.data_ptr(),
                  eu_c.data_ptr(), ei_c.data_ptr(), cu.data_ptr(),
                  ci.data_ptr(), B, C, T, n, m, d, int(target_aware),
                  _POOL_CODE[pool], _DTYPE_CODE[Eu.dtype])
    cross_coattn_pair.launches += 1
    return cu, ci


def cross_coattn_pair_bwd(Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci,
                          pool: str = "sum", target_aware: bool = True):
    """Fused backward of `cross_coattn_pair` for the sum and mean pools:
    from dcu, dci [B,C,T,d] (in Eu's dtype) -> dEu, dEi, deu, dei in the
    inputs' dtype and dWr [d,d] in f32, as `cross_coattn_pair_bwd_plain`.
    The forward is recomputed from the inputs, in f32."""
    _check_pool(pool, ("sum", "mean"))
    if Eu.device.type == "cpu":
        return cross_coattn_pair_bwd_plain(Eu, Ei, mu, mi, Wr, eu, ei, dcu,
                                           dci, pool, target_aware)
    B, C, T, n, m, d = _check("cross_coattn_pair_bwd", Eu, Ei, mu, mi, Wr,
                              eu, ei, dcu, dci)
    if not tuned("cross_coattn_pair_bwd", n, m, d):
        return cross_coattn_wide_bwd(Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci,
                                     pool, target_aware)
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
    parts = _build.load("coattn_pair_bwd", "pair_bwd_num_partials",
                        (ctypes.c_int,))(B)
    dWr_part = torch.empty(parts, d, d, dtype=torch.float32, device=dev)
    _build.launch("coattn_pair_bwd",
                  _build.load("coattn_pair_bwd", "pair_bwd", _BWD_ARGTYPES),
                  dev.index, *(x.data_ptr() for x in ins), Wr32.data_ptr(),
                  *(x.data_ptr() for x in rest),
                  *(x.data_ptr() for x in (dEu, dEi, deu, dei, dei_acc,
                                           dWr_part, dWr)),
                  B, C, T, n, m, d, int(target_aware), _POOL_CODE[pool],
                  _DTYPE_CODE[Eu.dtype])
    cross_coattn_pair_bwd.launches += 1
    return dEu, dEi, deu, dei, dWr


def _max_vjp(Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci, target_aware):
    """The max pool's VJP, as the JAX package takes it: autograd through
    the plain forward, recomputed. Returns grads of (Eu, Ei, Wr, eu, ei),
    None where an input takes no part."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in (Eu, Ei, Wr, eu, ei)]
        out = cross_coattn_pair_plain(xs[0], xs[1], mu, mi, xs[2], xs[3],
                                      xs[4], "max", target_aware)
        return torch.autograd.grad(out, xs, (dcu, dci), allow_unused=True)


class _CrossCoattnPair(torch.autograd.Function):
    """The per-pair forward kernel; its VJP the fused backward kernel (sum,
    mean) or the recompute VJP (max)."""

    @staticmethod
    def forward(ctx, Eu, Ei, mu, mi, Wr, eu, ei, pool, target_aware):
        ctx.save_for_backward(Eu, Ei, mu, mi, Wr, eu, ei)
        ctx.pool, ctx.target_aware = pool, target_aware
        return _pair_fwd_launch(Eu, Ei, mu, mi, Wr, eu, ei, pool,
                                target_aware)

    @staticmethod
    def backward(ctx, dcu, dci):
        Eu, Ei, mu, mi, Wr, eu, ei = ctx.saved_tensors
        if ctx.pool == "max":
            dEu, dEi, dWr, deu, dei = _max_vjp(
                Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci, ctx.target_aware)
        else:
            dEu, dEi, deu, dei, dWr = cross_coattn_pair_bwd(
                Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci, ctx.pool,
                ctx.target_aware)
            dWr = dWr.to(Wr.dtype)
        return dEu, dEi, None, None, dWr, deu, dei, None, None


def cross_coattn_pair(Eu, Ei, mu, mi, Wr, eu, ei, pool: str = "sum",
                      target_aware: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused per-pair co-attention with pooling `pool` (sum, mean or max)
    of the relation matrix.

    Eu [B,T,n,d] (the user side, shared by the C candidates and read once
    per (b, t) in place), Ei [B,C,T,m,d], bool mu [B,T,n] and
    mi [B,C,T,m], Wr [d,d], target-projected eu [B,d] and ei [B,C,d] ->
    cu, ci [B,C,T,d] in Eu's dtype (f32 or bf16), computed in f32.
    Differentiable in Eu, Ei, Wr, eu and ei."""
    _check_pool(pool)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (Eu, Ei, Wr, eu, ei)):
        return _CrossCoattnPair.apply(Eu, Ei, mu, mi, Wr, eu, ei, pool,
                                      target_aware)
    return _pair_fwd_launch(Eu, Ei, mu, mi, Wr, eu, ei, pool, target_aware)


cross_coattn_pair.launches = 0
cross_coattn_pair_bwd.launches = 0
