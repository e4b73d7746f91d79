"""The co-attention kernels for widths past the tuned ones: forward (sum,
mean and max pools) and backward (sum and mean pools) in the candidates
form, for any d <= MAX_WIDE_DIM and n, m <= MAX_WIDE_ROWS.

`cross_coattn_cand` (kernels/coattn_cand.py) and `cross_coattn_pair`
(kernels/coattn.py), and their backwards, send a shape to the tuned
kernels while d, n and m are at most `coattn_cand.MAX_DIM` (32), to these
beyond that, and raise beyond these limits: a choice between two
hand-written kernels by shape, made before any launch. The CUDA source is
`score_tpu_torch/csrc/coattn_wide.cu`; its note says which TPU kernels it
stands in for, what bounds it on the H100 and how the design meets that.
Each function here takes the inputs `coattn_cand._check` accepted and
computes what `coattn.cross_coattn_pair_plain` and
`coattn.cross_coattn_pair_bwd_plain` compute; on CPU tensors it runs
those plain versions. The backward's shared memory grows with C (a
block keeps every candidate's dWr rows of an item): at d = 128 with
n = m = 64 it takes C up to 17, and raises ValueError past what
fits.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_WIDE_DIM = 128    # d
MAX_WIDE_ROWS = 64    # n and m: neighbour rows a side
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_POOL_CODE = {"sum": 0, "mean": 1, "max": 2}
_FWD_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 9
                 + (ctypes.c_void_p,))
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 14 + (ctypes.c_longlong,)
                 + (ctypes.c_void_p,) + (ctypes.c_int,) * 9
                 + (ctypes.c_void_p,))


def cross_coattn_wide(Eu, Ei, mu, mi, Wr, eu, ei, pool: str = "sum",
                      target_aware: bool = True):
    """The wide forward: cu, ci [B,C,T,d] in Eu's dtype, as
    `cross_coattn_pair_plain(..., pool, target_aware)`."""
    if Eu.device.type == "cpu":
        from .coattn import cross_coattn_pair_plain
        return cross_coattn_pair_plain(Eu, Ei, mu, mi, Wr, eu, ei, pool,
                                       target_aware)
    B, T, n, d = Eu.shape
    C, m = Ei.shape[1], Ei.shape[3]
    dev = Eu.device
    args = [x.contiguous() for x in (Eu, Ei, mu, mi)]
    Wr32 = Wr.float().contiguous()
    eu_c, ei_c = eu.contiguous(), ei.contiguous()
    cu = torch.empty(B, C, T, d, dtype=Eu.dtype, device=dev)
    ci = torch.empty_like(cu)
    if cu.numel() == 0:
        return cu, ci
    _build.launch("coattn_wide",
                  _build.load("coattn_wide", "wide_fwd", _FWD_ARGTYPES),
                  dev.index, *(x.data_ptr() for x in args), Wr32.data_ptr(),
                  eu_c.data_ptr(), ei_c.data_ptr(), cu.data_ptr(),
                  ci.data_ptr(), B, C, T, n, m, d, int(target_aware),
                  _POOL_CODE[pool], _DTYPE_CODE[Eu.dtype])
    cross_coattn_wide.launches += 1
    return cu, ci


def cross_coattn_wide_bwd(Eu, Ei, mu, mi, Wr, eu, ei, dcu, dci,
                          pool: str = "sum", target_aware: bool = True):
    """The wide backward (sum and mean pools): dEu, dEi, deu, dei in the
    inputs' dtype and dWr [d,d] in f32, as `cross_coattn_pair_bwd_plain`
    (for the sum pool also `cross_coattn_cand_bwd_plain`)."""
    if Eu.device.type == "cpu":
        from .coattn import cross_coattn_pair_bwd_plain
        return cross_coattn_pair_bwd_plain(Eu, Ei, mu, mi, Wr, eu, ei, dcu,
                                           dci, pool, target_aware)
    B, T, n, d = Eu.shape
    C, m = Ei.shape[1], Ei.shape[3]
    dev = Eu.device
    dWr = torch.empty(d, d, dtype=torch.float32, device=dev)
    if B * C * T == 0:
        return (torch.zeros_like(Eu), torch.zeros_like(Ei),
                torch.zeros_like(eu), torch.zeros_like(ei), dWr.zero_())
    ins = [x.contiguous() for x in (Eu, Ei, mu, mi)]
    Wr32 = Wr.float().contiguous()
    rest = [x.contiguous() for x in (eu, ei, dcu, dci)]
    dEu, dEi = torch.empty_like(ins[0]), torch.empty_like(ins[1])
    deu, dei = torch.empty_like(rest[0]), torch.empty_like(rest[1])
    shape = (B, C, T, n, m, d)
    codes = (_POOL_CODE[pool], _DTYPE_CODE[Eu.dtype])
    floats = _build.load("coattn_wide", "wide_bwd_scratch_floats",
                         (ctypes.c_int,) * 8, ctypes.c_longlong)(*shape,
                                                                 *codes)
    if floats < 1:
        raise ValueError(f"cross_coattn_wide_bwd: the kernel's shared "
                         f"memory does not hold B, C, T, n, m, d = {shape}")
    # the blocks' partials of dWr, summed in block order by the kernel
    part = torch.empty(floats, dtype=torch.float32, device=dev)
    _build.launch("coattn_wide",
                  _build.load("coattn_wide", "wide_bwd", _BWD_ARGTYPES),
                  dev.index, *(x.data_ptr() for x in ins), Wr32.data_ptr(),
                  *(x.data_ptr() for x in rest),
                  *(x.data_ptr() for x in (dEu, dEi, deu, dei, part)),
                  floats, dWr.data_ptr(), *shape, int(target_aware), *codes)
    cross_coattn_wide_bwd.launches += 1
    return dEu, dEi, deu, dei, dWr


cross_coattn_wide.launches = 0
cross_coattn_wide_bwd.launches = 0
