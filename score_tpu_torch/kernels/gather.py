"""Row gather for embedding lookups and adjacency-history rows, and its
backward, the row scatter-add.

Counterpart of score_tpu/kernels/gather.py:gather_rows_pallas and of the
transpose XLA takes of it. On CUDA tensors `gather_rows` launches the
hand-written kernel in `score_tpu_torch/csrc/gather.cu` and, when the table
needs a gradient, its backward launches `scatter_add_rows`
(`score_tpu_torch/csrc/scatter_add.cu`); each source note says what bounds
it on the H100 and how the design meets that. On CPU tensors both run their
plain versions. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_void_p)
_SCATTER_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_void_p)


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [V, W], ids [...] int32 -> [..., W] (== table[ids])."""
    return torch.index_select(table, 0, ids.reshape(-1)).reshape(
        *ids.shape, table.shape[1])


def scatter_add_rows_plain(ids: torch.Tensor, src: torch.Tensor,
                           num_rows: int) -> torch.Tensor:
    """ids [...] int32, src [..., W] f32 -> [num_rows, W] f32 table with
    table[ids[j]] += src[j] from zeros."""
    W = src.shape[-1]
    return torch.zeros(num_rows, W, dtype=src.dtype,
                       device=src.device).index_add_(
        0, ids.reshape(-1), src.reshape(-1, W))


def _vec_bytes(row_bytes: int, *ptrs: int) -> int:
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(p % v == 0 for p in ptrs):
            return v
    raise ValueError(f"row of {row_bytes} bytes is not 2-byte aligned")


def _check_cuda(name: str, table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.device.type != "cuda" or ids.device != table.device:
        raise ValueError(f"{name}: tensors on {table.device} and "
                         f"{ids.device}; all must be on one CUDA device")
    if ids.dtype != torch.int32:
        raise ValueError(f"{name}: ids must be int32, got {ids.dtype}")


def _gather_launch(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The gather itself: the CUDA kernel, or the plain version on the
    CPU."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, ids)
    _check_cuda("gather_rows", table, ids)
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("gather_rows: table must be a contiguous 2-D tensor")
    if table.dtype not in _DTYPES:
        raise ValueError(f"gather_rows: unsupported table dtype {table.dtype}")
    ids_c = ids.contiguous()
    out = torch.empty(*ids.shape, table.shape[1], dtype=table.dtype,
                      device=table.device)
    row_bytes = table.shape[1] * table.element_size()
    if ids_c.numel() == 0 or row_bytes == 0:
        return out
    fn = _build.load("gather", "gather_rows", _ARGTYPES)
    vec = _vec_bytes(row_bytes, table.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        err = fn(table.data_ptr(), ids_c.data_ptr(), out.data_ptr(),
                 ids_c.numel(), table.shape[0], row_bytes, vec, stream)
    _build.check("gather", err)
    gather_rows.launches += 1
    return out


def scatter_add_rows(ids: torch.Tensor, src: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """ids [...] int32, src [..., W] f32 -> [num_rows, W] f32 with
    table[ids[j]] += src[j] from zeros: the CUDA kernel on CUDA tensors, the
    plain version on the CPU. Out-of-range ids are the caller's bug."""
    if src.device.type == "cpu":
        return scatter_add_rows_plain(ids, src, num_rows)
    _check_cuda("scatter_add_rows", src, ids)
    if src.dtype != torch.float32:
        raise ValueError(f"scatter_add_rows: src must be float32, got "
                         f"{src.dtype}")
    W = src.shape[-1]
    if tuple(src.shape[:-1]) != tuple(ids.shape):
        raise ValueError(f"scatter_add_rows: src {tuple(src.shape)} does not "
                         f"match ids {tuple(ids.shape)}")
    src_c, ids_c = src.contiguous(), ids.contiguous()
    table = torch.zeros(num_rows, W, dtype=torch.float32, device=src.device)
    if ids_c.numel() == 0 or W == 0:
        return table
    fn = _build.load("scatter_add", "scatter_add_rows", _SCATTER_ARGTYPES)
    vec = _vec_bytes(W * 4, src_c.data_ptr(), table.data_ptr()) // 4
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        err = fn(src_c.data_ptr(), ids_c.data_ptr(), table.data_ptr(),
                 ids_c.numel(), num_rows, W, vec, stream)
    _build.check("scatter_add", err)
    scatter_add_rows.launches += 1
    return table


class _GatherRows(torch.autograd.Function):
    """table[ids] with the scatter-add as its backward (no gradient for
    the ids)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return _gather_launch(table, ids)

    @staticmethod
    def backward(ctx, dout):
        (ids,) = ctx.saved_tensors
        return scatter_add_rows(ids, dout, ctx.num_rows), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [V, W] (f32, bf16 or int32, contiguous), ids [...] int32 ->
    [..., W], out[...] = table[ids[...]].

    Differentiable in the table when it requires a gradient: the gradient
    is the f32 scatter-add of the output's gradient, so such a table must
    be f32 (training gathers from the f32 master tables and casts after
    the gather). Out-of-range ids are the caller's bug (no clamping); row 0
    is a row like any other."""
    if not (table.requires_grad and torch.is_grad_enabled()):
        return _gather_launch(table, ids)
    if table.dtype != torch.float32:
        raise ValueError(f"gather_rows: a table that requires a gradient "
                         f"must be float32, got {table.dtype}")
    return _GatherRows.apply(table, ids)


gather_rows.launches = 0
scatter_add_rows.launches = 0
