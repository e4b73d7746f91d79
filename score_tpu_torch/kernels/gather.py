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
             ctypes.c_void_p)
_SCATTER_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                     ctypes.c_void_p)


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


def _device_index(name: str, x: torch.Tensor, ids: torch.Tensor) -> int:
    """The CUDA device both tensors lie on, or raise; ids must be int32."""
    index = x.get_device()
    if not x.is_cuda or ids.get_device() != index:
        raise ValueError(f"{name}: tensors on {x.device} and {ids.device}; "
                         f"all must be on one CUDA device")
    if ids.dtype != torch.int32:
        raise ValueError(f"{name}: ids must be int32, got {ids.dtype}")
    return index


def _gather_launch(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The gather itself: the CUDA kernel, or the plain version on the
    CPU. The host's work on the card's path is a few attribute reads, one
    allocation and one ctypes call: each microsecond here is one the step
    pays for every one of its gathers."""
    if table.is_cpu:
        return gather_rows_plain(table, ids)
    index = _device_index("gather_rows", table, ids)
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("gather_rows: table must be a contiguous 2-D tensor")
    if table.dtype not in _DTYPES:
        raise ValueError(f"gather_rows: unsupported table dtype {table.dtype}")
    ids_c = ids.contiguous()
    V, W = table.shape
    out = table.new_empty((*ids.shape, W))
    n = ids_c.numel()
    if n == 0 or W == 0:
        return out
    _build.launch("gather", _build.load("gather", "gather_rows", _ARGTYPES),
                  index, table.data_ptr(), ids_c.data_ptr(), out.data_ptr(),
                  n, V, W * table.element_size())
    gather_rows.launches += 1
    return out


def scatter_add_rows(ids: torch.Tensor, src: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """ids [...] int32, src [..., W] f32 -> [num_rows, W] f32 with
    table[ids[j]] += src[j] from zeros: the CUDA kernel on CUDA tensors, the
    plain version on the CPU. Out-of-range ids are the caller's bug."""
    if src.is_cpu:
        return scatter_add_rows_plain(ids, src, num_rows)
    index = _device_index("scatter_add_rows", src, ids)
    if src.dtype != torch.float32:
        raise ValueError(f"scatter_add_rows: src must be float32, got "
                         f"{src.dtype}")
    W = src.shape[-1]
    if tuple(src.shape[:-1]) != tuple(ids.shape):
        raise ValueError(f"scatter_add_rows: src {tuple(src.shape)} does not "
                         f"match ids {tuple(ids.shape)}")
    src_c, ids_c = src.contiguous(), ids.contiguous()
    table = src.new_zeros((num_rows, W))
    n = ids_c.numel()
    if n == 0 or W == 0:
        return table
    _build.launch("scatter_add",
                  _build.load("scatter_add", "scatter_add_rows",
                              _SCATTER_ARGTYPES),
                  index, src_c.data_ptr(), ids_c.data_ptr(), table.data_ptr(),
                  n, num_rows, W)
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
