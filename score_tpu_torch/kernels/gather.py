"""Row gather for embedding lookups and adjacency-history rows, and its
backward, the row scatter-add.

Counterpart of score_tpu/kernels/gather.py:gather_rows_pallas and of the
transpose XLA takes of it. On CUDA tensors `gather_rows` launches the
hand-written kernel in `score_tpu_torch/csrc/gather.cu` and, when the table
needs a gradient, its backward launches `scatter_add_rows`
(`score_tpu_torch/csrc/scatter_add.cu`); `gather_rows_grouped` takes all of
a step's lookups into one table, so that their backward is one
scatter-add. A table that trains is f32 or bf16; a bf16 table's gradient is
bf16, summed in f32 and rounded once (the scatter-add's bf16 form). Each
source note says what bounds it on the H100 and how the design meets that.
On CPU tensors both run their plain versions. There is no fallback from
one to the other.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p)
# segments a scatter-add takes: (src, ids, n) each, by value
_MAX_SEGMENTS = 4
_SEGMENT_ARGTYPES = ((ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong)
                     * _MAX_SEGMENTS)
_SCATTER_ARGTYPES = _SEGMENT_ARGTYPES + (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p)
# the bf16 form: the f32 workspace, then the bf16 table
_SCATTER_BF16_ARGTYPES = _SEGMENT_ARGTYPES + (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p)
# the sources (and tables) a scatter-add takes
_SCATTER_DTYPES = (torch.float32, torch.bfloat16)


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [V, W], ids [...] int32 -> [..., W] (== table[ids])."""
    return torch.index_select(table, 0, ids.reshape(-1)).reshape(
        *ids.shape, table.shape[1])


def _segments(ids, src) -> Tuple[list, list]:
    """ids and src as equal-length lists of segments (a lone tensor is
    one segment)."""
    if isinstance(ids, torch.Tensor):
        return [ids], [src]
    ids, src = list(ids), list(src)
    if len(ids) != len(src) or not ids:
        raise ValueError(f"scatter_add_rows: {len(ids)} id segments for "
                         f"{len(src)} source segments")
    return ids, src


def scatter_add_rows_plain(ids, src, num_rows: int) -> torch.Tensor:
    """ids [...] int32, src [..., W] f32 or bf16, or equal-length
    sequences of such segments -> [num_rows, W] table of src's dtype with
    table[ids[j]] += src[j] from zeros, the segments added in order; bf16
    sources are summed in f32 and the sums rounded once to bf16."""
    ids, src = _segments(ids, src)
    W, dtype = src[0].shape[-1], src[0].dtype
    acc = torch.float32 if dtype == torch.bfloat16 else dtype
    table = torch.zeros(num_rows, W, dtype=acc, device=src[0].device)
    for i, x in zip(ids, src):
        table.index_add_(0, i.reshape(-1), x.reshape(-1, W).to(table.dtype))
    return table.to(dtype)


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


def scatter_add_rows(ids, src, num_rows: int) -> torch.Tensor:
    """ids [...] int32, src [..., W] f32 or bf16, or equal-length
    sequences of up to _MAX_SEGMENTS such segments (one W, one dtype) ->
    [num_rows, W] of src's dtype with table[ids[j]] += src[j] from zeros:
    on CUDA tensors the kernel, one call for all the segments, its table
    zeroed on the same stream (bf16: summed in an f32 workspace, then
    rounded once into the bf16 table); on the CPU the plain version.
    Out-of-range ids are the caller's bug."""
    ids, src = _segments(ids, src)
    if src[0].is_cpu:
        return scatter_add_rows_plain(ids, src, num_rows)
    if len(ids) > _MAX_SEGMENTS:
        raise ValueError(f"scatter_add_rows: {len(ids)} segments; the "
                         f"kernel takes at most {_MAX_SEGMENTS}")
    W, dtype = src[0].shape[-1], src[0].dtype
    index = _device_index("scatter_add_rows", src[0], ids[0])
    live = []
    for i, x in zip(ids, src):
        if (_device_index("scatter_add_rows", x, i) != index
                or x.dtype != dtype or dtype not in _SCATTER_DTYPES):
            raise ValueError(f"scatter_add_rows: sources must be float32 "
                             f"or bfloat16, one dtype on one device; got "
                             f"{x.dtype} on {x.device} after {dtype}")
        if tuple(x.shape) != (*i.shape, W):
            raise ValueError(f"scatter_add_rows: src {tuple(x.shape)} does "
                             f"not match ids {tuple(i.shape)} and W={W}")
        if i.numel():
            live.append((x.contiguous(), i.contiguous()))
    table = src[0].new_empty((num_rows, W))
    if not live or W == 0:
        return table.zero_()
    args = []
    for x, i in live:
        args += [x.data_ptr(), i.data_ptr(), i.numel()]
    args += [None, None, 0] * (_MAX_SEGMENTS - len(live))
    if dtype == torch.float32:
        _build.launch("scatter_add",
                      _build.load("scatter_add", "scatter_add_segments",
                                  _SCATTER_ARGTYPES),
                      index, *args, table.data_ptr(), num_rows, W)
    else:
        workspace = table.new_empty((num_rows, W), dtype=torch.float32)
        _build.launch("scatter_add",
                      _build.load("scatter_add", "scatter_add_segments_bf16",
                                  _SCATTER_BF16_ARGTYPES),
                      index, *args, workspace.data_ptr(), table.data_ptr(),
                      num_rows, W)
        scatter_add_rows.launches_bf16 += 1
    scatter_add_rows.launches += 1
    return table


class _GatherRows(torch.autograd.Function):
    """table[ids] for each of a group of ids tensors, with one grouped
    scatter-add as the backward (no gradient for the ids). A segment whose
    output gets no gradient (None: it does not reach the loss) or is empty
    is left out of the scatter."""

    @staticmethod
    def forward(ctx, table, *ids):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*ids)
        ctx.num_rows = table.shape[0]
        return tuple(_gather_launch(table, i) for i in ids)

    @staticmethod
    def backward(ctx, *douts):
        ids = ctx.saved_tensors
        live = [(i, g) for i, g in zip(ids, douts)
                if g is not None and g.numel()]
        grad = None
        if live:
            grad = scatter_add_rows([i for i, _ in live],
                                    [g for _, g in live], ctx.num_rows)
        return (grad,) + (None,) * len(ids)


def _trainable(table: torch.Tensor) -> bool:
    """Whether lookups into `table` need its gradient; such a table must be
    f32 or bf16, a dtype the scatter-add takes (training gathers from the
    tables in their parameter dtype and casts after the gather)."""
    if not (table.requires_grad and torch.is_grad_enabled()):
        return False
    if table.dtype not in _SCATTER_DTYPES:
        raise ValueError(f"gather_rows: a table that requires a gradient "
                         f"must be float32 or bfloat16, got {table.dtype}")
    return True


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [V, W] (f32, bf16 or int32, contiguous), ids [...] int32 ->
    [..., W], out[...] = table[ids[...]].

    Differentiable in the table when it requires a gradient (f32 or bf16):
    the gradient is the scatter-add of the output's gradient, in the
    table's dtype. Out-of-range ids are
    the caller's bug (no clamping); row 0 is a row like any other."""
    if not _trainable(table):
        return _gather_launch(table, ids)
    return _GatherRows.apply(table, ids)[0]


def gather_rows_grouped(table: torch.Tensor,
                        ids: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """[gather_rows(table, i) for i in ids], one gather launch each, whose
    backward is one scatter-add launch for all of them (up to
    _MAX_SEGMENTS on a CUDA device; its table zeroed on the stream, not by
    a separate fill), where separate lookups would take one zeroed table
    and one launch each and an add of the dense gradients. Without a
    gradient to compute it is the separate gathers."""
    if not ids or not _trainable(table):
        return [_gather_launch(table, i) for i in ids]
    return list(_GatherRows.apply(table, *ids))


gather_rows.launches = 0
scatter_add_rows.launches = 0
# of those, the bf16 form's
scatter_add_rows.launches_bf16 = 0
