"""The yardstick's arithmetic: the card's published peaks, the least time a
kernel's work could take, the compulsory work of each of the port's
kernel families at the timed shapes, and the model FLOPs of a step.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at its full 700 W (a
card set below it runs slower; the run records the card's power limit
beside every number): 3.35 TB/s HBM, 67 TFLOP/s f32 on the CUDA cores,
989 TFLOP/s bf16 on the tensor cores.

A kernel's work counts each input byte it needs read once and each output
byte written once: for a row gather the ids, the distinct valid rows and
the valid output rows; for a scatter-add the valid gradient rows, the ids
and the distinct rows written; for the co-attention the valid history
rows, the masks, the weights and the outputs of the real (unpadded)
candidates, and its f32 operations (`cand_work`, frozen from
chip_smoke.py's `_cand_work`). Masked neighbours and padding candidates
are work the model does not need, whatever implements it.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Sequence

import torch

from ..reference.model import check_supported

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12


DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def elem_bytes(model: dict, training: bool) -> tuple:
    """(bytes of a table element, bytes of an activation) as the program
    holds them: a training step reads and writes the tables in the
    parameters' dtype; serving and evaluation read them cast to the
    compute dtype, as `params.cast_tables` casts them; activations are
    in the compute dtype."""
    for key in ("param_dtype", "compute_dtype"):
        if model[key] not in DTYPE_BYTES:
            raise NotImplementedError(f"model.{key} = {model[key]!r}")
    act = DTYPE_BYTES[model["compute_dtype"]]
    return (DTYPE_BYTES[model["param_dtype"]] if training else act), act


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    """The least seconds the card could take: bytes at the HBM rate or f32
    operations at their peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def distinct(ids: torch.Tensor) -> int:
    return int(torch.unique(ids).numel()) if ids.numel() else 0


def gather_bytes(ids: torch.Tensor, valid: Optional[torch.Tensor],
                 row_bytes: int) -> int:
    """ids read, the distinct valid rows read, the valid rows written."""
    used = ids if valid is None else ids[valid]
    return ids.numel() * 4 + (distinct(used) + used.numel()) * row_bytes


def scatter_bytes(segments: Sequence[tuple], row_bytes: int) -> int:
    """(ids, valid) segments into one table: the valid gradient rows and
    every id read, the distinct valid rows written."""
    used = [i if v is None else i[v] for i, v in segments]
    n_used = sum(u.numel() for u in used)
    return (sum(i.numel() for i, _ in segments) * 4 + n_used * row_bytes
            + distinct(torch.cat([u.reshape(-1) for u in used])) * row_bytes)


def cand_work(B: int, C: int, T: int, n: int, m: int, d: int, es: int,
              vu: int, vi: int, backward: bool):
    """Compulsory bytes and f32 operations of the candidates co-attention
    forward (or backward) over B users, C candidates each: vu, vi the
    valid user-side and item-side rows; es the activations' bytes."""
    out = 2 * B * C * T * d * es                 # cu, ci (or dcu, dci)
    masks = B * T * n + B * C * T * m
    moved = (vu + vi) * d * es + masks + 4 * d * d + (B + B * C) * d * es \
        + out
    if not backward:
        flops = (2 * d * d * B * T * (1 + C) + d * vu + 4 * d * C * vu
                 + 5 * d * vi)
        return moved, flops
    moved += (B * T * n + B * C * T * m) * d * es + (B + B * C) * d * es \
        + 4 * d * d
    flops = (6 * d * d * B * T * (1 + C) + 11 * d * C * vu + d * vu
             + 11 * d * vi)
    return moved, flops


def masks(graph, users, cand, slots, shifts: Sequence[int] = ()):
    """Histories of users [B] and cand [B, C], their valid-neighbour masks,
    and the item side's mask after the in-batch rolls of `shifts` (a
    rolled candidate's history seen up to this target's slot)."""
    uh = graph["u2i"][users.long()]
    ih = graph["i2u"][cand.long()]
    T, n, m = uh.shape[1], uh.shape[2], ih.shape[-1]
    sv = torch.arange(T, device=users.device)[None] < slots[:, None]
    uc = graph["u2i_cnt"][users.long()]
    ic = graph["i2u_cnt"][cand.long()]
    mu = (torch.arange(n, device=users.device) < uc[..., None]) \
        & sv[..., None]
    mi = (torch.arange(m, device=users.device) < ic[..., None]) \
        & sv[:, None, :, None]
    ic = torch.cat([ic] + [torch.roll(ic, -s, 0) for s in shifts], dim=1)
    mi_rolled = (torch.arange(m, device=users.device) < ic[..., None]) \
        & sv[:, None, :, None]
    return uh, ih, mu, mi, mi_rolled


def unit_work(model: dict, graph: Dict[str, torch.Tensor],
              users: torch.Tensor, cand: torch.Tensor, slots: torch.Tensor,
              table_bytes: int, act_bytes: int,
              shifts: Sequence[int] = (), backward: bool = False,
              table_step: bool = False) -> Dict[str, float]:
    """Bound seconds by kernel family ('gather', 'scatter', 'coattn_fwd',
    'coattn_bwd') of one step, call or block: users [B] against the real
    candidates cand [B, C0] (with `shifts`, C0 = 1 and the co-attention
    sees 1 + k rolled candidates), tables of `table_bytes` an element,
    activations of `act_bytes` (`elem_bytes`); `backward` adds the
    training step's backward, `table_step` its scatter-adds into the
    tables."""
    check_supported(model)
    work: Dict[str, float] = collections.defaultdict(float)
    uh, ih, mu, mi, mi_rolled = masks(graph, users, cand, slots, shifts)
    T, n, m = uh.shape[1], uh.shape[2], ih.shape[-1]
    d = model["embed_dim"]
    row = d * table_bytes
    # the graph's four row gathers: histories and counts of both sides
    for ids, width in ((users, T * n), (users, T), (cand, T * m),
                       (cand, T)):
        work["gather"] += bound_s(gather_bytes(ids, None, width * 4))
    # the lookups: the user table by the users and the item histories,
    # the item table by the candidates and the user histories
    for ids, valid in ((users, None), (ih, mi), (cand, None), (uh, mu)):
        work["gather"] += bound_s(gather_bytes(ids, valid, row))
    if backward and table_step:
        for segs in (((users, None), (ih, mi)), ((cand, None), (uh, mu))):
            work["scatter"] += bound_s(scatter_bytes(segs, row))
    if model["slot_agg"] == "coattn":
        B, C = users.numel(), mi_rolled.shape[1]
        vu, vi = int(mu.sum()), int(mi_rolled.sum())
        work["coattn_fwd"] += bound_s(*cand_work(B, C, T, n, m, d, act_bytes,
                                                 vu, vi, False))
        if backward:
            work["coattn_bwd"] += bound_s(*cand_work(B, C, T, n, m, d,
                                                     act_bytes, vu, vi,
                                                     True))
    return dict(work)


def forward_flops(model: dict, data: dict, B: int, C: int) -> float:
    """Model FLOPs of the forward pass over B users against C candidates
    each, at the configuration's shapes, each product counted in the
    cheapest form the model's equations allow (the co-attention's sum
    pool through the masked opposite-side sums, with no relation
    matrix). Padding is not the model's work: pass the real C."""
    check_supported(model)
    d, f = model["embed_dim"], model["hidden_dim"]
    T, n, m = data["slots"], data["user_fanout"], data["item_fanout"]
    fl = 0.0
    if model["slot_agg"] == "coattn":
        fl += B * T * n * 2 * d * d                    # Eu Wr
        fl += B * T * n * d + B * C * T * m * d        # the masked sums
        fl += B * C * T * (n + m) * 2 * d              # su, si
        if model["target_aware"]:
            fl += 2 * d * d * (B + B * C)              # the projections
            fl += B * C * T * (n + m) * 2 * d
        fl += B * C * T * (n + m) * (5 + 2 * d)        # softmaxes, cu, ci
        seqs_u = B * C
    else:
        fl += B * T * n * d + B * C * T * m * d        # slot means
        seqs_u = B
    gru_step = 2 * d * 3 * f + 2 * f * 3 * f + 12 * f
    fl += (seqs_u + B * C) * T * gru_step
    if model["seq_pool"] == "attn":
        fl += 2 * B * C * (2 * d * f + T * (4 * f + 5))
    width = 3 * f + 3 * d
    dims = [width] + list(model["mlp_dims"]) + [1]
    fl += B * C * (sum(2 * a * b for a, b in zip(dims, dims[1:]))
                   + f + d)
    return float(fl)


def train_flops(model: dict, data: dict, B: int, k: int) -> float:
    """A training step's model FLOPs: the forward on [B, 1 + k], and the
    backward at twice the forward."""
    return 3.0 * forward_flops(model, data, B, 1 + k)
