"""The SCoRe model family (the configs0-3 rungs of the preset ladder), and
`build_model`, which builds it or one of the baseline roster's archs.

Counterpart of score_tpu/nn/model.py:ScoreModel and of
score_tpu/train.py:build_model, for serving and for training with uniform
or in-batch negatives (`neg_shift`). One module covers the rungs through
ModelConfig's flags:

    configs0  sides='user', slot_agg='mean',   seq_pool='last', shared_table
    configs1  sides='dual', slot_agg='mean',   seq_pool='attn'
    configs2  sides='dual', slot_agg='attn',   seq_pool='attn'
    configs3  sides='dual', slot_agg='coattn', seq_pool='attn'

and any other combination of those flags (the co-attention needs both
sides), with the GRU, Caser or SASRec sequence encoder (`seq_encoder`
'gru', 'caser' or 'selfattn'; the roster's gru4rec, caser, sasrec and rrn
presets are such combinations). Submodule and parameter names mirror the
flax tree (tables, coattn or slot_attn_u/slot_attn_i, gru_u, gru_i,
pool_u, pool_i, scorer), and a rung has only the submodules the flax
model has, so `score_tpu_torch.params` maps one onto the other. The
roster's other archs (`arch` 'mf', 'pop', 'svdpp', 'delf') are in
`nn.baselines`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import Config, ModelConfig
from ..kernels.coattn_wide import MAX_WIDE_DIM, MAX_WIDE_ROWS
from .coattn import (CrossCoAttention, SlotAttention, roll_candidates,
                     slot_mean)
from .embed import EmbeddingTables
from .encoder import GRU, AttnPool, last_pool
from .scorer import Scorer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCHS = ("score", "mf", "pop", "svdpp", "delf")
ENCODERS = ("gru", "caser", "selfattn")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port does not build: an
    arch or sequence encoder the reference does not have, and compute or
    parameters other than f32 or bf16; ValueError for co-attention on one
    side, which the reference refuses too."""
    if cfg.arch not in ARCHS or cfg.seq_encoder not in ENCODERS:
        raise NotImplementedError(
            f"no arch {cfg.arch!r} with encoder {cfg.seq_encoder!r}; the "
            f"port builds the archs {ARCHS} and the encoders {ENCODERS}")
    if cfg.compute_dtype not in DTYPES:
        raise NotImplementedError(
            f"score_tpu_torch computes in f32 or bf16 only; got "
            f"compute_dtype={cfg.compute_dtype!r}")
    if (cfg.arch == "score" and cfg.slot_agg == "coattn"
            and cfg.sides != "dual"):
        raise ValueError("co-attention requires both sides (sides='dual')")
    # param_dtype sets ScoreModel's tables (the scatter-add takes f32 and
    # bf16); every other leaf is f32, as in the reference
    if cfg.param_dtype not in DTYPES:
        raise NotImplementedError(
            f"score_tpu_torch keeps float32 or bfloat16 parameters only; "
            f"got param_dtype={cfg.param_dtype!r}")


def check_config(cfg: Config, mesh=None) -> None:
    """check_supported on the model, and a sharded layout only under a
    mesh of its shape (`sharding.bringup`): a sharded config must not
    train as an unsharded one. (`ScoringService` without a mesh serves a
    sharded config's weights whole, and checks the config unsharded.)"""
    check_supported(cfg.model)
    sh = cfg.sharding
    if mesh is not None:
        if (mesh.num_data, mesh.num_rows) != (sh.num_data, sh.num_rows):
            raise ValueError(
                f"a ({mesh.num_data}, {mesh.num_rows}) mesh for a "
                f"(num_data={sh.num_data}, num_rows={sh.num_rows}) config")
        # every rank takes an equal block of the batch
        if cfg.train.batch_size % mesh.size:
            raise ValueError(
                f"batch_size {cfg.train.batch_size} does not split over a "
                f"{mesh.size}-rank mesh")
    elif sh.num_data * sh.num_rows > 1:
        raise NotImplementedError(
            f"a sharded layout (num_data={sh.num_data}, "
            f"num_rows={sh.num_rows}) trains only under a mesh of its "
            f"shape: sharding.bringup(cfg.sharding, ...), then "
            f"train.init_state(..., mesh=) or train.train(..., mesh=); the "
            f"CLI under python -m torch.distributed.run")


def check_device(cfg, device, fanouts: Optional[Sequence[int]] = None
                 ) -> None:
    """On a CUDA device, raise NotImplementedError for a co-attention
    config wider than its kernels take: embed_dim above MAX_WIDE_DIM, or a
    neighbour fan-out above MAX_WIDE_ROWS. The fan-outs are cfg.data's
    (cfg a Config; a ModelConfig has none) and `fanouts`, the widths a
    graph stores (`stored_fanouts`): eval and serving run at the stored
    width, and so does training unless it re-samples down to cfg.data's.
    The CPU runs the plain versions, which have no limit."""
    m = getattr(cfg, "model", cfg)
    if (torch.device(device).type != "cuda" or m.arch != "score"
            or m.slot_agg != "coattn"):
        return
    widths = ([cfg.data.user_fanout, cfg.data.item_fanout]
              if hasattr(cfg, "data") else [])
    widths += list(fanouts or ())
    if m.embed_dim > MAX_WIDE_DIM or max(widths, default=0) > MAX_WIDE_ROWS:
        raise NotImplementedError(
            f"the co-attention kernels take embed_dim <= {MAX_WIDE_DIM} and "
            f"neighbour fan-outs <= {MAX_WIDE_ROWS} on a CUDA device; got "
            f"embed_dim={m.embed_dim}, fan-outs {widths} (configured, then "
            f"stored)")


def stored_fanouts(graph) -> Tuple[int, int]:
    """The (user, item) neighbour fan-outs a graph stores: a GraphStore's
    adjacency's last axis, a DeviceGraph's or ShardedGraph's `fanouts`."""
    if hasattr(graph, "fanouts"):
        return tuple(graph.fanouts)
    return graph.u2i.shape[-1], graph.i2u.shape[-1]


def _nbr_mask(cnt: torch.Tensor, fanout: int,
              slot_valid: torch.Tensor) -> torch.Tensor:
    """[..., T, k] bool: neighbour j of slot t valid iff j < cnt and t < t*."""
    j = torch.arange(fanout, dtype=cnt.dtype, device=cnt.device)
    return (j < cnt[..., None]) & slot_valid[..., None]


def candidates_form(batch: dict, dual: bool) -> dict:
    """A flat (u, i) batch as the candidates form with C == 1 (the item's
    history too when the model reads it, `dual`)."""
    cb = dict(batch, cand=batch["item"][:, None])
    if dual:
        cb.update(i_hist=batch["i_hist"][:, None],
                  i_cnt=batch["i_cnt"][:, None])
    return cb


def build_model(cfg, num_users: int, num_items: int,
                lookup_fn=None) -> nn.Module:
    """The model `cfg.arch` names (cfg a Config or its ModelConfig):
    ScoreModel for 'score', its tables of param_dtype, else the baseline
    arch of `nn.baselines`, whose tables are f32 whatever param_dtype
    says, as the reference's are; every table's lookups through
    `lookup_fn` (`sharding.make_lookup_fn`; None: the local gather)."""
    m = getattr(cfg, "model", cfg)
    check_supported(m)
    if m.arch == "score":
        return ScoreModel(m, num_users, num_items, lookup_fn)
    from . import baselines
    cls = {"mf": baselines.MFModel, "pop": baselines.PopModel,
           "svdpp": baselines.SVDPPModel,
           "delf": baselines.DELFModel}[m.arch]
    return cls(m, num_users, num_items, lookup_fn)


def _encoder(kind: str, in_dim: int, features: int) -> nn.Module:
    """The sequence encoder `kind`: xs [B, T, in_dim], mask [B, T] ->
    [B, T, features]."""
    if kind == "gru":
        return GRU(in_dim, features)
    from .baselines import CaserEncoder, SelfAttnEncoder
    cls = CaserEncoder if kind == "caser" else SelfAttnEncoder
    return cls(in_dim, features)


class ScoreModel(nn.Module):
    """Neighbour-based sequential scorer (the SCoRe family, configs0-3)."""

    def __init__(self, cfg: ModelConfig, num_users: int, num_items: int,
                 lookup_fn=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.num_users, self.num_items = num_users, num_items
        self.compute_dtype = DTYPES[cfg.compute_dtype]
        self.dual = cfg.sides == "dual"
        d, f = cfg.embed_dim, cfg.hidden_dim
        self.tables = EmbeddingTables(num_users, num_items, d,
                                      shared=cfg.shared_table,
                                      lookup_fn=lookup_fn,
                                      dtype=DTYPES[cfg.param_dtype])
        if cfg.slot_agg == "coattn":
            self.coattn = CrossCoAttention(d, pool=cfg.coattn_pool,
                                           target_aware=cfg.target_aware)
        elif cfg.slot_agg == "attn":
            self.slot_attn_u = SlotAttention(d)
            if self.dual:
                self.slot_attn_i = SlotAttention(d)
        self.gru_u = _encoder(cfg.seq_encoder, d, f)
        if self.dual:
            self.gru_i = _encoder(cfg.seq_encoder, d, f)
        if cfg.seq_pool == "attn":
            self.pool_u = AttnPool(f, d)
            if self.dual:
                self.pool_i = AttnPool(f, d)
        self.scorer = Scorer(scorer_width(cfg), cfg.mlp_dims,
                             self.compute_dtype, cfg.dropout)

    def forward(self, batch: dict) -> torch.Tensor:
        """Flat (u, i) pairs: the candidates form with C == 1 -> [B]."""
        return self.score_candidates(candidates_form(batch, self.dual))[:, 0]

    def score_candidates(self, batch: dict,
                         neg_shift: Optional[Sequence[int]] = None,
                         dropout_masks: Optional[Sequence[torch.Tensor]]
                         = None) -> torch.Tensor:
        """One user vs C candidate items (batch from
        `graph.gather_candidate_batch`; with sides='user' the item side's
        i_hist and i_cnt are not read) -> logits [B, C] in f32.

        Lookups gather from the tables (f32, or bf16 with param_dtype
        bf16) and cast after the gather, so the tables' gradients arrive
        in the tables' dtype. `neg_shift` (k in-batch
        shifts, C == 1 only): candidate c >= 1 of example b is example
        (b + neg_shift[c-1]) mod B's positive, its item side a batch roll
        of the embedded tensors -> logits [B, 1 + k]. In training mode
        the scorer's dropout takes `dropout_masks` (one bool mask a hidden
        layer, [B, C, width]) or draws them from torch's default
        generator (`train.train_step` draws them from the step's)."""
        cfg, dual = self.cfg, self.dual
        cdt = self.compute_dtype
        sv = batch["slot_valid"]                                  # [B, T]
        # every lookup of the step, one grouped gather a table
        users = [batch["user"]] + ([batch["i_hist"]] if dual else [])
        user_rows, (ei, Eu) = self.tables.lookup(
            users, [batch["cand"], batch["u_hist"]])
        eu = user_rows[0].to(cdt)                                 # [B, d]
        ei = ei.to(cdt)                                           # [B, C, d]
        if neg_shift is not None:
            if ei.shape[1] != 1:
                raise ValueError(f"neg_shift needs C == 1 candidates, got "
                                 f"C={ei.shape[1]}")
            ei = roll_candidates(ei, neg_shift)
        B, C = ei.shape[0], ei.shape[1]
        T = sv.shape[1]
        # user side: shared by the candidates
        Eu = Eu.to(cdt)                                           # [B,T,n,d]
        mu = _nbr_mask(batch["u_cnt"], Eu.shape[2], sv)           # [B,T,n]
        eu_c = eu[:, None].expand(B, C, eu.shape[-1])
        if dual:
            # [B,C,T,m,d]; [B,1,T,m,d] before the rolls with neg_shift
            Ei = user_rows[1].to(cdt)
            i_cnt = batch["i_cnt"]                                # [B, C, T]
            if neg_shift is not None:
                i_cnt = roll_candidates(i_cnt, neg_shift)
                if cfg.slot_agg != "coattn":    # coattn rolls Ei itself
                    Ei = roll_candidates(Ei, neg_shift)
            mi = _nbr_mask(i_cnt, Ei.shape[3], sv[:, None])       # [B,C,T,m]

        # per-slot aggregation: cu [B, Cu, T, d] with Cu = 1 where it does
        # not depend on the candidate (the mean), ci [B, C, T, d]
        if cfg.slot_agg == "coattn":
            cu, ci = self.coattn(Eu, Ei, mu, mi, eu, ei, i_shifts=neg_shift)
        elif cfg.slot_agg == "attn":
            cu = self.slot_attn_u(Eu[:, None], mu[:, None], ei)
            if dual:
                ci = self.slot_attn_i(Ei, mi, eu_c)
        else:
            cu = slot_mean(Eu, mu)[:, None]
            if dual:
                ci = slot_mean(Ei, mi)

        h_u = self._encode(self.gru_u, getattr(self, "pool_u", None), cu,
                           ei, sv).expand(B, C, -1)               # [B,C,f]
        if not dual:
            feats = [h_u, eu_c, ei, eu_c * ei]
        else:
            h_i = self._encode(self.gru_i, getattr(self, "pool_i", None),
                               ci, eu_c, sv)
            feats = [h_u, h_i, eu_c, ei, h_u * h_i, eu_c * ei]
        return self.scorer(feats, dropout_masks)                 # [B, C]

    @staticmethod
    def _encode(gru: nn.Module, pool: Optional[AttnPool], c: torch.Tensor,
                query: torch.Tensor, sv: torch.Tensor) -> torch.Tensor:
        """The sequence encoder over the slots of each of the B*Ch
        sequences c [B, Ch, T, d], then the attention pool with `query`
        [B, C, dq] or (pool None) the last valid state -> [B, C, f] (or
        [B, 1, f] for the last state of a shared sequence). The GRU
        computes in c's dtype; the Caser and SASRec encoders in f32, as
        the reference's flax modules without a dtype do."""
        B, Ch, T, _ = c.shape
        sv_c = sv[:, None].expand(B, Ch, T).reshape(B * Ch, T)
        hs = gru(c.reshape(B * Ch, T, -1), sv_c)                  # [B*Ch,T,f]
        if pool is not None:
            return pool(hs.reshape(B, Ch, T, -1), query, sv)
        return last_pool(hs, sv_c).reshape(B, Ch, -1)


def scorer_width(cfg: ModelConfig) -> int:
    """The scorer's input width: [h_u, eu, ei, eu*ei] on the user side
    alone, [h_u, h_i, eu, ei, h_u*h_i, eu*ei] with both sides."""
    d, f = cfg.embed_dim, cfg.hidden_dim
    return 3 * f + 3 * d if cfg.sides == "dual" else f + 3 * d
