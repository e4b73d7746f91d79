"""The SCoRe model (configs3: full cross-neighbour co-attention).

Counterpart of score_tpu/nn/model.py:ScoreModel, for serving and for
training with in-batch negatives (`neg_shift`). Submodule
and parameter names mirror the flax tree (tables, coattn, gru_u, gru_i,
pool_u, pool_i, scorer), so `score_tpu_torch.params` maps one onto the
other. Only configs3, with the sum, mean or max co-attention pool, is
ported; other configurations raise NotImplementedError.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..config import Config, ModelConfig
from .coattn import CrossCoAttention, roll_candidates
from .embed import EmbeddingTables
from .encoder import GRU, AttnPool
from .scorer import Scorer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for anything but configs3 (any
    co-attention pool) in f32 or bf16 compute over f32 parameters."""
    want = dict(arch="score", sides="dual", slot_agg="coattn",
                seq_encoder="gru", seq_pool="attn")
    bad = {k: getattr(cfg, k) for k, v in want.items()
           if getattr(cfg, k) != v}
    if bad or cfg.compute_dtype not in _DTYPES:
        raise NotImplementedError(
            f"score_tpu_torch ports configs3 with f32 or bf16 compute only; "
            f"got {bad or cfg.compute_dtype}")
    # the master weights are f32: the table-gradient scatter-add takes f32
    if cfg.param_dtype != "float32":
        raise NotImplementedError(
            f"score_tpu_torch keeps float32 parameters only; got "
            f"param_dtype={cfg.param_dtype!r}")


def check_config(cfg: Config) -> None:
    """check_supported on the model, and refuse a sharded layout: the port
    runs on one device, and a sharded config must not run as an unsharded
    one."""
    check_supported(cfg.model)
    sh = cfg.sharding
    if sh.num_data * sh.num_rows > 1:
        raise NotImplementedError(
            f"score_tpu_torch runs on one device; sharding is not ported "
            f"(num_data={sh.num_data}, num_rows={sh.num_rows})")


def _nbr_mask(cnt: torch.Tensor, fanout: int,
              slot_valid: torch.Tensor) -> torch.Tensor:
    """[..., T, k] bool: neighbour j of slot t valid iff j < cnt and t < t*."""
    j = torch.arange(fanout, dtype=cnt.dtype, device=cnt.device)
    return (j < cnt[..., None]) & slot_valid[..., None]


class ScoreModel(nn.Module):
    """Dual-side neighbour-based sequential scorer (configs3)."""

    def __init__(self, cfg: ModelConfig, num_users: int, num_items: int):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.num_users, self.num_items = num_users, num_items
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        d, f = cfg.embed_dim, cfg.hidden_dim
        self.tables = EmbeddingTables(num_users, num_items, d,
                                      shared=cfg.shared_table)
        self.coattn = CrossCoAttention(d, pool=cfg.coattn_pool,
                                       target_aware=cfg.target_aware)
        self.gru_u = GRU(d, f)
        self.gru_i = GRU(d, f)
        self.pool_u = AttnPool(f, d)
        self.pool_i = AttnPool(f, d)
        self.scorer = Scorer(3 * f + 3 * d, cfg.mlp_dims, self.compute_dtype)

    def forward(self, batch: dict) -> torch.Tensor:
        """Flat (u, i) pairs: the candidates form with C == 1 -> [B]."""
        cb = dict(batch, cand=batch["item"][:, None],
                  i_hist=batch["i_hist"][:, None],
                  i_cnt=batch["i_cnt"][:, None])
        return self.score_candidates(cb)[:, 0]

    def score_candidates(self, batch: dict,
                         neg_shift: Optional[Sequence[int]] = None
                         ) -> torch.Tensor:
        """One user vs C candidate items (batch from
        `graph.gather_candidate_batch`) -> logits [B, C] in f32.

        Lookups gather from the f32 tables and cast after the gather, so
        the tables' gradients arrive in f32. `neg_shift` (k in-batch
        shifts, C == 1 only): candidate c >= 1 of example b is example
        (b + neg_shift[c-1]) mod B's positive, its item side a batch roll
        of the embedded tensors -> logits [B, 1 + k]."""
        cdt = self.compute_dtype
        sv = batch["slot_valid"]                                  # [B, T]
        eu = self.tables.user_emb(batch["user"]).to(cdt)          # [B, d]
        ei = self.tables.item_emb(batch["cand"]).to(cdt)          # [B, C, d]
        i_cnt = batch["i_cnt"]                                    # [B, C, T]
        if neg_shift is not None:
            if ei.shape[1] != 1:
                raise ValueError(f"neg_shift needs C == 1 candidates, got "
                                 f"C={ei.shape[1]}")
            ei = roll_candidates(ei, neg_shift)
            i_cnt = roll_candidates(i_cnt, neg_shift)
        B, C = ei.shape[0], ei.shape[1]
        T = sv.shape[1]
        # user side: shared by the candidates
        Eu = self.tables.item_emb(batch["u_hist"]).to(cdt)        # [B,T,n,d]
        mu = _nbr_mask(batch["u_cnt"], Eu.shape[2], sv)           # [B,T,n]
        # [B,C,T,m,d]; [B,1,T,m,d] before the rolls with neg_shift
        Ei = self.tables.user_emb(batch["i_hist"]).to(cdt)
        mi = _nbr_mask(i_cnt, Ei.shape[3], sv[:, None])           # [B,C,T,m]
        eu_c = eu[:, None].expand(B, C, eu.shape[-1])

        cu, ci = self.coattn(Eu, Ei, mu, mi, eu, ei,
                             i_shifts=neg_shift)                  # [B,C,T,d]
        # cu depends on the candidate, so the user GRU runs on B*C sequences
        sv_c = sv[:, None].expand(B, C, T).reshape(B * C, T)
        hu_seq = self.gru_u(cu.reshape(B * C, T, -1), sv_c).reshape(
            B, C, T, -1)
        h_u = self.pool_u(hu_seq, ei, sv)                         # [B,C,f]
        hi_seq = self.gru_i(ci.reshape(B * C, T, -1), sv_c).reshape(
            B, C, T, -1)
        h_i = self.pool_i(hi_seq, eu_c, sv)
        feats = [h_u, h_i, eu_c, ei, h_u * h_i, eu_c * ei]
        return self.scorer(feats)                                 # [B, C]
