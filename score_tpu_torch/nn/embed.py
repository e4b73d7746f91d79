"""Embedding tables and their lookups.

Counterpart of score_tpu/nn/embed.py. Row 0 of every table is the padding
row; padding is handled by masks where the rows are used, never by zeroing
the row. Row counts are rounded up to a multiple of 64 (the pad rows are
never addressed by valid ids). Lookups go through the gather kernel, whose
backward (the scatter-add kernel) gives the f32 tables their gradients.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.gather import gather_rows

ROW_MULTIPLE = 64


def round_up(rows: int) -> int:
    """Row count padded to a multiple of ROW_MULTIPLE."""
    return -(-rows // ROW_MULTIPLE) * ROW_MULTIPLE


class EmbeddingTables(nn.Module):
    """User/item tables; `shared=True` packs both into one table.

    Shared layout: index 0 = pad, 1..num_items = items, num_items+1.. =
    users. Parameters start empty; `score_tpu_torch.params` fills them."""

    def __init__(self, num_users: int, num_items: int, dim: int,
                 shared: bool = False):
        super().__init__()
        self.num_items = num_items
        self.shared = shared
        if shared:
            rows = round_up(1 + num_items + num_users)
            self.table = nn.Parameter(torch.empty(rows, dim))
        else:
            self.user_table = nn.Parameter(
                torch.empty(round_up(1 + num_users), dim))
            self.item_table = nn.Parameter(
                torch.empty(round_up(1 + num_items), dim))

    def user_emb(self, ids: torch.Tensor) -> torch.Tensor:
        if self.shared:
            return gather_rows(self.table, torch.where(
                ids > 0, ids + self.num_items, torch.zeros_like(ids)))
        return gather_rows(self.user_table, ids)

    def item_emb(self, ids: torch.Tensor) -> torch.Tensor:
        return gather_rows(self.table if self.shared else self.item_table,
                           ids)
