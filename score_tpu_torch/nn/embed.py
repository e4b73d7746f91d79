"""Embedding tables and their lookups.

Counterpart of score_tpu/nn/embed.py. Row 0 of every table is the padding
row; padding is handled by masks where the rows are used, never by zeroing
the row. Row counts are rounded up to a multiple of 64 (the pad rows are
never addressed by valid ids). Lookups go through the gather kernel, whose
backward (the scatter-add kernel) gives the f32 tables their gradients;
`lookup` groups all of a step's lookups into each table, so each table's
gradient is one scatter-add.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..kernels.gather import gather_rows_grouped

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
        return self.lookup([ids], [])[0][0]

    def item_emb(self, ids: torch.Tensor) -> torch.Tensor:
        return self.lookup([], [ids])[1][0]

    def lookup(self, users: Sequence[torch.Tensor],
               items: Sequence[torch.Tensor]
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """The rows of the user ids `users` and of the item ids `items`
        (each [...] int32 -> [..., dim]), each table's lookups in one
        grouped gather: in the backward one scatter-add a table (the shared
        table's: items, then users, whose ids are offset by num_items)."""
        if self.shared:
            offset = [torch.where(u > 0, u + self.num_items,
                                  torch.zeros_like(u)) for u in users]
            out = gather_rows_grouped(self.table, [*items, *offset])
            return out[len(items):], out[:len(items)]
        return (gather_rows_grouped(self.user_table, users),
                gather_rows_grouped(self.item_table, items))
