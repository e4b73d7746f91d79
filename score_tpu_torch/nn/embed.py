"""Embedding tables and their lookups.

Counterpart of score_tpu/nn/embed.py. Row 0 of every table is the padding
row; padding is handled by masks where the rows are used, never by zeroing
the row. Row counts are rounded up to a multiple of 64 (the pad rows are
never addressed by valid ids), so row-sharding over any rows axis that
divides 64 needs no repadding. The tables are f32 or, as the reference's
`param_dtype` makes them, bf16. Lookups go through the gather kernel,
whose backward (the scatter-add kernel) gives the tables their gradients
in their own dtype;
`lookup` groups all of a step's lookups into each table, so each table's
gradient is one scatter-add. With a `lookup_fn` (`sharding.make_lookup_fn`)
the tables are row blocks and each lookup is its own exchange over the
mesh, its rows' gradients still one scatter-add into each block.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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
    users. Parameters start empty, of `dtype`; `score_tpu_torch.params`
    fills them. `overflow` sums the a2a lookups' overflow counts since it
    was last reset to None, as the reference sows them."""

    def __init__(self, num_users: int, num_items: int, dim: int,
                 shared: bool = False, lookup_fn=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_items = num_items
        self.shared = shared
        self.lookup_fn = lookup_fn
        self.overflow: Optional[torch.Tensor] = None
        if shared:
            rows = round_up(1 + num_items + num_users)
            self.table = nn.Parameter(torch.empty(rows, dim, dtype=dtype))
        else:
            self.user_table = nn.Parameter(
                torch.empty(round_up(1 + num_users), dim, dtype=dtype))
            self.item_table = nn.Parameter(
                torch.empty(round_up(1 + num_items), dim, dtype=dtype))

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
            out = self._gather(self.table, [*items, *offset])
            return out[len(items):], out[:len(items)]
        return (self._gather(self.user_table, users),
                self._gather(self.item_table, items))

    def _gather(self, table: torch.Tensor, ids: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
        if self.lookup_fn is None:
            return gather_rows_grouped(table, ids)
        out, overflow = self.lookup_fn.grouped(table, ids)
        if overflow is not None:
            total = overflow.sum()
            self.overflow = (total if self.overflow is None
                             else self.overflow + total)
        return out
