"""Packed-array dataset formats (SURVEY.md §2.3 #4, §3.1).

The port's own copy of score_tpu/data/schema.py, since score_tpu_torch
imports nothing of the JAX package. Keep the two equal:
tests/test_torch_nojax.py compares what they produce.

The reference holds its time-sliced bipartite graph as pickled host-RAM dicts
(SURVEY.md §1.2 L2). Here the on-disk format *is* the device-resident layout:

GraphStore — per-time-slot bipartite adjacency, two representations:
  * dense padded (canonical for the device):
      u2i[T, U+1, n]  int32   items user u touched in slot t, 0-padded
      u2i_cnt[T, U+1] int32   true counts (<= n; truncation sampled at prep)
      i2u[T, I+1, m], i2u_cnt[T, I+1]   symmetric item side
    Row 0 of each node axis is the padding node and is all-zero. This layout
    makes the per-batch history gather a single static-shape take — the op the
    north star moves on-device (BASELINE.json:5).
  * CSR (canonical for storage/API parity with the reference's
    `get_neighbors(node, slot)` interface):
      u2i_indptr[T, U+2] int64  (per-slot row pointers), u2i_indices int32
      (ditto item side)

Targets — labeled examples (u, i, t*, y=1 implicit) per split, plus fixed-seed
eval negatives:  neg[N_eval_targets, num_eval_neg] int32.

Slot convention: slots are 0..T-1; a target at slot t* may only see history in
slots t < t* (no leakage — SURVEY.md §2.4 step 1). Targets with t* == 0 are
dropped at prep (no history).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np


@dataclasses.dataclass
class GraphStore:
    """Time-sliced bipartite adjacency, dense-padded + CSR."""

    num_users: int                  # real users (ids 1..num_users)
    num_items: int
    num_slots: int
    u2i: np.ndarray                 # int32 [T, U+1, n]
    u2i_cnt: np.ndarray             # int32 [T, U+1]
    i2u: np.ndarray                 # int32 [T, I+1, m]
    i2u_cnt: np.ndarray             # int32 [T, I+1]
    u2i_indptr: np.ndarray          # int64 [T, U+2]
    u2i_indices: np.ndarray         # int32 [nnz_u]
    i2u_indptr: np.ndarray          # int64 [T, I+2]
    i2u_indices: np.ndarray         # int32 [nnz_i]

    @property
    def user_fanout(self) -> int:
        return self.u2i.shape[-1]

    @property
    def item_fanout(self) -> int:
        return self.i2u.shape[-1]

    # --- reference-parity lookup API (SURVEY.md §1.2 L2 interface) ---

    def get_neighbors(self, side: str, node: int, slot: int) -> np.ndarray:
        """All neighbors of `node` in `slot` (untruncated, from CSR)."""
        indptr, indices = (
            (self.u2i_indptr, self.u2i_indices) if side == "user"
            else (self.i2u_indptr, self.i2u_indices))
        s, e = indptr[slot, node], indptr[slot, node + 1]
        return indices[s:e]

    def get_history(self, side: str, node: int, up_to_slot: int):
        """List of neighbor sets for slots 0..up_to_slot-1 (strictly before)."""
        return [self.get_neighbors(side, node, t) for t in range(up_to_slot)]


@dataclasses.dataclass
class Targets:
    """Labeled positives for one split; eval splits carry fixed negatives."""

    user: np.ndarray                # int32 [N]
    item: np.ndarray                # int32 [N]
    slot: np.ndarray                # int32 [N]  (t*)
    neg: np.ndarray | None = None   # int32 [N, num_eval_neg] or None (train)

    def __len__(self) -> int:
        return int(self.user.shape[0])


@dataclasses.dataclass
class Dataset:
    graph: GraphStore
    train: Targets
    val: Targets
    test: Targets
    meta: Dict

    @property
    def num_users(self) -> int:
        return self.graph.num_users

    @property
    def num_items(self) -> int:
        return self.graph.num_items


def save_dataset(ds: Dataset, out_dir: str, compress: bool = True) -> None:
    """Write `ds` as load_dataset reads it. compress=False stores the arrays
    uncompressed: larger files, and no zlib pass, which dominates the time
    to save a large dataset."""
    os.makedirs(out_dir, exist_ok=True)
    g = ds.graph
    savez = np.savez_compressed if compress else np.savez
    savez(
        os.path.join(out_dir, "graph.npz"),
        u2i=g.u2i, u2i_cnt=g.u2i_cnt, i2u=g.i2u, i2u_cnt=g.i2u_cnt,
        u2i_indptr=g.u2i_indptr, u2i_indices=g.u2i_indices,
        i2u_indptr=g.i2u_indptr, i2u_indices=g.i2u_indices)
    for name, t in (("train", ds.train), ("val", ds.val), ("test", ds.test)):
        arrs = dict(user=t.user, item=t.item, slot=t.slot)
        if t.neg is not None:
            arrs["neg"] = t.neg
        savez(os.path.join(out_dir, f"targets_{name}.npz"), **arrs)
    meta = dict(ds.meta, num_users=g.num_users, num_items=g.num_items,
                num_slots=g.num_slots)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_dataset(out_dir: str) -> Dataset:
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    gz = np.load(os.path.join(out_dir, "graph.npz"))
    graph = GraphStore(
        num_users=meta["num_users"], num_items=meta["num_items"],
        num_slots=meta["num_slots"],
        u2i=gz["u2i"], u2i_cnt=gz["u2i_cnt"], i2u=gz["i2u"], i2u_cnt=gz["i2u_cnt"],
        u2i_indptr=gz["u2i_indptr"], u2i_indices=gz["u2i_indices"],
        i2u_indptr=gz["i2u_indptr"], i2u_indices=gz["i2u_indices"])

    def _load_targets(name):
        z = np.load(os.path.join(out_dir, f"targets_{name}.npz"))
        return Targets(user=z["user"], item=z["item"], slot=z["slot"],
                       neg=z["neg"] if "neg" in z.files else None)

    return Dataset(graph=graph, train=_load_targets("train"),
                   val=_load_targets("val"), test=_load_targets("test"),
                   meta=meta)
