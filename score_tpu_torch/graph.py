"""Device-resident graph store and the per-request history gather.

Counterpart of score_tpu/graph.py. The dense padded adjacency lives on the
device, node-major (a node's full history [T, k] is one contiguous row), and
the history of a batch of targets is one row gather per side through the
gather kernel. Under a mesh the graph is row-sharded
(`sharding.shard_graph`) and each side's rows come from their owners
through the exact a2a exchange (`sharding.graph_rows`), one exchange a
side. The slot-validity mask is `t < t*`, so a target never sees
its own or future slots. `subsample_neighbors` re-draws a narrower
uniform subset of a stored history (DataConfig.neighbor_resample).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .data.schema import GraphStore
from .kernels.gather import gather_rows
from .sharding import ShardedGraph, graph_rows, make_lookup_fn, shard_graph


@dataclasses.dataclass
class DeviceGraph:
    """Dense padded per-slot adjacency as int32 tensors on one device."""

    u2i: torch.Tensor      # [U+1 padded, T, n]
    u2i_cnt: torch.Tensor  # [U+1 padded, T]
    i2u: torch.Tensor      # [I+1 padded, T, m]
    i2u_cnt: torch.Tensor  # [I+1 padded, T]

    @property
    def num_slots(self) -> int:
        return self.u2i.shape[1]

    @property
    def device(self) -> torch.device:
        return self.u2i.device

    @property
    def fanouts(self) -> Tuple[int, int]:
        return self.u2i.shape[-1], self.i2u.shape[-1]


NODE_MULTIPLE = 64


def _pad_nodes(a: np.ndarray) -> np.ndarray:
    """Pad the node axis to a multiple of 64; pad rows are zero and never
    addressed by valid node ids."""
    pad = (-a.shape[0]) % NODE_MULTIPLE
    if pad == 0:
        return a
    return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))


def device_graph(g: GraphStore, device) -> DeviceGraph:
    """Transpose the slot-major GraphStore to node-major once, pad the node
    axis and move it to `device`."""
    def put(a):
        a = _pad_nodes(np.ascontiguousarray(a))
        return torch.from_numpy(a.astype(np.int32)).to(device)
    return DeviceGraph(
        u2i=put(g.u2i.transpose(1, 0, 2)), u2i_cnt=put(g.u2i_cnt.T),
        i2u=put(g.i2u.transpose(1, 0, 2)), i2u_cnt=put(g.i2u_cnt.T))


def mesh_graph(g: GraphStore, mesh, lookup_mode: str):
    """A GraphStore as a model under `mesh` reads it: row-sharded
    (`sharding.shard_graph`, cut on the host so only the blocks reach the
    device) where `lookup_mode` row-shards the tables
    (`sharding.make_lookup_fn` gives an exchange), else whole on
    mesh.device, as the data-parallel 'local' tables are."""
    if make_lookup_fn(mesh, lookup_mode) is None:
        return device_graph(g, mesh.device)
    return shard_graph(mesh, device_graph(g, "cpu"))


def gather_side(adj: torch.Tensor, cnt: torch.Tensor, nodes: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """adj [N, T, k], cnt [N, T], nodes [...] int32 -> hist [..., T, k]
    neighbour ids and hcnt [..., T] true counts."""
    N, T, k = adj.shape
    hist = gather_rows(adj.view(N, T * k), nodes).view(*nodes.shape, T, k)
    return hist, gather_rows(cnt, nodes)


def _histories(g, side: str, nodes: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `side` ('user' or 'item') histories of `nodes`: gather_side on a
    whole graph, or the packed rows through the exchange on a sharded one,
    split into hist [..., T, k] and hcnt [..., T]."""
    if isinstance(g, ShardedGraph):
        rows = graph_rows(g.mesh, getattr(g, side), nodes)
        T = g.num_slots
        return rows[..., :-T].unflatten(-1, (T, -1)), rows[..., -T:]
    if side == "user":
        return gather_side(g.u2i, g.u2i_cnt, nodes)
    return gather_side(g.i2u, g.i2u_cnt, nodes)


def slot_valid_mask(slots: torch.Tensor, num_slots: int) -> torch.Tensor:
    """[B, T] bool: slot t is usable history for a target at t* iff t < t*."""
    t = torch.arange(num_slots, dtype=slots.dtype, device=slots.device)
    return t[None, :] < slots[:, None]


def subsample_neighbors(hist: torch.Tensor, cnt: torch.Tensor, k: int,
                        keys: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A uniform k-subset, without replacement, of each row's valid
    neighbours: hist [..., S] ids, cnt [...] valid counts, keys [..., S]
    uniform draws in [0, 1) -> ([..., k], min(cnt, k)). The top k of the
    keys over the valid prefix (the others' keys set to -1, so they sort
    last) pick the sample; a row of fewer than k valid neighbours keeps
    them all, first, and some of its invalid ones after them, which its
    count masks. Rows no wider than k come back as they are."""
    S = hist.shape[-1]
    if S <= k:
        return hist, cnt
    j = torch.arange(S, dtype=cnt.dtype, device=cnt.device)
    keys = torch.where(j < cnt[..., None], keys, -1.0)
    idx = torch.topk(keys, k, dim=-1).indices
    return torch.take_along_dim(hist, idx, dim=-1), cnt.clamp_max(k)


def gather_batch(g, users: torch.Tensor, items: torch.Tensor,
                 slots: torch.Tensor) -> dict:
    """The model's history inputs for B (user, item) targets: users, items
    and slots [B] -> {user, item, slot, u_hist [B, T, n], u_cnt, i_hist
    [B, T, m], i_cnt, slot_valid}. `g` is a DeviceGraph or, under a mesh,
    a ShardedGraph (likewise below)."""
    u_hist, u_cnt = _histories(g, "user", users)
    i_hist, i_cnt = _histories(g, "item", items)
    return dict(user=users, item=items, slot=slots, u_hist=u_hist,
                u_cnt=u_cnt, i_hist=i_hist, i_cnt=i_cnt,
                slot_valid=slot_valid_mask(slots, g.num_slots))


def gather_candidate_batch(g, users: torch.Tensor,
                           cand: torch.Tensor, slots: torch.Tensor,
                           item_side: bool = True) -> dict:
    """History inputs for B users vs C candidate items each
    (ScoreModel.score_candidates). users/slots: [B]; cand: [B, C]. The
    user-side gather runs once per user, not per candidate. With
    item_side=False (a model of sides='user', which reads no item-side
    history) the candidates' histories are not gathered."""
    u_hist, u_cnt = _histories(g, "user", users)
    out = dict(user=users, slot=slots, u_hist=u_hist, u_cnt=u_cnt, cand=cand,
               slot_valid=slot_valid_mask(slots, g.num_slots))
    if item_side:
        out["i_hist"], out["i_cnt"] = _histories(g, "item", cand)
    return out
