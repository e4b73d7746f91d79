"""Online scoring service over a model of the preset ladder (configs0-3)
or of the baseline roster, and the device graph.

Counterpart of score_tpu/serve.py:ScoringService (score, score_batch,
topk, topk_batch, from_checkpoint):

    svc = ScoringService(cfg, dataset, state_dict, device="cuda")
    svc = ScoringService.from_checkpoint(cfg, dataset, ckpt_dir)   # or
    scores = svc.score(user_id, item_ids)          # [len(item_ids)]
    items, scores = svc.topk(user_id, k=10)        # full catalogue
    items, scores = svc.topk_batch(user_ids, k=10) # [R, k] each

Under a (data, rows) mesh (`ScoringService(..., mesh=mesh)`, every rank
of the world constructing it) each rank holds its row block of the
tables and of the graph, and every rank passes the same request and
gets the same scores: each scores the whole request, its lookups and the
graph's histories coming from their owners through the exchange of
cfg.sharding.lookup_mode at its exact capacity. Without a mesh a sharded
config's weights are served whole on one device, as the reference's
`mesh=None` serves them.

Request shapes are padded to fixed buckets, as in the reference. Candidate
lists wider than `candidate_chunk` are scored in blocks of that width, all
blocks dispatched before any is read back; a full-catalogue `topk` lays
the catalogue out as rows of `topk_grid_rows` same-user requests.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config, ShardingConfig
from .data.schema import Dataset
from .graph import device_graph, gather_candidate_batch, mesh_graph
from .nn.model import (build_model, check_config, check_device,
                       stored_fanouts)
from .params import assign_weights, cast_tables
from .sharding import make_lookup_fn, shard_params

_BUCKETS = (1, 16, 64, 256, 1024, 4096)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return -(-n // _BUCKETS[-1]) * _BUCKETS[-1]


class ScoringService:
    """Scorer over the model and graph, resident on one `device` (the CUDA
    card unless the caller asks for another, as the CPU tests do), or on
    mesh.device under a `mesh`."""

    def __init__(self, cfg: Config, ds: Dataset,
                 state_dict: Mapping[str, torch.Tensor],
                 slot: Optional[int] = None, candidate_chunk: int = 4096,
                 topk_grid_rows: int = 16, device="cuda", mesh=None):
        """`state_dict`: the weights, whole, as they are (f32, the tables
        f32 or, of param_dtype bf16, bf16); under a mesh they may also be
        this rank's row blocks of the tables (what `from_checkpoint`
        restores). Whole tables are cut to this rank's blocks first and
        cast to the compute dtype after (an f32 table to bf16 under bf16
        compute; a bf16 table stays bf16, and f32 compute casts its rows
        after the gather), so no full table is cast on the device."""
        if mesh is None:        # a sharded config's weights, served whole
            cfg = cfg.replace(sharding=ShardingConfig())
        self.device = torch.device(device) if mesh is None else mesh.device
        check_config(cfg, mesh)
        check_device(cfg, self.device, stored_fanouts(ds.graph))
        self.cfg = cfg
        self.mesh = mesh
        self.candidate_chunk = int(candidate_chunk)
        self.topk_grid_rows = int(topk_grid_rows)
        self.num_users = ds.num_users
        self.num_items = ds.num_items
        lookup_fn = None
        if mesh is None:
            self.graph = device_graph(ds.graph, self.device)
        else:           # serving sizes vary: the exact capacity, always
            lookup_fn = make_lookup_fn(mesh, cfg.sharding.lookup_mode)
            self.graph = mesh_graph(ds.graph, mesh, cfg.sharding.lookup_mode)
        self.model = build_model(cfg, ds.num_users, ds.num_items, lookup_fn)
        if lookup_fn is not None:
            whole = {k: p.shape[0]
                     for k, p in self.model.named_parameters()}
            state_dict = shard_params(mesh, state_dict, whole)
        sd = cast_tables(state_dict, cfg.model.compute_dtype)
        assign_weights(self.model,
                       {k: v.to(self.device) for k, v in sd.items()})
        self.model.eval()
        # default scoring slot: one past the last, so the whole history is
        # visible
        self.slot = ds.graph.num_slots if slot is None else slot
        # scores `topk_batch` may hold on the device before it merges them:
        # the reference's 64 dispatches of 16 rows at R = 16, at any R
        self.topk_pending_bytes = 64 * 16 * self.candidate_chunk * 4

    @classmethod
    def from_checkpoint(cls, cfg: Config, ds: Dataset, ckpt_dir: str,
                        which: str = "best", device="cuda", mesh=None,
                        **service_kw) -> "ScoringService":
        """Serve checkpoint `which` of a `train` run (its weights in their
        saved dtypes, read straight onto `device`). Under a `mesh` each
        rank reads only the rows it serves (of a sharded checkpoint of any
        layout, or of an unsharded one); without one a sharded checkpoint
        is read whole.
        `service_kw` passes on slot, candidate_chunk and topk_grid_rows."""
        from .checkpoint import CheckpointManager
        restored = CheckpointManager(ckpt_dir, mesh).restore(
            which, torch.device(device))
        if restored is None:
            raise FileNotFoundError(f"no '{which}' checkpoint in {ckpt_dir}")
        return cls(cfg, ds, restored["params"], device=device, mesh=mesh,
                   **service_kw)

    def score(self, user_id: int, item_ids: Sequence[int]) -> np.ndarray:
        """Pointwise scores for one user against a candidate list; the user
        history tower runs once for the request."""
        items = np.asarray(item_ids, np.int32)
        return self.score_batch(np.asarray([user_id], np.int32),
                                items[None, :])[0]

    @torch.inference_mode()
    def _dispatch(self, users: np.ndarray, items: np.ndarray) -> torch.Tensor:
        """One bucket-padded dispatch: [R] users x [R, n] candidates ->
        scores [rb, nb] on the device (the caller slices after readback)."""
        r, n = items.shape
        rb, nb = _bucket(r), _bucket(n)
        pu = np.zeros(rb, np.int32)
        pu[:r] = users
        pi = np.zeros((rb, nb), np.int32)
        pi[:r, :n] = items
        slots = np.full(rb, self.slot, np.int32)
        mb = gather_candidate_batch(
            self.graph, *(torch.from_numpy(a).to(self.device)
                          for a in (pu, pi, slots)),
            item_side=self.model.dual)
        return self.model.score_candidates(mb)

    def _check_ids(self, users: np.ndarray, items: np.ndarray) -> None:
        # ids index device tables with no bounds check: refuse bad ones here
        for name, ids, hi in (("user", users, self.num_users),
                              ("item", items, self.num_items)):
            if ids.size and (ids.min() < 0 or ids.max() > hi):
                raise ValueError(f"{name} ids must lie in [0, {hi}]")

    def score_batch(self, user_ids: Sequence[int], item_ids) -> np.ndarray:
        """Scores for R independent requests: `user_ids` [R], `item_ids`
        [R, n] -> [R, n]. n > candidate_chunk splits into blocks of that
        width; every block is dispatched before any is read back."""
        users = np.asarray(user_ids, np.int32)
        items = np.asarray(item_ids, np.int32)
        if items.ndim != 2 or items.shape[0] != users.size:
            raise ValueError(
                f"item_ids must be [R, n] with R == len(user_ids); got "
                f"{items.shape} vs R={users.size}")
        self._check_ids(users, items)
        r, n = items.shape
        chunk = self.candidate_chunk
        outs = [(self._dispatch(users, items[:, lo:lo + chunk]),
                 min(chunk, n - lo)) for lo in range(0, max(n, 1), chunk)]
        return np.concatenate(
            [o.cpu().numpy()[:r, :w] for o, w in outs], axis=1)

    def topk(self, user_id: int, k: int = 10,
             candidates: Optional[Sequence[int]] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k items for a user over `candidates` (default: the full
        catalogue), best first. Catalogue-wide requests are laid out as
        rows of [topk_grid_rows, candidate_chunk] per dispatch; grid pads
        are item 0 and are cut off after readback."""
        if candidates is None:
            candidates = np.arange(1, self.num_items + 1, dtype=np.int32)
        else:
            candidates = np.asarray(candidates, np.int32)
        n = candidates.size
        if n == 0 or k <= 0:
            return (np.empty(0, np.int32), np.empty(0, np.float32))
        chunk = self.candidate_chunk
        if n <= chunk:
            scores = self.score(user_id, candidates)
        else:
            grid = np.concatenate(
                [candidates, np.zeros((-n) % chunk, np.int32)]
            ).reshape(-1, chunk)
            rows = self.topk_grid_rows
            outs = [self.score_batch(np.full(min(rows, len(grid) - lo),
                                             user_id, np.int32),
                                     grid[lo:lo + rows])
                    for lo in range(0, grid.shape[0], rows)]
            scores = np.concatenate([o.reshape(-1) for o in outs])[:n]
        k = min(k, scores.size)
        part = np.argpartition(-scores, k - 1)[:k]
        order = part[np.argsort(-scores[part])]
        return candidates[order], scores[order]

    def topk_batch(self, user_ids: Sequence[int], k: int = 10,
                   candidates: Optional[Sequence[int]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k for R users over one shared candidate list (default: the
        full catalogue): ([R, k] items, [R, k] scores), each row best
        first.

        Each dispatch holds g = max(1, topk_grid_rows // R) consecutive
        candidate chunks for every user (rows are (user, chunk) pairs), so
        the batch axis stays full at small R. Dispatches run ahead and are
        merged into a running top-k per user once the scores waiting on
        the device reach `topk_pending_bytes`, so what is held stays
        bounded at any R and catalogue size. Grid pads (item 0 past the
        last candidate) are set to -inf before any merge."""
        users = np.asarray(user_ids, np.int32)
        r = users.size
        if candidates is None:
            candidates = np.arange(1, self.num_items + 1, dtype=np.int32)
        else:
            candidates = np.asarray(candidates, np.int32)
        self._check_ids(users, candidates)
        n = candidates.size
        if n == 0 or k <= 0 or r == 0:
            return (np.empty((r, 0), np.int32), np.empty((r, 0), np.float32))
        k = min(k, n)
        chunk = self.candidate_chunk
        g = max(1, self.topk_grid_rows // r)     # chunks a user a dispatch
        width = g * chunk                        # candidates a dispatch
        grid = np.concatenate([candidates, np.zeros((-n) % width, np.int32)]
                              ).reshape(-1, g, chunk)
        urow = np.repeat(users, g)               # [r * g], user-major
        best_i = np.empty((r, 0), np.int32)
        best_s = np.empty((r, 0), np.float32)

        def merge(pending):
            nonlocal best_i, best_s
            bi, bs = [best_i], [best_s]
            for out, j in pending:
                s = out.float().cpu().numpy()[:r * g, :chunk].reshape(
                    r, width)
                s[:, min(max(n - j * width, 0), width):] = -np.inf
                bi.append(np.broadcast_to(grid[j].reshape(-1), (r, width)))
                bs.append(s)
            all_i = np.concatenate(bi, axis=1)
            all_s = np.concatenate(bs, axis=1)
            kk = min(k, all_s.shape[1])
            part = np.argpartition(-all_s, kk - 1, axis=1)[:, :kk]
            best_i = np.take_along_axis(all_i, part, axis=1)
            best_s = np.take_along_axis(all_s, part, axis=1)

        pending, held = [], 0
        for j in range(grid.shape[0]):
            irow = np.ascontiguousarray(
                np.broadcast_to(grid[j][None], (r, g, chunk))
                .reshape(r * g, chunk))
            pending.append((self._dispatch(urow, irow), j))
            held += pending[-1][0].numel() * pending[-1][0].element_size()
            if held >= self.topk_pending_bytes:
                merge(pending)
                pending, held = [], 0
        if pending:
            merge(pending)
        order = np.argsort(-best_s, axis=1)
        return (np.take_along_axis(best_i, order, axis=1),
                np.take_along_axis(best_s, order, axis=1))
