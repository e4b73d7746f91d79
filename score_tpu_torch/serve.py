"""Online scoring service over the configs3 model and the device graph.

Counterpart of score_tpu/serve.py:ScoringService (score, score_batch,
topk):

    svc = ScoringService(cfg, dataset, state_dict, device="cuda")
    scores = svc.score(user_id, item_ids)          # [len(item_ids)]
    items, scores = svc.topk(user_id, k=10)        # full catalogue

Request shapes are padded to fixed buckets, as in the reference. Candidate
lists wider than `candidate_chunk` are scored in blocks of that width, all
blocks dispatched before any is read back; a full-catalogue `topk` lays
the catalogue out as rows of `topk_grid_rows` same-user requests.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config
from .data.schema import Dataset
from .graph import DeviceGraph, device_graph, gather_candidate_batch
from .nn.model import ScoreModel, check_config
from .params import cast_tables

_BUCKETS = (1, 16, 64, 256, 1024, 4096)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return -(-n // _BUCKETS[-1]) * _BUCKETS[-1]


class ScoringService:
    """Scorer over the model and graph, resident on one `device` (the CUDA
    card unless the caller asks for another, as the CPU tests do)."""

    def __init__(self, cfg: Config, ds: Dataset,
                 state_dict: Mapping[str, torch.Tensor],
                 slot: Optional[int] = None, candidate_chunk: int = 4096,
                 topk_grid_rows: int = 16, device="cuda"):
        check_config(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.candidate_chunk = int(candidate_chunk)
        self.topk_grid_rows = int(topk_grid_rows)
        self.num_users = ds.num_users
        self.num_items = ds.num_items
        self.graph: DeviceGraph = device_graph(ds.graph, self.device)
        self.model = ScoreModel(cfg.model, ds.num_users, ds.num_items)
        sd = cast_tables(state_dict, cfg.model.compute_dtype)
        self.model.load_state_dict(
            {k: v.to(self.device) for k, v in sd.items()}, assign=True)
        self.model.eval()
        # default scoring slot: one past the last, so the whole history is
        # visible
        self.slot = ds.graph.num_slots if slot is None else slot

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
                          for a in (pu, pi, slots)))
        return self.model.score_candidates(mb)

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
        # ids index device tables with no bounds check: refuse bad ones here
        for name, ids, hi in (("user", users, self.num_users),
                              ("item", items, self.num_items)):
            if ids.size and (ids.min() < 0 or ids.max() > hi):
                raise ValueError(f"{name} ids must lie in [0, {hi}]")
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
