"""Host-side batch pipeline (SURVEY.md §2.3 #6).

The port's own copy of score_tpu/data/pipeline.py, since score_tpu_torch
imports nothing of the JAX package. Keep the two equal:
tests/test_torch_nojax.py compares what they produce.

The reference's hot CPU loop — multiprocessing neighbor samplers padding
dense batches — disappears in this design: histories are gathered on-device
(score_tpu_torch.graph), negatives are drawn on-device, so the host
only streams (u, i, t*) int32 triples. What remains is a deterministic,
checkpointable shuffled-epoch iterator (state = (epoch, position), seeded
permutations — the grain-style contract, SURVEY.md §5 'failure detection').
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from .schema import Targets


class TargetIterator:
    """Infinite shuffled epoch iterator over training targets.

    Deterministic: permutation of epoch e is seeded by (seed, e); state is
    (epoch, pos) and `set_state` resumes exactly (checkpointable-iterator
    contract). Batches are fixed-size; an epoch's ragged tail is dropped
    (drop_last) so jit sees one shape.
    """

    def __init__(self, targets: Targets, batch_size: int, seed: int = 0):
        if len(targets) < batch_size:
            raise ValueError(
                f"batch_size {batch_size} > num targets {len(targets)}")
        self.targets = targets
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        self.pos = 0
        self._perm = self._make_perm(0)

    def _make_perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(len(self.targets))

    @property
    def steps_per_epoch(self) -> int:
        return len(self.targets) // self.batch_size

    def get_state(self) -> Tuple[int, int]:
        return (self.epoch, self.pos)

    def set_state(self, state: Tuple[int, int]) -> None:
        self.epoch, self.pos = state
        self._perm = self._make_perm(self.epoch)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self.pos + self.batch_size > self.steps_per_epoch * self.batch_size:
            self.epoch += 1
            self.pos = 0
            self._perm = self._make_perm(self.epoch)
        idx = self._perm[self.pos:self.pos + self.batch_size]
        self.pos += self.batch_size
        t = self.targets
        return dict(user=t.user[idx], item=t.item[idx], slot=t.slot[idx])


def eval_index_batches(n: int, batch_size: int
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Fixed-order eval batch (indices, weights): every batch is exactly
    batch_size wide (one jit shape); the ragged tail is padded by clamping
    indices to n-1 (row repeats) with weight 0 so metrics ignore padding.

    This is the single owner of eval tail-padding — `train.evaluate` slices
    the device-resident split with these indices (the split is shipped to
    the device once; only these tiny index vectors cross per batch)."""
    for start in range(0, n, batch_size):
        idx = np.arange(start, start + batch_size)
        weight = (idx < n).astype(np.float32)
        yield np.minimum(idx, n - 1), weight
