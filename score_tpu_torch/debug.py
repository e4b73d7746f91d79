"""Numeric and bounds sanitizers.

Counterpart of score_tpu/debug.py. The realistic corruption in a
recommender is an out-of-range id that silently gathers a wrong row (the
gather kernel reads whatever row an id names, and an id past the table
reads memory it does not own). Tools:

  * enable_nan_checks()      autograd's anomaly mode with NaN checks
  * check_batch_bounds(...)  host-side id-range validation of a batch
  * checked_lookup(...)      a gather that raises on out-of-range ids
                             instead of reading past the table, for debug
                             runs
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.gather import gather_rows


def enable_nan_checks(on: bool = True) -> None:
    """torch.autograd.set_detect_anomaly(on, check_nan=True): a backward
    function that returns a NaN gradient raises, naming the forward op
    that made it. Unlike the reference's jax_debug_nans, which checks the
    output of every jitted computation, forward included, this checks the
    backward only: a NaN in a forward (a loss, a score) passes until a
    gradient carries it. It also records a traceback per op, which slows
    every step: for debug runs only."""
    torch.autograd.set_detect_anomaly(on, check_nan=True)


def check_batch_bounds(batch: dict, num_users: int, num_items: int) -> None:
    """Raise ValueError on any id outside [0, num_*] (0 = padding): users
    and the items' user histories (i_hist) against num_users; items,
    candidates and the users' item histories (u_hist) against num_items."""
    def _chk(name, arr, hi):
        a = np.asarray(arr.cpu() if isinstance(arr, torch.Tensor) else arr)
        if a.size and (a.min() < 0 or a.max() > hi):
            raise ValueError(
                f"{name}: ids outside [0, {hi}] (min {a.min()}, "
                f"max {a.max()})")

    if "user" in batch:
        _chk("user", batch["user"], num_users)
    for key in ("item", "cand", "u_hist"):
        if key in batch:
            _chk(key, batch[key], num_items)
    if "i_hist" in batch:
        _chk("i_hist", batch["i_hist"], num_users)


def checked_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] through the gather kernel (its plain version on the CPU),
    after raising ValueError on a negative id or one past the table's rows.
    The check reads two values back from the device, so it waits for it:
    a debug drop-in, not a step's lookup."""
    if ids.numel():
        lo, hi = (int(v) for v in torch.aminmax(ids))
        if lo < 0:
            raise ValueError(f"negative embedding id ({lo})")
        if hi >= table.shape[0]:
            raise ValueError(f"embedding id beyond table rows ({hi} >= "
                             f"{table.shape[0]})")
    return gather_rows(table, ids.to(torch.int32))
