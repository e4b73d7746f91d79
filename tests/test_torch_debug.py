"""The port's sanitizers and profiling tools (score_tpu_torch/debug.py,
profiling.py), mirroring tests/test_debug.py: host-side batch bounds, a
lookup that raises on out-of-range ids instead of reading past the
table, autograd's NaN checks; a torch.profiler window that writes a
Chrome trace (also `train()`'s profile_dir window), timing, and a FLOP
count."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from score_tpu_torch import profiling
from score_tpu_torch.config import configs0
from score_tpu_torch.debug import (check_batch_bounds, checked_lookup,
                                   enable_nan_checks)
from score_tpu_torch.kernels.gather import gather_rows
from score_tpu_torch.train import train

torch.set_num_threads(2)


def test_check_batch_bounds_ok():
    check_batch_bounds(dict(user=np.array([1, 2]), item=np.array([3]),
                            u_hist=np.array([[0, 1]]),
                            i_hist=torch.tensor([[2]])),
                       num_users=5, num_items=5)


@pytest.mark.parametrize("batch, name", [
    (dict(item=np.array([7])), "item"),
    (dict(i_hist=np.array([-1])), "i_hist"),
    (dict(user=torch.tensor([6])), "user"),
    (dict(cand=np.array([[1, 6]])), "cand")])
def test_check_batch_bounds_rejects(batch, name):
    with pytest.raises(ValueError, match=name):
        check_batch_bounds(batch, 5, 5)


def test_checked_lookup():
    """In-range ids gather as the gather kernel does; a negative id or
    one past the rows raises, where a plain gather would read past the
    table."""
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    rows = checked_lookup(table, torch.tensor([0, 3], dtype=torch.int32))
    assert torch.equal(rows, gather_rows(table, torch.tensor(
        [0, 3], dtype=torch.int32)))
    assert rows.shape == (2, 3)
    assert checked_lookup(table, torch.zeros(0, dtype=torch.int32)).shape \
        == (0, 3)
    with pytest.raises(ValueError, match="beyond table rows"):
        checked_lookup(table, torch.tensor([0, 4]))
    with pytest.raises(ValueError, match="negative"):
        checked_lookup(table, torch.tensor([[-1, 2]]))


def test_nan_checks_raise_in_the_backward():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    try:
        enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
        assert torch.is_anomaly_check_nan_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    torch.sqrt(x).sum().backward()      # off: no check


def test_maybe_profile_writes_a_chrome_trace(tmp_path):
    with profiling.maybe_profile(None) as prof:
        assert prof is None
    with profiling.maybe_profile(str(tmp_path / "p"), "w", device="cpu"):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    trace = json.loads((tmp_path / "p" / "w.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])


def test_timed_and_cost_summary():
    a, b = torch.ones(16, 32), torch.ones(32, 8)
    calls = []

    def fn(x, y):
        calls.append(1)
        return x @ y
    secs = profiling.timed(fn, a, b, reps=3)
    assert secs > 0 and len(calls) == 4        # one untimed call first
    cost = profiling.cost_summary(fn, a, b)
    assert cost["flops"] == 2 * 16 * 32 * 8
    assert math.isnan(cost["bytes_accessed"])
    assert profiling._first_device([{"k": (1, b)}]) == torch.device("cpu")


def test_train_profile_dir_writes_its_window(tiny_dataset, tmp_path):
    """cfg.train.profile_dir: `train()` profiles steps 10-30 and writes
    trace_step10.json."""
    cfg = configs0()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, embed_dim=8, hidden_dim=8,
                                  mlp_dims=(16, 8)),
        train=dataclasses.replace(
            cfg.train, batch_size=256, num_epochs=1, eval_max_targets=64,
            log_every_steps=10 ** 9, profile_dir=str(tmp_path)))
    out = train(cfg, tiny_dataset, verbose=False, device="cpu")
    assert out["steps_run"] >= 30
    trace = json.loads((tmp_path / "trace_step10.json").read_text())
    assert trace["traceEvents"]
