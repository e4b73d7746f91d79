"""The end-to-end arithmetic: a rate over a window that holds a stall
falls, the p95 is taken over all calls, and the run's end-to-end line
has each metric of its cell."""

import time

import numpy as np
import pytest
import torch

from portbench import run
from portbench.harness.kinds import serve


class _Service:
    """score_batch in `dt` seconds; the `stall_at`-th call in `stall`."""

    def __init__(self, dt, stall_at=None, stall=0.0):
        self.dt, self.stall_at, self.stall, self.calls = dt, stall_at, \
            stall, 0

    def score_batch(self, users, items):
        self.calls += 1
        time.sleep(self.stall if self.calls == self.stall_at else self.dt)
        return np.zeros(items.shape, np.float32)


def _window(svc, seconds=0.6):
    cell = run.Cell("x", {}, dict(requests_per_call=4), 1,
                    torch.device("cpu"))
    cell.state.update(svc=svc, users=np.zeros((2, 4), np.int32),
                      items=np.zeros((2, 4, 3), np.int32), kept={})
    return serve.window(cell, seconds)


def test_a_stall_in_the_window_lowers_the_rate():
    calm = _window(_Service(0.01))
    stalled = _window(_Service(0.01, stall_at=5, stall=0.3))
    assert stalled["serve_requests_per_s"] < \
        0.75 * calm["serve_requests_per_s"]


def test_p95_is_over_all_calls():
    lat = [0.01] * 94 + [1.0] * 6
    assert serve.p95(lat) == pytest.approx(1.0)
    assert serve.p95([0.01] * 95 + [1.0] * 5) == pytest.approx(0.01)
    assert serve.p95(list(range(1, 21))) == 19


def test_end_to_end_line_has_the_cells_metrics():
    from conftest import small
    cfg, tr = small("score_taobao.train")
    loose = {k: {"limit": 1.0} for k in ("grad_median_gap", "change_gap")}
    out = run.run_cell("score_taobao.train", 3, 0.2, False, device="cpu",
                       config=cfg, traffic=tr, limits=loose)
    assert set(out["metrics"]) == {"train_examples_per_s", "setup_s"}
    assert out["metrics"]["train_examples_per_s"]["unit"] == "examples/s"
    assert out["attempted"] > 0 and out["failed"] == 0
