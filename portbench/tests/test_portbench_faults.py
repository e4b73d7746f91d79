"""The harness drives a run with the timed path broken underneath, and
`correct` comes out false: a step that leaves the state unchanged, half
of the batch left out (the mean over the rest), an answer altered where
it is produced; and the control, the reference in fp8 in the program's
place, reads past at least one limit of its cell."""

import pytest
import torch

from conftest import CELLS, small
from portbench import run


def _run(workload, seed=23):
    cfg, tr = small(workload)
    return run.run_cell(workload, seed, 0.3, False, device="cpu",
                        config=cfg, traffic=tr)


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from score_tpu_torch import optim

    def step(self, names, grads):
        self.count += 1
    monkeypatch.setattr(optim.Optimizer, "step", step)
    out = _run("score_taobao.train")
    assert not out["correct"], out["checks"]
    assert out["checks"]["change_gap"]["value"] > 0.99


def test_half_of_the_batch_left_out(monkeypatch):
    from score_tpu_torch import train
    real = train.bce_loss

    def half(logits, labels, weights=None):
        h = logits.shape[0] // 2
        return real(logits[:h], labels[:h],
                    None if weights is None else weights[:h])
    monkeypatch.setattr(train, "bce_loss", half)
    out = _run("score_taobao.train")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS[1:])
def test_an_answer_altered_where_it_is_produced(monkeypatch, workload):
    from score_tpu_torch.nn import model
    real = model.ScoreModel.score_candidates

    def altered(self, batch, *a, **kw):
        out = real(self, batch, *a, **kw)
        return out + (torch.arange(out.shape[1]) == 0).to(out.dtype)
    monkeypatch.setattr(model.ScoreModel, "score_candidates", altered)
    out = _run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    cfg, tr = small(workload)
    kind = run.kind_module(tr)
    cell = run.Cell(workload, cfg, tr, 31, torch.device("cpu"))
    kind.setup(cell)
    kind.release(cell)
    limits = run.load_json("limits", workload)
    got = kind.control(cell, torch.float8_e4m3fn)
    assert any(v > limits[k]["limit"] for k, v in got.items()
               if k in limits), got
