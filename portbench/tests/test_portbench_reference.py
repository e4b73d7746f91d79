"""Each mix's plain reference against the port at a small size on the
CPU, computing in f32 (where the two must agree to rounding); a bf16
run's result line; and the program's bf16 readings below the control's
fp8 ones. (The limits are set for the cells' own sizes, at which the
readings average over far more rows: a small run is not held to them.)"""

import pytest
import torch

from conftest import CELLS, small
from portbench import run

CPU = torch.device("cpu")


def _ran(workload, seed=11, **model):
    cfg, tr = small(workload, **model)
    kind = run.kind_module(tr)
    cell = run.Cell(workload, cfg, tr, seed, CPU)
    kind.setup(cell)
    if tr["kind"] != "train":
        kind.window(cell, 0.2)
    kind.release(cell)
    return kind, cell


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_port_in_f32(workload):
    kind, cell = _ran(workload, compute_dtype="float32")
    got = kind.all_readings(cell) if hasattr(kind, "all_readings") \
        else kind.check(cell)
    tol = {"loss_gap": 1e-5, "grad_median_gap": 1e-4, "change_gap": 1e-4,
           "score_gap": 1e-5, "metric_gap": 1e-6}
    for k, v in got.items():
        assert v <= tol[k], (k, v)


@pytest.mark.parametrize("workload", CELLS)
def test_bf16_run_result_line(workload):
    cfg, tr = small(workload)
    out = run.run_cell(workload, 2 ** 33 + 17, 0.3, False, device="cpu",
                       config=cfg, traffic=tr)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(run.kind_module(tr).CHECKS)
    for c in out["checks"].values():
        assert 0 <= c["value"] < float("inf") and c["limit"] > 0


@pytest.mark.parametrize("workload,number", [
    ("score_taobao.train", "grad_median_gap"),
    ("rrn_taobao.serve", "score_gap"),
    ("score_taobao.serve", "score_gap")])
def test_bf16_program_reads_below_the_fp8_control(workload, number):
    kind, cell = _ran(workload, seed=13)
    assert kind.check(cell)[number] < \
        kind.control(cell, torch.float8_e4m3fn)[number]
