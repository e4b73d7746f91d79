"""Shared fixtures of the benchmark's CPU tests: the repository root on
sys.path, the cells at a size a test run holds, and the `cuda` marker
(tests that need the card skip, inside the `card` fixture, without
one)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL_DATA = dict(events=40000, users=400, items=1500, min_count=3)
SMALL_TRAFFIC = dict(
    train=dict(batch=64, steps_per_chunk=5, trace_chunks=1),
    serve=dict(requests_per_call=16, popular_items=20, distinct_calls=4,
               warmup_calls=1, check_calls=2, trace_calls=3),
    eval=dict(batch=64, targets_per_call=256, slices=3, trace_calls=1))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs on the CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def small(workload: str, **model):
    """(config, traffic) of cell `workload` at a size a test run holds;
    `model` overrides keys of the model block."""
    from portbench import run
    entry, cfg, tr = run.cell_of(workload)
    cfg = dict(cfg, data=dict(cfg["data"], **SMALL_DATA),
               model=dict(cfg["model"], **model))
    tr = dict(tr, **SMALL_TRAFFIC[tr["kind"]])
    return cfg, tr


CELLS = ("score_taobao.train", "rrn_taobao.serve", "score_taobao.serve",
         "score_taobao.eval")
