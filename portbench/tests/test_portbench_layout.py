"""The harness is driven by data: a copy of a configuration, a traffic
mix or a per-layer metric's reader under a new name is found by that
name with no edit; the harness and the reference load no JAX; a run with
no card prints no result."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, small
from portbench import run


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    """A copy of portbench/ the run reads its files from."""
    dst = tmp_path / "portbench"
    shutil.copytree(run.BENCH_DIR, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    monkeypatch.setattr(run, "BENCH_DIR", dst)
    return dst


def test_new_files_are_found_by_name(bench_copy):
    for kind, old, new in (("configs", "rrn_taobao", "rrn_copy"),
                           ("traffic", "serve", "serve_copy"),
                           ("limits", "rrn_taobao.serve", "rrn_copy.serve2"),
                           ("metrics", "idle_share", "idle_copy")):
        ext = ".py" if kind == "metrics" else ".json"
        shutil.copy(bench_copy / kind / (old + ext),
                    bench_copy / kind / (new + ext))
    bench = run.manifest()
    bench["configs"].append(dict(bench["configs"][1], name="rrn_copy",
                                 file="portbench/configs/rrn_copy.json"))
    bench["workloads"].append(dict(name="rrn_copy.serve2", config="rrn_copy",
                                   traffic="serve_copy", chips=1, why="x"))
    bench["per_layer"].append(dict(
        name="idle_copy.serve", unit="fraction", better="lower",
        source="device_trace", layer="device",
        moves="serve_requests_per_s", workloads=["rrn_copy.serve2"]))
    for m in bench["end_to_end"]:
        if "workloads" in m and "rrn_taobao.serve" in m["workloads"]:
            m["workloads"].append("rrn_copy.serve2")
    entry, cfg, tr = run.cell_of("rrn_copy.serve2", bench)
    assert cfg["model"]["slot_agg"] == "mean" and tr["kind"] == "serve"
    assert run.reader("idle_copy.serve").__module__.endswith("idle_copy")
    cfg, tr = small("rrn_taobao.serve")
    out = run.run_cell("rrn_copy.serve2", 5, 0.2, True, device="cpu",
                       bench=bench, config=cfg, traffic=tr)
    assert out["correct"]
    out = run.run_cell("rrn_copy.serve2", 5, 0.2, False, device="cpu",
                       bench=bench, config=cfg, traffic=tr)
    assert set(out["metrics"]) == {"serve_requests_per_s", "serve_p95_ms",
                                   "setup_s"}


def test_every_cell_has_its_files_and_limits():
    bench = run.manifest()
    names = {m["name"] for m in bench["per_layer"]}
    for w in bench["workloads"]:
        entry, cfg, tr = run.cell_of(w["name"], bench)
        kind = run.kind_module(tr)
        limits = run.load_json("limits", w["name"])
        assert set(limits) == set(kind.CHECKS)
    for name in names:
        assert callable(run.reader(name))


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "score_tpu")


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    mods = _modules_after(
        "import portbench.run\n"
        "import portbench.harness.kinds.train, portbench.harness.kinds.serve,"
        " portbench.harness.kinds.eval\n"
        "import score_tpu_torch.train, score_tpu_torch.serve")
    assert not mods & set(FORBIDDEN)
    assert "score_tpu_torch" in mods        # the port, compared whole


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules_after(
        "import portbench.reference.model, portbench.reference.train,"
        " portbench.reference.metrics")
    assert not mods & (set(FORBIDDEN) | {"score_tpu_torch"})


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "score_taobao.train", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_run_that_loaded_jax_gives_no_result(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    cfg, tr = small("rrn_taobao.serve")
    with pytest.raises(RuntimeError, match="jax"):
        run.run_cell("rrn_taobao.serve", 5, 0.1, False, device="cpu",
                     config=cfg, traffic=tr)
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "score_tpu_torch_x", types.ModuleType("x"))
    assert run.forbidden_modules() == []
