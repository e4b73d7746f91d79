"""The port's reference-scale scripts (score_tpu_torch/scripts: prep_bench,
eval_scale, serve_bench, perf_sweep, scaling) against the JAX package's
scripts/ of the same names, on the CPU at tiny sizes.

- `synth_uniform_zipf` is bit-equal to scripts/prep_bench.py's (loaded by
  path), and `prep_bench.main` writes the JAX record's keys with the
  counts the JAX package's `build_dataset` gives on the same events. The
  numpy CSV writer writes pandas' bytes, which pandas and the port's
  reader read back as the same columns.
- eval_scale's config is scripts/eval_scale.py:71-77's; its eval of given
  weights (`evaluate_weights`), on the JAX package's `init_state` at seed
  0 carried over by `params.from_flax`, equals the JAX
  `evaluate(make_eval_step(model), eval_table_cast(params), ...)` in f32
  at tests/test_torch_eval.py's tolerances (ranking metrics 1e-4, AUC
  1e-3), and its residency statement is the JAX formula.
- eval_scale's and serve_bench's `main` (both modes) write the keys of
  the JAX records beside them (EVAL_SCALE_r5_bf16, SERVE_BENCH_r4,
  SERVE_CATALOG_r5.json).
- Every ported perf_sweep variant builds the config that the JAX
  run_variant builds for that name (its rule restated on
  score_tpu.config), every JAX-only name raises ValueError naming its
  switch, and one variant takes 2 steps.
- `scaling.measure` and `main` run at N=1 (N=2 runs in the 2-rank gloo
  world of tests/test_torch_sharding.py).
"""

import dataclasses
import importlib.util
import io
import json
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from score_tpu import config as jconfig
from score_tpu.data.prep_common import build_dataset as jax_build_dataset
from score_tpu.graph import device_graph
from score_tpu.train import build_model, init_state
from score_tpu.train import eval_table_cast
from score_tpu.train import evaluate as jax_evaluate
from score_tpu.train import make_eval_step as jax_make_eval_step
from score_tpu_torch.data.prep_datasets import _read_csv_cols
from score_tpu_torch.params import from_flax
from score_tpu_torch.scripts import (eval_scale, perf_sweep, prep_bench,
                                     scaling, serve_bench)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PREP_TINY = dict(events=30000, users=500, items=2000)
EVAL_TINY = dict(events=5000, users=100, items=400)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(name):
    return json.loads((ROOT / name).read_text())


def _argv(kw):
    return [f"{k}={v}" for k, v in kw.items()]


# --- prep_bench -------------------------------------------------------------

@pytest.mark.parametrize("knobs", [(30000, 500, 2000, 9), (12345, 77, 5000, 3)])
def test_synth_uniform_zipf_bit_equal(knobs):
    want = _jax_script("prep_bench").synth_uniform_zipf(*knobs)
    got = prep_bench.synth_uniform_zipf(*knobs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_prep_bench_main_keys_and_counts(tmp_path):
    out = tmp_path / "prep.json"
    res = prep_bench.main([*_argv(PREP_TINY), "csv_rows=5000",
                           f"out={out}"], device="cpu")
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    want = _record("PREP_BENCH_r3.json")
    assert set(res) == set(want) | {"device", "host", "peak_rss_gib"}
    assert set(res["phase_s"]) == set(want["phase_s"])
    assert res["device"] == "cpu" and res["host"]["cores"] >= 1
    assert res["peak_rss_gib"] > 0
    user, item, ts = prep_bench.synth_uniform_zipf(
        PREP_TINY["events"], PREP_TINY["users"], PREP_TINY["items"], 9)
    jds = jax_build_dataset(user, item, ts, num_slots=9, user_fanout=10,
                            item_fanout=10, num_eval_neg=100, min_user=5,
                            min_item=5)
    assert (res["events_kept"], res["num_users"], res["num_items"],
            res["val_targets"]) == (jds.meta["num_events_kept"],
                                    jds.graph.num_users, jds.graph.num_items,
                                    len(jds.val))


@pytest.mark.parametrize("rows", [5000, 7])
def test_csv_writer_is_pandas(tmp_path, rows):
    """The prep's CSV (its taobao columns, and signed values) written by
    `prep_bench.write_csv`: pandas' to_csv bytes, read back the same by
    pandas and by the port's reader."""
    user, item, ts = prep_bench.synth_uniform_zipf(rows, 500, 2000, 9)
    cols = [user, item, item % 97, np.zeros_like(user), ts]
    cols[3][:7] = [-1, -10, -99, 0, 7, -1234567, 10 ** 12]
    names = prep_bench.CSV_HEADER.split(",")
    path = tmp_path / "p.csv"
    prep_bench.write_csv(str(path), cols)
    buf = io.StringIO()
    pd.DataFrame(dict(zip(names, cols))).to_csv(buf, index=False)
    assert path.read_text() == buf.getvalue()
    back = pd.read_csv(path)
    assert list(back.columns) == names
    ours = _read_csv_cols(str(path), usecols=range(5))
    for name, c, o in zip(names, cols, ours):
        np.testing.assert_array_equal(back[name].to_numpy(), c)
        np.testing.assert_array_equal(o, c)


# --- eval_scale -------------------------------------------------------------

def _jax_eval_scale_config(compute_dtype):
    """scripts/eval_scale.py:71-77, restated on score_tpu.config."""
    cfg = jconfig.configs3()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, embed_dim=32, hidden_dim=64,
                                  mlp_dims=(128, 64),
                                  compute_dtype=compute_dtype),
        data=dataclasses.replace(cfg.data, train_neg_mode="inbatch_iw"),
        train=dataclasses.replace(cfg.train, batch_size=4096,
                                  table_update_every=2, table_lr_boost=2.0))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_eval_scale_config_is_the_jax_scripts(dtype):
    assert dataclasses.asdict(eval_scale.bench_config(4096, dtype)) == \
        dataclasses.asdict(_jax_eval_scale_config(dtype))


def test_eval_weights_match_jax(tiny_dataset):
    ds = tiny_dataset
    jcfg = _jax_eval_scale_config("float32")
    model = build_model(jcfg, ds.num_users, ds.num_items)
    graph = device_graph(ds.graph)
    params = jax.jit(lambda rng: init_state(jcfg, model, graph, rng).params
                     )(jax.random.PRNGKey(0))    # op by op: ~10 s
    B = 96
    want = jax_evaluate(jax_make_eval_step(model),
                        eval_table_cast(params, "float32"), graph, ds.val,
                        batch_size=B)
    sd = from_flax(jax.tree.map(np.asarray, params))
    got = eval_scale.evaluate_weights(eval_scale.bench_config(4096,
                                                              "float32"),
                                      ds, sd, B, device="cpu")
    assert set(got["metrics"]) == set(want)
    assert 0.5 < want["auc"] < 1.0
    for k, v in want.items():
        np.testing.assert_allclose(got["metrics"][k], v,
                                   atol=1e-3 if k == "auc" else 1e-4,
                                   err_msg=k)
    n, N = ds.val.neg.shape
    assert (got["hist_pos"], got["hist_neg"]) == (n, n * N)
    assert got["blocks"] == -(-n // B) and got["staging_s"] >= 0


def test_residency_bytes_is_the_jax_formula(tiny_dataset):
    """scripts/eval_scale.py:120-129 on the same dataset and block."""
    ds, B = tiny_dataset, 2048
    T, n, m, d = ds.graph.num_slots, 10, 10, 32
    want = dict(
        graph=int(sum(a.nbytes for a in (ds.graph.u2i, ds.graph.i2u,
                                         ds.graph.u2i_cnt,
                                         ds.graph.i2u_cnt))),
        tables=int((ds.num_users + ds.num_items + 2) * d * 4),
        block_item_side_bf16=int(B * 101 * T * m * d * 2),
        carry=int(2 * 65536 * 4),
        never_resident_negs=int(len(ds.val) * 100 * 4),
        never_materialized_pooled_scores=int(len(ds.val) * 101 * 4))
    assert eval_scale.residency_bytes(ds, B) == want


def test_eval_scale_main_writes_the_jax_keys(tmp_path):
    out = tmp_path / "eval.json"
    res = eval_scale.main([*_argv(EVAL_TINY), "train_steps=2", "batch=64",
                           "eval_batch=128", f"out={out}", "--device",
                           "cpu"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    want = _record("EVAL_SCALE_r5_bf16.json")
    assert set(want) <= set(res)
    for key in ("prep_phase_s", "eval_metrics", "residency_bytes"):
        assert set(res[key]) == set(want[key]), key
    assert res["backend"] == res["device"] == "cpu"
    assert res["train_steps"] == 2 and np.isfinite(res["train_final_loss"])
    assert res["eval_hist_pos"] == res["eval_expected_pos"] == \
        res["val_targets"]
    assert res["eval_hist_neg"] == res["eval_expected_neg"] == \
        100 * res["val_targets"]


# --- serve_bench ------------------------------------------------------------

@pytest.fixture
def small_service(monkeypatch):
    """serve_bench at a tiny f32 width and 5 candidates a request."""
    def small():
        cfg = serve_bench.configs3()
        return cfg.replace(model=dataclasses.replace(
            cfg.model, embed_dim=8, hidden_dim=8, mlp_dims=(16, 8)))
    monkeypatch.setattr(serve_bench, "serve_config", small)
    monkeypatch.setattr(serve_bench, "C", 5)


def test_serve_bench_main_writes_the_jax_keys(tmp_path, small_service):
    out = tmp_path / "serve.json"
    res = serve_bench.main([str(out), "num_users=150", "num_items=300",
                            "num_events=6000", "reps=4", "--device", "cpu"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    want = _record("SERVE_BENCH_r4.json")
    assert set(res) == set(want) | {"device", "host"}
    for R in (16, 64, 256, 1024):
        row = res[f"batch_R{R}"]
        assert set(row) == set(want[f"batch_R{R}"]) and row["R"] == R
        assert row["ms"] > 0 and row["C"] == 5
    assert res["single_p50_ms"] > 0 and res["topk_full_catalog_ms"] > 0


def test_serve_bench_catalog_writes_the_jax_keys(tmp_path, small_service):
    out = tmp_path / "catalog.json"
    res = serve_bench.main([str(out), "--catalog", "users=100",
                            "items=3000", "events=5000", "chunk=256",
                            "rows=4", "--device", "cpu"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    want = _record("SERVE_CATALOG_r5.json")
    assert set(res) == set(want) | {"device", "host"}
    assert (res["candidate_chunk"], res["topk_grid_rows"]) == (256, 4)
    assert res["catalog_items"] > 256 * 4      # more than one dispatch
    assert res["topk_warm_s"] >= 0 and res["items_per_s"] > 0


def test_serve_bench_knob_defaults_are_the_jax_constants():
    jax_sb = _jax_script("serve_bench")
    assert (serve_bench.MAIN_SIZES["num_users"],
            serve_bench.MAIN_SIZES["num_items"],
            serve_bench.MAIN_SIZES["num_events"],
            serve_bench.MAIN_SIZES["reps"]) == (
        jax_sb.NUM_USERS, jax_sb.NUM_ITEMS, jax_sb.NUM_EVENTS, jax_sb.REPS)
    assert (serve_bench.NUM_SLOTS, serve_bench.FANOUT, serve_bench.EMBED_DIM,
            serve_bench.C) == (jax_sb.NUM_SLOTS, jax_sb.FANOUT,
                               jax_sb.EMBED_DIM, jax_sb.C)
    assert serve_bench.CATALOG_SIZES == dict(
        users=1_000_000, items=3_700_000, events=14_000_000, chunk=8192,
        rows=16)


# --- perf_sweep -------------------------------------------------------------

SWITCHES = ("pallas_coattn", "dotfree", "gru_unroll", "push_rolls",
            "static_pair", "wr_on_summary", "cand_kernel", "cand_tile_b")
JAX_VARIANTS = _jax_script("perf_sweep").VARIANTS


def _jax_run_variant_config(*, batch, compute_dtype="float32",
                            num_train_neg=1, neg_mode="uniform",
                            embed_dim=32, table_stride=1,
                            table_lr_boost=1.0, **switches):
    """scripts/perf_sweep.py:60-69's config, restated on score_tpu.config
    (the switches set module flags of the JAX model, not the config)."""
    cfg = jconfig.configs3()
    return cfg.replace(
        model=cfg.model.__class__(
            embed_dim=embed_dim, hidden_dim=64, mlp_dims=(128, 64),
            sides="dual", slot_agg="coattn", seq_pool="attn",
            target_aware=True, compute_dtype=compute_dtype),
        data=cfg.data.__class__(num_train_neg=num_train_neg,
                                train_neg_mode=neg_mode),
        train=cfg.train.__class__(batch_size=batch,
                                  table_update_every=table_stride,
                                  table_lr_boost=table_lr_boost))


def test_perf_sweep_splits_the_jax_variants():
    assert set(perf_sweep.VARIANTS) | set(perf_sweep.JAX_ONLY) == \
        set(JAX_VARIANTS)
    assert not set(perf_sweep.VARIANTS) & set(perf_sweep.JAX_ONLY)
    for name, switch in perf_sweep.JAX_ONLY.items():
        set_here = sorted(set(JAX_VARIANTS[name]) & set(SWITCHES))
        assert set_here == sorted(switch.split(", ")), name


@pytest.mark.parametrize("name", list(perf_sweep.VARIANTS))
def test_perf_sweep_config_is_the_jax_run_variant(name):
    knobs = JAX_VARIANTS[name]
    assert not set(knobs) & set(SWITCHES)
    assert perf_sweep.VARIANTS[name] == knobs
    assert dataclasses.asdict(perf_sweep.config(**knobs)) == \
        dataclasses.asdict(_jax_run_variant_config(**knobs))


@pytest.mark.parametrize("name", list(perf_sweep.JAX_ONLY))
def test_perf_sweep_jax_only_variant_raises(name):
    switch = perf_sweep.JAX_ONLY[name]
    with pytest.raises(ValueError, match=switch):
        perf_sweep.main([name, "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown"):
        perf_sweep.check_names(["b4096_nothing"])


def test_perf_sweep_runs_a_variant():
    rows = perf_sweep.main(["base_2048_f32", "--device", "cpu",
                            "num_users=300", "num_items=600",
                            "num_events=20000", "steps=1", "calls=1"])
    assert len(rows) == 1 and "error" not in rows[0], rows
    row = rows[0]
    jax_keys = {"variant", "batch", "dtype", "pallas_coattn", "neg",
                "examples_per_s", "rate_min", "rate_max", "step_ms",
                "last_loss"}     # scripts/perf_sweep.py:172-179
    assert jax_keys <= set(row)
    assert (row["variant"], row["batch"], row["dtype"], row["neg"]) == (
        "base_2048_f32", 2048, "float32", 1)
    assert row["examples_per_s"] > 0 and np.isfinite(row["last_loss"])


# --- scaling ----------------------------------------------------------------

def test_scaling_measure_and_main_at_one_device(tiny_dataset, capsys):
    assert scaling.measure(1, 32, 2, tiny_dataset, device="cpu") > 0
    out = scaling.main(["16", "2", "--device", "cpu"])
    assert list(out["examples_per_s"]) == ["1"] and out["world"] == 1
    lines = capsys.readouterr().out.splitlines()
    assert any(line.startswith("devices= 1  examples/s=") and
               line.endswith("parallel-efficiency=1.00") for line in lines)
    assert "backend=cpu" in lines
    with pytest.raises(ValueError, match="world of 2"):
        scaling.measure(2, 16, 1, tiny_dataset, device="cpu")
