"""The port's quality protocol (score_tpu_torch/scripts) against the JAX
package's scripts, on the CPU at a tiny size.

- Every preset of the ladder and roster, and every arm of the four
  quality gates, gets from the port's module the config that the JAX
  script's rule builds from score_tpu.config (scripts/ladder.py:74-78,
  table_stride_ablation.py:161-166, resample_ablation.py:242-248,
  bf16_quality.py:301-307, negmode_quality.py:354-360), as a dict.
- `data_tag` is scripts/ladder.py:54-60's md5 rule (3 and 3.0 hash
  alike), and the ladder's generator knobs at a tiny size give the same
  dataset arrays through both packages' PREP, at the model's fan-out and
  at the re-sampling gate's stored fan-out of 20.
- `ladder.main` (two presets, 1 epoch) and the stride gate's `main` write
  the JSON schema of the JAX records they stand beside
  (LADDER_roster_r3.json, TABLE_STRIDE_r4_boost2.json).
"""

import dataclasses
import hashlib
import json
import math
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from score_tpu import config as jconfig
from score_tpu.data import prep_datasets as jprep_ds
from score_tpu_torch.scripts import (bf16_quality, ladder, negmode_quality,
                                     resample_ablation, table_stride_ablation)

from _torch_helpers import assert_same_dataset, untimed_meta

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# the generator's size for every test here: ~2,000 train targets, 4-5
# steps an epoch at the protocol's batch of 512
TINY = dict(num_users=80, num_items=160, num_events=2500)
TINY_ARGV = [f"{k}={v}" for k, v in TINY.items()]


# --- the JAX scripts' config rules, restated on score_tpu.config ----------

def _jax_protocol_train(cfg, epochs, seed):
    return cfg.train.__class__(
        batch_size=512, learning_rate=1e-3, num_epochs=epochs,
        eval_every_steps=300, early_stop_patience=6,
        log_every_steps=10 ** 9, seed=seed)


def jax_ladder(name, epochs, seed):
    cfg = jconfig.PRESETS[name]()
    return cfg.replace(train=_jax_protocol_train(cfg, epochs, seed))


def jax_stride(K, boost, epochs, seed):
    cfg = jconfig.PRESETS["configs3"]()
    return cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=512, learning_rate=1e-3, num_epochs=epochs,
        eval_every_steps=300, early_stop_patience=6,
        log_every_steps=10 ** 9, seed=seed, table_update_every=K,
        table_lr_boost=boost))


def jax_resample(resample, epochs, seed):
    cfg = jconfig.PRESETS["configs3"]()
    return cfg.replace(data=cfg.data.__class__(neighbor_resample=resample),
                       train=_jax_protocol_train(cfg, epochs, seed))


def jax_bf16(dtype, epochs, seed):
    cfg = jconfig.configs3()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype=dtype),
        train=_jax_protocol_train(cfg, epochs, seed))


def jax_negmode(mode, epochs, seed):
    cfg = jconfig.configs3()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, train_neg_mode=mode),
        train=_jax_protocol_train(cfg, epochs, seed))


PRESET_NAMES = list(jconfig.BASELINE_PRESETS) + list(ladder.RUNGS)
CASES = (
    [(f"ladder-{n}", lambda e, s, n=n: ladder.protocol_config(n, e, s),
      lambda e, s, n=n: jax_ladder(n, e, s)) for n in PRESET_NAMES]
    + [(f"stride-{a}",
        lambda e, s, a=a: table_stride_ablation.config(
            *table_stride_ablation.parse_arms(a)[0], e, s),
        lambda e, s, a=a: jax_stride(*table_stride_ablation.parse_arms(a)[0],
                                     e, s)) for a in ("2", "4", "2b2")]
    + [(f"resample-{arm}",
        lambda e, s, r=r: resample_ablation.config(r, e, s),
        lambda e, s, r=r: jax_resample(r, e, s))
       for arm, r in resample_ablation.ARMS]
    + [(f"bf16-{d}", lambda e, s, d=d: bf16_quality.config(d, e, s),
        lambda e, s, d=d: jax_bf16(d, e, s)) for d in bf16_quality.DTYPES]
    + [(f"negmode-{m}", lambda e, s, m=m: negmode_quality.config(m, e, s),
        lambda e, s, m=m: jax_negmode(m, e, s))
       for m in negmode_quality.MODES])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_protocol_config_is_the_jax_scripts(case):
    _, port, jax = case
    for epochs, seed in ((4, 0), (3, 2)):
        assert dataclasses.asdict(port(epochs, seed)) == \
            dataclasses.asdict(jax(epochs, seed))


def test_protocol_covers_every_preset_and_arm():
    assert sorted(PRESET_NAMES) == sorted(
        n for n in jconfig.PRESETS if n != "configs4")
    assert table_stride_ablation.parse_arms("2,4,2b2") == [
        (2, 1.0), (4, 1.0), (2, 2.0)]
    assert [table_stride_ablation.arm_name(*a) for a in
            table_stride_ablation.parse_arms("2,4,2b2,4b4")] == [
        "stride2", "stride4", "stride2_boost2", "stride4_boost4"]


# --- dataset keying and the datasets themselves ----------------------------

def _jax_tag(dataset, mode, gen_kw):
    canon = {k: (float(v) if isinstance(v, (int, float)) else v)
             for k, v in gen_kw.items()}
    gh = hashlib.md5(json.dumps(canon, sort_keys=True).encode()) \
        .hexdigest()[:6]
    return (dataset if mode == "collab" else f"{dataset}_{mode}") + f"_{gh}"


@pytest.mark.parametrize("mode", ["collab", "crossattr", "latent"])
def test_data_tag_is_the_md5_rule(mode):
    kw = ladder.gen_kw(mode)
    assert ladder.data_tag("taobao", mode, kw) == _jax_tag("taobao", mode,
                                                           kw)
    assert ladder.gen_kw("crossattr")["drift_active"] == 3.0
    # 3 and 3.0 hash alike; another knob value does not
    assert ladder.data_tag("taobao", mode, dict(kw, num_slots=3)) == \
        ladder.data_tag("taobao", mode, dict(kw, num_slots=3.0))
    assert ladder.data_tag("taobao", mode, kw) != ladder.data_tag(
        "taobao", mode, dict(kw, num_events=kw["num_events"] + 1))
    assert ladder.knob_values({"a": "3", "b": "3.0"}) == {"a": 3, "b": 3.0}


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    """One temporary directory for the module: the tiny raw logs made by
    the first prep of each mode are the ones every later prep and `main`
    of the module reads."""
    root = tmp_path_factory.mktemp("quality")
    saved, tempfile.tempdir = tempfile.tempdir, str(root)
    yield root
    tempfile.tempdir = saved


@pytest.mark.parametrize("mode,fanout", [("crossattr", 10),
                                         ("crossattr", 20), ("collab", 10)])
def test_ladder_dataset_is_the_jax_prep(tmp_root, mode, fanout):
    kw = ladder.gen_kw(mode, **TINY)
    over = {} if fanout == 10 else dict(user_fanout=fanout,
                                        item_fanout=fanout)
    tds = ladder.ladder_dataset("taobao", mode, kw, **over)
    tag = ladder.data_tag("taobao", mode, kw)
    assert (tmp_root / "score_tpu_raw" / f"ladder_{tag}.csv").exists()
    # the JAX package synthesizes its own log of the same knobs
    jds = jprep_ds.PREP["taobao"](
        str(tmp_root / f"jax_{mode}_{fanout}"),
        raw_path=str(tmp_root / f"jax_{mode}.csv"), synth_kw=kw, **over)
    assert tds.graph.u2i.shape[-1] == fanout
    assert_same_dataset(tds, jds)
    assert untimed_meta(tds) == untimed_meta(jds)


# --- main() writes the JAX scripts' schema ----------------------------------

def _finite(x):
    return isinstance(x, (int, float)) and math.isfinite(x)


def test_ladder_main_writes_the_jax_schema(tmp_root):
    out = tmp_root / "ladder.json"
    got = ladder.main([str(out), "taobao", "1", "mode=crossattr",
                       "models=configs3,baseline_sasrec", *TINY_ARGV],
                      device="cpu")
    saved = json.loads(out.read_text())
    assert list(saved) == ["configs3", "baseline_sasrec"]
    assert json.loads(json.dumps(got)) == saved
    want = json.loads((ROOT / "LADDER_roster_r3.json").read_text())["seed0"]
    for name, rec in saved.items():
        assert set(rec) == set(want[name]), name
        assert set(rec["test"]) == set(want[name]["test"]), name
        assert all(_finite(v) for v in rec["test"].values())
        assert _finite(rec["best_val_auc"]) and _finite(rec["wall_s"])
        assert isinstance(rec["steps"], int) and rec["steps"] > 0


def test_stride_gate_main_writes_the_jax_schema(tmp_root):
    out = tmp_root / "stride.json"
    table_stride_ablation.main([str(out), "1", "2b2", "--device", "cpu",
                                *TINY_ARGV])
    saved = json.loads(out.read_text())
    want = json.loads((ROOT / "TABLE_STRIDE_r4_boost2.json").read_text())
    assert set(saved) == set(want) == {"pinned_k1", "stride2_boost2"}
    assert saved["pinned_k1"] == want["pinned_k1"]
    recs = saved["stride2_boost2"]
    assert [r["seed"] for r in recs] == [0, 1, 2]
    for got, ref in zip(recs, want["stride2_boost2"]):
        assert set(got) == set(ref)
        assert (got["K"], got["boost"]) == (ref["K"], ref["boost"])
        assert all(_finite(got[k]) for k in ("best_val_auc", "test_auc",
                                             "ndcg10", "wall_s"))
