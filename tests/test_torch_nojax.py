"""The port must run where JAX and pandas are not installed, as on the GPU
host, and without the JAX package: in a fresh interpreter that refuses to
import jax, flax, optax, orbax, pandas or anything of score_tpu, build a
dataset with the port's own host layer, score one request and take two
train steps on the CPU, with the sum pool and with the max pool, evaluate
the validation split, serve and train a baseline arch (DELF), run the
training CLI from a raw CSV log to its test line (configs3, and configs0
with its preset's uniform negatives), and run the entry points
(score_tpu_torch/entry.py: the forward and the sharded dry run), and
import the quality protocol's modules (score_tpu_torch/scripts), and
run the reference-scale scripts' host side (prep_bench's CSV without
pandas, perf_sweep's refusals, a scaling step).
And the port's copies of that host layer (config presets, the synthetic
generator, dataset prep and its CSV reader, the batch iterator) give
what the JAX package's give."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from score_tpu import config as jconfig
from score_tpu.data import pipeline as jpipeline
from score_tpu.data import prep_common as jprep
from score_tpu.data import prep_datasets as jprep_ds
from score_tpu.data import synth as jsynth
from score_tpu_torch import config as tconfig
from score_tpu_torch.data import pipeline as tpipeline
from score_tpu_torch.data import prep_common as tprep
from score_tpu_torch.data import prep_datasets as tprep_ds
from score_tpu_torch.data import synth as tsynth

from _torch_helpers import assert_same_dataset, untimed_meta

BLOCK = r"""
import importlib.abc
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "score_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Refuse())
"""

SCRIPT = BLOCK + r"""
import numpy as np
import torch

torch.set_num_threads(2)
import dataclasses

from score_tpu_torch.config import configs3
from score_tpu_torch.data import synth
from score_tpu_torch.data.pipeline import TargetIterator
from score_tpu_torch.data.prep_common import build_dataset
from score_tpu_torch.graph import device_graph
from score_tpu_torch.params import init_params
from score_tpu_torch.serve import ScoringService
from score_tpu_torch.train import (evaluate, init_state,
                                   item_importance_weights, make_eval_step,
                                   train_step)

user, item, ts = synth.synth_events(100, 200, 3000, num_slots=4, seed=0)
ds = build_dataset(user, item, ts, num_slots=4, user_fanout=3,
                   item_fanout=3, num_eval_neg=5, min_user=1, min_item=1,
                   seed=0)
cfg = configs3()
cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                           train_neg_mode="inbatch_iw"),
                  train=dataclasses.replace(cfg.train, table_update_every=2,
                                            table_lr_boost=2.0))
sd = init_params(cfg, ds.num_users, ds.num_items,
                 torch.Generator().manual_seed(0))
scores = ScoringService(cfg, ds, sd, device="cpu").score(1, [1, 2, 3])
assert scores.shape == (3,) and np.isfinite(scores).all(), scores

graph = device_graph(ds.graph, "cpu")
neg_iw = torch.from_numpy(item_importance_weights(ds.train, ds.num_items))
losses = []
for pool in ("sum", "max"):
    c = cfg.replace(model=dataclasses.replace(cfg.model, coattn_pool=pool))
    state = init_state(c, ds.num_users, ds.num_items, sd, device="cpu")
    it = TargetIterator(ds.train, 32, seed=0)
    for _ in range(2):
        state, m = train_step(state, graph, next(it), neg_iw=neg_iw)
        losses.append(m["loss"].item())
    assert state.step == 2 and np.isfinite(losses).all(), losses
metrics = evaluate(make_eval_step(state.model), graph, ds.val, batch_size=16)
assert 0.0 <= metrics["auc"] <= 1.0 and "ndcg@10" in metrics, metrics

# the trainer's other knobs: adagrad on a warmup-cosine schedule, scorer
# dropout and per-step neighbour re-sampling; and the debug and profiling
# modules
from score_tpu_torch import debug, profiling

c = cfg.replace(
    model=dataclasses.replace(cfg.model, dropout=0.1),
    data=dataclasses.replace(cfg.data, user_fanout=2, item_fanout=2,
                             neighbor_resample=True),
    train=dataclasses.replace(cfg.train, optimizer="adagrad",
                              lr_schedule="cosine", warmup_steps=1,
                              decay_steps=4))
state = init_state(c, ds.num_users, ds.num_items, sd, device="cpu")
it = TargetIterator(ds.train, 32, seed=0)
for _ in range(2):
    state, m = train_step(state, graph, next(it), neg_iw=neg_iw)
    assert np.isfinite(m["loss"].item())
assert debug.checked_lookup(torch.ones(4, 2), torch.tensor([3])).shape == (
    1, 2)
assert profiling.timed(torch.mm, torch.ones(2, 3), torch.ones(3, 4)) > 0

# a baseline arch of the roster (DELF: both sides' histories), served and
# trained with its preset's uniform negatives
from score_tpu_torch.config import PRESETS

bcfg = PRESETS["baseline_delf"]()
bsd = init_params(bcfg, ds.num_users, ds.num_items,
                  torch.Generator().manual_seed(0))
bscores = ScoringService(bcfg, ds, bsd, device="cpu").score(1, [1, 2, 3])
assert bscores.shape == (3,) and np.isfinite(bscores).all(), bscores
bstate = init_state(bcfg, ds.num_users, ds.num_items, bsd, device="cpu")
it = TargetIterator(ds.train, 32, seed=0)
blosses = []
for _ in range(2):
    bstate, m = train_step(bstate, graph, next(it))
    blosses.append(m["loss"].item())
assert bstate.step == 2 and np.isfinite(blosses).all(), blosses

# the CLI, from a raw log at its default path (under $TMPDIR) to the test line
import contextlib
import io
import os
import runpy
import tempfile

from score_tpu_torch.data.prep_datasets import default_raw_path

synth.write_raw("taobao", default_raw_path("taobao"), num_users=100,
                num_items=200, num_events=4000, num_slots=9, seed=0)
work = tempfile.mkdtemp()
sys.argv = ["score_tpu_torch.train", "configs3", os.path.join(work, "data"),
            "--device", "cpu", "model.embed_dim=8", "model.hidden_dim=8",
            "model.mlp_dims=16,8", "data.train_neg_mode=inbatch_iw",
            "data.user_fanout=3", "data.item_fanout=3", "data.num_eval_neg=5",
            "train.batch_size=32", "train.num_epochs=1",
            "train.eval_every_steps=20", "train.eval_max_targets=64",
            "train.checkpoint_dir=" + os.path.join(work, "ck")]
cli = io.StringIO()
with contextlib.redirect_stdout(cli):
    runpy.run_module("score_tpu_torch.train", run_name="__main__")
test_line = [l for l in cli.getvalue().splitlines() if l.startswith("test:")]
assert len(test_line) == 1, cli.getvalue()
assert os.path.exists(os.path.join(work, "ck", "best.pt"))

# the sharding module and the sharding tests' world worker; an a2a step in
# a gloo world of one rank
import torch.distributed as dist

sys.path.insert(0, "tests")
import _torch_shard_worker
from score_tpu_torch.config import ShardingConfig
from score_tpu_torch.sharding import bringup

mesh, _ = bringup(None, init_method="file://" + os.path.join(work, "store"),
                  world_size=1, rank=0, device="cpu")
scfg = cfg.replace(sharding=ShardingConfig(lookup_mode="a2a"))
sstate = init_state(scfg, ds.num_users, ds.num_items, sd, device="cpu",
                    mesh=mesh)
sstate, m = train_step(sstate, graph, next(TargetIterator(ds.train, 32,
                                                          seed=0)),
                       neg_iw=neg_iw)
assert int(m["a2a_overflow"]) == 0 and np.isfinite(m["loss"].item()), m
# the entry points: the configs3 forward, and the sharded dry run (a psum
# step and 3 a2a steps on the row-sharded graph) in this world of one
from score_tpu_torch import entry

fn, fargs = entry.entry(device="cpu")
assert fn(*fargs).shape == (16,)
dry = entry.dryrun_rank(mesh)
assert len(dry) == 4 and np.isfinite(dry).all(), dry
dist.destroy_process_group()

loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print("SERVED", scores.tolist(), "TRAINED", losses, "EVALUATED", metrics,
      "BASELINE", bscores.tolist(), blosses, "CLI", test_line[0],
      "SHARDED", sstate.step, "DRYRUN", dry)
"""


# the configs0 CLI with the preset's own (uniform) negatives: it preps the
# ccmr dataset from a raw log at its default path, trains one epoch, tests
CLI_CONFIGS0 = BLOCK + r"""
import contextlib
import io
import os
import runpy
import tempfile

import torch

torch.set_num_threads(2)
from score_tpu_torch.data import synth
from score_tpu_torch.data.prep_datasets import default_raw_path

synth.write_raw("ccmr", default_raw_path("ccmr"), num_users=100,
                num_items=200, num_events=4000, num_slots=8, seed=0)
work = tempfile.mkdtemp()
sys.argv = ["score_tpu_torch.train", "configs0", os.path.join(work, "data"),
            "--device", "cpu", "model.embed_dim=8", "model.hidden_dim=8",
            "model.mlp_dims=16,8", "data.user_fanout=3", "data.item_fanout=3",
            "data.num_eval_neg=5", "train.batch_size=32",
            "train.num_epochs=1", "train.eval_max_targets=64"]
cli = io.StringIO()
with contextlib.redirect_stdout(cli):
    runpy.run_module("score_tpu_torch.train", run_name="__main__")
test_line = [l for l in cli.getvalue().splitlines() if l.startswith("test:")]
assert len(test_line) == 1, cli.getvalue()
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print("CLI", test_line[0])
"""


# the quality protocol's modules, each imported with JAX and score_tpu
# blocked, and their host-side rules run
QUALITY_SCRIPTS = BLOCK + r"""
import importlib

names = ("ladder", "table_stride_ablation", "resample_ablation",
         "bf16_quality", "negmode_quality")
mods = {n: importlib.import_module(f"score_tpu_torch.scripts.{n}")
        for n in names}
ladder = mods["ladder"]
kw = ladder.gen_kw("crossattr")
tag = ladder.data_tag("taobao", "crossattr", kw)
cfg = mods["table_stride_ablation"].config(2, 2.0, 4, 1)
assert cfg.train.table_update_every == 2 and cfg.train.batch_size == 512
assert mods["resample_ablation"].config(True, 4, 0).data.neighbor_resample
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print("QUALITY", tag, sorted(mods))
"""


# the reference-scale scripts, each imported with JAX, pandas and
# score_tpu blocked; the prep benchmark run at a tiny size (its CSV
# written and read back without pandas), a JAX-only perf_sweep variant
# refused, and the scaling harness stepping on the CPU
SCALE_SCRIPTS = BLOCK + r"""
import importlib
import os
import tempfile

import torch

torch.set_num_threads(2)
names = ("prep_bench", "eval_scale", "serve_bench", "perf_sweep", "scaling",
         "machine")
mods = {n: importlib.import_module(f"score_tpu_torch.scripts.{n}")
        for n in names}
out = os.path.join(tempfile.gettempdir(), "prep.json")
res = mods["prep_bench"].main(["events=20000", "csv_rows=4000",
                               "users=400", "items=1500", f"out={out}"],
                              device="cpu")
assert res["csv_rows_per_s"] > 0 and res["events_kept"] > 0, res
try:
    mods["perf_sweep"].check_names(["b2048_pallas"])
    raise AssertionError("a JAX-only variant ran")
except ValueError as e:
    assert "pallas_coattn" in str(e)
ds = mods["scaling"].scaling_dataset()
eps = mods["scaling"].measure(1, 16, 1, ds, device="cpu")
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print("SCALE", res["events_kept"], eps > 0, sorted(mods))
"""


def _run_blocked(script, tmp_path):
    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TMPDIR"] = str(tmp_path)
    return subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_trains_configs0_without_jax(tmp_path):
    proc = _run_blocked(CLI_CONFIGS0, tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "CLI test: auc" in proc.stdout, proc.stdout


def test_port_serves_and_trains_without_jax(tmp_path):
    proc = _run_blocked(SCRIPT, tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("SERVED"), proc.stdout
    assert "TRAINED" in proc.stdout, proc.stdout
    assert "EVALUATED" in proc.stdout, proc.stdout
    assert "BASELINE" in proc.stdout, proc.stdout
    assert "CLI test: auc" in proc.stdout, proc.stdout
    assert "SHARDED 1" in proc.stdout, proc.stdout
    assert "DRYRUN" in proc.stdout, proc.stdout


def test_quality_scripts_import_without_jax(tmp_path):
    proc = _run_blocked(QUALITY_SCRIPTS, tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("QUALITY taobao_crossattr_"), proc.stdout


def test_scale_scripts_run_without_jax(tmp_path):
    proc = _run_blocked(SCALE_SCRIPTS, tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = proc.stdout.splitlines()[-1]
    assert last.startswith("SCALE ") and " True " in last, proc.stdout


@pytest.mark.parametrize("name", ["configs0", "configs1", "configs2",
                                  "configs3", "configs4"])
def test_config_copies_equal(name):
    want = getattr(jconfig, name)()
    got = getattr(tconfig, name)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    over = {"train.batch_size": "512", "model.mlp_dims": "8,4",
            "data.train_neg_mode": "inbatch_iw"}
    assert dataclasses.asdict(tconfig.apply_overrides(got, over)) == \
        dataclasses.asdict(jconfig.apply_overrides(want, over))
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)


@pytest.mark.parametrize("mode", ["latent", "crossattr", "collab"])
def test_data_copies_equal(mode):
    """synth_events, build_dataset (with its native adjacency code, as
    both packages default to) and TargetIterator, for one seed."""
    got = tsynth.synth_events(150, 300, 6000, num_slots=5, seed=2, mode=mode)
    want = jsynth.synth_events(150, 300, 6000, num_slots=5, seed=2,
                               mode=mode)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    kw = dict(num_slots=5, user_fanout=4, item_fanout=3, num_eval_neg=7,
              min_user=2, min_item=2, seed=2)
    tds, jds = tprep.build_dataset(*got, **kw), jprep.build_dataset(*want,
                                                                    **kw)
    assert_same_dataset(tds, jds)
    ti, ji = (tpipeline.TargetIterator(tds.train, 16, seed=1),
              jpipeline.TargetIterator(jds.train, 16, seed=1))
    for _ in range(tds.train.user.size // 16 + 2):   # across an epoch
        a, b = next(ti), next(ji)
        for k in ("user", "item", "slot"):
            np.testing.assert_array_equal(a[k], b[k])


def test_prep_taobao_equal(tmp_path):
    """The port's and the reference's prep_taobao on one synthesized raw
    log give equal datasets."""
    raw = tsynth.write_raw("taobao", str(tmp_path / "raw.csv"),
                           num_users=120, num_items=240, num_events=5000,
                           num_slots=6, seed=3)
    kw = dict(num_slots=6, user_fanout=4, item_fanout=3, min_user=3,
              min_item=3, num_eval_neg=7, seed=1)
    tds = tprep_ds.prep_taobao(str(tmp_path / "port"), raw_path=raw, **kw)
    jds = jprep_ds.prep_taobao(str(tmp_path / "ref"), raw_path=raw, **kw)
    assert_same_dataset(tds, jds)
    assert untimed_meta(tds) == untimed_meta(jds)


@pytest.mark.parametrize("dataset", ["ccmr", "tmall"])
def test_prep_ccmr_and_tmall_equal(tmp_path, dataset):
    """The other presets' datasets (configs0 trains ccmr, configs2 tmall):
    the port's PREP entry and the reference's on one synthesized raw log
    of that dataset's columns give equal datasets."""
    raw = tsynth.write_raw(dataset, str(tmp_path / "raw.csv"),
                           num_users=120, num_items=240, num_events=5000,
                           num_slots=6, seed=3)
    kw = dict(num_slots=6, user_fanout=4, item_fanout=3, min_user=3,
              min_item=3, num_eval_neg=7, seed=1)
    tds = tprep_ds.PREP[dataset](str(tmp_path / "port"), raw_path=raw, **kw)
    jds = jprep_ds.PREP[dataset](str(tmp_path / "ref"), raw_path=raw, **kw)
    assert_same_dataset(tds, jds)
    assert untimed_meta(tds) == untimed_meta(jds)


@pytest.mark.parametrize("usecols", [(0, 1, 4), (4, 0, 2)])
@pytest.mark.parametrize("newline", ["\n", "\r\n"], ids=["lf", "crlf"])
def test_csv_reader_matches_pandas(tmp_path, usecols, newline):
    """The port's numpy reader against the reference's pandas reader: a
    header line, a non-numeric column outside `usecols` (Taobao's
    behavior_type), negative values, a blank line; LF, or CRLF with no
    final newline; blocks of 64 bytes (cut mid-line) and the default."""
    rng = np.random.default_rng(len(newline) + usecols[0])
    n = 500
    behaviour = np.array(["pv", "buy", "cart", "fav"])[rng.integers(0, 4, n)]
    rows = [f"{u},{i},{c},{b},{t}" for u, i, c, b, t in zip(
        rng.integers(0, 10 ** 6, n), rng.integers(0, 10 ** 9, n),
        rng.integers(-50, 50, n), behaviour,
        rng.integers(1_500_000_000, 1_600_000_000, n))]
    lines = (["user_id,item_id,category_id,behavior_type,timestamp"]
             + rows[:10] + [""] + rows[10:])
    text = newline.join(lines) + ("\n" if newline == "\n" else "")
    path = tmp_path / "log.csv"
    path.write_bytes(text.encode())
    want = jprep_ds._read_csv_cols(str(path), usecols)
    for chunk in (64, 32 << 20):
        got = tprep_ds._read_csv_cols(str(path), usecols, chunk_bytes=chunk)
        assert len(got) == len(usecols)
        for g, w in zip(got, want):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)
