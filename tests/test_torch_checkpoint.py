"""Checkpoint and resume in the port (mirrors tests/test_checkpoint.py):
a save/restore round trip, a missing checkpoint, a bit-exact resume of the
train step into a state from another init, a failed write that leaves the
previous checkpoint whole, the `train()` driver writing `latest` and `best`
and resuming from them to the same result as a straight run, and
`ScoringService.from_checkpoint` serving what was saved (bit-equal to a
service built from the same weights; within 1e-4 in f32 of the JAX
package's service on them). All on the CPU, where every run is
deterministic, so resume is compared bit for bit."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from score_tpu import config as jconfig
from score_tpu.serve import ScoringService as JaxService
from score_tpu_torch import checkpoint as tckpt
from score_tpu_torch import config as tconfig
from score_tpu_torch.checkpoint import CheckpointManager, apply_restore
from score_tpu_torch.data.pipeline import TargetIterator
from score_tpu_torch.graph import device_graph
from score_tpu_torch.params import init_params, to_flax
from score_tpu_torch.serve import ScoringService
from score_tpu_torch.train import (init_state, item_importance_weights,
                                   step_shifts, train, train_step)

from _torch_helpers import bounded

torch.set_num_threads(2)

B = 64


def _cfg(module=tconfig, **train_kw):
    cfg = module.configs3()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, embed_dim=8, hidden_dim=8,
                                  mlp_dims=(16, 8)),
        data=dataclasses.replace(cfg.data, train_neg_mode="inbatch_iw"),
        train=dataclasses.replace(cfg.train, **{
            "batch_size": B, "table_update_every": 2, "table_lr_boost": 2.0,
            **train_kw}))


def _state(ds, seed=0):
    cfg = _cfg()
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(seed))
    return init_state(cfg, ds.num_users, ds.num_items, sd, device="cpu")


class Driver:
    """Steps a state as `train` does: batches from a TargetIterator, each
    step's shifts from `step_shifts`."""

    def __init__(self, ds):
        self.ds = ds
        self.graph = device_graph(ds.graph, "cpu")
        self.neg_iw = torch.from_numpy(
            item_importance_weights(ds.train, ds.num_items))

    def run(self, state, it, n):
        for _ in range(n):
            shifts = step_shifts(0, state.step, 1, B)
            state, _ = train_step(state, self.graph, next(it), shifts,
                                  self.neg_iw)
        return state


def _assert_same_state(a, b):
    assert a.step == b.step and a.opt.count == b.opt.count
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    for name in ("mu", "nu"):
        for k, v in getattr(a.opt, name).items():
            assert torch.equal(v, getattr(b.opt, name)[k]), (name, k)


def test_save_restore_roundtrip(tiny_dataset, tmp_path):
    ds = tiny_dataset
    state = Driver(ds).run(_state(ds), TargetIterator(ds.train, B), 1)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    bounded(mgr.save, "latest", state, (2, 7), 0.81, 123, block=True)
    assert mgr.has("latest") and not mgr.has("best")
    restored = mgr.restore("latest", state)
    assert restored["step"] == 123
    assert (restored["it_epoch"], restored["it_pos"]) == (2, 7)
    assert restored["best_val"] == pytest.approx(0.81)
    assert restored["opt_state"]["count"] == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored["params"][k], v), k
    other = _state(ds, seed=1)
    apply_restore(other, restored)
    assert other.step == 123
    state.step = 123
    _assert_same_state(other, state)


def test_restore_missing_returns_none(tiny_dataset, tmp_path):
    state = _state(tiny_dataset)
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.restore("latest", state) is None
    assert not mgr.has("best")
    assert not (tmp_path / "empty").exists()      # reading creates nothing


def test_resume_continues_exactly(tiny_dataset, tmp_path):
    """7 straight steps against 3 steps, save, restore into a state from
    another init, 4 more steps: weights, moments, count and step bit-equal.
    3 is odd under stride 2, so the restored step count decides which of
    the next steps update the tables."""
    ds = tiny_dataset
    drv = Driver(ds)
    straight = drv.run(_state(ds), TargetIterator(ds.train, B), 7)

    it = TargetIterator(ds.train, B)
    first = drv.run(_state(ds), it, 3)
    mgr = CheckpointManager(str(tmp_path / "resume"))
    mgr.save("latest", first, it.get_state(), 0.5, first.step)
    bounded(mgr.wait)

    resumed = _state(ds, seed=1)                  # another init
    restored = mgr.restore("latest", resumed)
    apply_restore(resumed, restored)
    assert resumed.step == 3
    it2 = TargetIterator(ds.train, B)
    it2.set_state((restored["it_epoch"], restored["it_pos"]))
    resumed = drv.run(resumed, it2, 4)
    _assert_same_state(resumed, straight)


def test_failed_write_keeps_previous_checkpoint(tiny_dataset, tmp_path,
                                               monkeypatch):
    """A write that dies half way (here: torch.save raises after writing
    part of the file) leaves `latest` as it was, and no temporary file."""
    ds = tiny_dataset
    state = _state(ds)
    mgr = CheckpointManager(str(tmp_path / "crash"))
    bounded(mgr.save, "latest", state, (0, 0), 0.5, 0, block=True)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state = Driver(ds).run(state, TargetIterator(ds.train, B), 2)

    def torn_save(obj, f, *a, **kw):
        f.write(b"PK\x03\x04 half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.torch, "save", torn_save)
    with pytest.raises(RuntimeError, match="checkpoint save failed"):
        bounded(mgr.save, "latest", state, (0, 2 * B), 0.6, 2, block=True)
    monkeypatch.undo()
    assert os.listdir(mgr.directory) == ["latest.pt"]
    restored = mgr.restore("latest", state)
    assert restored["step"] == 0 and restored["best_val"] == 0.5
    for k, v in before.items():
        assert torch.equal(restored["params"][k], v), k


@pytest.fixture(scope="module")
def runs(tiny_dataset, tmp_path_factory):
    """A straight 2-epoch train() (with a profiler window, which runs its
    steps one at a time), and the same run as 1 epoch, then a second
    train() of 2 epochs resuming from its checkpoints. 45 steps an epoch,
    val every 15: the first run's last val (at its last step) is one of
    the straight run's."""
    root = tmp_path_factory.mktemp("driver")
    kw = dict(num_epochs=2, eval_every_steps=15, early_stop_patience=100,
              log_every_steps=10 ** 9, eval_max_targets=256)
    cfg = _cfg(**dict(kw, batch_size=256))
    ds = tiny_dataset
    straight = train(cfg.replace(train=dataclasses.replace(
        cfg.train, profile_dir=str(root / "profile"))), ds, verbose=False,
        device="cpu")
    ck = str(root / "ck")
    log = str(root / "log.jsonl")
    first = train(cfg.replace(train=dataclasses.replace(
        cfg.train, num_epochs=1, checkpoint_dir=ck)), ds, verbose=False,
        device="cpu", log_path=log)
    second = train(cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=ck)), ds, verbose=False, device="cpu",
        log_path=log)
    return dict(root=root, cfg=cfg, ck=ck, log=log, straight=straight,
                first=first, second=second)


def test_train_writes_latest_and_best_and_resumes(runs):
    mgr = CheckpointManager(runs["ck"])
    assert mgr.has("latest") and mgr.has("best")
    first, second, straight = runs["first"], runs["second"], runs["straight"]
    spe = first["steps_run"]
    assert second["timing"]["start_step"] == spe
    assert second["steps_run"] == straight["steps_run"] == 2 * spe
    rows = [json.loads(line) for line in open(runs["log"])]
    assert [r["split"] for r in rows].count("test") == 2
    assert [r["step"] for r in rows if r["split"] == "val"] == \
        [r["step"] for r in straight["history"]]
    # the resumed run reproduces the straight one bit for bit
    strip = lambda r: {k: v for k, v in r.items() if k != "elapsed_s"}
    assert [strip(r) for r in first["history"] + second["history"]] == \
        [strip(r) for r in straight["history"]]
    assert second["best_step"] == straight["best_step"]
    assert second["test"] == straight["test"]
    for k, v in straight["params"].items():
        assert torch.equal(second["params"][k], v), k
    assert os.listdir(runs["root"] / "profile")     # the profiler window


def test_from_checkpoint_serves_what_was_saved(runs, tiny_dataset):
    ds, cfg = tiny_dataset, runs["cfg"]
    best = runs["second"]["params"]
    svc = ScoringService.from_checkpoint(cfg, ds, runs["ck"], device="cpu",
                                         candidate_chunk=64)
    assert svc.candidate_chunk == 64
    users = ds.test.user[:4]
    items = np.random.default_rng(0).integers(1, ds.num_items + 1, (4, 100))
    got = svc.score_batch(users, items)
    np.testing.assert_array_equal(
        got, ScoringService(cfg, ds, best, device="cpu").score_batch(users,
                                                                     items))
    want = JaxService(_cfg(jconfig), ds, to_flax(best)).score_batch(users,
                                                                    items)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    with pytest.raises(FileNotFoundError):
        ScoringService.from_checkpoint(cfg, ds, runs["ck"], which="nope",
                                       device="cpu")
