"""One preset's train steps under the quality protocol, the JAX package's
and the port's side by side on the CPU, from the same weights and draws.

    python tests/_torch_quality_parity.py <preset> [steps] [seed=N]
        [resync=1] [train.<field>=V ...] [gen knob k=v ...]

Both start from the JAX package's init (its `init_state` params and optax
state, through `params.from_flax` / `opt_state_from_optax`); each step
takes the next batch of the same `TargetIterator` and the reference's
draws (its uniform negatives `randint(fold_in(PRNGKey(seed), step), (B,
k), 1, num_items + 1)`, or its in-batch shift), under the protocol's
train section (batch 512, lr 1e-3; `train.<field>=V` keys go over it,
e.g. train.table_update_every=2 train.table_lr_boost=2.0), on the
crossattr ladder dataset at the given generator knobs (a reduced copy:
600 users, 1,200 items, 60,000 events unless given). Each step prints
both losses and the largest distance between any parameter of the two,
and its leaf; the last line is the JSON of every step. A fault shows as
the two parting at once; f32 roundoff grows from the ulps over hundreds
of Adam steps (tests/test_torch_driver.py: at lr 1e-3 two f32 runs part
in the third decimal of the val metrics within an epoch). With resync=1
the port starts every step from the reference's state (weights and
optimizer state), so each distance is one step's own.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from score_tpu import config as jconfig  # noqa: E402
from score_tpu.graph import device_graph  # noqa: E402
from score_tpu.train import build_model, init_state  # noqa: E402
from score_tpu.train import item_importance_weights  # noqa: E402
from score_tpu.train import make_train_step  # noqa: E402
from score_tpu_torch import graph as tgraph  # noqa: E402
from score_tpu_torch import train as ttrain  # noqa: E402
from score_tpu_torch.data.pipeline import TargetIterator  # noqa: E402
from score_tpu_torch.params import from_flax, opt_state_from_optax  # noqa
from score_tpu_torch.scripts import ladder  # noqa: E402

REDUCED = dict(num_users=600, num_items=1200, num_events=60_000)


def jax_protocol(name: str, epochs: int, seed: int, **train_overrides):
    """scripts/ladder.py:74-78's rule on score_tpu.config."""
    cfg = jconfig.PRESETS[name]()
    return cfg.replace(train=cfg.train.__class__(**dict(
        ladder.PROTOCOL, num_epochs=epochs, seed=seed, **train_overrides)))


def steps(preset: str, n: int, seed: int = 0, ds=None, log=print,
          resync: bool = False, **train_overrides) -> list[dict]:
    """`n` protocol steps of `preset` on both sides: per step the two
    losses and the largest parameter distance (and its leaf); with
    `resync` each port step starts from the reference's state."""
    if ds is None:
        ds = ladder.ladder_dataset("taobao", "crossattr",
                                   ladder.gen_kw("crossattr", **REDUCED))
    jcfg = jax_protocol(preset, 4, seed, **train_overrides)
    tcfg = ladder.protocol_config(preset, 4, seed, **train_overrides)
    neg_mode, k = tcfg.data.train_neg_mode, tcfg.data.num_train_neg
    if tcfg.data.neighbor_resample or tcfg.model.dropout:
        raise ValueError("re-sampling and dropout draw from the port's own "
                         "generators: not replayed here")
    B, ni = tcfg.train.batch_size, ds.num_items
    rng = jax.random.PRNGKey(seed)
    jg = device_graph(ds.graph)
    jm = build_model(jcfg, ds.num_users, ni)
    jstate = init_state(jcfg, jm, jg, rng)
    jiw = tiw = None
    if neg_mode == "inbatch_iw":
        w = item_importance_weights(ds.train, ni)
        jiw, tiw = jnp.asarray(w), torch.from_numpy(np.asarray(w))
    jstep = make_train_step(jm, jcfg, neg_iw=jiw)

    def port_state(js):
        return ttrain.init_state(
            tcfg, ds.num_users, ni,
            from_flax(jax.tree.map(np.asarray, js.params)), device="cpu",
            opt_state=opt_state_from_optax(jax.device_get(js.opt_state)))

    st = port_state(jstate)
    tg = tgraph.device_graph(ds.graph, "cpu")
    it = TargetIterator(ds.train, B, seed=seed)
    rows = []
    for step in range(n):
        batch = next(it)
        step_rng = jax.random.fold_in(rng, step)
        if resync and step:
            st = port_state(jstate)     # before the step donates it
        jstate, jmet = jstep(jstate, jg,
                             {key: jnp.asarray(v) for key, v in batch.items()},
                             rng)
        if neg_mode == "uniform":
            raw = np.array(jax.random.randint(step_rng, (B, k), 1, ni + 1,
                                              dtype=jnp.int32))
            st, m = ttrain.train_step(st, tg, batch, neg_iw=tiw,
                                      negatives=raw)
        else:
            shifts = [int(s) for s in np.asarray(jax.random.randint(
                step_rng, (k,), 1, max(B, 2), dtype=jnp.int32))]
            st, m = ttrain.train_step(st, tg, batch, shifts, tiw)
        want = from_flax(jax.tree.map(np.asarray, jstate.params))
        got = dict(st.model.named_parameters())
        dist = {key: float((got[key].detach() - w).abs().max())
                for key, w in want.items()}
        leaf = max(dist, key=dist.get)
        row = dict(step=step + 1, loss_jax=float(jmet["loss"]),
                   loss_port=float(m["loss"]), max_param_dist=dist[leaf],
                   leaf=leaf)
        rows.append(row)
        log(f"step {row['step']}: loss jax {row['loss_jax']:.6f} port "
            f"{row['loss_port']:.6f} |d| "
            f"{abs(row['loss_jax'] - row['loss_port']):.2e}; largest "
            f"parameter distance {row['max_param_dist']:.3e} ({leaf})")
    return rows


def main(argv) -> None:
    torch.set_num_threads(4)
    args, kv, _ = ladder.split_argv(argv, "cpu")
    preset = args[0]
    n = int(args[1]) if len(args) > 1 else 200
    seed = int(kv.pop("seed", "0"))
    resync = kv.pop("resync", "0") == "1"
    over = {k.split(".", 1)[1]: float(v) if "." in v else int(v)
            for k, v in list(kv.items()) if k.startswith("train.")}
    for k in over:
        kv.pop(f"train.{k}")
    knobs = dict(REDUCED, **ladder.knob_values(kv))
    ds = ladder.ladder_dataset("taobao", "crossattr",
                               ladder.gen_kw("crossattr", **knobs))
    rows = steps(preset, n, seed, ds, resync=resync, **over)
    print(json.dumps(dict(preset=preset, seed=seed, knobs=knobs,
                          resync=resync, **over, steps=rows)))


if __name__ == "__main__":
    main(sys.argv[1:])
