"""Run the config ladder (configs0..3) on one dataset and report per-rung
metrics, the ablation-monotonicity oracle: each rung should improve
validation AUC over the previous.

With --baselines, also runs the baseline-model roster (the eight
`baseline_*` presets: popularity, MF, SVD++, DELF, GRU4Rec, Caser,
SASRec, RRN) under the identical train/eval protocol, the comparison
table where full SCoRe (configs3) should lead.

The port's counterpart of the JAX package's scripts/ladder.py: the same
arguments, protocol, dataset and JSON, on `--device` (default cuda).

Usage: python -m score_tpu_torch.scripts.ladder [out_json] [dataset]
           [epochs] [--baselines] [--device D]
           [mode=collab|crossattr|latent] [seed=N] [models=a,b,...]
           [gen knob k=v ...]

seed= sets the TRAIN seed only (the dataset is the same prep for all
seeds). models= restricts the roster to a comma list of preset names.

mode=crossattr uses the cross-side relational generator with the skew
defaults that make the co-attention rung's advantage measurable
(drift_active=3, sig_frac=0.7, junk_frac=0.2).

The dataset is synthesized and prepped under the temporary directory
($TMPDIR or /tmp), its paths keyed by the generator knobs (`data_tag`).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import time

from ..config import BASELINE_PRESETS, PRESETS, Config, TrainConfig
from ..data.prep_datasets import PREP
from ..data.schema import Dataset
from ..train import train

RUNGS = ("configs0", "configs1", "configs2", "configs3")

# the protocol's train section; every other TrainConfig field stays at its
# default
PROTOCOL = dict(batch_size=512, learning_rate=1e-3, eval_every_steps=300,
                early_stop_patience=6, log_every_steps=10 ** 9)


def gen_kw(mode: str = "collab", **knobs) -> dict:
    """The generator's knobs: 3,000 users, 6,000 items and 400,000 events
    of `mode`, crossattr's skew defaults, then `knobs` over them."""
    kw = dict(num_users=3000, num_items=6000, num_events=400_000, mode=mode)
    if mode == "crossattr":
        kw.update(drift_active=3.0, sig_frac=0.7, junk_frac=0.2)
    kw.update(knobs)
    return kw


def data_tag(dataset: str, mode: str, gen_kw: dict) -> str:
    """The dataset's cache key: `dataset` (and `mode` unless collab) and
    the md5 of the knobs with every number as a float, so 3 and 3.0 hash
    alike. A raw log made with other knobs is never reused: the prep
    skips synthesis when the raw path exists."""
    canon = {k: (float(v) if isinstance(v, (int, float)) else v)
             for k, v in gen_kw.items()}
    gh = hashlib.md5(json.dumps(canon, sort_keys=True).encode()) \
        .hexdigest()[:6]
    return (dataset if mode == "collab" else f"{dataset}_{mode}") + f"_{gh}"


def ladder_dataset(dataset: str, mode: str, gen_kw: dict,
                   root: str | None = None, **prep_overrides) -> Dataset:
    """Synthesize (unless present) and prep the dataset of `gen_kw` under
    `root` (default: the temporary directory): the raw log at
    score_tpu_raw/ladder_<tag>.csv, the prepped dataset at
    score_tpu_data/ladder_<tag>[_<override><value>...]. `prep_overrides`
    (e.g. user_fanout=20) go to the prep, not to the generator."""
    root = tempfile.gettempdir() if root is None else root
    tag = data_tag(dataset, mode, gen_kw)
    suffix = "".join(f"_{k}{v}" for k, v in sorted(prep_overrides.items()))
    return PREP[dataset](
        os.path.join(root, "score_tpu_data", f"ladder_{tag}{suffix}"),
        raw_path=os.path.join(root, "score_tpu_raw", f"ladder_{tag}.csv"),
        synth_kw=gen_kw, **prep_overrides)


def protocol_config(name: str, epochs: int, seed: int,
                    **train_overrides) -> Config:
    """Preset `name` with its train section replaced by the protocol's:
    batch 512, lr 1e-3, `epochs`, a val every 300 steps, patience 6, no
    log lines, `seed`, then `train_overrides`; every other field at its
    TrainConfig default."""
    cfg = PRESETS[name]()
    return cfg.replace(train=TrainConfig(**dict(
        PROTOCOL, num_epochs=epochs, seed=seed, **train_overrides)))


def run(name: str, cfg: Config, ds: Dataset, device) -> dict:
    """One quiet train() call: {best_val_auc, test, steps, wall_s}."""
    t0 = time.time()
    out = train(cfg, ds, verbose=False, device=device)
    return dict(best_val_auc=out["best_val_auc"], test=out["test"],
                steps=out["steps_run"], wall_s=round(time.time() - t0, 1))


def split_argv(argv, device: str = "cuda") -> tuple[list, dict, str]:
    """(positional arguments, k=v keys, device) of a command line, the
    device from `--device D` or else `device`; other flags stay among the
    positional arguments."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device needs a value (cuda, cpu, ...)")
        device = argv[i + 1]
        del argv[i:i + 2]
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    return [a for a in argv if "=" not in a], kv, device


def knob_values(kv: dict, defaults: dict | None = None) -> dict:
    """Knobs from k=v strings. Without `defaults` (the generator's open
    set of knobs): a float if it has a '.', else an int. With them:
    `defaults` with `kv` over them, each cast to its default's type; an
    unknown key raises KeyError, naming the knobs."""
    if defaults is None:
        return {k: float(v) if "." in v else int(v) for k, v in kv.items()}
    kw = dict(defaults)
    for k, v in kv.items():
        if k not in kw:
            raise KeyError(f"unknown knob {k!r}; knobs: {', '.join(kw)}")
        kw[k] = type(kw[k])(v)
    return kw


def main(argv=None, device: str = "cuda") -> dict:
    args, kv, device = split_argv(argv, device)
    with_baselines = "--baselines" in args
    args = [a for a in args if a != "--baselines"]
    out_path = args[0] if len(args) > 0 else os.path.join(
        tempfile.gettempdir(), "ladder.json")
    dataset = args[1] if len(args) > 1 else "taobao"
    epochs = int(args[2]) if len(args) > 2 else 3
    mode = kv.pop("mode", "collab")
    seed = int(kv.pop("seed", "0"))
    models = kv.pop("models", None)
    kw = gen_kw(mode, **knob_values(kv))
    ds = ladder_dataset(dataset, mode, kw)
    print(f"{dataset}: users={ds.num_users} items={ds.num_items} "
          f"train={len(ds.train)}", flush=True)

    results = {}
    if models:
        names = models.split(",")
    else:
        names = list(BASELINE_PRESETS) if with_baselines else []
        names += list(RUNGS)
    for name in names:
        results[name] = rec = run(name, protocol_config(name, epochs, seed),
                                  ds, device)
        print(f"{name}: val_auc={rec['best_val_auc']:.4f} "
              f"test_auc={rec['test']['auc']:.4f} "
              f"ndcg@10={rec['test']['ndcg@10']:.4f} "
              f"wall={rec['wall_s']}s", flush=True)

    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    rungs = [n for n in RUNGS if n in results]
    if len(rungs) == 4:
        aucs = [results[n]["best_val_auc"] for n in rungs]
        print("ladder val AUCs:", [round(a, 4) for a in aucs], flush=True)
        print("monotone:",
              all(b >= a - 0.002 for a, b in zip(aucs, aucs[1:])),
              flush=True)
    return results


if __name__ == "__main__":
    main()
