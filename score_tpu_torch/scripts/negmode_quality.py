"""Quality gate for in-batch negatives: train configs3 once per train
negative mode ('uniform', 'inbatch', 'inbatch_iw') on the collab ladder
dataset, same seed, same data, and compare val/test AUC. An in-batch mode
drops the per-negative embedding gathers and gradient scatter-adds, and
becomes the default only if its AUC is within run-to-run variance of
'uniform'.

The port's counterpart of the JAX package's scripts/negmode_quality.py:
the same arguments and JSON lines, on `--device` (default cuda), with
bf16_quality's two departures: seed= sets the train seed (the
reference's is fixed at 0), and the dataset's paths are keyed by the
generator knobs as ladder's are. Generator knobs k=v (as ladder takes
them) shrink it for a quick run.

Usage: python -m score_tpu_torch.scripts.negmode_quality [epochs]
           [mode,mode,..] [seed=N] [--device D] [gen knob k=v ...]
"""

from __future__ import annotations

import dataclasses
import json

from . import ladder

MODES = ("uniform", "inbatch", "inbatch_iw")


def config(mode: str, epochs: int, seed: int):
    cfg = ladder.protocol_config("configs3", epochs, seed)
    return cfg.replace(data=dataclasses.replace(cfg.data,
                                                train_neg_mode=mode))


def main(argv=None, device: str = "cuda") -> dict:
    args, kv, device = ladder.split_argv(argv, device)
    epochs = int(args[0]) if len(args) > 0 else 3
    modes = args[1].split(",") if len(args) > 1 else MODES
    seed = int(kv.pop("seed", "0"))
    ds = ladder.ladder_dataset(
        "taobao", "collab", ladder.gen_kw("collab", **ladder.knob_values(kv)))
    print(f"users={ds.num_users} items={ds.num_items} "
          f"train={len(ds.train)}", flush=True)
    results = {}
    for mode in modes:
        out = ladder.run("configs3", config(mode, epochs, seed), ds, device)
        results[mode] = dict(best_val_auc=out["best_val_auc"],
                             test_auc=out["test"]["auc"],
                             ndcg10=out["test"]["ndcg@10"],
                             wall_s=out["wall_s"])
        print(json.dumps({mode: results[mode]}), flush=True)
    if "uniform" in results:
        for mode in results:
            if mode == "uniform":
                continue
            d = (results["uniform"]["best_val_auc"]
                 - results[mode]["best_val_auc"])
            print(json.dumps({f"val_auc_uniform_minus_{mode}": round(d, 5)}),
                  flush=True)
    return results


if __name__ == "__main__":
    main()
