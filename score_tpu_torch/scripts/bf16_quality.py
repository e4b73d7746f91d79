"""Quality gate for the bf16 mixed-precision compute path: train configs3
twice on the collab ladder dataset, compute_dtype float32 against
bfloat16, same seed, same data, and compare val/test AUC. bf16 is
accepted as the default only if its AUC is within run-to-run variance of
f32.

The port's counterpart of the JAX package's scripts/bf16_quality.py: the
same argument and JSON lines, on `--device` (default cuda), with two
departures. seed= sets the train seed (the reference's is fixed at 0),
so the gate can run at several seeds. The dataset's paths are keyed by
the generator knobs, as ladder's are (the reference reads the unkeyed
default raw log, which a run with other knobs may have left behind); it
is the same dataset whenever no such stale log is present. Generator
knobs k=v (as ladder takes them) shrink it for a quick run.

Usage: python -m score_tpu_torch.scripts.bf16_quality [epochs] [seed=N]
           [--device D] [gen knob k=v ...]
"""

from __future__ import annotations

import dataclasses
import json

from . import ladder

DTYPES = ("float32", "bfloat16")


def config(dtype: str, epochs: int, seed: int):
    cfg = ladder.protocol_config("configs3", epochs, seed)
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 compute_dtype=dtype))


def main(argv=None, device: str = "cuda") -> dict:
    args, kv, device = ladder.split_argv(argv, device)
    epochs = int(args[0]) if len(args) > 0 else 3
    seed = int(kv.pop("seed", "0"))
    ds = ladder.ladder_dataset(
        "taobao", "collab", ladder.gen_kw("collab", **ladder.knob_values(kv)))
    print(f"users={ds.num_users} items={ds.num_items} "
          f"train={len(ds.train)}", flush=True)
    results = {}
    for dtype in DTYPES:
        out = ladder.run("configs3", config(dtype, epochs, seed), ds, device)
        results[dtype] = dict(best_val_auc=out["best_val_auc"],
                              test_auc=out["test"]["auc"],
                              ndcg10=out["test"]["ndcg@10"],
                              wall_s=out["wall_s"])
        print(json.dumps({dtype: results[dtype]}), flush=True)
    d = (results["float32"]["best_val_auc"]
         - results["bfloat16"]["best_val_auc"])
    print(json.dumps(dict(val_auc_f32_minus_bf16=round(d, 5))), flush=True)
    return results


if __name__ == "__main__":
    main()
