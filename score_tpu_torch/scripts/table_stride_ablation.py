"""Stride-K table-update quality gate.

TrainConfig.table_update_every=K skips the table-gradient scatter-adds
and the table optimizer update on (K-1)/K of steps: tables train on a 1/K
batch subsample. This runs configs3 under the ladder's protocol at seeds
0-2 on the crossattr ladder dataset for each arm, against the K=1
reference arm.

The K=1 reference is the JAX package's pinned configs3 3-seed row (val AUC
per seed 0.7766/0.7613/0.7804; identical dataset, knobs and seeds).

The port's counterpart of the JAX package's
scripts/table_stride_ablation.py: the same arguments and JSON, on
`--device` (default cuda); generator knobs k=v (as ladder takes them)
shrink the dataset for a quick run.

Usage: python -m score_tpu_torch.scripts.table_stride_ablation [out_json]
           [epochs] [K,K,..] [--device D] [gen knob k=v ...]

An arm is K ("2") or K with a table-lr boost ("2b2": stride 2, boost 2,
the K-fold-fewer-steps compensation).
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from . import ladder

SEEDS = (0, 1, 2)
PINNED_K1 = {"val_auc": [0.7766, 0.7613, 0.7804],
             "source": "BASELINE.md r3 multi-seed ladder (same dataset/knobs)"}


def parse_arms(spec: str) -> list[tuple[int, float]]:
    """"2,4,2b2" -> [(2, 1.0), (4, 1.0), (2, 2.0)]: (K, boost) per arm."""
    arms = []
    for a in spec.split(","):
        K, _, b = a.partition("b")
        arms.append((int(K), float(b) if b else 1.0))
    return arms


def arm_name(K: int, boost: float) -> str:
    return f"stride{K}" + (f"_boost{boost:g}" if boost != 1.0 else "")


def config(K: int, boost: float, epochs: int, seed: int):
    return ladder.protocol_config("configs3", epochs, seed,
                                  table_update_every=K, table_lr_boost=boost)


def main(argv=None, device: str = "cuda") -> dict:
    args, kv, device = ladder.split_argv(argv, device)
    out_path = args[0] if len(args) > 0 else os.path.join(
        tempfile.gettempdir(), "table_stride.json")
    epochs = int(args[1]) if len(args) > 1 else 4
    arms = parse_arms(args[2] if len(args) > 2 else "2,4")
    ds = ladder.ladder_dataset(
        "taobao", "crossattr",
        ladder.gen_kw("crossattr", **ladder.knob_values(kv)))
    print(f"dataset: users={ds.num_users} items={ds.num_items} "
          f"train={len(ds.train)}", flush=True)

    results = {"pinned_k1": PINNED_K1}
    for K, boost in arms:
        arm = arm_name(K, boost)
        results[arm] = []
        for seed in SEEDS:
            out = ladder.run("configs3", config(K, boost, epochs, seed), ds,
                             device)
            rec = dict(seed=seed, K=K, boost=boost,
                       best_val_auc=out["best_val_auc"],
                       test_auc=out["test"]["auc"],
                       ndcg10=out["test"]["ndcg@10"], wall_s=out["wall_s"])
            results[arm].append(rec)
            print(f"{arm} seed={seed}: val_auc={rec['best_val_auc']:.4f} "
                  f"test_auc={rec['test_auc']:.4f} "
                  f"ndcg@10={rec['ndcg10']:.4f} wall={rec['wall_s']}s",
                  flush=True)

    ref = np.array(PINNED_K1["val_auc"])
    print(f"pinned K=1: val_auc mean={ref.mean():.4f} sd={ref.std():.4f}",
          flush=True)
    for arm, recs in results.items():
        if arm == "pinned_k1":
            continue
        v = np.array([r["best_val_auc"] for r in recs])
        print(f"{arm}: val_auc mean={v.mean():.4f} sd={v.std():.4f} "
              f"delta_vs_k1={v.mean() - ref.mean():+.4f}", flush=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
