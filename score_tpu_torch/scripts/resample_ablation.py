"""Neighbour re-sampling quality ablation: does the draw-per-occurrence
sampler (a fresh uniform neighbour subset every step,
`data.neighbor_resample=true`) help or hurt against the prep-time fixed
sample?

Protocol: the crossattr ladder dataset at the model's fan-out (10) is the
OFF arm; the ON arm preps the SAME generator's log at 2x fan-out (20) and
subsamples to 10 on the device each step (graph.subsample_neighbors).
configs3, the ladder's train protocol, seeds {0,1,2}.

The port's counterpart of the JAX package's scripts/resample_ablation.py:
the same arguments and JSON, on `--device` (default cuda); generator knobs
k=v (as ladder takes them) shrink the dataset for a quick run.

Usage: python -m score_tpu_torch.scripts.resample_ablation [out_json]
           [epochs] [--device D] [gen knob k=v ...]
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from ..config import DataConfig
from . import ladder

SEEDS = (0, 1, 2)
STORED_FANOUT = 20          # the ON arm's prep; the model samples 10
ARMS = (("fixed_prep_sample", False), ("per_step_resample", True))


def config(resample: bool, epochs: int, seed: int):
    """configs3 under the protocol, its data section replaced whole (as
    the reference's script does: every other DataConfig field at its
    default)."""
    return ladder.protocol_config("configs3", epochs, seed).replace(
        data=DataConfig(neighbor_resample=resample))


def main(argv=None, device: str = "cuda") -> dict:
    args, kv, device = ladder.split_argv(argv, device)
    out_path = args[0] if len(args) > 0 else os.path.join(
        tempfile.gettempdir(), "resample_abl.json")
    epochs = int(args[1]) if len(args) > 1 else 4
    kw = ladder.gen_kw("crossattr", **ladder.knob_values(kv))
    ds10 = ladder.ladder_dataset("taobao", "crossattr", kw)
    ds20 = ladder.ladder_dataset("taobao", "crossattr", kw,
                                 user_fanout=STORED_FANOUT,
                                 item_fanout=STORED_FANOUT)
    print(f"off-arm fanout={ds10.graph.u2i.shape[-1]} "
          f"on-arm fanout={ds20.graph.u2i.shape[-1]}", flush=True)

    results = {}
    for (arm, resample), ds in zip(ARMS, (ds10, ds20)):
        results[arm] = []
        for seed in SEEDS:
            out = ladder.run("configs3", config(resample, epochs, seed), ds,
                             device)
            rec = dict(seed=seed, best_val_auc=out["best_val_auc"],
                       test_auc=out["test"]["auc"],
                       ndcg10=out["test"]["ndcg@10"], wall_s=out["wall_s"])
            results[arm].append(rec)
            print(f"{arm} seed={seed}: val_auc={rec['best_val_auc']:.4f} "
                  f"test_auc={rec['test_auc']:.4f} "
                  f"ndcg@10={rec['ndcg10']:.4f} wall={rec['wall_s']}s",
                  flush=True)

    for arm in results:
        v = [r["best_val_auc"] for r in results[arm]]
        print(f"{arm}: val_auc mean={np.mean(v):.4f} sd={np.std(v):.4f}",
              flush=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
