#!/usr/bin/env python3
"""The quality protocol of the port on one CUDA card, held against the JAX
package's pinned numbers.

    python3 chip_quality.py [out_dir] [--device D] [--knobs k=v,k=v]
    python3 chip_quality.py --compare [out_dir]

Runs the five modules of score_tpu_torch.scripts as the JAX package's
scripts ran them for the pinned records, split into jobs of a few train()
runs each and run PARALLEL (6) at a time (the step is host-bound, so one
card takes several processes), each job in a process of its own with
its own temporary directory (the dataset is prepped there):

  ladder  `ladder taobao 4 --baselines mode=crossattr seed=S`, the twelve
          presets split into three jobs a seed, seeds 0-2;
  stride  `table_stride_ablation <out> 4 K` for the arms 2, 4 and 2b2
          (seeds 0-2 each);
  resample `resample_ablation <out> 4` (both arms, seeds 0-2);
  bf16    `bf16_quality 3 seed=S`, seeds 0-2;
  negmode `negmode_quality 3 seed=S`, seeds 0-2.

Each job's JSON (or, for the bf16 and negmode gates, its printed JSON
lines) and log go to out_dir (default: score_tpu_quality under the
temporary directory). Then, and with --compare alone on a finished
out_dir, it compares them with the pinned JAX records
(LADDER_roster_r3.json, TABLE_STRIDE_r4_plain.json,
TABLE_STRIDE_r4_boost2.json, RESAMPLE_ABL_r3.json; the bf16 and negmode
gates' one-seed rows of BASELINE.md round 1 and 2) by this rule, on val
AUC, for every preset and arm pinned at 3 seeds:

  delta = port mean - JAX mean; SE = sqrt(sd_port^2/3 + sd_jax^2/3), with
  population sds; a row is flagged when |delta| > max(3 SE, 0.010).

The one-seed gates are compared on their arm differences (f32 - bf16,
inbatch_iw - uniform, inbatch - uniform) by the same rule with the JAX
sd taken as 0. It also reports the ladder's orderings (configs0 <
{configs1, configs2} < configs3 on means; configs3 ahead of every
baseline) and each gate's decision, and writes compare.json to out_dir
and a markdown table to its standard output. Test AUC and NDCG@10 stand
beside val AUC. Imports nothing of JAX.

A rehearsal on the CPU at tiny generator knobs (every job gets them):
`python3 chip_quality.py <dir> --device cpu --knobs
num_users=150,num_items=300,num_events=6000` (~3 min on 8 cores).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from score_tpu_torch.config import BASELINE_PRESETS
from score_tpu_torch.scripts.ladder import RUNGS

ROOT = Path(__file__).resolve().parent
SEEDS = (0, 1, 2)
LADDER_SPLIT = (
    "configs3,configs0,baseline_pop,baseline_mf",
    "configs2,configs1,baseline_svdpp,baseline_delf",
    "baseline_rrn,baseline_gru4rec,baseline_caser,baseline_sasrec")
BASELINES = tuple(BASELINE_PRESETS)
STRIDE_ARMS = {"2": "stride2", "4": "stride4", "2b2": "stride2_boost2"}
RESAMPLE_ARMS = ("fixed_prep_sample", "per_step_resample")
BF16_ARMS = ("float32", "bfloat16")
NEG_ARMS = ("uniform", "inbatch", "inbatch_iw")
# the bf16 and negmode gates' one-seed JAX rows (seed 0, 3 epochs, TPU):
# BASELINE.md round 1 "bf16 quality gate" and round 2 "negative-mode
# quality gate"
JAX_ONE_SEED = {"float32": 0.7554, "bfloat16": 0.7538, "uniform": 0.7557,
                "inbatch": 0.6530, "inbatch_iw": 0.7790}
MIN_FLAG = 0.010
PARALLEL = 6


def jobs(out: Path) -> list[tuple[str, list[str]]]:
    """(name, module argv) of every job, the longest first."""
    js = []
    for part, models in enumerate(LADDER_SPLIT):
        for s in SEEDS:
            js.append((f"ladder_s{s}_{part}", [
                "ladder", str(out / f"ladder_s{s}_{part}.json"), "taobao",
                "4", "--baselines", "mode=crossattr", f"seed={s}",
                f"models={models}"]))
    js.append(("resample", ["resample_ablation", str(out / "resample.json"),
                            "4"]))
    for arm in STRIDE_ARMS:
        js.append((f"stride_{arm}", [
            "table_stride_ablation", str(out / f"stride_{arm}.json"), "4",
            arm]))
    for s in SEEDS:
        js.append((f"negmode_s{s}", ["negmode_quality", "3", f"seed={s}"]))
        js.append((f"bf16_s{s}", ["bf16_quality", "3", f"seed={s}"]))
    return js


def prebuild() -> None:
    """Build the kernels the protocol's presets launch once, before the
    jobs start, so they do not each run nvcc."""
    from score_tpu_torch.kernels import _build
    names = ("gather", "scatter_add", "coattn_cand", "coattn_cand_bwd")
    with ThreadPoolExecutor(len(names)) as pool:
        for lib in pool.map(_build._build, names):
            print(f"built {lib.name}", flush=True)


def run_jobs(out: Path, device: str = "cuda", knobs=()) -> dict:
    work = Path(tempfile.mkdtemp(prefix="chip_quality_"))
    t0 = time.perf_counter()
    running, rcs = [], {}
    try:
        pending = jobs(out)
        while pending or running:
            while pending and len(running) < PARALLEL:
                name, argv = pending.pop(0)
                tmp = work / name
                tmp.mkdir()
                env = dict(os.environ, TMPDIR=str(tmp), OMP_NUM_THREADS="2",
                           PYTHONUNBUFFERED="1")
                log = open(out / f"{name}.log", "w")
                proc = subprocess.Popen(
                    [sys.executable, "-m",
                     f"score_tpu_torch.scripts.{argv[0]}", *argv[1:],
                     "--device", device, *knobs],
                    cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
                running.append((name, proc, log, time.perf_counter()))
            time.sleep(1.0)
            for item in list(running):
                name, proc, log, start = item
                if proc.poll() is not None:
                    log.close()
                    running.remove(item)
                    rcs[name] = proc.returncode
                    print(f"job {name}: exit {proc.returncode} after "
                          f"{time.perf_counter() - start:.1f} s "
                          f"({time.perf_counter() - t0:.1f} s in all)",
                          flush=True)
    finally:
        for name, proc, log, _ in running:
            proc.kill()
            proc.wait()
            log.close()
        shutil.rmtree(work, ignore_errors=True)
    return rcs


def _json_lines(path: Path) -> dict:
    """The {arm: record} JSON lines a bf16 or negmode job printed."""
    got = {}
    for line in path.read_text().splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            got.update({k: v for k, v in rec.items() if isinstance(v, dict)})
    return got


def collect(out: Path) -> dict:
    """{row name: {"val": [...], "test": [...], "ndcg": [...]}} of the
    port's runs, one entry a seed in seed order."""
    rows: dict = {}

    def add(name, val, test, ndcg):
        r = rows.setdefault(name, {"val": [], "test": [], "ndcg": []})
        r["val"].append(val)
        r["test"].append(test)
        r["ndcg"].append(ndcg)

    for s in SEEDS:
        for part in range(len(LADDER_SPLIT)):
            p = out / f"ladder_s{s}_{part}.json"
            if p.exists():
                for name, rec in json.loads(p.read_text()).items():
                    add(name, rec["best_val_auc"], rec["test"]["auc"],
                        rec["test"]["ndcg@10"])
    for p in sorted(out.glob("stride_*.json")) + [out / "resample.json"]:
        if p.exists():
            for arm, recs in json.loads(p.read_text()).items():
                for rec in recs if arm != "pinned_k1" else ():
                    add(arm, rec["best_val_auc"], rec["test_auc"],
                        rec["ndcg10"])
    for kind, arms in (("bf16", BF16_ARMS), ("negmode", NEG_ARMS)):
        for s in SEEDS:
            p = out / f"{kind}_s{s}.log"
            if p.exists():
                got = _json_lines(p)
                for arm in arms:
                    if arm in got:
                        rec = got[arm]
                        add(arm, rec["best_val_auc"], rec["test_auc"],
                            rec["ndcg10"])
    return rows


def pinned() -> dict:
    """The JAX records' per-seed values, in the shape of `collect`."""
    rows: dict = {}
    roster = json.loads((ROOT / "LADDER_roster_r3.json").read_text())
    for name in RUNGS + BASELINES:
        recs = [roster[f"seed{s}"][name] for s in SEEDS]
        rows[name] = {"val": [r["best_val_auc"] for r in recs],
                      "test": [r["test"]["auc"] for r in recs],
                      "ndcg": [r["test"]["ndcg@10"] for r in recs]}
    for fname in ("TABLE_STRIDE_r4_plain.json", "TABLE_STRIDE_r4_boost2.json",
                  "RESAMPLE_ABL_r3.json"):
        for arm, recs in json.loads((ROOT / fname).read_text()).items():
            if isinstance(recs, list):
                rows[arm] = {"val": [r["best_val_auc"] for r in recs],
                             "test": [r["test_auc"] for r in recs],
                             "ndcg": [r["ndcg10"] for r in recs]}
    return rows


def _stats(xs) -> tuple[float, float]:
    a = np.asarray(xs, np.float64)
    return float(a.mean()), float(a.std())      # population sd


def compare_row(port_vals, jax_vals) -> dict:
    pm, ps = _stats(port_vals)
    jm, js = _stats(jax_vals)
    se = math.sqrt(ps ** 2 / len(port_vals) + js ** 2 / len(jax_vals))
    delta = pm - jm
    return dict(port_mean=pm, port_sd=ps, jax_mean=jm, jax_sd=js,
                delta=delta, se=se,
                flagged=bool(abs(delta) > max(3 * se, MIN_FLAG)))


def compare(out: Path) -> dict:
    port, jax = collect(out), pinned()
    table = {}
    for name in RUNGS + BASELINES + tuple(STRIDE_ARMS.values()) \
            + RESAMPLE_ARMS:
        if name in port and name in jax:
            row = compare_row(port[name]["val"], jax[name]["val"])
            row.update(seeds=len(port[name]["val"]),
                       test_auc=_stats(port[name]["test"]),
                       jax_test_auc=_stats(jax[name]["test"]),
                       ndcg10=_stats(port[name]["ndcg"]),
                       jax_ndcg10=_stats(jax[name]["ndcg"]))
            table[name] = row
    diffs = {}
    for a, b in (("float32", "bfloat16"), ("inbatch_iw", "uniform"),
                 ("inbatch", "uniform")):
        if a in port and b in port and len(port[a]["val"]) == \
                len(port[b]["val"]):
            d = list(np.subtract(port[a]["val"], port[b]["val"]))
            row = compare_row(d, [JAX_ONE_SEED[a] - JAX_ONE_SEED[b]])
            row.update(seeds=len(d), port_arms={
                arm: _stats(port[arm]["val"]) for arm in (a, b)},
                jax_arms={arm: JAX_ONE_SEED[arm] for arm in (a, b)})
            diffs[f"{a} - {b}"] = row
    means = {n: _stats(port[n]["val"])[0] for n in port}
    orderings = {}
    if all(n in means for n in RUNGS):
        c0, c1, c2, c3 = (means[n] for n in RUNGS)
        orderings["configs0 < {configs1, configs2} < configs3"] = bool(
            c0 < min(c1, c2) and max(c1, c2) < c3)
    if "configs3" in means and all(b in means for b in BASELINES):
        orderings["configs3 ahead of every baseline"] = bool(
            all(means["configs3"] > means[b] for b in BASELINES))
    decisions = {}
    thr = lambda row: max(3 * row["se"], MIN_FLAG)   # noqa: E731
    if "float32 - bfloat16" in diffs:
        r = diffs["float32 - bfloat16"]
        decisions["bf16 compute accepted (f32 - bf16 within the rule)"] = \
            bool(abs(r["port_mean"]) <= thr(r))
    if "inbatch_iw - uniform" in diffs:
        r = diffs["inbatch_iw - uniform"]
        decisions["inbatch_iw adopted (not below uniform past the rule)"] = \
            bool(r["port_mean"] >= -thr(r))
    if "inbatch - uniform" in diffs:
        r = diffs["inbatch - uniform"]
        decisions["plain inbatch refused (below uniform past the rule)"] = \
            bool(r["port_mean"] < -thr(r))
    if "configs3" in port and "stride2_boost2" in port:
        r = compare_row(port["stride2_boost2"]["val"],
                        port["configs3"]["val"])
        decisions["stride 2 at 2x adopted (not below the port's K=1 "
                  "configs3 past the rule)"] = bool(r["delta"] >= -thr(r))
    if "configs3" in port and "stride4" in port:
        r = compare_row(port["stride4"]["val"], port["configs3"]["val"])
        decisions["plain stride 4 refused (below K=1 past the rule)"] = \
            bool(r["delta"] < -thr(r))
    if all(a in port for a in RESAMPLE_ARMS):
        r = compare_row(port["per_step_resample"]["val"],
                        port["fixed_prep_sample"]["val"])
        decisions["re-sampling stays off (no gain past the rule)"] = bool(
            r["delta"] <= thr(r))
    return dict(rows=table, arm_differences=diffs, orderings=orderings,
                decisions=decisions)


def markdown(res: dict, card: str) -> str:
    f = lambda m, s: f"{m:.4f}±{s:.4f}"   # noqa: E731
    lines = [f"card: {card}", "",
             "| preset or arm | seeds | port val AUC | JAX val AUC | delta "
             "| SE | flagged | port test AUC | JAX test AUC | port NDCG@10 "
             "| JAX NDCG@10 |", "|---" * 11 + "|"]
    for name, r in res["rows"].items():
        lines.append(
            f"| {name} | {r['seeds']} | {f(r['port_mean'], r['port_sd'])} | "
            f"{f(r['jax_mean'], r['jax_sd'])} | {r['delta']:+.4f} | "
            f"{r['se']:.4f} | {'yes' if r['flagged'] else 'no'} | "
            f"{f(*r['test_auc'])} | {f(*r['jax_test_auc'])} | "
            f"{f(*r['ndcg10'])} | {f(*r['jax_ndcg10'])} |")
    for name, r in res["arm_differences"].items():
        lines.append(
            f"| {name} (val AUC difference) | {r['seeds']} | "
            f"{f(r['port_mean'], r['port_sd'])} | {r['jax_mean']:+.4f} "
            f"(1 seed) | {r['delta']:+.4f} | {r['se']:.4f} | "
            f"{'yes' if r['flagged'] else 'no'} | | | | |")
    lines.append("")
    for k, v in {**res["orderings"], **res["decisions"]}.items():
        lines.append(f"- {k}: {v}")
    return "\n".join(lines)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv) -> int:
    argv = list(argv)
    compare_only, device, knobs = False, "cuda", []
    if "--compare" in argv:
        argv.remove("--compare")
        compare_only = True
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if "--knobs" in argv:
        i = argv.index("--knobs")
        knobs = argv[i + 1].split(",")
        del argv[i:i + 2]
    out = Path(argv[0] if argv else os.path.join(tempfile.gettempdir(),
                                                  "score_tpu_quality"))
    out.mkdir(parents=True, exist_ok=True)
    card_file = out / "card.txt"
    if compare_only and card_file.exists():     # the card of the runs
        card = card_file.read_text().strip()
    else:
        card = card_line()
        card_file.write_text(card + "\n")
    print(card, flush=True)
    rc = 0
    if not compare_only:
        if device == "cuda":
            import torch
            if not torch.cuda.is_available():
                print("chip_quality: no CUDA device", file=sys.stderr)
                return 1
            prebuild()
        rcs = run_jobs(out, device, knobs)
        rc = int(any(rcs.values()))
    res = compare(out)
    res["card"] = card
    (out / "compare.json").write_text(json.dumps(res, indent=1))
    print(markdown(res, card), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
