#!/usr/bin/env python3
"""The sum-pool train step of two checkouts of the port, in turns, on one
card.

    python3 chip_ab_train.py DIR_A DIR_B

Each DIR is a checkout of the repo (for example the parent commit unpacked
with `git archive` next to the change). Every run is a fresh process that
imports that checkout's `chip_smoke.py`, builds its kernels, builds the
synthetic dataset and calls its `phase_training` (configs3 at the bench
width, sum pool: 3 warm-up steps, 50 timed steps through `train_loop`, a
torch.profiler window), so both sides run exactly the code their checkout
ships. PAIRS pairs of runs go A B, then B A, and so on, so that neither a
drift of the host over the call nor a run's place in its pair falls on
one side.

Each run's step and profile lines are printed as they come, tagged with
its directory. The last line is a JSON object: the card's name and power
limit; per side every run's step time (CUDA events and wall clock, ms)
and device time a step, and the median and quartiles of the event step
times; and the number of pairs in which B's step was the shorter. Exits
non-zero if any run fails. About 50 s a run on an H100.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys

PAIRS = 10

RUN = """
import sys, torch
sys.path.insert(0, '.')
import chip_smoke as cs
from score_tpu_torch.kernels import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all()
cs.phase_training(cs.card_line(), cs.bench_dataset(), torch.device('cuda'))
"""

STEP = re.compile(r"step ([0-9.]+) ms by CUDA events, ([0-9.]+) ms by wall")
PROF = re.compile(r"kernels and ([0-9.]+) ms of device time a step")


def run(path: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=path,
                          capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, PYTHONUNBUFFERED="1"))
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"run in {path} failed ({proc.returncode})")
    step = STEP.search(proc.stdout)
    prof = PROF.search(proc.stdout)
    for line in proc.stdout.splitlines():
        if STEP.search(line) or PROF.search(line):
            print(f"[{path}] {line[:300]}", flush=True)
    return dict(event_ms=float(step[1]), wall_ms=float(step[2]),
                device_ms=float(prof[1]) if prof else None)


def summary(runs: list) -> dict:
    q25, q50, q75 = statistics.quantiles([r["event_ms"] for r in runs], n=4)
    return dict(runs=runs, median_ms=q50, q25_ms=q25, q75_ms=q75)


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = sys.argv[1:]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {a: [], b: []}
    for i in range(PAIRS):
        for d in (a, b) if i % 2 == 0 else (b, a):
            out[d].append(run(d))
    b_wins = sum(rb["event_ms"] < ra["event_ms"]
                 for ra, rb in zip(out[a], out[b]))
    print(json.dumps({"card": card, "pairs": PAIRS, "b_shorter": b_wins,
                      a: summary(out[a]), b: summary(out[b])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
