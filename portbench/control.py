"""The readings a cell's limits are set from, on the card, at the cell's
own size: for each seed, the program's numbers (as a run compares them)
and the control's, the plain reference computed in fp8 (e4m3) in the
program's place against the reference in f32; for a training cell also
the fault of half of each batch left out (the reference's loss the mean
over the first half of its rows). One process reads every seed.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3
                                 [--seconds 3]

Each seed prints one JSON line {seed, program, control[, half_batch]}.
The benchmark's runs do not run this; `portbench/tests` keep the control
at a small size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import run  # noqa: E402
from portbench.reference.model import set_precision  # noqa: E402


def readings(workload: str, seed: int, seconds: float, device="cuda"
             ) -> dict:
    entry, cfg, tr = run.cell_of(workload)
    kind = run.kind_module(tr)
    cell = run.Cell(workload, cfg, tr, seed, torch.device(device))
    kind.setup(cell)
    if tr["kind"] != "train":
        kind.window(cell, seconds)
    kind.release(cell)
    set_precision()
    out = dict(seed=seed, program=kind.check(cell),
               control=kind.control(cell, torch.float8_e4m3fn))
    if tr["kind"] == "train":
        out["half_batch"] = kind.half_batch(cell)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench: the control is read on the card", file=sys.stderr)
        return 1
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
