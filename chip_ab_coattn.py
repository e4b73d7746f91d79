#!/usr/bin/env python3
"""The co-attention kernels of two checkouts of the port, in turns, on one
card: the candidates forward (`cross_coattn_cand`), the per-pair forward
with the max and the mean pool (`cross_coattn_pair`), and the shared
backward, for the sum pool (`cross_coattn_cand_bwd`) and the mean pool
(`cross_coattn_pair_bwd`).

    python3 chip_ab_coattn.py DIR_A DIR_B

Each DIR is a checkout of the repo (for example the parent commit unpacked
with `git archive` next to the change). Every run is a fresh process that
imports that checkout's `chip_smoke.py` and kernel wrappers, builds its
kernels, and times them in bf16 and f32 on inputs made by that checkout's
`chip_smoke._cand_inputs` from seed 0. The forwards run at each of
FWD_SHAPES: the shapes `score` (B=1, C=256), `score_batch` (B=16, C=4096
and one user at C=4096), eval (B=512 and 256, C=101), training (B=4096,
C=2), a ragged B and configs3's own d=16 give it. The backwards run at
BWD_SHAPES, `chip_smoke.phase_coattn_bwd`'s: training (B=4096, C=2), a
ragged B, flat pairs (C=1) and d=16, target-aware, on output gradients
drawn from the same generator; the wide backward
(`cross_coattn_pair_bwd` past d, n, m = 32, sum and mean pools) at
WIDE_BWD_SHAPES: configs3's training shape at d=64 and d=128, and d=32
with n = m = 40; and the wide forward (`cross_coattn_pair` past d, n, m =
32, the sum, mean and max pools) at WIDE_FWD_SHAPES, `chip_smoke.py`'s
WIDE_SHAPES: d=64 training, eval and serving, d=128 training and d=32
with n = m = 40. Two times a shape, both CUDA events:
"stream", the mean of ITERS calls of the wrapper after 3 warm-ups
(`chip_smoke.cuda_ms`, as `chip_smoke.py` times it; where a call's host
work outlasts the kernel, this is the host's time), and "graph", the mean
launch of ITERS calls captured in one CUDA graph and replayed REPLAYS
times, which leaves the host out. PAIRS pairs of runs go A B, then B A,
and so on.

The last line is a JSON object: the card's name and power limit, and for
every kernel, shape and timing each side's times (ms) in run order, their
medians, and the ratio of A's median to B's. The candidates forward's
keys read "B=.. C=.. <dtype> <timing>", the per-pair forward's
"pair_fwd <pool> B=.. C=.. <dtype> <timing>", the backwards' "cand_bwd
sum B=.. ...", "pair_bwd mean B=.. ..." and "wide_bwd <pool> B=.. ...",
the wide forward's "wide_fwd <pool> B=.. ...". Exits non-zero if any run
fails. About a minute a run on an H100.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

from chip_smoke import WIDE_SHAPES, card_line

PAIRS = 3
ITERS = 50
REPLAYS = 5
FWD_SHAPES = [dict(B=1, C=256), dict(B=1, C=4096), dict(B=16, C=4096),
              dict(B=512, C=101), dict(B=256, C=101), dict(B=4096, C=2),
              dict(B=37, C=101), dict(B=64, C=101, d=16)]
BWD_SHAPES = [dict(B=4096, C=2), dict(B=37, C=2), dict(B=64, C=1),
              dict(B=64, C=2, d=16)]
# the wide backward (past d, n, m = 32): configs3's training shape at d=64
# and d=128, and d=32 with 40 neighbour rows a side
WIDE_BWD_SHAPES = [dict(B=4096, C=2, d=64), dict(B=4096, C=2, d=128),
                   dict(B=1024, C=2, n=40, m=40, d=32)]
# the wide forward (past d, n, m = 32), each pool: chip_smoke.WIDE_SHAPES,
# configs3 at d=64 as training, eval and serving launch it, d=128 training,
# and d=32 with 40 neighbour rows a side
WIDE_FWD_SHAPES = [kw for _, kw in WIDE_SHAPES]

RUN = """
import json, sys, torch
sys.path.insert(0, '.')
import chip_smoke as cs
from score_tpu_torch.kernels.coattn import (cross_coattn_pair,
                                            cross_coattn_pair_bwd)
from score_tpu_torch.kernels.coattn_cand import (cross_coattn_cand,
                                                 cross_coattn_cand_bwd)
ITERS, REPLAYS = %d, %d
dev = torch.device('cuda')
gen = torch.Generator(device=dev).manual_seed(0)


def graph_ms(fn):   # chip_smoke.graph_ms, which older checkouts lack
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(ITERS):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPLAYS):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (REPLAYS * ITERS)


def time_both(key, fn):
    out[key + ' stream'] = cs.cuda_ms(fn, iters=ITERS)
    out[key + ' graph'] = graph_ms(fn)


out = {}
for kw in %r:
    for dtype in (torch.bfloat16, torch.float32):
        args = cs._cand_inputs(gen, dev, dtype, **kw)
        key = ' '.join(f'{k}={v}' for k, v in kw.items()) + ' ' + str(
            dtype)[6:]
        time_both(key, lambda: cross_coattn_cand(*args))
        for pool in ('max', 'mean'):
            time_both(f'pair_fwd {pool} ' + key, lambda: cross_coattn_pair(
                *args, pool=pool, target_aware=True))
        del args
        torch.cuda.empty_cache()
for kw in %r:
    for dtype in (torch.bfloat16, torch.float32):
        args = cs._cand_inputs(gen, dev, dtype, **kw)
        grads = [torch.randn(kw['B'], kw['C'], cs.T, kw.get('d', cs.D),
                             generator=gen, device=dev).to(dtype)
                 for _ in range(2)]
        key = ' '.join(f'{k}={v}' for k, v in kw.items()) + ' ' + str(
            dtype)[6:]
        time_both('cand_bwd sum ' + key, lambda: cross_coattn_cand_bwd(
            *args, *grads, target_aware=True))
        time_both('pair_bwd mean ' + key, lambda: cross_coattn_pair_bwd(
            *args, *grads, pool='mean', target_aware=True))
        del args, grads
        torch.cuda.empty_cache()
for kw in %r:
    for dtype in (torch.bfloat16, torch.float32):
        args = cs._cand_inputs(gen, dev, dtype, **kw)
        grads = [torch.randn(kw['B'], kw['C'], cs.T, kw['d'],
                             generator=gen, device=dev).to(dtype)
                 for _ in range(2)]
        key = ' '.join(f'{k}={v}' for k, v in kw.items()) + ' ' + str(
            dtype)[6:]
        for pool in ('sum', 'mean'):
            time_both(f'wide_bwd {pool} ' + key,
                      lambda: cross_coattn_pair_bwd(*args, *grads, pool=pool,
                                                    target_aware=True))
        del args, grads
        torch.cuda.empty_cache()
for kw in %r:
    for dtype in (torch.bfloat16, torch.float32):
        args = cs._cand_inputs(gen, dev, dtype, **kw)
        key = ' '.join(f'{k}={v}' for k, v in kw.items()) + ' ' + str(
            dtype)[6:]
        for pool in ('sum', 'mean', 'max'):
            time_both(f'wide_fwd {pool} ' + key, lambda: cross_coattn_pair(
                *args, pool=pool, target_aware=True))
        del args
        torch.cuda.empty_cache()
print('RESULT ' + json.dumps(out))
"""


def run_code(fwd_shapes, bwd_shapes, wide_shapes=(),
             wide_fwd_shapes=()) -> str:
    """The program one run executes, timing the given shapes."""
    return RUN % (ITERS, REPLAYS, fwd_shapes, bwd_shapes, list(wide_shapes),
                  list(wide_fwd_shapes))


def run(path: str, code: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", code], cwd=path,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONUNBUFFERED="1"))
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"run in {path} failed ({proc.returncode})")
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    res = json.loads(line[-1][len("RESULT "):])
    print(f"[{path}] {json.dumps(res)}", flush=True)
    return res


def in_turns(a: str, b: str, code: str, pairs: int = PAIRS) -> dict:
    """`pairs` pairs of runs of `code` in checkouts a and b (A B, then B A,
    ...); for every key of the runs' results each side's times in run
    order, their medians and the ratio of A's median to B's."""
    runs = {a: [], b: []}
    for i in range(pairs):
        for d in (a, b) if i % 2 == 0 else (b, a):
            runs[d].append(run(d, code))
    shapes = {}
    for key in runs[a][0]:
        ta = [r[key] for r in runs[a]]
        tb = [r[key] for r in runs[b]]
        ma, mb = statistics.median(ta), statistics.median(tb)
        shapes[key] = {a: ta, b: tb, "median_" + a: ma, "median_" + b: mb,
                       "a_over_b": ma / mb}
    return shapes


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = sys.argv[1:]
    card = card_line()
    shapes = in_turns(a, b, run_code(FWD_SHAPES, BWD_SHAPES,
                                     WIDE_BWD_SHAPES, WIDE_FWD_SHAPES))
    print(json.dumps({"card": card, "pairs": PAIRS, "iters": ITERS,
                      "replays": REPLAYS, "shapes": shapes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
