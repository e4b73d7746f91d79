#!/usr/bin/env python3
"""The row gather (`gather_rows`) of two checkouts of the port, in turns,
on one card, beside `index_select`.

    python3 chip_ab_gather.py DIR_A DIR_B

Each DIR is a checkout of the repo (for example the parent commit unpacked
with `git archive` next to the change). Every run is a fresh process in
that checkout that builds its gather kernel and times it at the eight
cases of this checkout's `chip_smoke.gather_cases` (the shapes serving,
training and uniform negatives give the gather), on tables and ids made
from seed 0: "eager", the mean of 50 back-to-back wrapper calls after 3
warm-ups (the checkout's `chip_smoke.cuda_ms`: what a train step pays,
the host's time where it outlasts the kernel's), and "graph", the mean
launch of 50 calls captured in one CUDA graph and replayed 5 times (its
`chip_smoke.graph_ms`: the kernel alone); and
`torch.index_select` on the same inputs, both ways. Every run checks the
kernel bit-exact against `index_select`. PAIRS pairs of runs go A B, then
B A, and so on (chip_ab_coattn.in_turns).

The last line is a JSON object: the card's name and power limit, and for
every case and timing each side's times (ms) in run order, their medians
and the ratio of A's median to B's. Exits non-zero if any run fails.
About 15 s a run on an H100.
"""

from __future__ import annotations

import json
import sys

from chip_ab_coattn import in_turns
from chip_smoke import card_line, gather_cases

PAIRS = 3

RUN = """
import json, sys, torch
sys.path.insert(0, '.')
from chip_smoke import cuda_ms, graph_ms
from score_tpu_torch.kernels.gather import gather_rows
CASES = %r
dev = torch.device('cuda')
gen = torch.Generator(device=dev).manual_seed(0)
out = {}
for label, dtype, V, W, shape in CASES:
    if dtype == 'int32':
        table = torch.randint(0, 1 << 30, (V, W), generator=gen, device=dev,
                              dtype=torch.int32)
    else:
        table = torch.randn(V, W, generator=gen, device=dev).to(
            getattr(torch, dtype))
    ids = torch.randint(0, V, shape, generator=gen, device=dev,
                        dtype=torch.int32)
    flat = ids.reshape(-1)
    want = torch.index_select(table, 0, flat).reshape(*shape, W)
    if not torch.equal(gather_rows(table, ids), want):
        raise SystemExit(f'gather {label}: kernel != index_select')
    out[label + ' eager'] = cuda_ms(lambda: gather_rows(table, ids),
                                     iters=50)
    out[label + ' graph'] = graph_ms(lambda: gather_rows(table, ids))
    out[label + ' index_select eager'] = cuda_ms(
        lambda: torch.index_select(table, 0, flat), iters=50)
    out[label + ' index_select graph'] = graph_ms(
        lambda: torch.index_select(table, 0, flat))
    del table, ids, flat, want
    torch.cuda.empty_cache()
print('RESULT ' + json.dumps(out))
"""


def cases() -> list:
    """(label, dtype name, rows, width, ids shape) of chip_smoke's gather
    cases, made on the CPU so that no card is needed to list them."""
    import torch
    out = []
    for label, table, shape in gather_cases(torch.Generator(), "cpu"):
        out.append((label, str(table.dtype)[6:], table.shape[0],
                    table.shape[1], tuple(shape)))
    return out


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = sys.argv[1:]
    card = card_line()
    shapes = in_turns(a, b, RUN % (cases(),), PAIRS)
    print(json.dumps({"card": card, "pairs": PAIRS, "shapes": shapes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
