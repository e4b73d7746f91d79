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
kernel bit-exact against `index_select`. Then the table gradients of one
configs3 table-update step (TABLE_RUN: each checkout's lookups into both
tables and their backward, which a checkout with grouped lookups runs as
one scatter-add a table and an older one as one a lookup plus an add),
checked against index_add_ and timed eagerly and by graph. PAIRS pairs
of runs go A B, then B A, and so on (chip_ab_coattn.in_turns).

The last line is a JSON object: the card's name and power limit, and for
every case and timing each side's times (ms) in run order, their medians
and the ratio of A's median to B's. Exits non-zero if any run fails.
About 15 s a run of each program on an H100.
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


# configs3's table gradients of one table-update step: both tables' lookups
# (user [B] and its histories, item candidates and histories) and their
# backward, in each checkout as its model makes them (grouped lookups
# where EmbeddingTables has `lookup`, else one lookup a call), on ids with
# 55% pad rows in the histories (as a real batch has) whose gradient is
# zero. "lookups": the four gathers alone; "lookups+grad": the gathers and
# the tables' gradients, eagerly and by CUDA graph; and the item table's
# one-lookup scatter-adds alone.
TABLE_RUN = """
import json, sys, torch
sys.path.insert(0, '.')
from chip_smoke import cuda_ms, graph_ms
from score_tpu_torch.nn.embed import EmbeddingTables
dev = torch.device('cuda')
gen = torch.Generator(device=dev).manual_seed(0)
B, T, FAN, D, USERS, ITEMS = 4096, 9, 10, 32, 50000, 90553
out = {}
for label, C in (('configs3 in-batch', 1), ('configs3 uniform', 2)):
    tables = EmbeddingTables(USERS, ITEMS, D).to(dev)
    def ids(hi, shape, pad):
        x = torch.randint(1, hi + 1, shape, generator=gen, device=dev,
                          dtype=torch.int32)
        return torch.where(torch.rand(shape, generator=gen, device=dev)
                           < pad, 0, x)
    user, cand = ids(USERS, (B,), 0.0), ids(ITEMS, (B, C), 0.0)
    i_hist, u_hist = ids(USERS, (B, C, T, FAN), 0.55), ids(ITEMS, (B, T, FAN), 0.55)
    douts = [torch.randn(*x.shape, D, generator=gen, device=dev)
             * (x != 0)[..., None] for x in (user, i_hist, cand, u_hist)]
    params = [tables.user_table, tables.item_table]
    def lookups():
        if hasattr(tables, 'lookup'):
            (eu, Ei), (ei, Eu) = tables.lookup([user, i_hist], [cand, u_hist])
            return [eu, Ei, ei, Eu]
        return [tables.user_emb(user), tables.user_emb(i_hist),
                tables.item_emb(cand), tables.item_emb(u_hist)]
    def step():
        return torch.autograd.grad(lookups(), params, grad_outputs=douts)
    want = [torch.zeros_like(p) for p in params]
    for p, w, xs in ((0, want[0], (user, i_hist)), (1, want[1], (cand, u_hist))):
        for x, g in zip(xs, douts[2 * p:2 * p + 2]):
            w.index_add_(0, x.reshape(-1).long(), g.reshape(-1, D))
    for g, w in zip(step(), want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * w.abs().max().item())
    if C == 1:   # one lookup's scatter-add alone, as both checkouts take it
        from score_tpu_torch.kernels.gather import scatter_add_rows
        for x, gx in ((u_hist, douts[3]), (cand, douts[2])):
            key = f'scatter-add ids {list(x.shape)}'
            rows = tables.item_table.shape[0]
            out[key + ' eager'] = cuda_ms(
                lambda: scatter_add_rows(x, gx, rows), iters=50)
            out[key + ' graph'] = graph_ms(
                lambda: scatter_add_rows(x, gx, rows))
    out[label + ' lookups eager'] = cuda_ms(lookups, iters=50)
    out[label + ' lookups+grad eager'] = cuda_ms(step, iters=50)
    out[label + ' lookups graph'] = graph_ms(lookups)
    try:   # autograd's backward inside a CUDA graph capture
        out[label + ' lookups+grad graph'] = graph_ms(step)
    except RuntimeError as err:
        print(f'{label}: no graph of the backward: {err}', file=sys.stderr)
    del tables, params, douts, want
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
    shapes.update(in_turns(a, b, TABLE_RUN, PAIRS))
    print(json.dumps({"card": card, "pairs": PAIRS, "shapes": shapes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
