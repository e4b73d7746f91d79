"""Reference-scale preprocessing benchmark.

Taobao UserBehavior is ~1e8 events; the prep pipeline must survive that
scale. This times the two halves separately:

  1. `build_dataset` on N in-memory events (k-core filter -> remap ->
     dedup -> native O(E) adjacency build x2 -> split -> vectorized eval
     negatives). Events are zipf-like in items (duplicate-heavy, like a
     real click log) and uniform in users at Taobao-like cardinalities.
  2. The chunked CSV reader (`_read_csv_cols`) on an M-row file it first
     writes (`write_csv`, numpy alone), reported as rows/s.

The port's counterpart of the JAX package's scripts/prep_bench.py: the
same knobs, events and JSON keys, plus `device` and `host` (the machine,
`machine.record`) and the process's `peak_rss_gib`. The prep runs on the
host whatever `--device` says; the device only names the card the record
stands beside.

Usage: python -m score_tpu_torch.scripts.prep_bench [events=100000000]
           [csv_rows=20000000] [users=1000000] [items=4000000] [slots=9]
           [native=1] [out=$TMPDIR/prep_bench.json] [--device D]

At the defaults it holds 71 GiB of host memory at its peak (the 1.06e9
eval-negative draws and their membership checks) and takes ~9 min on an
8-core host, 75 s of it writing the CSV.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np

from ..data.prep_common import build_dataset
from ..data.prep_datasets import _read_csv_cols
from . import machine
from .ladder import knob_values, split_argv

CSV_HEADER = "user_id,item_id,category_id,behavior_type,timestamp"


def synth_uniform_zipf(n, num_users, num_items, num_slots, seed=0):
    """Schema-valid events at scale, vectorized: uniform users, zipf-ish
    items (alias-free: inverse-CDF on a power-law rank weight), uniform ts.
    No learnable signal needed: this benchmarks prep, not models."""
    rng = np.random.default_rng(seed)
    user = rng.integers(0, num_users, size=n, dtype=np.int64)
    # item rank r with P(r) ~ (r+1)^-0.9: inverse CDF via cumsum lookup.
    w = (np.arange(1, num_items + 1, dtype=np.float64)) ** -0.9
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    item = np.searchsorted(cdf, rng.random(n)).astype(np.int64)
    ts = rng.integers(0, num_slots * 86400, size=n, dtype=np.int64)
    return user, item, ts


def write_csv(path: str, cols) -> None:
    """Int columns `cols` under the line CSV_HEADER as a CSV, in numpy
    alone (the card's host has no pandas): the bytes pandas'
    `DataFrame.to_csv(index=False)` writes for int64 columns."""
    np.savetxt(path, np.column_stack(cols), fmt="%d", delimiter=",",
               header=CSV_HEADER, comments="")


def main(argv=None, device: str = "cuda") -> dict:
    _, kv, device = split_argv(argv, device)
    kw = knob_values(kv, dict(events=100_000_000, csv_rows=20_000_000,
                        users=1_000_000, items=4_000_000, slots=9, native=1,
                        out=os.path.join(tempfile.gettempdir(),
                                         "prep_bench.json")))
    res = {"events": kw["events"], "csv_rows": kw["csv_rows"],
           "users": kw["users"], "items": kw["items"],
           **machine.record(device)}

    t0 = time.time()
    user, item, ts = synth_uniform_zipf(
        kw["events"], kw["users"], kw["items"], kw["slots"])
    res["synth_s"] = round(time.time() - t0, 1)
    print(f"synth {kw['events']:,} events: {res['synth_s']}s", flush=True)

    t0 = time.time()
    ds = build_dataset(user, item, ts, num_slots=kw["slots"],
                       user_fanout=10, item_fanout=10, num_eval_neg=100,
                       min_user=5, min_item=5, use_native=bool(kw["native"]))
    res["native"] = bool(kw["native"])
    build_s = time.time() - t0
    res["build_dataset_s"] = round(build_s, 1)
    res["phase_s"] = ds.meta.get("prep_phase_s", {})
    res["events_kept"] = ds.meta["num_events_kept"]
    res["num_users"] = ds.graph.num_users
    res["num_items"] = ds.graph.num_items
    res["val_targets"] = len(ds.val)
    res["events_per_s"] = round(kw["events"] / build_s)
    print(f"build_dataset: {res['build_dataset_s']}s "
          f"({res['events_per_s']:,} ev/s; kept {res['events_kept']:,}; "
          f"{res['num_users']:,} users, {res['num_items']:,} items, "
          f"{res['val_targets']:,} val targets w/ 100 negs)", flush=True)
    del ds

    # CSV read rate on a csv_rows-row taobao-schema file.
    m = kw["csv_rows"]
    fd, path = tempfile.mkstemp(prefix="prep_bench_", suffix=".csv")
    os.close(fd)
    try:
        t0 = time.time()
        write_csv(path, [user[:m], item[:m], item[:m] % 97,
                         np.zeros(min(m, user.size), np.int64), ts[:m]])
        res["csv_write_s"] = round(time.time() - t0, 1)
        t0 = time.time()
        cols = _read_csv_cols(path, usecols=(0, 1, 4))
        read_s = time.time() - t0
        res["csv_read_s"] = round(read_s, 1)
    finally:
        os.remove(path)
    res["csv_rows_per_s"] = round(m / read_s)
    res["csv_read_1e8_extrapolated_s"] = round(1e8 / res["csv_rows_per_s"],
                                               1)
    if cols[0].size != m:
        raise RuntimeError(f"read back {cols[0].size} CSV rows of {m}")
    print(f"csv: write {res['csv_write_s']}s, read {res['csv_read_s']}s "
          f"({res['csv_rows_per_s']:,} rows/s -> "
          f"{res['csv_read_1e8_extrapolated_s']}s per 1e8)", flush=True)

    res["peak_rss_gib"] = machine.peak_rss_gib()
    with open(kw["out"], "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
