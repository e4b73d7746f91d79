"""Per-dataset preprocessing entry points: CCMR / Taobao / Tmall.

The port's own copy of score_tpu/data/prep_datasets.py, since
score_tpu_torch imports nothing of the JAX package; it also needs no
pandas (the GPU host has none). tests/test_torch_nojax.py holds the two
equal: the same raw CSV gives the same dataset, and the CSV reader gives
what the reference's pandas reader gives.

  * CCMR (Douban-derived movie ratings): user_id,item_id,rating,timestamp.
    Slots: equal-width buckets over the log's time range.
  * Taobao UserBehavior (Nov 25 - Dec 3 2017 click log): slots ~ days.
  * Tmall IJCAI-15: slots ~ half-months.

Each `prep_*` reads the raw CSV if present, else synthesizes a
schema-identical log at the default path, then runs the shared
`build_dataset` pipeline.

CLI:  python -m score_tpu_torch.data.prep_datasets <ccmr|taobao|tmall>
          <out_dir> [raw_path] [key=value ...]
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from . import synth
from .prep_common import build_dataset
from .schema import Dataset, save_dataset

_DEFAULTS = {
    # dataset: (num_slots, user_fanout, item_fanout, min_user, min_item)
    "ccmr": dict(num_slots=12, user_fanout=10, item_fanout=10,
                 min_user=5, min_item=5),
    "taobao": dict(num_slots=9, user_fanout=10, item_fanout=10,
                   min_user=5, min_item=5),
    "tmall": dict(num_slots=12, user_fanout=10, item_fanout=10,
                  min_user=5, min_item=5),
}

_COMMA, _NEWLINE, _MINUS, _PLUS, _ZERO = (ord(c) for c in ",\n-+0")


def _parse_int_fields(buf: np.ndarray, start: np.ndarray,
                      end: np.ndarray) -> np.ndarray:
    """The integers written in buf[start[j]:end[j]] for every j, with an
    optional sign, one vectorized pass per digit position."""
    sign = buf[np.minimum(start, buf.size - 1)]
    neg = sign == _MINUS
    start = start + (neg | (sign == _PLUS))
    length = end - start
    if length.size and length.min() <= 0:
        raise ValueError("empty integer field in CSV")
    val = np.zeros(start.size, np.int64)
    for j in range(int(length.max(initial=0))):
        live = j < length
        digit = buf[np.where(live, start + j, 0)].astype(np.int64) - _ZERO
        if ((digit < 0) | (digit > 9))[live].any():
            raise ValueError("non-integer value in a CSV column read as int64")
        val = np.where(live, val * 10 + digit, val)
    return np.where(neg, -val, val)


def _parse_block(data: bytes, cols: list) -> list:
    """Columns `cols` (0-based positions) of the whole lines in `data`, each
    as int64. Blank lines are skipped; other columns are not parsed and may
    hold anything without a comma."""
    buf = np.frombuffer(data, np.uint8)
    seps = np.flatnonzero((buf == _COMMA) | (buf == _NEWLINE))
    if seps.size == 0:
        return [np.empty(0, np.int64) for _ in cols]
    is_nl = buf[seps] == _NEWLINE
    start = np.empty_like(seps)
    start[0] = 0
    start[1:] = seps[:-1] + 1
    row = np.cumsum(is_nl) - is_nl                 # the line of each field
    first = np.flatnonzero(np.concatenate(([True], is_nl[:-1])))
    col = np.arange(seps.size) - first[row]        # its column in the line
    width = np.diff(np.append(first, seps.size))   # fields per line
    keep = ~((width == 1) & (seps[first] == start[first]))   # blank lines
    rows = int(keep.sum())
    out = []
    for c in cols:
        sel = np.flatnonzero((col == c) & keep[row])
        if sel.size != rows:
            raise ValueError(f"CSV line with no column {c}")
        out.append(_parse_int_fields(buf, start[sel], seps[sel]))
    return out


def _read_csv_cols(path: str, usecols, dtype=np.int64,
                   chunk_bytes: int = 32 << 20) -> list[np.ndarray]:
    """Chunked columnar CSV reader in numpy alone (a per-row Python loop
    such as np.loadtxt would not survive Taobao-scale ~1e8-event logs). It
    reads blocks of `chunk_bytes`, cuts each at its last newline and parses
    only the `usecols` fields, so peak memory is the packed output and one
    block's index arrays. As the reference calls pandas.read_csv: the
    first line is a header, columns outside `usecols` may hold anything
    (Taobao's behavior_type is 'pv', 'buy', ...), and the columns come
    back in the order of `usecols`."""
    cols = [int(c) for c in usecols]
    parts: list[list[np.ndarray]] = [[] for _ in cols]
    with open(path, "rb") as f:
        f.readline()                                # the header
        tail = b""
        while True:
            block = f.read(chunk_bytes)
            data = tail + block
            if block:
                cut = data.rfind(b"\n") + 1
                data, tail = data[:cut], data[cut:]
            elif data and not data.endswith(b"\n"):
                data += b"\n"                       # no final newline
            if data:
                for part, arr in zip(parts, _parse_block(
                        data.replace(b"\r", b""), cols)):
                    part.append(arr)
            if not block:
                break
    return [np.concatenate(p).astype(dtype, copy=False) for p in parts]


def default_raw_path(dataset: str) -> str:
    """Where a raw log is looked for, and synthesized when missing: the
    reference's /tmp/score_tpu_raw/<dataset>.csv, under $TMPDIR if set."""
    return os.path.join(tempfile.gettempdir(), "score_tpu_raw",
                        f"{dataset}.csv")


def _load_or_synth(dataset: str, raw_path: str | None, usecols,
                   synth_kw) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    if raw_path is None or not os.path.exists(raw_path):
        raw_path = raw_path or default_raw_path(dataset)
        if not os.path.exists(raw_path):
            synth.write_raw(dataset, raw_path, **synth_kw)
    return tuple(_read_csv_cols(raw_path, usecols))


def prep_ccmr(out_dir: str, raw_path: str | None = None, seed: int = 0,
              synth_kw: dict | None = None, **overrides) -> Dataset:
    kw = dict(_DEFAULTS["ccmr"], **overrides)
    user, item, ts = _load_or_synth(
        "ccmr", raw_path, usecols=(0, 1, 3),
        synth_kw=dict(synth_kw or {}, num_slots=kw["num_slots"], seed=seed))
    ds = build_dataset(user, item, ts, dataset_name="ccmr", seed=seed, **kw)
    save_dataset(ds, out_dir)
    return ds


def prep_taobao(out_dir: str, raw_path: str | None = None, seed: int = 0,
                synth_kw: dict | None = None, **overrides) -> Dataset:
    kw = dict(_DEFAULTS["taobao"], **overrides)
    user, item, ts = _load_or_synth(
        "taobao", raw_path, usecols=(0, 1, 4),
        synth_kw=dict(synth_kw or {}, num_slots=kw["num_slots"], seed=seed))
    ds = build_dataset(user, item, ts, dataset_name="taobao", seed=seed, **kw)
    save_dataset(ds, out_dir)
    return ds


def prep_tmall(out_dir: str, raw_path: str | None = None, seed: int = 0,
               synth_kw: dict | None = None, **overrides) -> Dataset:
    kw = dict(_DEFAULTS["tmall"], **overrides)
    user, item, ts = _load_or_synth(
        "tmall", raw_path, usecols=(0, 1, 5),
        synth_kw=dict(synth_kw or {}, num_slots=kw["num_slots"], seed=seed))
    ds = build_dataset(user, item, ts, dataset_name="tmall", seed=seed, **kw)
    save_dataset(ds, out_dir)
    return ds


PREP = {"ccmr": prep_ccmr, "taobao": prep_taobao, "tmall": prep_tmall}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2 or argv[0] not in PREP:
        print(__doc__)
        raise SystemExit(2)
    dataset, out_dir = argv[0], argv[1]
    raw_path = None
    overrides = {}
    for a in argv[2:]:
        if "=" in a:
            k, v = a.split("=", 1)
            overrides[k] = int(v)
        else:
            raw_path = a
    ds = PREP[dataset](out_dir, raw_path=raw_path, **overrides)
    print(f"{dataset}: users={ds.num_users} items={ds.num_items} "
          f"slots={ds.graph.num_slots} train={len(ds.train)} "
          f"val={len(ds.val)} test={len(ds.test)} -> {out_dir}")


if __name__ == "__main__":
    main()
