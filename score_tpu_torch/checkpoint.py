"""Checkpoint / resume: the `latest` and `best` checkpoints of a run.

Counterpart of score_tpu/checkpoint.py. Each checkpoint holds what the
reference's orbax checkpoint holds:

    {params: the state_dict (f32, the tables in param_dtype),
     opt_state: {name, count, and the optimizer's state dicts}
                (adam and adamw: mu, nu; adagrad: sum_of_squares; sgd:
                none; one count shared by all leaves),
     step, it_epoch, it_pos, best_val}

Every tensor keeps its dtype: bf16 tables and their bf16 moments are
saved, restored and memory-mapped bit for bit. A file with no optimizer
name (`{count, mu, nu}`, as the port wrote
before it had other optimizers) restores as Adam.

Without a mesh it is written by `torch.save` to `<directory>/<name>.pt`.
It is not orbax: it imports none and cannot read a checkpoint the JAX
package wrote (convert weights with score_tpu_torch.params.from_flax
instead).

Under a (data, rows) mesh (`CheckpointManager(directory, mesh)`) each file
holds only its own rows, in one of two slot directories, `<name>.a` and
`<name>.b`:

    rows-<r>-of-<R>.pt  row block r of every table and of its optimizer
                        state, written by the rank of data block 0 and
                        row block r (ranks that share r hold the same
                        blocks);
    dense.pt            the dense parameters, their optimizer state, the
                        count, step, iterator state and best val, written
                        by rank 0.

A save writes into the slot the checkpoint does not use, and is committed
by `<name>.json` (the slot and the layout), which rank 0 replaces once
every rank's files are on disk: the main thread's `wait()` (and the next
save, which waits first) all-reduces the ranks' write errors, and only
then commits. A save that fails, or a crash before the commit, leaves the
previous checkpoint whole. No collective runs on the writer thread.
`restore` reads into any layout whose num_rows divides the tables' rows,
or whole without a mesh; each rank opens, memory-mapped, only the files
that hold its rows, so none materialises a table it does not serve.

A save snapshots the tensors to host memory and writes them in a
background thread, as orbax's async save does; `wait()` and the next save
first finish the one in flight. Each file is written under a temporary
name and moved into place with os.replace, so a crash mid-save leaves the
previous checkpoint whole.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from .sharding import state_spec

DENSE_FILE = "dense.pt"


def _to_host(tensors: Mapping[str, torch.Tensor]) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _rows_file(r: int, num_rows: int) -> str:
    return f"rows-{r}-of-{num_rows}.pt"


def _replace_atomically(path: str, write) -> None:
    """write(f) into a temporary file beside `path`, on disk, then moved
    into place; the temporary file is removed if anything fails."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointManager:
    """A directory holding named checkpoints (`latest`, `best`), whole or,
    under a `mesh` (`sharding.Mesh`), sharded by rows."""

    def __init__(self, directory: str, mesh=None):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._commit: Optional[Tuple[str, dict]] = None

    def path(self, name: str) -> str:
        """The file of an unsharded checkpoint."""
        return os.path.join(self.directory, f"{name}.pt")

    def _marker(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.json")

    def _read_marker(self, name: str) -> Optional[dict]:
        if not os.path.exists(self._marker(name)):
            return None
        with open(self._marker(name)) as f:
            return json.load(f)

    def save(self, name: str, state, it_state: Tuple[int, int],
             best_val: float, step: int, block: bool = False) -> None:
        """Snapshot `state` (a train.TrainState) to host memory now and
        write it in the background; block=True returns once it is on disk
        (and, under a mesh, committed). A save still in flight is
        finished first. Under a mesh every rank calls it, at the same
        points."""
        self.wait()
        meta = {"step": int(step), "it_epoch": int(it_state[0]),
                "it_pos": int(it_state[1]), "best_val": float(best_val)}
        opt = state.opt.state()
        os.makedirs(self.directory, exist_ok=True)
        if self.mesh is None:
            files = [(self.path(name), dict(
                params=_to_host(state.model.state_dict()),
                opt_state={k: (_to_host(v) if isinstance(v, Mapping) else v)
                           for k, v in opt.items()}, **meta))]
        else:
            files = self._shard_files(name, state, opt, meta)
        self._thread = threading.Thread(target=self._write, args=(files,),
                                        name=f"checkpoint-{name}")
        self._thread.start()
        if block:
            self.wait()

    def _shard_files(self, name: str, state, opt: dict, meta: dict
                     ) -> List[Tuple[str, dict]]:
        """This rank's files of a sharded save into the slot `name` does
        not use, and the commit that `wait()` makes of them."""
        mesh = self.mesh
        marker = self._read_marker(name)
        slot = "b" if marker is not None and marker["slot"] == "a" else "a"
        folder = os.path.join(self.directory, f"{name}.{slot}")
        os.makedirs(folder, exist_ok=True)
        params = state.model.state_dict()
        tables = {k for k, p in params.items() if state_spec(k, p)}
        keys = [k for k, v in opt.items() if isinstance(v, Mapping)]
        files = []
        if mesh.data_index == 0:
            files.append((os.path.join(
                folder, _rows_file(mesh.row_index, mesh.num_rows)), dict(
                    params=_to_host({k: params[k] for k in tables}),
                    opt_state={key: _to_host({k: opt[key][k]
                                              for k in tables})
                               for key in keys})))
        if mesh.rank == 0:
            dense_opt = {k: v for k, v in opt.items() if k not in keys}
            for key in keys:
                dense_opt[key] = _to_host({k: v for k, v in opt[key].items()
                                           if k not in tables})
            files.append((os.path.join(folder, DENSE_FILE), dict(
                params=_to_host({k: p for k, p in params.items()
                                 if k not in tables}),
                opt_state=dense_opt, **meta)))
        whole = {k: params[k].shape[0] * mesh.num_rows for k in tables}
        self._commit = (name, {"slot": slot, "num_rows": mesh.num_rows,
                               "step": meta["step"], "tables": whole})
        return files

    def _write(self, files: List[Tuple[str, dict]]) -> None:
        try:
            for path, payload in files:
                _replace_atomically(path,
                                    lambda f, p=payload: torch.save(p, f))
        except Exception as e:   # re-raised by wait() in the caller
            self._error = e

    def wait(self) -> None:
        """Block until the save in flight, if any, is on disk; raise what
        it raised. Under a mesh every rank calls it at the same points: it
        all-reduces the ranks' write errors and, if none failed, rank 0
        commits the save; a second all-reduce carries the commit's
        outcome, so every rank raises together or none does."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._commit is not None:
            name, marker = self._commit
            self._commit = None
            if not self._all_ok(self._error is None):    # every file written
                self._error = self._error or RuntimeError(
                    "another rank's checkpoint write failed")
            else:
                if self.mesh.rank == 0:
                    try:
                        _replace_atomically(
                            self._marker(name),
                            lambda f: f.write(json.dumps(marker).encode()))
                        self._drop_strays(name, marker)
                    except OSError as e:
                        self._error = e
                if not self._all_ok(self._error is None):   # the commit
                    self._error = self._error or RuntimeError(
                        "rank 0 could not commit the checkpoint")
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def _drop_strays(self, name: str, marker: dict) -> None:
        """Remove what the committed slot holds beyond its files: another
        layout's rows files, an earlier failed write's leftovers."""
        folder = os.path.join(self.directory, f"{name}.{marker['slot']}")
        keep = {os.path.basename(f) for f in self._slot_files(marker)}
        for f in os.listdir(folder):
            if f not in keep:
                os.remove(os.path.join(folder, f))

    @staticmethod
    def _slot_files(marker: dict) -> List[str]:
        R = int(marker["num_rows"])
        return [DENSE_FILE] + [_rows_file(r, R) for r in range(R)]

    def _all_ok(self, ok: bool) -> bool:
        """Whether every rank of the mesh's world reports ok."""
        flag = torch.tensor([0 if ok else 1], dtype=torch.int32,
                            device=self.mesh.device)
        dist.all_reduce(flag)
        return int(flag.item()) == 0

    def _sharded_is_newer(self, name: str) -> Optional[bool]:
        """Which format `name` has (True: sharded, False: one file; None:
        neither); where a directory holds both, the newer."""
        marker, whole = self._marker(name), self.path(name)
        if not os.path.exists(marker):
            return False if os.path.exists(whole) else None
        return (not os.path.exists(whole)
                or os.path.getmtime(marker) >= os.path.getmtime(whole))

    def restore(self, name: str, state) -> Optional[dict]:
        """The payload of checkpoint `name` on the device of `state` (a
        TrainState, or a device; under a mesh, the mesh's), or None if
        there is none. Under a mesh its tables and their optimizer state
        are this rank's row blocks, read from the files that hold them
        (a checkpoint of any layout, or an unsharded one); without a mesh
        they are whole."""
        self.wait()
        sharded = self._sharded_is_newer(name)
        if sharded is None:
            return None
        device = (self.mesh.device if self.mesh is not None
                  else getattr(state, "device", state))
        if not sharded:
            if self.mesh is None:
                return torch.load(self.path(name), map_location=device,
                                  weights_only=True)
            whole = torch.load(self.path(name), map_location="cpu",
                               mmap=True, weights_only=True)
            return self._place(whole, self._my_rows, device)
        return self._read_sharded(name, device)

    def _my_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's row block of a whole table (its copy)."""
        lo, hi = self._row_range(t.shape[0])
        return t[lo:hi].clone()

    def _row_range(self, whole_rows: int) -> Tuple[int, int]:
        if self.mesh is None:
            return 0, whole_rows
        R = self.mesh.num_rows
        if whole_rows % R:
            raise ValueError(f"a table of {whole_rows} rows does not split "
                             f"over {R} row blocks")
        per = whole_rows // R
        return self.mesh.row_index * per, (self.mesh.row_index + 1) * per

    @staticmethod
    def _place(payload: dict, table_fn, device) -> dict:
        """The payload with table_fn applied to every table and its
        optimizer state, and every tensor on `device`."""
        def put(d, specs):
            return {k: (table_fn(v) if state_spec(k, specs[k]) else v
                        ).to(device) for k, v in d.items()}
        params = payload["params"]
        out = dict(payload, params=put(params, params))
        out["opt_state"] = {k: (put(v, params) if isinstance(v, Mapping)
                                else v)
                            for k, v in payload["opt_state"].items()}
        return out

    def _read_sharded(self, name: str, device) -> dict:
        marker = self._read_marker(name)
        folder = os.path.join(self.directory, f"{name}.{marker['slot']}")
        R = int(marker["num_rows"])
        files: Dict[int, dict] = {}

        def rows(key: Optional[str], table: str) -> torch.Tensor:
            """This rank's rows of `table` (of its `key` state dict under
            opt_state, or of the weights with key None), from the files
            that hold them, opened memory-mapped."""
            per = marker["tables"][table] // R
            lo, hi = self._row_range(per * R)
            pieces = []
            for j in range(lo // per, -(-hi // per)):
                if j not in files:
                    files[j] = torch.load(
                        os.path.join(folder, _rows_file(j, R)),
                        map_location="cpu", mmap=True, weights_only=True)
                part = files[j]["params" if key is None else "opt_state"]
                part = part[table] if key is None else part[key][table]
                pieces.append(part[max(lo - j * per, 0):
                                   min(hi - j * per, per)])
            return torch.cat(pieces).to(device)

        out = torch.load(os.path.join(folder, DENSE_FILE),
                         map_location=device, weights_only=True)
        tables = marker["tables"]
        out["params"].update({k: rows(None, k) for k in tables})
        for key, state in out["opt_state"].items():
            if isinstance(state, Mapping):
                state.update({k: rows(key, k) for k in tables})
        return out

    def has(self, name: str) -> bool:
        return self._sharded_is_newer(name) is not None

    def files(self, name: str) -> List[str]:
        """The files checkpoint `name` consists of now (under a mesh: every
        rank's files of its committed slot)."""
        if not self._sharded_is_newer(name):
            return [self.path(name)] if self.has(name) else []
        marker = self._read_marker(name)
        folder = os.path.join(self.directory, f"{name}.{marker['slot']}")
        return [os.path.join(folder, f) for f in self._slot_files(marker)]


def apply_restore(state, restored: dict):
    """Load a restored payload into `state` in place: the model's weights,
    the optimizer's count and state (refused if the payload names another
    optimizer; a payload with no name is Adam's), and `state.step`, so
    stride-K table updates fall on the steps the reference's do. Under a
    mesh the payload's tables are this rank's blocks, as the state's
    are."""
    with torch.no_grad():
        state.model.load_state_dict(restored["params"])
    state.opt.load_state(**{"name": "adam", **restored["opt_state"]})
    state.step = int(restored["step"])
    return state
