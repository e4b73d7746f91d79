"""Checkpoint / resume: the `latest` and `best` checkpoints of a run.

Counterpart of score_tpu/checkpoint.py. Each checkpoint holds what the
reference's orbax checkpoint holds:

    {params: the f32 master state_dict,
     opt_state: {name, count, and the optimizer's state dicts}
                (adam and adamw: mu, nu; adagrad: sum_of_squares; sgd:
                none; one count shared by all leaves),
     step, it_epoch, it_pos, best_val}

A file with no optimizer name (`{count, mu, nu}`, as the port wrote
before it had other optimizers) restores as Adam.

written by `torch.save` to `<directory>/<name>.pt`. It is not orbax: it
imports none and cannot read a checkpoint the JAX package wrote (convert
weights with score_tpu_torch.params.from_flax instead).

A save snapshots the tensors to host memory and writes them in a
background thread, as orbax's async save does; `wait()` and the next save
first finish the one in flight. The file is written under a temporary
name and moved into place with os.replace, so a crash mid-save leaves the
previous checkpoint whole.
"""

from __future__ import annotations

import os
import threading
from typing import Mapping, Optional, Tuple

import torch


def _to_host(tensors: Mapping[str, torch.Tensor]) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


class CheckpointManager:
    """A directory holding named checkpoints (`latest`, `best`)."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def save(self, name: str, state, it_state: Tuple[int, int],
             best_val: float, step: int, block: bool = False) -> None:
        """Snapshot `state` (a train.TrainState) to host memory now and
        write it in the background; block=True returns once it is on
        disk. A save still in flight is finished first."""
        self.wait()
        opt = {k: (_to_host(v) if isinstance(v, Mapping) else v)
               for k, v in state.opt.state().items()}
        payload = {
            "params": _to_host(state.model.state_dict()),
            "opt_state": opt,
            "step": int(step),
            "it_epoch": int(it_state[0]),
            "it_pos": int(it_state[1]),
            "best_val": float(best_val),
        }
        os.makedirs(self.directory, exist_ok=True)
        self._thread = threading.Thread(
            target=self._write, args=(payload, self.path(name)),
            name=f"checkpoint-{name}")
        self._thread.start()
        if block:
            self.wait()

    def _write(self, payload: dict, path: str) -> None:
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except Exception as e:   # re-raised by wait() in the caller
            self._error = e
            if os.path.exists(tmp):
                os.remove(tmp)

    def wait(self) -> None:
        """Block until the save in flight, if any, is on disk; raise what
        it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def restore(self, name: str, state) -> Optional[dict]:
        """The payload of checkpoint `name` with its tensors on the device
        of `state` (a TrainState, or a device), or None if there is none."""
        self.wait()
        path = self.path(name)
        if not os.path.exists(path):
            return None
        device = getattr(state, "device", state)
        return torch.load(path, map_location=device, weights_only=True)

    def has(self, name: str) -> bool:
        return os.path.exists(self.path(name))


def apply_restore(state, restored: dict):
    """Load a restored payload into `state` in place: the model's weights,
    the optimizer's count and state (refused if the payload names another
    optimizer; a payload with no name is Adam's), and `state.step`, so
    stride-K table updates fall on the steps the reference's do."""
    with torch.no_grad():
        state.model.load_state_dict(restored["params"])
    state.opt.load_state(**{"name": "adam", **restored["opt_state"]})
    state.step = int(restored["step"])
    return state
