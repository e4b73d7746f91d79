"""Tracing and timing: a profiler window, honest timing and a FLOP count.

Counterpart of score_tpu/profiling.py:
  * `maybe_profile(dir)`: a torch.profiler context (host ops, and the
    device's kernels on a CUDA device) that writes a Chrome trace into
    `dir` when it closes; no-op without a directory. `train()` takes its
    cfg.train.profile_dir window through it.
  * `timed(fn, *args)`: the median seconds of a call, by CUDA events on a
    CUDA device (the events wait for the device, so nothing needs to be
    read back) and by the wall clock on the CPU.
  * `cost_summary(fn, *args)`: the FLOPs of one call, from
    torch.utils.flop_counter.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import time
from typing import Mapping, Optional

import torch


def _activities(device):
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str], name: str = "trace",
                  device="cuda"):
    """Profile the body with torch.profiler and write its Chrome trace to
    `<profile_dir>/<name>.json` on exit (the CUDA kernels too when
    `device` is a CUDA device); yields the profiler, or None and does
    nothing when profile_dir is empty."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import profile
    prof = profile(activities=_activities(device))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.json"))


def _first_device(x) -> Optional[torch.device]:
    """The device of the first tensor in x (nested sequences, mappings and
    dataclasses searched in order), or None."""
    if isinstance(x, torch.Tensor):
        return x.device
    if isinstance(x, torch.nn.Module):
        return next((p.device for p in x.parameters()), None)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, Mapping):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            dev = _first_device(v)
            if dev is not None:
                return dev
    return None


def timed(fn, *args, reps: int = 3, device=None) -> float:
    """Median seconds a call of fn(*args) takes over `reps` calls after one
    untimed call (the warm-up: kernel builds, allocator). On a CUDA device
    (`device`, or that of the first tensor in args) each call is timed by
    CUDA events recorded around it on the current stream: the device's
    time from the call's first launch to its last kernel's end, host
    launch gaps included. On the CPU, by the wall clock."""
    dev = torch.device(device) if device is not None else _first_device(args)
    fn(*args)
    times = []
    if dev is not None and dev.type == "cuda":
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


def cost_summary(fn, *args) -> dict:
    """FLOPs of one call of fn(*args), counted by
    torch.utils.flop_counter.FlopCounterMode over the aten operations it
    dispatches (matrix products, convolutions, attention; elementwise
    operations and the port's own CUDA kernels, which are not aten
    operations, count 0). `bytes_accessed` is NaN: the reference reads it
    from XLA's cost analysis of the compiled program, and eager PyTorch
    has no such analysis. `raw` holds the counts by module and
    operation."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    raw = {mod: {str(op): n for op, n in ops.items()}
           for mod, ops in counter.get_flop_counts().items()}
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": float("nan"), "raw": raw}
