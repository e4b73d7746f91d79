"""The traced run's device trace: torch.profiler over a steady stretch,
reduced in memory to what the per-layer readers take.

`Trace` holds the stretch's kernels (name, start, duration; memcpy and
memset count as device work too), its wall time on the host clock, the
harness's spans (`Cell.span`), the units it covered (steps, calls or
blocks) and the compulsory work and model FLOPs the mix counted for them.
Nothing is written to disk.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

Span = Tuple[float, float]


@dataclasses.dataclass
class Trace:
    window_s: float                       # host wall time of the stretch
    kernels: List[Tuple[str, float, float]]   # (name, start_s, dur_s)
    units: int                            # steps, calls or blocks traced
    spans: Dict[str, List[Span]]          # harness spans (host clock)
    aligned: bool                         # spans and kernels share a clock
    work: Dict[str, float]                # bound seconds by kernel family
    flops: float                          # model FLOPs of the stretch
    own: Tuple[str, ...]                  # the program's kernel names

    def family_s(self, names: Tuple[str, ...]) -> float:
        """Device seconds of the kernels whose function is one of
        `names`."""
        return sum(d for k, _, d in self.kernels if base_name(k) in names)

    def kernel_list(self) -> List[Tuple[str, float, float]]:
        """The kernels alone (no memcpy or memset)."""
        return [e for e in self.kernels if not is_copy(e[0])]

    def roofline(self, family: str, names: Tuple[str, ...]):
        """Bound time over kernel time of a kernel family, in %, or None
        where the stretch ran none of its kernels."""
        spent = self.family_s(names)
        if spent <= 0 or self.work.get(family, 0.0) <= 0:
            return None
        return 100.0 * self.work[family] / spent

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of the
        kernel intervals."""
        if not self.kernels:
            return 0.0
        iv = np.array([(s, s + d) for _, s, d in self.kernels])
        iv = iv[np.argsort(iv[:, 0])]
        ends = np.maximum.accumulate(iv[:, 1])
        new = np.ones(len(iv), bool)
        new[1:] = iv[1:, 0] > ends[:-1]
        starts = iv[new, 0]
        last = np.append(np.nonzero(new)[0][1:] - 1, len(iv) - 1)
        return float(np.sum(ends[last] - starts))

    def is_own(self, name: str) -> bool:
        return base_name(name) in self.own

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals between device operations (start, end)."""
        if not self.kernels:
            return []
        iv = sorted((s, s + d) for _, s, d in self.kernels)
        out, end = [], iv[0][1]
        for s, e in iv[1:]:
            if s > end:
                out.append((end, s))
            end = max(end, e)
        return out

    def span_s(self, name: str) -> float:
        return sum(e - s for s, e in self.spans.get(name, ()))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the harness span the host was in (where the
        clocks align) and the device operation that ended it."""
        by = {}
        for k, _, d in self.kernels:
            name = short_name(k)
            by[name] = by.get(name, 0.0) + d
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        starts = sorted((s, k) for k, s, _ in self.kernels)
        first = [s for s, _ in starts]
        named = []
        for s, e in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]:
            where = "host"
            if self.aligned:
                mid = 0.5 * (s + e)
                where = next((k for k, v in self.spans.items()
                              for a, b in v if a <= mid <= b), "between spans")
            nxt = starts[min(np.searchsorted(first, e), len(starts) - 1)][1]
            named.append([f"{where}, before {short_name(nxt, 60)}", e - s])
        return dict(device_ops=[[k, v] for k, v in ops], idle_gaps=named)


def _plain(name: str) -> str:
    name = name.strip().replace("(anonymous namespace)::", "")
    return name[5:] if name.startswith("void ") else name


def base_name(name: str) -> str:
    """A kernel's function name, its named namespaces included (the
    program's kernels sit in an anonymous one, which is dropped):
    'void ns::f<T>(args)' -> 'ns::f'."""
    return re.split(r"[<(]", _plain(name), maxsplit=1)[0].strip()


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list, cut to `width` (a copy's
    name whole)."""
    if is_copy(name):
        return name[:width]
    return _plain(name).split("(", 1)[0][:width]


_GLOBAL = re.compile(r"__global__")
_CALL = re.compile(r"(\w+)\s*\(")


def own_kernel_names(package: Path) -> Tuple[str, ...]:
    """Names of the program's own kernels: each `__global__` function of
    its CUDA sources and each `@triton.jit` function of its Python."""
    names = set()
    for src in sorted(package.rglob("*.cu")) + sorted(package.rglob("*.cuh")):
        text = src.read_text(errors="replace")
        for g in _GLOBAL.finditer(text):
            pos = g.end()
            while True:
                call = _CALL.search(text, pos)
                if call is None:
                    break
                if call.group(1) != "__launch_bounds__":
                    names.add(call.group(1))
                    break
                depth, pos = 1, call.end()
                while depth and pos < len(text):
                    depth += {"(": 1, ")": -1}.get(text[pos], 0)
                    pos += 1
    for src in sorted(package.rglob("*.py")):
        text = src.read_text(errors="replace")
        names.update(re.findall(r"@triton\.jit[^\n]*\n\s*def (\w+)", text))
    return tuple(sorted(names))


def _device_events(prof) -> list:
    """(name, start_s, dur_s) of each device operation of a finished
    profile, from kineto's raw events."""
    return [(e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9)
            for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")]


def record(body: Callable[[], int], device, spans: Dict[str, List[Span]]
           ) -> tuple:
    """Run body() under torch.profiler (device activity only: recording
    every host op would slow the host, which sets much of these steps'
    time, twofold) after a synchronize, synchronize again, and return
    (wall seconds, device events, the units body returned, spans, whether
    the two share a clock). Times are seconds from the stretch's start on
    the host clock; `spans` holds (start, end) pairs of time.time_ns()
    that body recorded, which the device events share where kineto
    reports them on that clock (else only the spans' lengths mean
    anything). Off a CUDA device nothing is profiled."""
    cuda = torch.device(device).type == "cuda"
    with contextlib.ExitStack() as stack:
        if cuda:
            from torch.profiler import ProfilerActivity, profile
            prof = stack.enter_context(
                profile(activities=[ProfilerActivity.CUDA]))
        sync(device)
        t0 = time.perf_counter()
        t0_ns = time.time_ns()
        units = body()
        sync(device)
        wall = time.perf_counter() - t0
        t1_ns = time.time_ns()
    dev = _device_events(prof) if cuda else []
    lo, hi = t0_ns * 1e-9, t1_ns * 1e-9
    aligned = all(lo - 0.01 <= s and s + d <= hi + 0.01 for _, s, d in dev)
    first = lo if aligned else min((s for _, s, _ in dev), default=lo)
    dev = [(n, s - first, d) for n, s, d in dev]
    out = {k: [(a * 1e-9 - lo, b * 1e-9 - lo) for a, b in v]
           for k, v in spans.items()}
    return wall, dev, units, out, aligned


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
