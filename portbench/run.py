"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json at the root of the
checkout: a configuration (`portbench/configs/<config>.json`) under a
traffic mix (`portbench/traffic/<traffic>.json`, whose `kind` names its
code in `portbench/harness/kinds/`). With --trace 0 the run measures
the cell's end-to-end metrics over --seconds; with --trace 1 it profiles
the mix's traced stretch and reports the cell's per-layer metrics, each
read by `portbench/metrics/<name>.py` (or, for `<base>.<suffix>`, by
`<base>.py`). Every run then frees the program's state and holds what the
timed path produced against the plain reference (`portbench/reference/`):
`correct` is true when each number compared is within its limit
(`portbench/limits/<cell>.json`).

The last line of standard output is one JSON object; `setup_builds` in it
names the kernels this run built with nvcc (a checkout's first run; its
`setup_s` holds those builds), and the numbers compared, with their
limits, come last, under `checks`, as they do on standard error. Without
a CUDA card, or with fewer cards than the cell asks for, the run prints no
result and exits 1; so it does if the process has loaded JAX, flax,
optax, orbax or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "score_tpu")


def _cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so the
    first run of a cell builds and every later one finds what it built."""
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


_cache_env()
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.harness import trace  # noqa: E402
from portbench.reference.model import set_precision  # noqa: E402


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(BENCH_DIR / kind / f"{name}.json") as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that are JAX's or the JAX
    package's, compared whole (score_tpu_torch is not score_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def reader(metric: str):
    """The reader of per-layer metric `metric`: portbench/metrics/
    <metric>.py, else <base>.py for a name <base>.<suffix>."""
    for stem in (metric, metric.split(".")[0]):
        path = BENCH_DIR / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"portbench.metrics.{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for per-layer metric {metric!r} "
                            f"under {BENCH_DIR / 'metrics'}")


def nvcc_builds() -> dict:
    """The port's kernel libraries this process built with nvcc, by name,
    in seconds: the first run in a checkout builds them and counts them
    in its set-up; a later run finds them built and reports none."""
    mod = sys.modules.get("score_tpu_torch.kernels._build")
    return {} if mod is None else {k: round(v[0], 3)
                                   for k, v in mod.build_log.items()}


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    state: dict = dataclasses.field(default_factory=dict)
    data: object = None
    spans: Optional[dict] = None        # set while a stretch is traced

    @contextlib.contextmanager
    def span(self, name: str):
        """A harness span around a call into a layer, kept (host clock,
        time.time_ns) while a stretch is traced."""
        if self.spans is None:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append((t0, time.time_ns()))

    def data_ready(self) -> None:
        """The benchmark's own inputs are made: the device's peak memory
        counts from here (the generator's sorts are not the program's)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.log(f"data ready: {self.data.num_users} users, "
                 f"{self.data.num_items} items")

    def log(self, what: str) -> None:
        """A progress line on standard error, with the seconds since the
        process started."""
        print(f"portbench: {time.perf_counter() - _T_START:.1f} s {what}",
              file=sys.stderr, flush=True)


def kind_module(traffic: dict):
    return importlib.import_module(
        f"portbench.harness.kinds.{traffic['kind']}")


def cell_of(workload: str, bench: Optional[dict] = None) -> tuple:
    """(the cell's entry, its configuration, its traffic mix)."""
    bench = bench or manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    return w, load_json("configs", w["config"]), load_json("traffic",
                                                          w["traffic"])


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", bench: Optional[dict] = None,
             config: Optional[dict] = None, traffic: Optional[dict] = None,
             limits: Optional[dict] = None) -> dict:
    """One run of cell `workload`: its result line as a dict. `config`,
    `traffic` and `limits` replace the cell's files (the CPU tests run the
    cell at a small size so)."""
    bench = bench or manifest()
    entry, cfg, tr = cell_of(workload, bench)
    cfg, tr = config or cfg, traffic or tr
    limits = limits or load_json("limits", workload)
    dev = torch.device(device)
    cell = Cell(workload, cfg, tr, int(seed), dev)
    kind = kind_module(tr)
    kind.setup(cell)
    trace.sync(dev)
    setup_s = time.perf_counter() - _T_START
    builds = nvcc_builds()
    cell.log(f"set up; nvcc builds of this run (s): {builds or 'none'}")
    result_dev = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                      kind=(torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                      count=1)
    out: dict = {}
    if traced:
        metrics, busy, window, brk = per_layer(cell, kind, bench, entry)
        result_dev.update(busy_s=busy, window_s=window)
        out["breakdown"] = brk
    else:
        e2e = kind.window(cell, seconds)
        trace.sync(dev)
        e2e["setup_s"] = setup_s
        metrics = {}
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        for name, value in e2e.items():
            metrics[name] = dict(value=float(value), unit=units[name])
    result_dev["memory_peak_bytes"] = (
        int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
        else 0)
    cell.log("window closed")
    kind.release(cell)
    set_precision()
    checks = kind.check(cell)
    cell.log("checked")
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"the run loaded {bad}: the benchmark measures "
                           f"the port alone")
    compared = {k: dict(value=float(v), limit=float(limits[k]["limit"]))
                for k, v in checks.items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    attempted = int(cell.state.get("attempted", 0))
    out = dict(correct=correct, attempted=attempted,
               failed=0 if correct else attempted, metrics=metrics,
               device=result_dev, **out)
    out["setup_builds"] = builds
    out["checks"] = compared
    return out


def per_layer(cell, kind, bench: dict, entry: dict) -> tuple:
    """The traced stretch: (per-layer metrics, busy_s, window_s,
    breakdown)."""
    cell.spans = {}
    wall, dev_ev, units, spans, aligned = trace.record(
        lambda: kind.traced(cell), cell.device, cell.spans)
    cell.spans = None
    work, flops = kind.trace_work(cell)
    tr = trace.Trace(
        window_s=wall, units=units, spans=spans, aligned=aligned, work=work,
        flops=flops, kernels=dev_ev,
        own=trace.own_kernel_names(ROOT / "score_tpu_torch"))
    metrics = {}
    for m in bench["per_layer"]:
        if "workloads" in m and entry["name"] not in m["workloads"]:
            continue
        if "workloads" not in m and not _reports(bench, entry, m["moves"]):
            continue
        value = reader(m["name"])(tr)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    return metrics, tr.busy_s(), wall, tr.breakdown()


def _reports(bench: dict, entry: dict, metric: str) -> bool:
    for m in bench["end_to_end"]:
        if m["name"] == metric:
            return "workloads" not in m or entry["name"] in m["workloads"]
    return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    entry, _, _ = cell_of(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA "
              f"card(s); this machine shows "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
