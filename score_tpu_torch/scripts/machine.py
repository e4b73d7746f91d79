"""The machine a record was taken on, for the JSON of the reference-scale
scripts: the card's name and power limit as nvidia-smi prints them, and
the host's CPU model, cores and memory. A record names both, since host
time sets most of the port's times and a card may be capped below its
maximum power."""

from __future__ import annotations

import os
import platform
import resource
import subprocess

import torch


def card(device) -> str:
    """`name, power.limit` of the card `device` runs on, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them, or
    'cpu'. A CUDA device with no card visible raises RuntimeError: no
    script carries on on the CPU under the card's name."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but no CUDA device is "
            f"visible; pass --device cpu to run on the CPU")
    index = dev.index if dev.index is not None else 0
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    lines = out.stdout.strip().splitlines()
    return lines[min(index, len(lines) - 1)].strip()


def host() -> dict:
    """{cpu: model name, cores: CPUs this process may run on, ram_gib:
    total memory}, from /proc on Linux (the model from lscpu where
    /proc/cpuinfo has none, else its vendor, family and model numbers)."""
    model, ram = platform.processor() or platform.machine(), None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    ram = round(int(line.split()[1]) / 2 ** 20, 1)
                    break
    except OSError:
        pass
    if model in ("", "unknown"):        # /proc/cpuinfo may not name it
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=10).stdout
        except (OSError, subprocess.SubprocessError):
            out = ""
        info = dict(line.split(":", 1) for line in out.splitlines()
                    if ":" in line)
        info = {k.strip(): v.strip() for k, v in info.items()}
        name = info.get("Model name", "unknown")
        if name in ("", "unknown") and "Vendor ID" in info:
            name = (f"{info['Vendor ID']} family {info.get('CPU family')} "
                    f"model {info.get('Model')}")
        model = name
    cores = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
             else os.cpu_count())
    return dict(cpu=model, cores=cores, ram_gib=ram)


def peak_rss_gib() -> float:
    """This process's peak resident memory so far, in GiB (Linux gives
    ru_maxrss in KiB)."""
    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
                 1)


def record(device) -> dict:
    """{device: card(device), host: host()}: the two keys every
    reference-scale record carries."""
    return dict(device=card(device), host=host())
