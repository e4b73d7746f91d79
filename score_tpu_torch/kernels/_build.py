"""Build the CUDA sources under score_tpu_torch/csrc and load them.

Each `csrc/<name>.cu` has a plain C interface. At first use it is compiled
by `nvcc` for Hopper (`sm_90a`) into a shared library under
`score_tpu_torch/_build/` and loaded with ctypes. The library's file name
carries a hash of its source and of the shared `csrc/*.cuh` headers, so an
edited source is rebuilt and a stale library is never loaded. A missing
`nvcc` or a failed build raises.

Every C entry point takes the stream last and returns `cudaGetLastError()`
after its launch; `launch` calls one on a device's current stream and
raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# (name, entry) -> the C function, its restype and argtypes set once
_fns: Dict[Tuple[str, str], Callable] = {}
# name -> (seconds spent in nvcc, nvcc's output) of builds in this process
build_log: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA "
            "kernels of score_tpu_torch need the CUDA toolkit")
    return path


def _build(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    # the shared headers count as part of every source
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)   # atomic: no process loads half a library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_log[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return lib


def load(name: str, entry: str, argtypes: Sequence,
         restype=ctypes.c_int) -> Callable:
    """C entry point `entry` of `csrc/<name>.cu`, built at first use; it
    returns `restype`, for a launching entry a CUDA error code (`check`
    raises on one). Later calls return the same function object and set
    nothing on it."""
    fn = _fns.get((name, entry))
    if fn is not None:
        return fn
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            err = getattr(lib, f"{name}_error_string")
            err.restype = ctypes.c_char_p
            err.argtypes = [ctypes.c_int]
            _libs[name] = lib
        fn = getattr(lib, entry)
        fn.restype = restype
        fn.argtypes = list(argtypes)
        _fns[(name, entry)] = fn
        return fn


def build_all() -> None:
    """Build every source under csrc/, one nvcc per source, all at once (a
    cached library is not rebuilt)."""
    names = sorted(src.stem for src in CSRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(names) or 1) as pool:
        for fut in [pool.submit(_build, name) for name in names]:
            fut.result()


def check(name: str, err: int) -> None:
    """Raise if a C entry point of `name` returned a CUDA error code."""
    if err != 0:
        msg = getattr(_libs[name], f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def launch(name: str, fn: Callable, index: int, *args) -> None:
    """Call `fn`, a C entry point of `csrc/<name>.cu` from `load`, with
    `args` and the raw current stream of CUDA device `index`, and raise on
    its error code. The device guard is entered only when `index` is not
    the current device, and the error string is looked up only on an
    error: a launch costs the host little more than the ctypes call."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch._C._cuda_getDevice():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err:
        check(name, err)
