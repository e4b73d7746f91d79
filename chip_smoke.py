#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (score_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and `nvcc`; imports no JAX and nothing of the JAX
package. It exits non-zero, and prints no result line, if anything below
fails or no CUDA device is present.

1. Device: the card's name and power limit, the CUDA versions, and the
   build of every kernel under score_tpu_torch/csrc (one nvcc per source,
   all at once, sm_90a), with ptxas's register and spill counts, and a
   line for each instance of the per-pair forward (csrc/coattn_pair.cu's
   instances of the kernel in csrc/coattn_cand.cuh) and of the shared
   co-attention backward.
2. Forward kernels against their plain PyTorch versions on the card, at
   the shapes serving (`score`'s 1 x 256 bucket, `score_batch`'s chunk),
   eval and training give them: the gather, the candidates-form
   co-attention (sum pool) and the per-pair co-attention
   ([coattn_pair], max and mean pools; at the serving and training
   shapes also the sum pool, held against the candidates kernel on the
   same inputs). The gather must be exact; the co-attention agrees to
   1e-4 in f32 and 2e-2 in bf16 (f32 inside, other summation order, one
   bf16 rounding of the output).
2b. Backward kernels against their plain versions. The scatter-add
   ([scatter]) at uniform ids one lookup at a time, then grouped as a
   step groups a table's lookups into one call, on the real ids of one
   training batch of the bench dataset (configs3 with in-batch and with
   uniform negatives, configs0's shared table), beside `index_add` of
   the same segments and the separate scatters and their sum; and the
   grouped backward of a table's lookups must run a memset and the
   scatter kernel and no other kernel. It is exact on integer-valued
   sources and within 1e-5 relative of `index_add_` on random ones (f32
   atomics add in no fixed order); the
   co-attention backwards' ([coattn_bwd] sum; [coattn_pair_bwd] sum and
   mean) five gradients agree to 1e-4 in f32 and 2e-2 in bf16, relative
   to each gradient's largest value.
   For every kernel: CUDA-event times of kernel, plain version and, where
   one PyTorch call computes the same function, that call; and the bound,
   the least time the card could take for the work (bytes over 3.35 TB/s
   or operations at their peak rates, whichever is larger: f32 on the
   CUDA cores at 67 TFLOP/s; the max pool's EuW and relation matrix on the
   tensor cores, two bf16 passes at 989 TFLOP/s or three TF32 passes at
   495, as the kernels split their operands). The gather is
   timed eagerly (what a step pays; below ~0.03 ms the host's time) and
   by CUDA graph (the kernel alone), `index_select` beside it both ways.
2c. [coattn_wide]: the wide co-attention kernels (csrc/coattn_wide.cu,
   past d, n, m = 32) through the public wrappers, forward for each pool
   and backward for sum and mean, against their plain versions at
   configs3's d=64 training, eval and serving shapes, d=128 at training
   and d=32 with n = m = 40 rows; two runs of the backward bit-equal; the
   tuned kernels must not launch.
3. Serving, for each co-attention pool (sum, max, mean): ScoringService on
   the configs3 model at the benchmark's width (bench.py: d=32, hidden 64,
   MLP 128/64, T=9, n=m=10, bf16 compute) over a synthetic 50k-user /
   100k-item / 2M-event dataset, with random weights from a seed. score,
   score_batch and a full-catalogue topk run through the forward kernels
   (launch counters checked: the candidates kernel for sum, the per-pair
   kernel for max and mean, never the other), and a 4 x 256 request
   matches the same service on the CPU, in f32 and in bf16. p50 latency,
   score_batch throughput and topk time.
4. Training: the configs3 train step as bench.py configures it (batch
   4096, bf16 over f32 master weights, one importance-weighted in-batch
   negative, tables every 2nd step at 2x lr, Adam 1e-3, L2 1e-5) on the
   same dataset from flax-faithful init (seed 0). 3 warm-up steps (tables
   must change on steps 0 and 2 only), then timed steps through
   train_loop with the kernels' launches counted (the scatter-add once a
   table on each table-update step, one call for all of a table's
   lookups): 50 steps with the sum
   pool (gather, scatter-add, candidates forward and backward) and with
   the mean pool (gather, scatter-add, per-pair forward and backward), in
   which the loss must fall, each with a torch.profiler window of device
   time by op; 10 steps with the max pool (per-pair forward; the backward
   is the recompute VJP), whose loss must stay finite. Then, per pool, 3
   steps of a small f32 model (configs3's default widths, batch 256) on
   the card and on the CPU from the same weights, batches and shifts must
   agree.
4b. [d64]: configs3 at d=64 (hidden 64, MLP 128/64, bf16, B=4096,
   in-batch IW, as scripts/perf_sweep.py trains b4096_bf16_iw_d64) with
   each pool, then at d=128 with the sum pool, through the wide kernels
   (launch counters: the wide ones above 0, the tuned co-attention ones
   at 0): serving (score, score_batch, topk; 4 x 256 against the CPU in
   f32 and bf16; score's p50), 20 training steps (max: 10) in which the
   loss must fall (the d=64 sum pool profiled), and 3 steps at batch 256
   in f32 on the card and on the CPU.
5. Eval: the streaming `evaluate` of the max-pool model at the bench
   width, bf16, batch 256, over 8192 validation targets x (1 + 100)
   candidates: targets/s and the metrics; and in f32 on 512 targets, the
   card's metrics against the CPU's (ranking metrics 1e-4, AUC 1e-3, as
   tests/test_torch_eval.py holds the port to the JAX package).
6. The training driver, checkpoints and serving from them, sum pool: the
   bench dataset saved to a temporary directory; the CLI (`python -m
   score_tpu_torch.train configs3 <dir> ...` at the bench width, one epoch,
   val every 100 steps on 8192 targets, checkpoints on) in a subprocess,
   which must exit 0 and print its test line; then `train()` in this
   process for two epochs on the same checkpoints, which must resume at
   the end of the first (launches counted), and write finite val rows; a
   checkpoint's save and restore times and size;
   `ScoringService.from_checkpoint` of `best` scoring 4 x 256 bit-equal to
   a service built from the weights `train()` returned; and `topk_batch`
   for 16 users giving the score multisets of 16 `topk` calls. Steps/s,
   time per val, time per user, and the val and test AUC.
7. The preset ladder: configs0, configs1, configs2 and configs3 (sum
   pool), each with its preset's model flags and its own uniform
   negatives (collisions resampled, [positive | negative] scored in the
   candidates form), at the bench width and training knobs. Per rung: 3
   warm-up steps (tables change on steps 0 and 2 only); 50 steps through
   train_loop with the launches counted (every rung the gather and the
   scatter-add, configs3 also the candidates forward and backward, no
   rung the per-pair kernels), in which the loss must fall; the step's
   time, a val on 8192 targets (its AUC printed) and a profile of 4 more
   steps (kernels and device time a step); a 4 x 256 request on
   the card against the CPU in f32 and bf16 at phase 3's tolerances; 3
   steps of the preset's own widths in f32 on the card and on the CPU
   from the same weights, batches and raw negatives. Then the CLI
   (`python -m score_tpu_torch.train configs0 <dir>`, the bench width and
   batch, one epoch, no `train_neg_mode` override) on phase 6's saved
   dataset, in a subprocess, which must exit 0 and print its test line.
   Phase 2 also holds the gather and scatter-add to their plain versions
   at the launch shapes uniform negatives give: configs3's user table
   over [positive | negative] ([4096,2,9,10]) and the item histories of
   both candidates ([4096,2]), and configs0's shared table.

The line before the last lists each kernel with its launches in the
training run of its path (the sum-pool run for the gather, scatter-add and
candidates kernels, the mean-pool run for the per-pair kernels), its
largest error against the plain version, and its, the plain version's and
the library call's time beside its bound (the candidates forward also
gives its time and bound at the training shape, B=4096 C=2, where its
launches are counted, and the per-pair forward its mean pool's there, by
CUDA graph; the wide kernels their d=64 training shape's, sum pool, with
the launches of the [d64] sum-pool run); the last line is
{"ok": true, "device": {...}}. Every timing line carries the card's name
and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
T, FAN, D = 9, 10, 32                 # bench.py's slots, fan-out, width
USERS, ITEMS, EVENTS = 50_000, 100_000, 2_000_000
ROWS, WIDE = 16, 4096                 # score_batch: 16 users x 4096 items
BATCH = 4096                          # bench.py's training batch
# configs0's shared table on that dataset: round_up(1 + 90,553 + 50,000)
SHARED_ROWS = 140608
WARMUP_STEPS, TIMED_STEPS, MAX_POOL_STEPS = 3, 50, 10
EVAL_TARGETS, EVAL_CPU_TARGETS, EVAL_BATCH = 8192, 512, 256
F32_TOL = 1e-4
BF16_TOL = 2e-2
CPU_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
           "bfloat16": dict(rtol=2e-2, atol=2e-3)}
TRAIN_CPU_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)     # f32 losses, card against CPU
EVAL_TOL, EVAL_AUC_TOL = 1e-4, 1e-3
# the card's published peaks (H100 SXM): HBM bytes/s, f32 outside the
# tensor cores (the kernels here do f32 FMAs on the CUDA cores), and the
# dense tensor-core rates of bf16 and TF32 products
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_MMA_FLOPS_PER_S = 989e12
TF32_MMA_FLOPS_PER_S = 495e12


def log(*args) -> None:
    print(*args, flush=True)


_START = time.perf_counter()


def mark(phase: str) -> None:
    """Log the script's seconds so far, at the end of `phase`."""
    log(f"[time] {phase} done at {time.perf_counter() - _START:.1f} s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50, replays: int = 5) -> float:
    """Mean device time of fn() over `iters` calls captured in one CUDA
    graph and replayed `replays` times: the host's launch work left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def bound(nbytes: float, flops: float, mma_ms: float = 0.0) -> dict:
    """The least time the card could take: compulsory bytes at the HBM
    rate or operations at their peak rates (f32 operations on the CUDA
    cores, and `mma_ms` of products on the tensor cores), whichever is
    longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3 + mma_ms
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --- phase 1 ---------------------------------------------------------------

_BWD_INSTANCE = re.compile(
    r"coattn_bwd_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])ELi(\d+)E")
_FWD_INSTANCE = re.compile(
    r"cand_fwd_kernelI(f|13__nv_bfloat16)Lb([01])ELb([01])ELi(\d)ELi(\d+)E")


_WIDE_FWD_INSTANCE = re.compile(
    r"wide_fwd_kernelI(f|13__nv_bfloat16)Lb([01])ELi(\d)ELi(\d)ELb([01])E")


def _wide_fwd_name(inst) -> str:
    dtype = "f32" if inst.group(1) == "f" else "bf16"
    pool = "max" if inst.group(2) == "1" else "sum/mean"
    path = "16-byte" if inst.group(5) == "1" else "scalar"
    return (f"wide_fwd_kernel<{dtype}, {pool}, d <= {32 * int(inst.group(3))}"
            f", n <= {16 * int(inst.group(4))}, {path}>")


def _bwd_name(inst) -> str:
    dtype = "f32" if inst.group(1) == "f" else "bf16"
    pool = "mean" if inst.group(3) == "1" else "sum"
    width = "any d" if inst.group(4) == "0" else f"d={inst.group(4)}"
    return f"coattn_bwd_kernel<{dtype}, MAXK={inst.group(2)}, {pool}, {width}>"


def _fwd_name(inst) -> str:
    dtype = "f32" if inst.group(1) == "f" else "bf16"
    path = "16-byte" if inst.group(2) == "1" else "scalar"
    pool = ("sum", "mean", "max")[int(inst.group(4))]
    if pool == "max":
        what = f"n, m <= {inst.group(5)}"
    else:
        what = "EuW staged" if inst.group(3) == "1" else "v per unit"
    return f"cand_fwd_kernel<{dtype}, {path}, {pool}, {what}>"


def kernel_usage(ptxas_log: str, pattern, describe) -> list:
    """Registers and spill bytes of each kernel instance in an `nvcc -Xptxas
    -v` log whose mangled name matches `pattern` (the shared co-attention
    backward's or forward's), as (describe(match), registers, spill stores,
    spill loads)."""
    usage, name, spills = [], None, (None, None)
    for line in ptxas_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w.$]+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        inst = pattern.search(name or "")
        if m and inst:
            usage.append((describe(inst), int(m.group(1)), *spills))
            name, spills = None, (None, None)
    return usage


def phase_device(card: str) -> None:
    from score_tpu_torch.kernels import _build
    log(f"[device] nvidia-smi: {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"[device] nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[device] kernels built in {time.perf_counter() - t0:.2f} s")
    for name, (secs, out) in sorted(_build.build_log.items()):
        log(f"[device] nvcc {name}: {secs:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[device]   {line.strip()}")
    for name, pattern, describe in (
            ("coattn_pair", _FWD_INSTANCE, _fwd_name),
            ("coattn_wide", _WIDE_FWD_INSTANCE, _wide_fwd_name),
            ("coattn_cand_bwd", _BWD_INSTANCE, _bwd_name),
            ("coattn_pair_bwd", _BWD_INSTANCE, _bwd_name)):
        if name not in _build.build_log:
            log(f"[device] {name}: built before this run, no ptxas log")
            continue
        usage = kernel_usage(_build.build_log[name][1], pattern, describe)
        if not usage:
            raise AssertionError(f"no kernel instance in {name}'s ptxas log")
        for inst, regs, stores, loads in usage:
            log(f"[device] {name}: {inst}: {regs} registers, spill stores "
                f"{stores} B, spill loads {loads} B")


# --- phase 2: forward kernels ----------------------------------------------

def gather_cases(gen, dev) -> list:
    """(label, table, ids shape) of the gather at the shapes serving,
    training and uniform negatives give it, and at a few other sizes."""
    return [
        ("bf16 [100032,32] ids [16,4096,9,10]",
         torch.randn(100032, D, generator=gen, device=dev).bfloat16(),
         (16, 4096, T, FAN)),
        ("f32 [90560,32] ids [4096,9,10] (training)",
         torch.randn(90560, D, generator=gen, device=dev), (BATCH, T, FAN)),
        # uniform negatives: configs3's user table and item histories over
        # [positive | negative], and configs0's shared table
        ("f32 [50048,32] ids [4096,2,9,10] (configs3 uniform, user table)",
         torch.randn(50048, D, generator=gen, device=dev),
         (BATCH, 2, T, FAN)),
        ("int32 [90560,90] ids [4096,2] (configs3 uniform, item histories)",
         torch.randint(0, 1 << 30, (90560, T * FAN), generator=gen,
                       device=dev, dtype=torch.int32), (BATCH, 2)),
        ("f32 [140608,32] ids [4096,9,10] (configs0 shared table)",
         torch.randn(SHARED_ROWS, D, generator=gen, device=dev),
         (BATCH, T, FAN)),
        ("f32 [100032,32] ids [1000003]",
         torch.randn(100032, D, generator=gen, device=dev), (1000003,)),
        ("int32 [150000,90] ids [16,4096]",
         torch.randint(0, 1 << 30, (150000, T * FAN), generator=gen,
                       device=dev, dtype=torch.int32), (16, 4096)),
        ("int32 [150000,9] ids [65537]",
         torch.randint(0, 1 << 30, (150000, T), generator=gen, device=dev,
                       dtype=torch.int32), (65537,)),
    ]


GATHER_ROUNDS = 5


def phase_gather(card: str, dev, gen) -> dict:
    """Each case exact against the plain version; timed eagerly (`cuda_ms`:
    back-to-back wrapper calls, what a step pays, the host's time where it
    outlasts the kernel's; the median of GATHER_ROUNDS rounds taken in
    turns with `index_select`'s), by CUDA graph (the kernel alone), and
    beside them `index_select` eagerly and by graph."""
    from score_tpu_torch.kernels.gather import gather_rows, gather_rows_plain
    worst = 0.0
    line = None
    for label, table, shape in gather_cases(gen, dev):
        ids = torch.randint(0, table.shape[0], shape, generator=gen,
                            device=dev, dtype=torch.int32)
        got = gather_rows(table, ids)
        want = gather_rows_plain(table, ids)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gather {label}: kernel != plain")
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        flat = ids.reshape(-1)
        eager, lib = [], []
        for _ in range(GATHER_ROUNDS):   # in turns: the host's time drifts
            eager.append(cuda_ms(lambda: gather_rows(table, ids)))
            lib.append(cuda_ms(lambda: torch.index_select(table, 0, flat)))
        ms, lib_ms = statistics.median(eager), statistics.median(lib)
        gms = graph_ms(lambda: gather_rows(table, ids))
        plain_ms = cuda_ms(lambda: gather_rows_plain(table, ids))
        lib_gms = graph_ms(lambda: torch.index_select(table, 0, flat))
        rows = torch.unique(ids).numel()        # the rows this run reads
        b = bound(rows * table.shape[1] * table.element_size()
                  + nbytes(ids, got), 0)
        log(f"[gather] {label}: exact, kernel {ms:.4f} ms eagerly, "
            f"{gms:.4f} ms by graph; plain {plain_ms:.4f} ms; index_select "
            f"{lib_ms:.4f} ms eagerly, {lib_gms:.4f} ms by graph; bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]")
        if line is None:
            line = dict(ms=ms, graph_ms=gms, plain_ms=plain_ms,
                        library_ms=lib_ms, **b)
        del table, ids, got, want
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, **line)


def _cand_inputs(gen, dev, dtype, B, C, n=FAN, m=FAN, d=D, Tn=T):
    def r(*s):
        return torch.randn(*s, generator=gen, device=dev)
    mu = torch.rand(B, Tn, n, generator=gen, device=dev) > 0.3
    mi = torch.rand(B, C, Tn, m, generator=gen, device=dev) > 0.3
    mu[:, 0] = False                  # all-masked slots on both sides
    mi[:, :, Tn - 1] = False
    return (r(B, Tn, n, d).to(dtype), r(B, C, Tn, m, d).to(dtype), mu, mi,
            r(d, d) * 0.3, r(B, d).to(dtype), r(B, C, d).to(dtype))


def _cand_work(args, C, backward: bool):
    """Compulsory bytes and f32 operations of the co-attention forward or
    backward on these inputs: masked rows need not be read."""
    Eu, Ei, mu, mi, Wr, eu, ei = args
    B, Tn, n, d = Eu.shape
    es = Eu.element_size()
    vu, vi = mu.sum().item(), mi.sum().item()     # valid rows
    out = 2 * B * C * Tn * d * es                 # cu, ci (or dcu, dci)
    moved = ((vu + vi) * d * es + nbytes(mu, mi, Wr, eu, ei) + out)
    if not backward:
        flops = (2 * d * d * B * Tn * (1 + C) + d * vu + 4 * d * C * vu
                 + 5 * d * vi)
        return moved, flops
    # reads dcu, dci; writes dEu, dEi (every row), deu, dei, dWr
    moved += nbytes(Eu, Ei, eu, ei) + 4 * d * d
    flops = (6 * d * d * B * Tn * (1 + C) + 11 * d * C * vu + d * vu
             + 11 * d * vi)
    return moved, flops


def phase_coattn(card: str, dev, gen) -> dict:
    from score_tpu_torch.kernels.coattn_cand import (cross_coattn_cand,
                                                     cross_coattn_cand_plain)
    shapes = [dict(B=1, C=256),                           # score(u, 101)
              dict(B=1, C=4096), dict(B=16, C=4096), dict(B=512, C=101),
              dict(B=4096, C=2), dict(B=37, C=101),       # ragged B
              dict(B=64, C=101, d=16)]                    # configs3 default d
    worst = 0.0
    line = train = None
    for kw in shapes:
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32,
                                                        F32_TOL)):
            for ta in ((True, False) if kw["B"] == 37 else (True,)):
                args = _cand_inputs(gen, dev, dtype, **kw)
                got = cross_coattn_cand(*args, target_aware=ta)
                want = cross_coattn_cand_plain(*args, target_aware=ta)
                torch.cuda.synchronize()
                err = 0.0
                for g, w in zip(got, want):
                    if not torch.isfinite(g).all():
                        raise AssertionError(f"coattn {kw}: non-finite")
                    torch.testing.assert_close(g.float(), w.float(),
                                               rtol=tol, atol=tol)
                    err = max(err, (g.float() - w.float()).abs().max().item())
                if not ((got[0][:, :, 0] == 0).all()
                        and (got[1][:, :, T - 1] == 0).all()):
                    raise AssertionError(f"coattn {kw}: masked slot != 0")
                worst = max(worst, err)
                ms = cuda_ms(lambda: cross_coattn_cand(*args, target_aware=ta))
                plain_ms = cuda_ms(lambda: cross_coattn_cand_plain(
                    *args, target_aware=ta), iters=5)
                b = bound(*_cand_work(args, kw["C"], backward=False))
                log(f"[coattn] {kw} {str(dtype)[6:]} target_aware={ta}: "
                    f"max_abs_err {err:.3e} (tol {tol}), kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                    f"({b['bound_by']}) [{card}]")
                if kw == dict(B=16, C=4096) and dtype == torch.bfloat16:
                    line = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                **b)
                if kw == dict(B=4096, C=2) and dtype == torch.bfloat16:
                    train = dict(training_shape_ms=ms,
                                 training_shape_bound_ms=b["bound_ms"])
                del args, got, want
    torch.cuda.empty_cache()
    # the serving shape's times, and beside them the training shape's, at
    # which the launches of the line are counted
    return dict(max_abs_err=worst, **line, **train)


def _pair_work(args, pool: str):
    """Compulsory bytes, f32 operations on the CUDA cores and ms of
    tensor-core products of the per-pair forward on these inputs: masked
    rows need not be read; EuW = Eu Wr once per valid user row; the max
    pool's relation entries only for valid (j, k) pairs, EuW and the
    relation matrix on the tensor cores in the passes the kernels take
    (bf16: EuW split hi + lo, two; f32: 3xTF32, three). The sum and mean
    pools need no relation matrix: they take the fewer operations of this
    form and the candidates form (`_cand_work`: w = Em Wr once per (b, t),
    v = Es Wr^T once per unit), which needs fewer where C is small."""
    Eu, Ei, mu, mi, Wr, eu, ei = args
    B, Tn, n, d = Eu.shape
    C = Ei.shape[1]
    es = Eu.element_size()
    vu, vi = mu.sum().item(), mi.sum().item()
    moved = ((vu + vi) * d * es + nbytes(mu, mi, Wr, eu, ei)
             + 2 * B * C * Tn * d * es)
    flops = 2 * d * d * vu
    if pool == "max":
        pairs = (mu.sum(-1)[:, None].double()
                 * mi.sum(-1).double()).sum().item()
        passes, rate = ((2, BF16_MMA_FLOPS_PER_S)
                        if Eu.dtype == torch.bfloat16
                        else (3, TF32_MMA_FLOPS_PER_S))
        # EuW and the relation entries; per row the target term and the
        # weighted sum
        mma_ms = passes * (flops + 2 * d * pairs) / rate * 1e3
        return moved, 4 * d * (C * vu + vi), mma_ms
    # per user row: score with the target folded in, weighted sum; per item
    # row: the masked sum, score, weighted sum
    flops = min(flops + 6 * d * C * vu + 5 * d * vi,
                _cand_work(args, C, backward=False)[1])
    return moved, flops


def phase_coattn_pair(card: str, dev, gen) -> dict:
    """The per-pair forward against its plain version, max and mean pools;
    at the serving and training shapes also the sum pool, which must give
    the candidates kernel's result on the same inputs (the model routes the
    sum pool to the candidates kernel, so this holds the two kernels to
    one function)."""
    from score_tpu_torch.kernels.coattn import (cross_coattn_pair,
                                                cross_coattn_pair_plain)
    from score_tpu_torch.kernels.coattn_cand import cross_coattn_cand
    cases = [  # (label, shape, dtypes): serving, eval, training, ragged
        ("serving", dict(B=16, C=4096), (torch.bfloat16,)),
        ("eval", dict(B=256, C=101), (torch.bfloat16,)),
        ("training", dict(B=4096, C=2), (torch.float32, torch.bfloat16)),
        ("ragged", dict(B=37, C=101), (torch.float32,)),
        ("configs3 d", dict(B=64, C=101, d=16), (torch.float32,))]
    worst = 0.0
    line = train = None
    for label, kw, dtypes in cases:
        pools = ("max", "mean") + (("sum",) if label in ("serving",
                                                       "training") else ())
        for pool in pools:
            for dtype in dtypes:
                tol = F32_TOL if dtype == torch.float32 else BF16_TOL
                for ta in ((True, False) if label == "ragged" else (True,)):
                    args = _cand_inputs(gen, dev, dtype, **kw)
                    got = cross_coattn_pair(*args, pool=pool,
                                            target_aware=ta)
                    want = cross_coattn_pair_plain(*args, pool=pool,
                                                   target_aware=ta)
                    torch.cuda.synchronize()
                    err = 0.0
                    for g, w in zip(got, want):
                        if not torch.isfinite(g).all():
                            raise AssertionError(
                                f"coattn_pair {kw} {pool}: non-finite")
                        torch.testing.assert_close(g.float(), w.float(),
                                                   rtol=tol, atol=tol)
                        err = max(err,
                                  (g.float() - w.float()).abs().max().item())
                    if not ((got[0][:, :, 0] == 0).all()
                            and (got[1][:, :, T - 1] == 0).all()):
                        raise AssertionError(
                            f"coattn_pair {kw} {pool}: masked slot != 0")
                    worst = max(worst, err)
                    if pool == "sum":
                        cand = cross_coattn_cand(*args, target_aware=ta)
                        torch.cuda.synchronize()
                        cerr = 0.0
                        for g, w in zip(got, cand):
                            torch.testing.assert_close(g.float(), w.float(),
                                                       rtol=tol, atol=tol)
                            cerr = max(cerr, (g.float() - w.float()).abs()
                                       .max().item())
                        cand_ms = cuda_ms(lambda: cross_coattn_cand(
                            *args, target_aware=ta))
                        log(f"[coattn_pair] {label} {kw} sum "
                            f"{str(dtype)[6:]}: per-pair kernel vs "
                            f"candidates kernel max_abs_err {cerr:.3e} (tol "
                            f"{tol}); candidates kernel {cand_ms:.4f} ms "
                            f"[{card}]")
                        del cand
                    ms = cuda_ms(lambda: cross_coattn_pair(
                        *args, pool=pool, target_aware=ta))
                    plain_ms = cuda_ms(lambda: cross_coattn_pair_plain(
                        *args, pool=pool, target_aware=ta), iters=5)
                    b = bound(*_pair_work(args, pool))
                    log(f"[coattn_pair] {label} {kw} {pool} "
                        f"{str(dtype)[6:]} target_aware={ta}: max_abs_err "
                        f"{err:.3e} (tol {tol}), kernel {ms:.4f} ms, plain "
                        f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                        f"({b['bound_by']}) [{card}]")
                    if (label == "serving" and pool == "max"
                            and dtype == torch.bfloat16):
                        line = dict(ms=ms, plain_ms=plain_ms,
                                    library_ms=None, **b)
                    if (label == "training" and pool == "mean"
                            and dtype == torch.bfloat16):
                        # the shape and pool of the launches the line
                        # counts, the device alone (stream times at this
                        # size are the host's)
                        gms = graph_ms(lambda: cross_coattn_pair(
                            *args, pool=pool, target_aware=ta))
                        log(f"[coattn_pair] {label} {kw} {pool} "
                            f"{str(dtype)[6:]}: by CUDA graph {gms:.4f} ms, "
                            f"bound {b['bound_ms']:.4f} ms [{card}]")
                        train = dict(training_shape_ms=gms,
                                     training_shape_timing="cuda graph",
                                     training_shape_bound_ms=b["bound_ms"])
                    del args, got, want
    torch.cuda.empty_cache()
    # the serving shape's times (max pool), and beside them the training
    # shape's by graph (mean pool), at which the launches are counted
    return dict(max_abs_err=worst, **line, **train)


# --- phase 2b: backward kernels --------------------------------------------

def _scatter_line(card, label, ids, src, V, lib_tables=None) -> dict:
    """One grouped scatter-add (the segments ids, src into a [V, D] table)
    held to its plain version (exact on integer-valued sources, within
    1e-5 relative of it on random ones) and timed: the
    kernel eagerly (what a step pays) and by CUDA graph, the plain version,
    index_add of the concatenated segments (one PyTorch call), the
    separate one-segment scatters and their sum (what each lookup's own
    backward did before the lookups were grouped), and the bound."""
    from score_tpu_torch.kernels.gather import (scatter_add_rows,
                                                scatter_add_rows_plain)
    ints = [torch.randint(-8, 9, x.shape, generator=torch.Generator(
        device=x.device).manual_seed(SEED), device=x.device).float()
            * (x != 0) for x in src]
    got = scatter_add_rows(ids, ints, V)
    if not torch.equal(got, scatter_add_rows_plain(ids, ints, V)):
        raise AssertionError(f"scatter_add {label}: integer sums differ "
                             f"from the plain version")
    got = scatter_add_rows(ids, src, V)
    want = scatter_add_rows_plain(ids, src, V)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err = (got - want).abs().max().item()
    ms = cuda_ms(lambda: scatter_add_rows(ids, src, V))
    gms = graph_ms(lambda: scatter_add_rows(ids, src, V))
    plain_ms = cuda_ms(lambda: scatter_add_rows_plain(ids, src, V))
    zeros = torch.zeros(V, D, device=src[0].device)
    flat_ids = torch.cat([x.reshape(-1) for x in ids])
    flat_src = torch.cat([x.reshape(-1, D) for x in src])
    lib_ms = cuda_ms(lambda: torch.index_add(zeros, 0, flat_ids, flat_src))
    sep = ""
    if len(ids) > 1:
        def separate():
            tables = [scatter_add_rows(i, x, V) for i, x in zip(ids, src)]
            return sum(tables[1:], tables[0])
        sep = (f", separate scatters and their sum {cuda_ms(separate):.4f} "
               f"ms ({graph_ms(separate):.4f} by graph)")
    b = bound(nbytes(*src, *ids, got),
              sum((x != 0).sum().item() for x in src))
    rows = sum(x.numel() for x in ids)
    live = sum((x != 0).any(-1).sum().item() for x in src)
    distinct = torch.unique(torch.cat([x.reshape(-1) for x in ids])).numel()
    log(f"[scatter] {label}: {len(ids)} segment(s), {rows} ids ({live} with "
        f"a non-zero gradient, {distinct} distinct), integer sums "
        f"exact, random max_abs_err {err:.3e} (tol 1e-5 rel), kernel "
        f"{ms:.4f} ms eagerly, {gms:.4f} ms by graph; plain "
        f"{plain_ms:.4f} ms, index_add {lib_ms:.4f} ms{sep}; bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]")
    return dict(max_abs_err=err, ms=ms, graph_ms=gms, plain_ms=plain_ms,
                library_ms=lib_ms, **b)


def _real_segments(ds, dev, rung: str, neg: str, gen) -> dict:
    """Each table's lookups (ids, and a random gradient that is zero where
    the model masks the slot) of one training batch of the bench dataset,
    as the step groups them: table name -> (rows, ids list, src list)."""
    from score_tpu_torch.graph import device_graph, gather_candidate_batch
    from score_tpu_torch.nn.embed import round_up
    from score_tpu_torch.nn.model import _nbr_mask
    b = _device_batches(ds, 1, BATCH, dev)[0]
    C = 1 if neg == "inbatch" else 2          # [positive | one negative]
    cand = b["item"][:, None]
    if C == 2:
        negs = torch.randint(1, ds.num_items + 1, (BATCH, 1), generator=gen,
                             device=dev, dtype=torch.int32)
        cand = torch.cat([cand, negs], dim=1)
    mb = gather_candidate_batch(device_graph(ds.graph, dev), b["user"], cand,
                                b["slot"], item_side=rung != "configs0")
    sv = mb["slot_valid"]

    def grad_like(ids, mask=None):
        g = torch.randn(*ids.shape, D, generator=gen, device=dev)
        return g if mask is None else g * mask[..., None]

    Eu_mask = _nbr_mask(mb["u_cnt"], FAN, sv)
    items = [mb["cand"], mb["u_hist"]]
    item_src = [grad_like(mb["cand"]), grad_like(mb["u_hist"], Eu_mask)]
    users, user_src = [mb["user"]], [grad_like(mb["user"])]
    if rung == "configs0":     # the shared table: items, then users offset
        off = torch.where(mb["user"] > 0, mb["user"] + ds.num_items, 0)
        rows = round_up(1 + ds.num_items + ds.num_users)
        return {"shared": (rows, items + [off], item_src + user_src)}
    Ei_mask = _nbr_mask(mb["i_cnt"], FAN, sv[:, None])
    users.append(mb["i_hist"])
    user_src.append(grad_like(mb["i_hist"], Ei_mask))
    return {"item": (round_up(1 + ds.num_items), items, item_src),
            "user": (round_up(1 + ds.num_users), users, user_src)}


def check_grouped_backward_kernels(card: str, dev) -> None:
    """The backward of one table's grouped lookups runs a memset and the
    scatter-add kernel and nothing else: no fill and no add of a dense
    table gradient (torch.profiler's CUDA kernels of that backward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from score_tpu_torch.kernels.gather import gather_rows_grouped
    table = torch.randn(90560, D, device=dev, requires_grad=True)
    ids = [torch.randint(0, 90560, s, device=dev, dtype=torch.int32)
           for s in ((BATCH, 1), (BATCH, T, FAN))]
    outs = gather_rows_grouped(table, ids)
    douts = [torch.randn_like(o) for o in outs]
    torch.autograd.grad(outs, [table], grad_outputs=douts,
                        retain_graph=True)                  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(outs, [table], grad_outputs=douts)
        torch.cuda.synchronize()
    names = sorted({ev.key for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA})
    kernels = [k for k in names if "memset" not in k.lower()]
    if not names or any("scatter_add_kernel" not in k for k in kernels):
        raise AssertionError(f"[scatter] the grouped backward ran {names}; "
                             f"expected a memset and scatter_add_kernel")
    log(f"[scatter] the grouped backward of 2 lookups runs {names} and no "
        f"other kernel [{card}]")


def phase_scatter(card: str, dev, gen, ds) -> dict:
    """The table-gradient scatter-add: uniform ids at the shapes a step's
    lookups give (70% valid), then the grouped call as the step makes it on
    the real ids of one training batch of the bench dataset (configs3 with
    in-batch and with uniform negatives, configs0's shared table). Returns
    the kernels-line fields of the main path's call: configs3's item table
    with in-batch negatives."""
    # training's four lookups one at a time: (table rows, ids shape)
    cases = [("item [90560,32] ids [4096,9,10]", 90560, (BATCH, T, FAN)),
             ("item [90560,32] ids [4096,1]", 90560, (BATCH, 1)),
             ("user [50048,32] ids [4096,1,9,10]", 50048, (BATCH, 1, T, FAN)),
             ("user [50048,32] ids [4096]", 50048, (BATCH,)),
             # uniform negatives: configs3's user table over [positive |
             # negative], and configs0's shared table
             ("user [50048,32] ids [4096,2,9,10] (configs3 uniform)", 50048,
              (BATCH, 2, T, FAN)),
             ("shared [140608,32] ids [4096,9,10] (configs0)", SHARED_ROWS,
              (BATCH, T, FAN))]
    worst = 0.0
    for label, V, shape in cases:
        ids = torch.randint(1, V, shape, generator=gen, device=dev,
                            dtype=torch.int32)
        pad = torch.rand(shape, generator=gen, device=dev) < 0.3
        ids[pad] = 0        # masked neighbour slots: pad id, zero gradient
        src = torch.randn(shape + (D,), generator=gen, device=dev)
        src[pad] = 0.0
        worst = max(worst, _scatter_line(card, label, [ids], [src],
                                         V)["max_abs_err"])
    line = None
    for rung, neg in (("configs3", "inbatch"), ("configs3", "uniform"),
                      ("configs0", "uniform")):
        for table, (V, ids, src) in _real_segments(ds, dev, rung, neg,
                                                   gen).items():
            label = (f"{rung} {neg}, {table} table [{V},{D}], real ids "
                     f"{' + '.join(str(list(x.shape)) for x in ids)}")
            out = _scatter_line(card, label, ids, src, V)
            worst = max(worst, out["max_abs_err"])
            if line is None:
                line = out
    check_grouped_backward_kernels(card, dev)
    torch.cuda.empty_cache()
    line["max_abs_err"] = worst
    return line


def phase_coattn_bwd(card: str, dev, gen) -> dict:
    from score_tpu_torch.kernels.coattn_cand import (
        cross_coattn_cand_bwd, cross_coattn_cand_bwd_plain)
    shapes = [dict(B=4096, C=2), dict(B=37, C=2),      # training; ragged B
              dict(B=64, C=1), dict(B=64, C=2, d=16)]  # flat pairs; d=16
    worst = 0.0
    line = None
    for kw in shapes:
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32,
                                                        F32_TOL)):
            for ta in (True, False):
                args = _cand_inputs(gen, dev, dtype, **kw)
                B, C, d = kw["B"], kw["C"], kw.get("d", D)
                grads = [torch.randn(B, C, T, d, generator=gen,
                                     device=dev).to(dtype) for _ in range(2)]
                got = cross_coattn_cand_bwd(*args, *grads, target_aware=ta)
                want = cross_coattn_cand_bwd_plain(*args, *grads,
                                                   target_aware=ta)
                torch.cuda.synchronize()
                err = 0.0
                for name, g, w in zip(("dEu", "dEi", "deu", "dei", "dWr"),
                                      got, want):
                    if not torch.isfinite(g).all():
                        raise AssertionError(f"coattn_bwd {kw}: {name} "
                                             f"non-finite")
                    scale = max(w.float().abs().max().item(), 1.0)
                    torch.testing.assert_close(
                        g.float(), w.float(), rtol=tol, atol=tol * scale,
                        msg=f"coattn_bwd {kw} {dtype} ta={ta} {name}")
                    err = max(err, (g.float() - w.float()).abs().max().item())
                if not ((got[0][:, 0] == 0).all()
                        and (got[1][:, :, T - 1] == 0).all()):
                    raise AssertionError(f"coattn_bwd {kw}: masked rows' "
                                         f"gradient != 0")
                worst = max(worst, err)
                ms = cuda_ms(lambda: cross_coattn_cand_bwd(
                    *args, *grads, target_aware=ta))
                plain_ms = cuda_ms(lambda: cross_coattn_cand_bwd_plain(
                    *args, *grads, target_aware=ta), iters=5)
                b = bound(*_cand_work(args, C, backward=True))
                log(f"[coattn_bwd] {kw} {str(dtype)[6:]} target_aware={ta}: "
                    f"max_abs_err {err:.3e} (tol {tol} x the largest value), "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]")
                if (kw == dict(B=4096, C=2) and dtype == torch.bfloat16
                        and ta):
                    line = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                **b)
                del args, grads, got, want
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, **line)


def phase_coattn_pair_bwd(card: str, dev, gen) -> dict:
    from score_tpu_torch.kernels.coattn import (cross_coattn_pair_bwd,
                                                cross_coattn_pair_bwd_plain)
    shapes = [dict(B=4096, C=2), dict(B=37, C=2),    # training; ragged B
              dict(B=64, C=2, d=16)]                 # configs3's own d
    worst = 0.0
    line = None
    for kw in shapes:
        for pool in ("mean", "sum"):
            for dtype, tol in ((torch.bfloat16, BF16_TOL),
                               (torch.float32, F32_TOL)):
                ta = kw["B"] != 37 or dtype == torch.bfloat16
                args = _cand_inputs(gen, dev, dtype, **kw)
                B, C, d = kw["B"], kw["C"], kw.get("d", D)
                grads = [torch.randn(B, C, T, d, generator=gen,
                                     device=dev).to(dtype) for _ in range(2)]
                got = cross_coattn_pair_bwd(*args, *grads, pool=pool,
                                            target_aware=ta)
                want = cross_coattn_pair_bwd_plain(*args, *grads, pool=pool,
                                                   target_aware=ta)
                torch.cuda.synchronize()
                err = 0.0
                for name, g, w in zip(("dEu", "dEi", "deu", "dei", "dWr"),
                                      got, want):
                    if not torch.isfinite(g).all():
                        raise AssertionError(f"coattn_pair_bwd {kw}: {name} "
                                             f"non-finite")
                    scale = max(w.float().abs().max().item(), 1.0)
                    torch.testing.assert_close(
                        g.float(), w.float(), rtol=tol, atol=tol * scale,
                        msg=f"coattn_pair_bwd {kw} {pool} {dtype} {name}")
                    err = max(err, (g.float() - w.float()).abs().max().item())
                if not ((got[0][:, 0] == 0).all()
                        and (got[1][:, :, T - 1] == 0).all()):
                    raise AssertionError(f"coattn_pair_bwd {kw}: masked "
                                         f"rows' gradient != 0")
                worst = max(worst, err)
                ms = cuda_ms(lambda: cross_coattn_pair_bwd(
                    *args, *grads, pool=pool, target_aware=ta))
                plain_ms = cuda_ms(lambda: cross_coattn_pair_bwd_plain(
                    *args, *grads, pool=pool, target_aware=ta), iters=5)
                b = bound(*_cand_work(args, C, backward=True))
                log(f"[coattn_pair_bwd] {kw} {pool} {str(dtype)[6:]} "
                    f"target_aware={ta}: max_abs_err {err:.3e} (tol {tol} x "
                    f"the largest value), kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                    f"({b['bound_by']}) [{card}]")
                if (kw == dict(B=4096, C=2) and dtype == torch.bfloat16
                        and pool == "mean"):
                    line = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                **b)
                del args, grads, got, want
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, **line)


# --- phase 2c: the wide co-attention kernels --------------------------------

def _check_grads(tag: str, got, want, tol: float) -> float:
    """The five gradients within tol of each one's largest value; their
    largest absolute error."""
    err = 0.0
    for name, g, w in zip(("dEu", "dEi", "deu", "dei", "dWr"), got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{tag}: {name} non-finite")
        scale = max(w.float().abs().max().item(), 1.0)
        torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                   atol=tol * scale, msg=f"{tag} {name}")
        err = max(err, (g.float() - w.float()).abs().max().item())
    return err


# (label, shape) of the wide kernels: configs3 at d=64 as training, eval and
# serving launch it (n = m = 10), d=128 at training, and d=32 with 40 rows
WIDE_SHAPES = [("d64 training", dict(B=4096, C=2, d=64)),
               ("d64 eval", dict(B=256, C=101, d=64)),
               ("d64 serving", dict(B=16, C=4096, d=64)),
               ("d128 training", dict(B=4096, C=2, d=128)),
               ("n=m=40 d32", dict(B=1024, C=2, n=40, m=40, d=32))]


def phase_coattn_wide(card: str, dev, gen) -> dict:
    """The wide forward (each pool at every shape, two runs bit-equal) and
    backward (sum, mean) against their plain versions, through the public
    wrappers at widths that route to them, with times and bounds; the
    tuned kernels must not launch. Returns the kernels-line fields of
    both, at the d=64 training shape (bf16, the sum pool), where the [d64]
    phase counts their launches."""
    from score_tpu_torch.kernels.coattn import (cross_coattn_pair,
                                                cross_coattn_pair_bwd,
                                                cross_coattn_pair_bwd_plain,
                                                cross_coattn_pair_plain)
    fns = reset_counts()
    worst = {"fwd": 0.0, "bwd": 0.0}
    line = {}
    for label, kw in WIDE_SHAPES:
        training = kw["C"] == 2
        dtypes = ((torch.bfloat16, torch.float32) if label == "d64 training"
                  else (torch.bfloat16,))
        # the backward at d=128 for the sum pool only (its mean is the
        # same kernel with one scale)
        bwd_pools = ("sum",) if label == "d128 training" else ("sum",
                                                               "mean")
        for dtype in dtypes:
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            args = _cand_inputs(gen, dev, dtype, **kw)
            B, C, d = kw["B"], kw["C"], kw["d"]
            grads = [torch.randn(B, C, T, d, generator=gen, device=dev)
                     .to(dtype) for _ in range(2)]
            for pool in ("sum", "mean", "max"):
                tag = f"[coattn_wide] {label} {kw} {pool} {str(dtype)[6:]}"
                got = cross_coattn_pair(*args, pool=pool)
                want = cross_coattn_pair_plain(*args, pool=pool)
                again = cross_coattn_pair(*args, pool=pool)
                torch.cuda.synchronize()
                if not all(torch.equal(a, g) for a, g in zip(again, got)):
                    raise AssertionError(f"{tag}: two runs of the forward "
                                         f"differ")
                err = 0.0
                for g, w in zip(got, want):
                    if not torch.isfinite(g).all():
                        raise AssertionError(f"{tag}: non-finite")
                    torch.testing.assert_close(g.float(), w.float(),
                                               rtol=tol, atol=tol)
                    err = max(err, (g.float() - w.float()).abs().max().item())
                if not ((got[0][:, :, 0] == 0).all()
                        and (got[1][:, :, T - 1] == 0).all()):
                    raise AssertionError(f"{tag}: masked slot != 0")
                worst["fwd"] = max(worst["fwd"], err)
                ms = cuda_ms(lambda: cross_coattn_pair(*args, pool=pool))
                gms = graph_ms(lambda: cross_coattn_pair(*args, pool=pool))
                plain_ms = cuda_ms(lambda: cross_coattn_pair_plain(
                    *args, pool=pool), iters=5)
                b = bound(*_pair_work(args, pool))
                log(f"{tag} forward: max_abs_err {err:.3e} (tol {tol}), "
                    f"two runs bit-equal, "
                    f"kernel {ms:.4f} ms ({gms:.4f} by graph), plain "
                    f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                    f"({b['bound_by']}) [{card}]")
                if (label == "d64 training" and pool == "sum"
                        and dtype == torch.bfloat16):
                    line["fwd"] = dict(ms=ms, graph_ms=gms,
                                       plain_ms=plain_ms, library_ms=None,
                                       **b)
                if pool not in bwd_pools or not training:
                    continue
                got = cross_coattn_pair_bwd(*args, *grads, pool=pool)
                want = cross_coattn_pair_bwd_plain(*args, *grads, pool=pool)
                again = cross_coattn_pair_bwd(*args, *grads, pool=pool)
                torch.cuda.synchronize()
                worst["bwd"] = max(worst["bwd"],
                                   _check_grads(tag, got, want, tol))
                if not all(torch.equal(a, g) for a, g in zip(again, got)):
                    raise AssertionError(f"{tag}: two runs of the backward "
                                         f"differ")
                if not ((got[0][:, 0] == 0).all()
                        and (got[1][:, :, T - 1] == 0).all()):
                    raise AssertionError(f"{tag}: masked rows' gradient != 0")
                ms = cuda_ms(lambda: cross_coattn_pair_bwd(*args, *grads,
                                                           pool=pool))
                gms = graph_ms(lambda: cross_coattn_pair_bwd(*args, *grads,
                                                             pool=pool))
                plain_ms = cuda_ms(lambda: cross_coattn_pair_bwd_plain(
                    *args, *grads, pool=pool), iters=5)
                b = bound(*_cand_work(args, C, backward=True))
                log(f"{tag} backward: max_abs_err (largest of the five) "
                    f"within tol {tol} x the largest value, kernel {ms:.4f} "
                    f"ms ({gms:.4f} by graph), plain {plain_ms:.4f} ms, "
                    f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}) "
                    f"[{card}]")
                if (label == "d64 training" and pool == "sum"
                        and dtype == torch.bfloat16):
                    line["bwd"] = dict(ms=ms, graph_ms=gms,
                                       plain_ms=plain_ms, library_ms=None,
                                       **b)
            del args, grads, got, want
            torch.cuda.empty_cache()
    launches = {k: fn.launches for k, fn in fns.items()}
    check_launches("[coattn_wide]", launches,
                   {"cross_coattn_wide", "cross_coattn_wide_bwd"})
    return {k: dict(max_abs_err=worst[k], **v) for k, v in line.items()}


# --- the dataset and the configuration ---------------------------------------

def bench_dataset():
    from score_tpu_torch.data import synth
    from score_tpu_torch.data.prep_common import build_dataset
    t0 = time.perf_counter()
    user, item, ts = synth.synth_events(USERS, ITEMS, EVENTS, num_slots=T,
                                        seed=SEED)
    ds = build_dataset(user, item, ts, num_slots=T, user_fanout=FAN,
                       item_fanout=FAN, num_eval_neg=100, min_user=3,
                       min_item=3, seed=SEED, dataset_name="bench-taobao")
    log(f"[data] {ds.num_users} users, {ds.num_items} items, "
        f"{len(ds.train)} train targets, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return ds


def ladder_config(rung: str, dtype: str, width: bool = True, dim: int = D):
    """Preset `rung` (configs0-3, with its own model flags and its uniform
    negatives) at bench.py's width and training knobs (batch 4096, tables
    every 2nd step at 2x lr), or at embed_dim `dim` with the same hidden
    and MLP widths (scripts/perf_sweep.py's b4096_bf16_iw_d64, _d128);
    width=False keeps the preset's own (smaller) widths."""
    from score_tpu_torch.config import PRESETS
    cfg = PRESETS[rung]()
    model = dict(compute_dtype=dtype)
    if width:
        model.update(embed_dim=dim, hidden_dim=64, mlp_dims=(128, 64))
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **model),
        train=dataclasses.replace(cfg.train, batch_size=BATCH,
                                  table_update_every=2, table_lr_boost=2.0))


def bench_config(dtype: str, width: bool = True, pool: str = "sum",
                 dim: int = D):
    """configs3 as bench.py trains it (importance-weighted in-batch
    negatives), with co-attention pool `pool`, at embed_dim `dim`."""
    cfg = ladder_config("configs3", dtype, width, dim)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, coattn_pool=pool),
        data=dataclasses.replace(cfg.data, train_neg_mode="inbatch_iw"))


def random_weights(cfg, ds) -> dict:
    """Flax-faithful init from a seed; then the zero-initialised attention
    weights (Wr, Wtu, Wti, the slot attention's and both pooling W) made
    non-zero and the tables widened, so the attention scores are far from
    uniform and the score path is exercised."""
    from score_tpu_torch.params import init_params
    gen = torch.Generator().manual_seed(SEED)
    sd = init_params(cfg, ds.num_users, ds.num_items, gen)
    for k in sd:
        if k.startswith("coattn.") or k.endswith(".w"):
            sd[k] = torch.randn(sd[k].shape, generator=gen) * 0.3
    for k in sd:
        if "table" in k:
            sd[k] = torch.randn(sd[k].shape, generator=gen) * 0.5
    return sd


def reset_counts() -> dict:
    """Every kernel's launch counter, by kernel name, set to 0."""
    from score_tpu_torch.kernels.coattn import (cross_coattn_pair,
                                                cross_coattn_pair_bwd)
    from score_tpu_torch.kernels.coattn_cand import (cross_coattn_cand,
                                                     cross_coattn_cand_bwd)
    from score_tpu_torch.kernels.coattn_wide import (cross_coattn_wide,
                                                     cross_coattn_wide_bwd)
    from score_tpu_torch.kernels.gather import gather_rows, scatter_add_rows
    fns = dict(gather_rows=gather_rows, scatter_add_rows=scatter_add_rows,
               cross_coattn_cand=cross_coattn_cand,
               cross_coattn_cand_bwd=cross_coattn_cand_bwd,
               cross_coattn_pair=cross_coattn_pair,
               cross_coattn_pair_bwd=cross_coattn_pair_bwd,
               cross_coattn_wide=cross_coattn_wide,
               cross_coattn_wide_bwd=cross_coattn_wide_bwd)
    for fn in fns.values():
        fn.launches = 0
    return fns


def check_table_scatters(what: str, cfg, launches: dict, timed) -> None:
    """One scatter-add a table on each table-update step of the steps
    `timed` (a range of step numbers), none on the others: 2 a step with
    separate user and item tables, 1 with configs0's shared table."""
    stride = max(cfg.train.table_update_every, 1)
    updates = sum(1 for j in range(timed.start, timed.stop)
                  if j % stride == 0)
    tables = 1 if cfg.model.shared_table else 2
    got = launches["scatter_add_rows"]
    if got != tables * updates:
        raise AssertionError(f"{what}: scatter_add_rows launched {got} "
                             f"times in {updates} table-update steps; "
                             f"expected {tables} a step")
    log(f"{what} scatter_add_rows: {got} launches, {tables} a table-update "
        f"step ({updates} of them)")


def check_launches(what: str, launches: dict, want: set) -> None:
    """The kernels in `want` launched at least once, every other not."""
    for name, n in launches.items():
        if (n > 0) != (name in want):
            raise AssertionError(f"{what}: {name} launched {n} times; "
                                 f"expected {'some' if name in want else 0}")


# the kernels each path launches: serving, and training by pool
SERVE_KERNELS = {"sum": {"gather_rows", "cross_coattn_cand"},
                 "mean": {"gather_rows", "cross_coattn_pair"},
                 "max": {"gather_rows", "cross_coattn_pair"}}
TRAIN_KERNELS = {"sum": {"gather_rows", "scatter_add_rows",
                         "cross_coattn_cand", "cross_coattn_cand_bwd"},
                 "mean": {"gather_rows", "scatter_add_rows",
                          "cross_coattn_pair", "cross_coattn_pair_bwd"},
                 "max": {"gather_rows", "scatter_add_rows",
                         "cross_coattn_pair"}}
# past d = 32 every pool runs the wide kernels, and no tuned co-attention one
WIDE_SERVE_KERNELS = {"gather_rows", "cross_coattn_wide"}
WIDE_TRAIN_KERNELS = {"sum": {"gather_rows", "scatter_add_rows",
                              "cross_coattn_wide", "cross_coattn_wide_bwd"}}
WIDE_TRAIN_KERNELS["mean"] = WIDE_TRAIN_KERNELS["sum"]
WIDE_TRAIN_KERNELS["max"] = {"gather_rows", "scatter_add_rows",
                             "cross_coattn_wide"}


# --- phase 3: serving ------------------------------------------------------

def phase_serving(card: str, ds, pool: str = "sum",
                  device: str = "cuda") -> dict:
    from score_tpu_torch.serve import ScoringService

    cfg = bench_config("bfloat16", pool=pool)
    sd = random_weights(cfg, ds)
    svc = ScoringService(cfg, ds, sd, device=device)
    rng = np.random.default_rng(SEED)
    u = int(ds.test.user[0])
    items100 = rng.integers(1, ds.num_items + 1, 100).astype(np.int32)
    users16 = ds.test.user[:ROWS].astype(np.int32)
    items16 = rng.integers(1, ds.num_items + 1, (ROWS, WIDE)).astype(np.int32)

    # the serving run whose launches the counters report
    fns = reset_counts()
    s1 = svc.score(u, items100)
    sb = svc.score_batch(users16, items16)
    top_i, top_s = svc.topk(u, k=10)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in fns.items()}
    log(f"[serve {pool}] launches in the serving run: {launches}")
    check_launches(f"serving, pool {pool}", launches, SERVE_KERNELS[pool])
    for name, arr, shape in (("score", s1, (100,)),
                             ("score_batch", sb, (ROWS, WIDE)),
                             ("topk", top_s, (10,))):
        if arr.shape != shape or not np.isfinite(arr).all():
            raise AssertionError(f"{name}: shape {arr.shape} or non-finite")
    if not (np.all(np.diff(top_s) <= 0) and np.all(top_i >= 1)):
        raise AssertionError("topk is not sorted over real items")
    np.testing.assert_allclose(svc.score(u, top_i), top_s,
                               **CPU_TOL["bfloat16"])
    log(f"[serve {pool}] score std {s1.std():.4f}; topk items "
        f"{top_i.tolist()}")

    serve_vs_cpu(ds, lambda dtype: bench_config(dtype, pool=pool), sd, rng,
                 f"[serve {pool}]", device, card_bf16=svc)

    # timings (bf16 service), host clock around calls that read back
    items101 = rng.integers(1, ds.num_items + 1, 101).astype(np.int32)
    for _ in range(10):
        svc.score(u, items101)
    lat = []
    for _ in range(200):
        t0 = time.perf_counter()
        svc.score(u, items101)
        lat.append(time.perf_counter() - t0)
    p50 = statistics.median(lat) * 1e3
    q = np.quantile(lat, [0.25, 0.75, 0.9]) * 1e3
    svc.score_batch(users16, items16)
    t0 = time.perf_counter()
    for _ in range(10):
        svc.score_batch(users16, items16)
    cps = 10 * items16.size / (time.perf_counter() - t0)
    tk = []
    for _ in range(3):
        t0 = time.perf_counter()
        svc.topk(u, k=10)
        tk.append(time.perf_counter() - t0)
    log(f"[serve {pool}] score(u, 101) latency p50 {p50:.3f} ms (q25 "
        f"{q[0]:.3f}, q75 {q[1]:.3f}, p90 {q[2]:.3f}; 200 calls) [{card}]")
    log(f"[serve {pool}] score_batch {ROWS}x{WIDE}: {cps:.0f} candidates/s "
        f"[{card}]")
    log(f"[serve {pool}] topk over {ds.num_items} items: median "
        f"{statistics.median(tk):.4f} s of {tk} [{card}]")
    del svc
    torch.cuda.empty_cache()
    return launches


def serve_vs_cpu(ds, config, sd, rng, tag: str, device="cuda",
                 card_bf16=None) -> None:
    """A 4 x 256 request on the card against the same service on the CPU
    (the plain path), same weights, with config(dtype) in f32 and bf16
    (`card_bf16`: a bf16 service on the card to reuse)."""
    from score_tpu_torch.serve import ScoringService
    users4 = ds.test.user[ROWS:ROWS + 4].astype(np.int32)
    items4 = rng.integers(1, ds.num_items + 1, (4, 256)).astype(np.int32)
    for dtype in ("float32", "bfloat16"):
        c = config(dtype)
        gpu = (card_bf16 if dtype == "bfloat16" and card_bf16 is not None
               else ScoringService(c, ds, sd, device=device))
        cpu = ScoringService(c, ds, sd, device="cpu")
        got, want = gpu.score_batch(users4, items4), cpu.score_batch(
            users4, items4)
        np.testing.assert_allclose(got, want, **CPU_TOL[dtype])
        log(f"{tag} {dtype} card vs cpu 4x256: max_abs_err "
            f"{np.abs(got - want).max():.3e} (tol {CPU_TOL[dtype]})")
        del gpu, cpu


# --- phase 4: training -----------------------------------------------------

def _device_batches(ds, n: int, batch: int, device):
    from score_tpu_torch.data.pipeline import TargetIterator
    it = TargetIterator(ds.train, batch, seed=SEED)
    return [{k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
            for _ in range(n)]


def _tables(state) -> dict:
    return {k: v.detach().clone()
            for k, v in state.model.named_parameters() if "table" in k}


def _profile(state, graph, batches, neg_iw, card, step_ms,
             tag: str = "[train]", negatives=None) -> None:
    """Device time by kernel over the steady steps of a torch.profiler
    window (the first two steps start the profiler and are not counted).
    The profiler slows the host, so the idle share is given twice: within
    the profiled window, and against the unprofiled step time `step_ms`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from score_tpu_torch.train import train_step
    active = len(batches) - 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=active)) as prof:
        for j, b in enumerate(batches):
            if j == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            train_step(state, graph, b, neg_iw=neg_iw, with_auc=False,
                       negatives=None if negatives is None else negatives[j])
            if j == len(batches) - 1:
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            prof.step()
    rows = []
    for ev in prof.key_averages():
        if (ev.device_type == DeviceType.CUDA and ev.self_device_time_total
                and not ev.key.startswith("ProfilerStep")):
            rows.append((ev.self_device_time_total / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    per_step = busy / active
    log(f"{tag} profile of {active} steps: "
        f"{sum(r[1] for r in rows) / active:.0f} kernels and {per_step:.3f} "
        f"ms of device time a step; idle share {1 - busy / wall:.3f} of the "
        f"profiled window ({wall / active:.3f} ms a step), "
        f"{1 - per_step / step_ms:.3f} of an unprofiled {step_ms:.3f} ms "
        f"step [{card}]")
    for ms, cnt, key in sorted(rows, reverse=True)[:15]:
        log(f"{tag}   {ms:8.3f} ms {100 * ms / busy:5.1f}% x{cnt:<5} "
            f"{key[:100]}")


def _train_run(card: str, state, graph, batches, steps: int, tag: str,
               want: set, full: bool = True, neg_iw=None, negatives=None):
    """Warm-up steps, in which the tables must change on steps 0 and 2
    only; then `steps` steps through train_loop with the launches counted
    (the kernels in `want` and no other), in which the loss must stay
    finite and, when `full`, fall. `negatives`: the raw uniform draws for
    each batch; without them each step's in-batch shifts come from
    state.generator. Returns the state, the launches and the step's ms by
    CUDA events."""
    from score_tpu_torch.train import draw_shifts, train_loop, train_step
    losses, aucs = [], []
    for j in range(WARMUP_STEPS):
        before = _tables(state)
        state, m = train_step(
            state, graph, batches[j], neg_iw=neg_iw,
            negatives=None if negatives is None else negatives[j])
        losses.append(m["loss"])
        aucs.append(round(m["batch_auc"].item(), 5))
        after = dict(state.model.named_parameters())
        changed = any(not torch.equal(v, after[k]) for k, v in before.items())
        if changed != (j % 2 == 0):
            raise AssertionError(f"{tag} step {j}: tables changed={changed}")
    log(f"{tag} warm-up: tables changed on steps 0 and 2 only; batch_auc "
        f"{aucs}")

    # the training run whose launches the counters report
    timed = slice(WARMUP_STEPS, WARMUP_STEPS + steps)
    shifts = negs = None
    if negatives is None:
        shifts = [draw_shifts(state.generator, 1, BATCH)
                  for _ in range(steps)]
    else:
        negs = list(negatives[timed])
    fns = reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    state, ms = train_loop(state, graph, batches[timed], shifts, neg_iw,
                           negatives_list=negs)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    ev_ms = start.elapsed_time(end) / steps
    launches = {k: fn.launches for k, fn in fns.items()}
    log(f"{tag} launches in {steps} steps: {launches}")
    check_launches(tag, launches, want)
    check_table_scatters(tag, state.cfg, launches, timed)
    curve = [x.item() for x in losses] + ms["loss"].tolist()
    if not np.isfinite(curve).all():
        raise AssertionError(f"{tag} non-finite loss: {curve}")
    if full and not np.mean(curve[-10:]) < curve[0]:
        raise AssertionError(f"{tag} the loss did not fall: {curve}")
    log(f"{tag} loss curve ({len(curve)} steps): "
        f"{[round(x, 5) for x in curve]}")
    log(f"{tag} batch_auc of the last step {ms['batch_auc'].item():.4f}")
    log(f"{tag} step {ev_ms:.3f} ms by CUDA events, {wall_ms:.3f} ms by "
        f"wall clock; {BATCH / ev_ms * 1e3:.0f} examples/s (events), "
        f"{BATCH / wall_ms * 1e3:.0f} examples/s (wall) [{card}]")
    log(f"{tag} peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return state, launches, ev_ms


def phase_training(card: str, ds, dev, pool: str = "sum",
                   steps: int = TIMED_STEPS) -> dict:
    """Warm-up, then `steps` timed steps whose launches are counted; with
    50 or more steps the loss must fall and a profile follows."""
    from score_tpu_torch.graph import device_graph
    from score_tpu_torch.params import init_params
    from score_tpu_torch.train import init_state, item_importance_weights
    full = steps >= TIMED_STEPS
    tag = f"[train {pool}]"
    cfg = bench_config("bfloat16", pool=pool)
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(SEED))
    state = init_state(cfg, ds.num_users, ds.num_items, sd, device=dev)
    graph = device_graph(ds.graph, dev)
    neg_iw = torch.from_numpy(
        item_importance_weights(ds.train, ds.num_items)).to(dev)
    batches = _device_batches(ds, WARMUP_STEPS + steps + 6 * full, BATCH,
                              dev)

    state, launches, ev_ms = _train_run(
        card, state, graph, batches, steps, tag, TRAIN_KERNELS[pool], full,
        neg_iw=neg_iw)
    if full:
        _profile(state, graph, batches[-6:], neg_iw, card, ev_ms, tag)
    del state, graph, batches
    torch.cuda.empty_cache()
    return launches


def phase_training_vs_cpu(ds, pool: str = "sum",
                          devices=("cuda", "cpu")) -> list:
    """3 steps of configs3 (co-attention pool `pool`) at its own widths,
    f32, batch 256, on the card and on the CPU from the same weights (the
    co-attention's made non-zero), batches and shifts; the card's losses."""
    return steps_vs_cpu(
        ds, bench_config("float32", width=False, pool=pool),
        f"[train {pool}]", devices, shifts=[[17], [101], [3]])


def steps_vs_cpu(ds, cfg, tag: str, devices=("cuda", "cpu"), shifts=None,
                 negatives=None) -> list:
    """3 steps of `cfg`, f32, batch 256, on the card and on the CPU from
    the same weights (the zero-initialised attention weights made non-zero
    and the tables widened as `random_weights` does: at their init scales
    the attention scores are near 0, the softmaxes near uniform, and every
    co-attention pool gives the same losses), batches and in-batch shifts
    or raw uniform negatives. Returns the first device's losses."""
    from score_tpu_torch.graph import device_graph
    from score_tpu_torch.params import init_params
    from score_tpu_torch.train import (init_state, item_importance_weights,
                                       train_step)
    gen = torch.Generator().manual_seed(SEED + 1)
    sd = init_params(cfg, ds.num_users, ds.num_items, gen)
    for k in sd:
        if k.startswith("coattn.") or k.startswith("slot_attn_"):
            sd[k] = torch.randn(sd[k].shape, generator=gen) * 0.3
        elif "table" in k:
            sd[k] = torch.randn(sd[k].shape, generator=gen) * 0.5
    neg_iw = torch.from_numpy(item_importance_weights(ds.train, ds.num_items))
    batches = _device_batches(ds, 3, 256, "cpu")
    out = {}
    for device in devices:
        # a state on the CPU trains sd's own tensors in place: give it a copy
        state = init_state(cfg, ds.num_users, ds.num_items,
                           {k: v.clone() for k, v in sd.items()},
                           device=device)
        graph = device_graph(ds.graph, device)
        losses = []
        for j, b in enumerate(batches):
            state, m = train_step(
                state, graph, b, shifts and shifts[j], neg_iw.to(device),
                negatives=None if negatives is None else negatives[j])
            losses.append(m["loss"].item())
        out[device] = (losses, {k: v.detach().cpu() for k, v in
                                state.model.named_parameters()})
    card, cpu = (out[d] for d in devices)
    np.testing.assert_allclose(card[0], cpu[0], **LOSS_TOL)
    worst, where = 0.0, None
    for k, want in cpu[1].items():
        got = card[1][k]
        torch.testing.assert_close(got, want, msg=k, **TRAIN_CPU_TOL)
        err = (got - want).abs().max().item()
        if err >= worst:
            worst, where = err, k
    log(f"{tag} f32 card vs cpu, 3 steps of batch 256: losses "
        f"{card[0]} vs {cpu[0]}; params max_abs_err "
        f"{worst:.3e} ({where}; tol {TRAIN_CPU_TOL})")
    return card[0]


def check_pools_differ(tag: str, losses: dict) -> None:
    """Fail unless every two co-attention pools' 3-step losses differ by
    more than the card-against-CPU tolerance: a comparison that cannot tell
    the pools apart cannot see a wrong score path in one of them."""
    pools = sorted(losses)
    for i, a in enumerate(pools):
        for b in pools[i + 1:]:
            if np.allclose(losses[a], losses[b], **LOSS_TOL):
                raise AssertionError(
                    f"{tag} pools {a} and {b} give the same losses "
                    f"{losses[a]} within {LOSS_TOL}")
    log(f"{tag} the pools' 3-step losses differ beyond {LOSS_TOL}")


# --- phase 4b: configs3 past d = 32 ------------------------------------------

WIDE_STEPS, WIDE_MAX_STEPS, WIDE_P50_CALLS = 20, 10, 50


def phase_wide_model(card: str, ds, dev, dim: int, pool: str,
                     profile: bool = False) -> dict:
    """configs3 at embed_dim `dim` (hidden 64, MLP 128/64, bf16 over f32
    master weights, B=4096 in-batch IW, tables every 2nd step at 2x lr, as
    scripts/perf_sweep.py trains b4096_bf16_iw_d64 / _d128) with pool
    `pool`, through the wide kernels: serving (score, score_batch, topk)
    with its launches counted, a 4 x 256 request against the CPU in f32 and
    bf16, and score's p50; training from flax-faithful init, warm-up and
    WIDE_STEPS steps (max: WIDE_MAX_STEPS) with the launches counted, in
    which the loss must fall, and a profile when asked; 3 steps at batch
    256 in f32 on the card and on the CPU. Returns the training launches
    and the card's losses of those 3 steps."""
    from score_tpu_torch.graph import device_graph
    from score_tpu_torch.params import init_params
    from score_tpu_torch.serve import ScoringService
    from score_tpu_torch.train import init_state, item_importance_weights
    tag = f"[d{dim} {pool}]"
    cfg = bench_config("bfloat16", pool=pool, dim=dim)
    sd = random_weights(cfg, ds)
    svc = ScoringService(cfg, ds, sd, device=dev)
    rng = np.random.default_rng(SEED + dim)
    u = int(ds.test.user[0])
    items101 = rng.integers(1, ds.num_items + 1, 101).astype(np.int32)
    users16 = ds.test.user[:ROWS].astype(np.int32)
    items16 = rng.integers(1, ds.num_items + 1, (ROWS, WIDE)).astype(np.int32)
    fns = reset_counts()
    s1 = svc.score(u, items101)
    sb = svc.score_batch(users16, items16)
    top_i, top_s = svc.topk(u, k=10)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in fns.items()}
    log(f"{tag} launches in the serving run: {launches}")
    check_launches(f"{tag} serving", launches, WIDE_SERVE_KERNELS)
    for name, arr, shape in (("score", s1, (101,)),
                             ("score_batch", sb, (ROWS, WIDE)),
                             ("topk", top_s, (10,))):
        if arr.shape != shape or not np.isfinite(arr).all():
            raise AssertionError(f"{tag} {name}: shape {arr.shape} or "
                                 f"non-finite")
    if not (np.all(np.diff(top_s) <= 0) and np.all(top_i >= 1)):
        raise AssertionError(f"{tag} topk is not sorted over real items")
    np.testing.assert_allclose(svc.score(u, top_i), top_s,
                               **CPU_TOL["bfloat16"])
    lat = []
    for _ in range(WIDE_P50_CALLS):
        t0 = time.perf_counter()
        svc.score(u, items101)
        lat.append(time.perf_counter() - t0)
    log(f"{tag} score std {s1.std():.4f}; score(u, 101) p50 "
        f"{statistics.median(lat) * 1e3:.3f} ms of {WIDE_P50_CALLS} calls "
        f"[{card}]")
    serve_vs_cpu(ds, lambda dtype: bench_config(dtype, pool=pool, dim=dim),
                 sd, rng, tag, dev, card_bf16=svc)
    del svc
    torch.cuda.empty_cache()

    steps = WIDE_MAX_STEPS if pool == "max" else WIDE_STEPS
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(SEED))
    state = init_state(cfg, ds.num_users, ds.num_items, sd, device=dev)
    graph = device_graph(ds.graph, dev)
    neg_iw = torch.from_numpy(
        item_importance_weights(ds.train, ds.num_items)).to(dev)
    batches = _device_batches(ds, WARMUP_STEPS + steps + 6 * profile, BATCH,
                              dev)
    state, launches, ev_ms = _train_run(card, state, graph, batches, steps,
                                        tag, WIDE_TRAIN_KERNELS[pool],
                                        neg_iw=neg_iw)
    if profile:
        _profile(state, graph, batches[-6:], neg_iw, card, ev_ms, tag)
    del state, graph, batches
    torch.cuda.empty_cache()
    losses = steps_vs_cpu(ds, bench_config("float32", pool=pool, dim=dim),
                          tag, (dev, "cpu"), shifts=[[17], [101], [3]])
    return launches, losses


# --- phase 5: eval ---------------------------------------------------------

def _eval_model(cfg, ds, sd, device):
    from score_tpu_torch.nn.model import ScoreModel
    model = ScoreModel(cfg.model, ds.num_users, ds.num_items)
    model.load_state_dict({k: v.to(device) for k, v in sd.items()},
                          assign=True)
    return model


def phase_eval(card: str, ds, dev) -> None:
    """The streaming evaluate of the max-pool model: bf16 at the bench
    width over EVAL_TARGETS validation targets (timed), and f32 on
    EVAL_CPU_TARGETS targets on the card and on the CPU."""
    from score_tpu_torch.graph import device_graph
    from score_tpu_torch.train import evaluate, make_eval_step
    cfg = bench_config("bfloat16", pool="max")
    sd = random_weights(cfg, ds)
    graph = device_graph(ds.graph, dev)
    step = make_eval_step(_eval_model(cfg, ds, sd, dev))
    evaluate(step, graph, ds.val, EVAL_BATCH, max_targets=EVAL_BATCH)  # warm
    fns = reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = evaluate(step, graph, ds.val, EVAL_BATCH, max_targets=EVAL_TARGETS)
    secs = time.perf_counter() - t0           # evaluate reads back at its end
    launches = {k: fn.launches for k, fn in fns.items()}
    log(f"[eval] launches: {launches}")
    check_launches("eval, pool max", launches, SERVE_KERNELS["max"])
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in got.values()):
        raise AssertionError(f"eval metrics out of range: {got}")
    n_neg = ds.val.neg.shape[1]
    log(f"[eval] max pool bf16, {EVAL_TARGETS} val targets x (1 + {n_neg}), "
        f"batch {EVAL_BATCH}: {secs:.4f} s, {EVAL_TARGETS / secs:.0f} "
        f"targets/s [{card}]")
    log(f"[eval] metrics "
        f"{json.dumps({k: round(v, 6) for k, v in got.items()})}")
    del step, graph

    cfg32 = bench_config("float32", pool="max")
    on_card, on_cpu = (
        evaluate(make_eval_step(_eval_model(cfg32, ds, sd, device)),
                 device_graph(ds.graph, device), ds.val, EVAL_BATCH,
                 max_targets=EVAL_CPU_TARGETS)
        for device in (dev, torch.device("cpu")))
    worst = 0.0
    for k, want in on_cpu.items():
        err = abs(on_card[k] - want)
        if err > (EVAL_AUC_TOL if k == "auc" else EVAL_TOL):
            raise AssertionError(f"eval {k}: card {on_card[k]} vs cpu {want}")
        worst = max(worst, err)
    log(f"[eval] f32 card vs cpu on {EVAL_CPU_TARGETS} targets: max |diff| "
        f"{worst:.3e} (tol {EVAL_TOL}, auc {EVAL_AUC_TOL}); card "
        f"{json.dumps({k: round(v, 6) for k, v in on_card.items()})}")
    torch.cuda.empty_cache()


# --- phase 6: the training driver, checkpoints, serving from them ----------

# the CLI's overrides: configs3 as bench.py trains it, one epoch
DRIVER_ARGS = ("model.embed_dim=32", "model.hidden_dim=64",
               "model.mlp_dims=128,64", "model.compute_dtype=bfloat16",
               "data.train_neg_mode=inbatch_iw", f"train.batch_size={BATCH}",
               "train.table_update_every=2", "train.table_lr_boost=2.0",
               "train.num_epochs=1", "train.eval_every_steps=100",
               f"train.eval_max_targets={EVAL_TARGETS}")
DRIVER_TIMEOUT_S = 300
TOPK_USERS = 16


def phase_driver(card: str, ds, dev, work: str) -> str:
    """The driver phase in the directory `work`; returns the directory of
    the saved bench dataset, which phase 7's CLI reuses."""
    from score_tpu_torch.checkpoint import CheckpointManager, apply_restore
    from score_tpu_torch.config import apply_overrides, configs3
    from score_tpu_torch.data.schema import save_dataset
    from score_tpu_torch.serve import ScoringService
    from score_tpu_torch.train import init_state, train
    spe = len(ds.train) // BATCH
    data_dir, ck = os.path.join(work, "data"), os.path.join(work, "ck")
    t0 = time.perf_counter()
    save_dataset(ds, data_dir, compress=False)
    log(f"[driver] bench dataset saved (uncompressed) in "
        f"{time.perf_counter() - t0:.2f} s")

    # the CLI, one epoch, in its own process
    args = [*DRIVER_ARGS, f"train.checkpoint_dir={ck}"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "score_tpu_torch.train", "configs3",
         data_dir, *args], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=DRIVER_TIMEOUT_S,
        env=dict(os.environ, PYTHONUNBUFFERED="1"))
    cli_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"[driver] cli: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"the CLI exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    if sum(line.startswith("test: auc") for line in lines) != 1:
        raise AssertionError("the CLI printed no test line")
    cli_val = [float(line.split()[5]) for line in lines
               if line.startswith("  val @ step")]
    log(f"[driver] cli: exit 0 in {cli_s:.1f} s of wall clock, "
        f"{spe} steps; val auc by step {cli_val} [{card}]")

    # the second epoch in this process, resuming from the CLI's latest
    cfg = apply_overrides(configs3(), dict(
        a.split("=", 1) for a in (*args, "train.num_epochs=2")))
    rows_path = os.path.join(work, "log.jsonl")
    fns = reset_counts()
    out = train(cfg, ds, log_path=rows_path, device=dev)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in fns.items()}
    log(f"[driver] launches in the resumed run: {launches}")
    check_launches("driver, sum pool", launches, TRAIN_KERNELS["sum"])
    tm = out["timing"]
    if tm["start_step"] != spe or out["steps_run"] != 2 * spe:
        raise AssertionError(f"resumed at {tm['start_step']} and ran "
                             f"to {out['steps_run']}; expected {spe} "
                             f"and {2 * spe}")
    rows = [json.loads(line) for line in open(rows_path)]
    vals = [r for r in rows if r["split"] == "val"]
    if (not vals or any(r["step"] <= spe for r in vals)
            or [r["split"] for r in rows][-1] != "test"
            or not all(np.isfinite(v) for r in rows for k, v in r.items()
                       if k not in ("step", "split"))):
        raise AssertionError(f"bad JSONL rows: {rows}")
    log(f"[driver] resumed at step {tm['start_step']}, ran to "
        f"{out['steps_run']}: {tm['steps']} steps in "
        f"{tm['train_s']:.3f} s, {tm['steps'] / tm['train_s']:.2f} "
        f"steps/s ({BATCH * tm['steps'] / tm['train_s']:.0f} "
        f"examples/s); {len(tm['val_s'])} vals of {EVAL_TARGETS} "
        f"targets, {statistics.mean(tm['val_s']):.3f} s each "
        f"({[round(v, 3) for v in tm['val_s']]}); test eval of "
        f"{len(ds.test)} targets {tm['test_s']:.3f} s [{card}]")
    log(f"[driver] val auc by step "
        f"{[(r['step'], round(r['auc'], 4)) for r in vals]}; best "
        f"{out['best_val_auc']:.4f} at step {out['best_step']}; test "
        f"{json.dumps({k: round(v, 4) for k, v in out['test'].items()})}")

    # one checkpoint's save and restore
    state = init_state(cfg, ds.num_users, ds.num_items,
                       {k: v.clone() for k, v in out["params"].items()},
                       device=dev)
    mgr = CheckpointManager(os.path.join(work, "timed"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save("latest", state, (1, 0), 0.5, 2 * spe)
    snap_s = time.perf_counter() - t0
    mgr.wait()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    apply_restore(state, mgr.restore("latest", state))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    size = os.path.getsize(mgr.path("latest"))
    log(f"[driver] checkpoint {size} bytes: save {save_s:.3f} s "
        f"({snap_s:.3f} s until the step may go on), restore "
        f"{restore_s:.3f} s [{card}]")
    del state

    # serving the best checkpoint
    fns = reset_counts()
    svc = ScoringService.from_checkpoint(cfg, ds, ck, which="best",
                                         device=dev)
    ref = ScoringService(cfg, ds, out["params"], device=dev)
    rng = np.random.default_rng(SEED + 6)
    users4 = ds.test.user[:4].astype(np.int32)
    items4 = rng.integers(1, ds.num_items + 1, (4, 256)).astype(np.int32)
    got, want = svc.score_batch(users4, items4), ref.score_batch(
        users4, items4)
    if not np.array_equal(got, want):
        raise AssertionError(
            f"from_checkpoint scores differ from train()'s weights': "
            f"max |diff| {np.abs(got - want).max():.3e}")
    log("[driver] from_checkpoint('best') 4x256: bit-equal to a "
        "service on train()'s returned weights")
    users = np.unique(ds.test.user)[:TOPK_USERS].astype(np.int32)
    svc.topk_batch(users[:2], k=10)                  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bi, bs = svc.topk_batch(users, k=10)
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    singles = [svc.topk(int(u), k=10) for u in users]
    single_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    check_launches("driver serving, sum pool", launches,
                   SERVE_KERNELS["sum"])
    for r, (ti, ts) in enumerate(singles):
        if not (np.array_equal(np.sort(bs[r]), np.sort(ts))
                and (bi[r] >= 1).all() and np.all(np.diff(bs[r]) <= 0)):
            raise AssertionError(f"topk_batch user {users[r]}: "
                                 f"{bs[r]} vs topk {ts}")
    log(f"[driver] topk_batch of {TOPK_USERS} users over "
        f"{ds.num_items} items: score multisets equal to {TOPK_USERS} "
        f"topk calls; {batch_s:.4f} s, {batch_s / TOPK_USERS:.4f} s a "
        f"user (topk: {single_s / TOPK_USERS:.4f} s a user) [{card}]")
    del svc, ref
    torch.cuda.empty_cache()
    return data_dir


# --- phase 7: the preset ladder with its uniform negatives ------------------

LADDER = ("configs0", "configs1", "configs2", "configs3")
# configs0-2 run no co-attention; configs3 its candidates kernels (sum pool)
LADDER_KERNELS = {rung: {"gather_rows", "scatter_add_rows"}
                  for rung in LADDER[:3]}
LADDER_KERNELS["configs3"] = TRAIN_KERNELS["sum"]
# the CLI's overrides: the bench width and batch, one epoch; the preset's
# own negatives (no train_neg_mode)
LADDER_CLI_ARGS = ("model.embed_dim=32", "model.hidden_dim=64",
                   "model.mlp_dims=128,64", "model.compute_dtype=bfloat16",
                   f"train.batch_size={BATCH}", "train.table_update_every=2",
                   "train.table_lr_boost=2.0", "train.num_epochs=1",
                   f"train.eval_max_targets={EVAL_TARGETS}")


def phase_ladder_rung(card: str, ds, dev, rung: str) -> dict:
    """Preset `rung` at the bench width with its uniform negatives:
    `_train_run`'s warm-up and 50 counted steps, in which the loss must
    fall; a val on EVAL_TARGETS targets; a torch.profiler window; serving
    card against CPU; 3 small f32 steps card against CPU from the same raw
    negatives."""
    from score_tpu_torch.graph import device_graph
    from score_tpu_torch.params import init_params
    from score_tpu_torch.train import (draw_negatives, evaluate, init_state,
                                       make_eval_step)
    tag = f"[ladder {rung}]"
    cfg = ladder_config(rung, "bfloat16")
    if cfg.data.train_neg_mode != "uniform":
        raise AssertionError(f"{rung}: negatives {cfg.data.train_neg_mode}")
    k = cfg.data.num_train_neg
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(SEED))
    state = init_state(cfg, ds.num_users, ds.num_items, sd, device=dev)
    graph = device_graph(ds.graph, dev)
    batches = _device_batches(ds, WARMUP_STEPS + TIMED_STEPS + 6, BATCH,
                              dev)
    # raw draws on the host, staged once
    negs = torch.stack([draw_negatives(state.generator, BATCH, k,
                                       ds.num_items)
                        for _ in batches]).to(dev)
    state, _, ev_ms = _train_run(card, state, graph, batches, TIMED_STEPS,
                                 tag, LADDER_KERNELS[rung], negatives=negs)

    t0 = time.perf_counter()
    val = evaluate(make_eval_step(state.model), graph, ds.val,
                   max_targets=EVAL_TARGETS)
    val_s = time.perf_counter() - t0
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in val.values()):
        raise AssertionError(f"{tag} val metrics out of range: {val}")
    log(f"{tag} val after {WARMUP_STEPS + TIMED_STEPS} steps, "
        f"{EVAL_TARGETS} targets: auc {val['auc']:.4f} ndcg@10 "
        f"{val['ndcg@10']:.4f} in {val_s:.3f} s [{card}]")
    _profile(state, graph, batches[-6:], None, card, ev_ms, tag,
             negatives=negs[-6:])
    del state, graph, batches, negs
    torch.cuda.empty_cache()

    serve_vs_cpu(ds, lambda dtype: ladder_config(rung, dtype),
                 random_weights(cfg, ds), np.random.default_rng(SEED + 7),
                 tag, dev)
    small = ladder_config(rung, "float32", width=False)
    gen = torch.Generator().manual_seed(SEED + 2)
    raw = [draw_negatives(gen, 256, small.data.num_train_neg, ds.num_items)
           for _ in range(3)]
    steps_vs_cpu(ds, small, tag, (dev, "cpu"), negatives=raw)
    return dict(step_ms=ev_ms, val_auc=val["auc"])


def phase_ladder(card: str, ds, dev, data_dir: str) -> None:
    """Phase 7: every rung of the ladder, then the configs0 CLI for one
    epoch on the saved bench dataset, in a subprocess."""
    t_phase = time.perf_counter()
    out = {rung: phase_ladder_rung(card, ds, dev, rung) for rung in LADDER}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "score_tpu_torch.train", "configs0", data_dir,
         *LADDER_CLI_ARGS], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=DRIVER_TIMEOUT_S,
        env=dict(os.environ, PYTHONUNBUFFERED="1"))
    cli_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"[ladder] cli configs0: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"the configs0 CLI exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    if sum(line.startswith("test: auc")
           for line in proc.stdout.splitlines()) != 1:
        raise AssertionError("the configs0 CLI printed no test line")
    log(f"[ladder] cli configs0: exit 0 in {cli_s:.1f} s of wall clock "
        f"[{card}]")
    log(f"[ladder] {json.dumps(out)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    phase_device(card)
    mark("[device]")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gather = phase_gather(card, dev, gen)
    coattn = phase_coattn(card, dev, gen)
    pair = phase_coattn_pair(card, dev, gen)
    ds = bench_dataset()
    scatter = phase_scatter(card, dev, gen, ds)
    coattn_bwd = phase_coattn_bwd(card, dev, gen)
    pair_bwd = phase_coattn_pair_bwd(card, dev, gen)
    mark("the tuned kernels' phases and [data]")
    wide = phase_coattn_wide(card, dev, gen)
    mark("[coattn_wide]")
    for pool in ("sum", "max", "mean"):
        phase_serving(card, ds, pool)
    launches = phase_training(card, ds, dev)              # sum pool
    launches_pair = phase_training(card, ds, dev, "mean")
    phase_training(card, ds, dev, "max", steps=MAX_POOL_STEPS)
    check_pools_differ("[train]", {pool: phase_training_vs_cpu(ds, pool)
                                   for pool in ("sum", "mean", "max")})
    mark("[serve] and [train]")
    launches_wide, losses = phase_wide_model(card, ds, dev, 64, "sum",
                                             profile=True)
    wide_losses = {"sum": losses}
    for pool in ("mean", "max"):
        wide_losses[pool] = phase_wide_model(card, ds, dev, 64, pool)[1]
    check_pools_differ("[d64]", wide_losses)
    phase_wide_model(card, ds, dev, 128, "sum")
    mark("[d64] and [d128]")
    phase_eval(card, ds, dev)
    with tempfile.TemporaryDirectory() as work:
        data_dir = phase_driver(card, ds, dev, work)
        mark("[eval] and [driver]")
        phase_ladder(card, ds, dev, data_dir)
    mark("[ladder]")
    kernels = [
        dict(name="gather_rows", route="cuda",
             source="score_tpu_torch/csrc/gather.cu",
             replaces="score_tpu/kernels/gather.py:67",
             launches=launches["gather_rows"], **gather),
        dict(name="scatter_add_rows", route="cuda",
             source="score_tpu_torch/csrc/scatter_add.cu",
             replaces="score_tpu/kernels/gather.py:67 (its transpose, "
                      "XLA's scatter-add)",
             launches=launches["scatter_add_rows"], **scatter),
        dict(name="cross_coattn_cand", route="cuda",
             source="score_tpu_torch/csrc/coattn_cand.cu",
             replaces="score_tpu/kernels/coattn_cand.py:275",
             launches=launches["cross_coattn_cand"], **coattn),
        dict(name="cross_coattn_cand_bwd", route="cuda",
             source="score_tpu_torch/csrc/coattn_cand_bwd.cu",
             replaces="score_tpu/kernels/coattn_cand.py:301",
             launches=launches["cross_coattn_cand_bwd"], **coattn_bwd),
        dict(name="cross_coattn_pair", route="cuda",
             source="score_tpu_torch/csrc/coattn_pair.cu",
             replaces="score_tpu/kernels/coattn.py:110",
             launches=launches_pair["cross_coattn_pair"], **pair),
        dict(name="cross_coattn_pair_bwd", route="cuda",
             source="score_tpu_torch/csrc/coattn_pair_bwd.cu",
             replaces="score_tpu/kernels/coattn.py:241",
             launches=launches_pair["cross_coattn_pair_bwd"], **pair_bwd),
        dict(name="cross_coattn_wide", route="cuda",
             source="score_tpu_torch/csrc/coattn_wide.cu",
             replaces="score_tpu/kernels/coattn_cand.py:275 and "
                      "score_tpu/kernels/coattn.py:110 past d, n, m = 32",
             launches=launches_wide["cross_coattn_wide"], **wide["fwd"]),
        dict(name="cross_coattn_wide_bwd", route="cuda",
             source="score_tpu_torch/csrc/coattn_wide.cu",
             replaces="score_tpu/kernels/coattn_cand.py:301 and "
                      "score_tpu/kernels/coattn.py:241 past d, n, m = 32",
             launches=launches_wide["cross_coattn_wide_bwd"], **wide["bwd"]),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
