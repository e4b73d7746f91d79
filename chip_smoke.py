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
2b. Backward kernels against their plain versions. The scatter-add is
   exact on integer-valued sources and within 1e-5 relative of
   `index_add_` on random ones (f32 atomics add in no fixed order); the
   co-attention backwards' ([coattn_bwd] sum; [coattn_pair_bwd] sum and
   mean) five gradients agree to 1e-4 in f32 and 2e-2 in bf16, relative
   to each gradient's largest value.
   For every kernel: CUDA-event times of kernel, plain version and, where
   one PyTorch call computes the same function, that call; and the bound,
   the least time the card could take for the work (bytes over 3.35 TB/s
   or f32 operations over 67 TFLOP/s, whichever is larger).
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
   train_loop with the kernels' launches counted: 50 steps with the sum
   pool (gather, scatter-add, candidates forward and backward) and with
   the mean pool (gather, scatter-add, per-pair forward and backward), in
   which the loss must fall, each with a torch.profiler window of device
   time by op; 10 steps with the max pool (per-pair forward; the backward
   is the recompute VJP), whose loss must stay finite. Then, per pool, 3
   steps of a small f32 model (configs3's default widths, batch 256) on
   the card and on the CPU from the same weights, batches and shifts must
   agree.
5. Eval: the streaming `evaluate` of the max-pool model at the bench
   width, bf16, batch 256, over 8192 validation targets x (1 + 100)
   candidates: targets/s and the metrics; and in f32 on 512 targets, the
   card's metrics against the CPU's (ranking metrics 1e-4, AUC 1e-3, as
   tests/test_torch_eval.py holds the port to the JAX package).

The line before the last lists each kernel with its launches in the
training run of its path (the sum-pool run for the gather, scatter-add and
candidates kernels, the mean-pool run for the per-pair kernels), its
largest error against the plain version, and its, the plain version's and
the library call's time beside its bound (the candidates forward also
gives its time and bound at the training shape, B=4096 C=2, where its
launches are counted, and the per-pair forward its mean pool's there, by
CUDA graph); the last line is
{"ok": true, "device": {...}}. Every timing line carries the card's name
and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
T, FAN, D = 9, 10, 32                 # bench.py's slots, fan-out, width
USERS, ITEMS, EVENTS = 50_000, 100_000, 2_000_000
ROWS, WIDE = 16, 4096                 # score_batch: 16 users x 4096 items
BATCH = 4096                          # bench.py's training batch
WARMUP_STEPS, TIMED_STEPS, MAX_POOL_STEPS = 3, 50, 10
EVAL_TARGETS, EVAL_CPU_TARGETS, EVAL_BATCH = 8192, 512, 256
F32_TOL = 1e-4
BF16_TOL = 2e-2
CPU_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
           "bfloat16": dict(rtol=2e-2, atol=2e-3)}
TRAIN_CPU_TOL = dict(rtol=1e-4, atol=1e-5)
EVAL_TOL, EVAL_AUC_TOL = 1e-4, 1e-3
# the card's published peaks (H100 SXM): HBM bytes/s, f32 outside the
# tensor cores (the kernels here do f32 FMAs on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def log(*args) -> None:
    print(*args, flush=True)


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


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: compulsory bytes at the HBM
    rate or f32 operations at the peak rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --- phase 1 ---------------------------------------------------------------

_BWD_INSTANCE = re.compile(
    r"coattn_bwd_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])ELi(\d+)E")
_FWD_INSTANCE = re.compile(
    r"cand_fwd_kernelI(f|13__nv_bfloat16)Lb([01])ELb([01])ELi(\d)ELi(\d+)E")


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

def phase_gather(card: str, dev, gen) -> dict:
    from score_tpu_torch.kernels.gather import gather_rows, gather_rows_plain
    cases = [  # (label, table, ids); shapes as serving and training give
        ("bf16 [100032,32] ids [16,4096,9,10]",
         torch.randn(100032, D, generator=gen, device=dev).bfloat16(),
         (16, 4096, T, FAN)),
        ("f32 [90560,32] ids [4096,9,10] (training)",
         torch.randn(90560, D, generator=gen, device=dev), (BATCH, T, FAN)),
        ("f32 [100032,32] ids [1000003]",
         torch.randn(100032, D, generator=gen, device=dev), (1000003,)),
        ("int32 [150000,90] ids [16,4096]",
         torch.randint(0, 1 << 30, (150000, T * FAN), generator=gen,
                       device=dev, dtype=torch.int32), (16, 4096)),
        ("int32 [150000,9] ids [65537]",
         torch.randint(0, 1 << 30, (150000, T), generator=gen, device=dev,
                       dtype=torch.int32), (65537,)),
    ]
    worst = 0.0
    line = None
    for label, table, shape in cases:
        ids = torch.randint(0, table.shape[0], shape, generator=gen,
                            device=dev, dtype=torch.int32)
        got = gather_rows(table, ids)
        want = gather_rows_plain(table, ids)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gather {label}: kernel != plain")
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        ms = cuda_ms(lambda: gather_rows(table, ids))
        plain_ms = cuda_ms(lambda: gather_rows_plain(table, ids))
        flat = ids.reshape(-1)
        lib_ms = cuda_ms(lambda: torch.index_select(table, 0, flat))
        rows = torch.unique(ids).numel()        # the rows this run reads
        b = bound(rows * table.shape[1] * table.element_size()
                  + nbytes(ids, got), 0)
        log(f"[gather] {label}: exact, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, index_select {lib_ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]")
        if line is None:
            line = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **b)
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
    """Compulsory bytes and f32 operations of the per-pair forward on these
    inputs: masked rows need not be read; EuW = Eu Wr once per valid user
    row; the max pool's relation entries only for valid (j, k) pairs."""
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
        # relation entries; per row the target term and the weighted sum
        flops += 2 * d * pairs + 4 * d * (C * vu + vi)
    else:
        # per user row: score with the target folded in, weighted sum; per
        # item row: the masked sum, score, weighted sum
        flops += 6 * d * C * vu + 5 * d * vi
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

def phase_scatter(card: str, dev, gen) -> dict:
    from score_tpu_torch.kernels.gather import (scatter_add_rows,
                                                scatter_add_rows_plain)
    # training's four table gradients: (table rows, ids shape)
    cases = [("item [90560,32] ids [4096,9,10]", 90560, (BATCH, T, FAN)),
             ("item [90560,32] ids [4096,1]", 90560, (BATCH, 1)),
             ("user [50048,32] ids [4096,1,9,10]", 50048, (BATCH, 1, T, FAN)),
             ("user [50048,32] ids [4096]", 50048, (BATCH,))]
    worst = 0.0
    line = None
    for label, V, shape in cases:
        ids = torch.randint(1, V, shape, generator=gen, device=dev,
                            dtype=torch.int32)
        pad = torch.rand(shape, generator=gen, device=dev) < 0.3
        ids[pad] = 0        # masked neighbour slots: pad id, zero gradient
        ints = torch.randint(-8, 9, shape + (D,), generator=gen,
                             device=dev).float()
        ints[pad] = 0.0
        got = scatter_add_rows(ids, ints, V)
        if not torch.equal(got, scatter_add_rows_plain(ids, ints, V)):
            raise AssertionError(f"scatter_add {label}: integer sums "
                                 f"differ from the plain version")
        src = torch.randn(shape + (D,), generator=gen, device=dev)
        src[pad] = 0.0
        got = scatter_add_rows(ids, src, V)
        want = scatter_add_rows_plain(ids, src, V)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        ms = cuda_ms(lambda: scatter_add_rows(ids, src, V))
        plain_ms = cuda_ms(lambda: scatter_add_rows_plain(ids, src, V))
        zeros = torch.zeros(V, D, device=dev)
        flat_ids, flat_src = ids.reshape(-1), src.reshape(-1, D)
        lib_ms = cuda_ms(lambda: torch.index_add(zeros, 0, flat_ids,
                                                 flat_src))
        b = bound(nbytes(src, ids, got), (src != 0).sum().item())
        log(f"[scatter] {label}: integer sums exact, random max_abs_err "
            f"{err:.3e} (tol 1e-5 rel), kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, index_add {lib_ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]")
        if line is None:
            line = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **b)
        del ids, ints, src, got, want, zeros
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, **line)


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


def bench_config(dtype: str, width: bool = True, pool: str = "sum"):
    """configs3 as bench.py trains it, with co-attention pool `pool`;
    width=False keeps configs3's own (smaller) widths."""
    from score_tpu_torch.config import configs3
    cfg = configs3()
    model = dict(compute_dtype=dtype, coattn_pool=pool)
    if width:
        model.update(embed_dim=D, hidden_dim=64, mlp_dims=(128, 64))
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **model),
        data=dataclasses.replace(cfg.data, train_neg_mode="inbatch_iw"),
        train=dataclasses.replace(cfg.train, batch_size=BATCH,
                                  table_update_every=2, table_lr_boost=2.0))


def random_weights(cfg, ds) -> dict:
    """Flax-faithful init from a seed; then the zero-initialised attention
    weights (Wr, Wtu, Wti, both pooling W) made non-zero and the tables
    widened, so the co-attention and pooling scores are far from
    uniform and the score path is exercised."""
    from score_tpu_torch.params import init_params
    gen = torch.Generator().manual_seed(SEED)
    sd = init_params(cfg, ds.num_users, ds.num_items, gen)
    for k in ("coattn.wr", "coattn.wtu", "coattn.wti", "pool_u.w",
              "pool_i.w"):
        sd[k] = torch.randn(sd[k].shape, generator=gen) * 0.3
    for k in ("tables.user_table", "tables.item_table"):
        sd[k] = torch.randn(sd[k].shape, generator=gen) * 0.5
    return sd


def reset_counts() -> dict:
    """Every kernel's launch counter, by kernel name, set to 0."""
    from score_tpu_torch.kernels.coattn import (cross_coattn_pair,
                                                cross_coattn_pair_bwd)
    from score_tpu_torch.kernels.coattn_cand import (cross_coattn_cand,
                                                     cross_coattn_cand_bwd)
    from score_tpu_torch.kernels.gather import gather_rows, scatter_add_rows
    fns = dict(gather_rows=gather_rows, scatter_add_rows=scatter_add_rows,
               cross_coattn_cand=cross_coattn_cand,
               cross_coattn_cand_bwd=cross_coattn_cand_bwd,
               cross_coattn_pair=cross_coattn_pair,
               cross_coattn_pair_bwd=cross_coattn_pair_bwd)
    for fn in fns.values():
        fn.launches = 0
    return fns


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

    # the card against the CPU's plain path, same weights, 4 x 256
    users4 = ds.test.user[ROWS:ROWS + 4].astype(np.int32)
    items4 = rng.integers(1, ds.num_items + 1, (4, 256)).astype(np.int32)
    for dtype in ("float32", "bfloat16"):
        c = bench_config(dtype, pool=pool)
        gpu = svc if dtype == "bfloat16" else ScoringService(
            c, ds, sd, device=device)
        cpu = ScoringService(c, ds, sd, device="cpu")
        got, want = gpu.score_batch(users4, items4), cpu.score_batch(
            users4, items4)
        np.testing.assert_allclose(got, want, **CPU_TOL[dtype])
        log(f"[serve {pool}] {dtype} card vs cpu 4x256: max_abs_err "
            f"{np.abs(got - want).max():.3e} (tol {CPU_TOL[dtype]})")
        del gpu, cpu

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
             tag: str = "[train]") -> None:
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
            train_step(state, graph, b, neg_iw=neg_iw, with_auc=False)
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


def phase_training(card: str, ds, dev, pool: str = "sum",
                   steps: int = TIMED_STEPS) -> dict:
    """Warm-up, then `steps` timed steps whose launches are counted; with
    50 or more steps the loss must fall and a profile follows."""
    from score_tpu_torch.graph import device_graph
    from score_tpu_torch.params import init_params
    from score_tpu_torch.train import (draw_shifts, init_state,
                                       item_importance_weights, train_loop,
                                       train_step)
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

    # warm-up: tables change on steps 0 and 2 only
    losses, aucs = [], []
    for j in range(WARMUP_STEPS):
        before = _tables(state)
        state, m = train_step(state, graph, batches[j], neg_iw=neg_iw)
        losses.append(m["loss"])
        aucs.append(round(m["batch_auc"].item(), 5))
        after = dict(state.model.named_parameters())
        changed = any(not torch.equal(v, after[k]) for k, v in before.items())
        if changed != (j % 2 == 0):
            raise AssertionError(f"step {j}: tables changed={changed}")
    log(f"{tag} warm-up: tables changed on steps 0 and 2 only; batch_auc "
        f"{aucs}")

    # the training run whose launches the counters report
    timed = batches[WARMUP_STEPS:WARMUP_STEPS + steps]
    shifts = [draw_shifts(state.generator, 1, BATCH) for _ in timed]
    fns = reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    state, ms = train_loop(state, graph, timed, shifts, neg_iw)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    ev_ms = start.elapsed_time(end) / steps
    launches = {k: fn.launches for k, fn in fns.items()}
    log(f"{tag} launches in {steps} steps: {launches}")
    check_launches(f"training, pool {pool}", launches, TRAIN_KERNELS[pool])
    curve = [x.item() for x in losses] + ms["loss"].tolist()
    if not np.isfinite(curve).all():
        raise AssertionError(f"non-finite loss: {curve}")
    if full and not np.mean(curve[-10:]) < curve[0]:
        raise AssertionError(f"the loss did not fall: {curve}")
    log(f"{tag} loss curve ({len(curve)} steps): "
        f"{[round(x, 5) for x in curve]}")
    log(f"{tag} batch_auc of the last step {ms['batch_auc'].item():.4f}")
    log(f"{tag} step {ev_ms:.3f} ms by CUDA events, {wall_ms:.3f} ms by "
        f"wall clock; {BATCH / ev_ms * 1e3:.0f} examples/s (events), "
        f"{BATCH / wall_ms * 1e3:.0f} examples/s (wall) [{card}]")
    log(f"{tag} peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if full:
        _profile(state, graph, batches[-6:], neg_iw, card, ev_ms, tag)
    del state, graph, batches
    torch.cuda.empty_cache()
    return launches


def phase_training_vs_cpu(ds, pool: str = "sum",
                          devices=("cuda", "cpu")) -> None:
    """3 steps of configs3 (co-attention pool `pool`) at its own widths,
    f32, batch 256, on the card and on the CPU from the same weights (the
    co-attention's made non-zero), batches and shifts."""
    from score_tpu_torch.graph import device_graph
    from score_tpu_torch.params import init_params
    from score_tpu_torch.train import (init_state, item_importance_weights,
                                       train_step)
    cfg = bench_config("float32", width=False, pool=pool)
    gen = torch.Generator().manual_seed(SEED + 1)
    sd = init_params(cfg, ds.num_users, ds.num_items, gen)
    # non-zero co-attention weights: at their zero init every pool scores
    # the same (a zero relation matrix)
    for k in ("coattn.wr", "coattn.wtu", "coattn.wti"):
        sd[k] = torch.randn(sd[k].shape, generator=gen) * 0.3
    neg_iw = torch.from_numpy(item_importance_weights(ds.train, ds.num_items))
    batches = _device_batches(ds, 3, 256, "cpu")
    shifts = [[17], [101], [3]]
    out = {}
    for device in devices:
        state = init_state(cfg, ds.num_users, ds.num_items, sd, device=device)
        graph = device_graph(ds.graph, device)
        losses = []
        for b, s in zip(batches, shifts):
            state, m = train_step(state, graph, b, s, neg_iw.to(device))
            losses.append(m["loss"].item())
        out[device] = (losses, {k: v.detach().cpu() for k, v in
                                state.model.named_parameters()})
    card, cpu = (out[d] for d in devices)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5, atol=1e-6)
    worst, where = 0.0, None
    for k, want in cpu[1].items():
        got = card[1][k]
        torch.testing.assert_close(got, want, msg=k, **TRAIN_CPU_TOL)
        err = (got - want).abs().max().item()
        if err >= worst:
            worst, where = err, k
    log(f"[train {pool}] f32 card vs cpu, 3 steps of batch 256: losses "
        f"{card[0]} vs {cpu[0]}; params max_abs_err "
        f"{worst:.3e} ({where}; tol {TRAIN_CPU_TOL})")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    phase_device(card)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gather = phase_gather(card, dev, gen)
    coattn = phase_coattn(card, dev, gen)
    pair = phase_coattn_pair(card, dev, gen)
    scatter = phase_scatter(card, dev, gen)
    coattn_bwd = phase_coattn_bwd(card, dev, gen)
    pair_bwd = phase_coattn_pair_bwd(card, dev, gen)
    ds = bench_dataset()
    for pool in ("sum", "max", "mean"):
        phase_serving(card, ds, pool)
    launches = phase_training(card, ds, dev)              # sum pool
    launches_pair = phase_training(card, ds, dev, "mean")
    phase_training(card, ds, dev, "max", steps=MAX_POOL_STEPS)
    for pool in ("sum", "mean", "max"):
        phase_training_vs_cpu(ds, pool)
    phase_eval(card, ds, dev)
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
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
