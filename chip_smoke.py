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
   atomics add in no fixed order). Its bf16 form (bf16 tables: an f32
   workspace, one rounding pass) on configs3's in-batch segments rounded
   to bf16: within 1 bf16 ulp of the f64 sum rounded, beside bf16
   `index_add_`, and its grouped backward a memset, the scatter kernel
   and the rounding kernel only; the
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
8. The baseline roster ([roster]): the eight `baseline_*` presets (MF,
   popularity, SVD++, DELF, GRU4Rec, Caser, SASRec, RRN), each as phase 7
   runs a rung (the bench width, bf16, B=4096, stride 2 at 2x lr, its
   uniform negatives): 3 warm-up and 50 counted steps in which the loss
   must fall, with the gather's launches a step and the scatter-adds a
   table-update step counted against `ROSTER` and no co-attention kernel
   launched; a val on 8192 targets, a profile of 4 steps, a 4 x 256
   request card against CPU in f32 and bf16 (the bf16 service casts the
   [rows, 1] bias tables too), 3 small f32 steps card against CPU. Then
   DELF's CLI for one epoch on phase 6's saved dataset. Phases 2 and 2b
   hold the gather and scatter-add to their plain versions at the
   roster's widths: a [rows, 1] bias table in f32 (and, gathered, in
   bf16) and a 16-wide table.
9. The trainer ([trainer]): configs3 (sum pool, in-batch IW) at the bench
   width with adamw (wd 1e-4), adagrad (lr 1e-2), sgd (lr 0.5), adam
   with a 10-step warmup and with warmup 5 + cosine over 53 steps, then
   with scorer dropout 0.1; each as phase 7 runs a rung (3 warm-up steps,
   in which the tables change on steps 0 and 2 unless the scheduled lr
   is 0; 50 counted steps in which the loss must fall, the sum pool's
   kernels counted; a val, a profile, 3 small f32 steps card against CPU,
   with host-made masks for dropout). Dropout: two evals bit-equal, the
   first hidden layer's dropped share within 0.1 +- 0.01, and
   `profiling.timed` of a step. Then the same events built at a stored
   fan-out of 20 and re-sampled to n=m=10 each step, with the preset's
   uniform negatives and with in-batch IW: a step gathers int32 [*, 180]
   adjacency rows, each sample lies in its row's valid prefix with no
   position twice and counts min(cnt, 10), the re-sample's device ms, a
   val at the stored width, 3 small steps card against CPU from the same
   keys. Last, `debug.checked_lookup` on the card raises on an
   out-of-range id. Phase 2 holds the gather to its plain version at the
   stored width too ([90560,180] ids [4096,2], [50048,180] ids [4096]).
9b. bf16 parameters ([bf16params]): configs3 with model.param_dtype
   bf16 (bf16 tables and Adam moments): 3 small f32-compute steps card
   against CPU (losses within bf16's rtol, tables within 2 lr x boost a
   table step and 2% of entries past 1 ulp, dense leaves within 2 lr a
   step); then at the bench width (sum pool, B=4096, bf16 compute,
   in-batch IW, stride 2 at 2x) beside f32 parameters from the same init
   and shifts: the bytes init_state takes on the device and those of the
   tables and moments, 3 warm-up steps and 50 steps each in turns of 10
   (the bf16 run's launches counted: two bf16 scatter-adds a table-update
   step), the loss falling, step ms, a val, a profile of each; a
   `latest` checkpoint restored bit-equal; a 4 x 256 request card against
   CPU; `score` p50 at 1 x 101 and `score_batch` at 16 x 4096 of both in
   turns.
10. Sharding ([shard]): a one-rank NCCL world through `sharding.bringup`
   (a file store in a temporary directory; a multi-rank world needs a
   card a rank). The a2a and psum lookups into configs3's item table, f32
   [90560,32], at the real ids of one in-batch batch (the [4096,1]
   targets, the [4096,9,10] histories), each id tensor its own exchange:
   rows bit-equal to the local grouped gather, the table gradient within
   1e-5 relative of its scatter-add; CUDA-event ms forward and backward,
   kernels a lookup and each dedup sort's ms. Then configs3 (sum pool,
   in-batch IW, B=4096, stride 2 at 2x) trained under the mesh with a2a
   lookups: 3 f32 steps against 3 local steps from the same weights and
   shifts (params rtol 1e-4 / atol 1e-6, a2a_overflow 0); in bf16 the
   first step's loss bit-equal and its dense weights within that
   tolerance (the tables part: the local step sums a rolled negative's
   gradient in bf16, the sharded one in f32), then 20 steps of each in
   turns (local, a2a, a2a, local, 5 steps each), the gather and
   scatter-add launched under the sharded steps, each profiled; with
   bf16 parameters (f32 compute) 3 local steps, each beside an a2a step
   from the same state, as [bf16params] holds two runs; an a2a
   step at a2a_capacity 1000, whose a2a_overflow must equal the uniques
   past it that the host counts in its four lookups' ids. Then
   configs4(1, 1) in the same world (a2a, sum pool, in-batch IW,
   B=4096, bf16, stride 2 at 2x) through `train(..., mesh=mesh)` for one
   epoch on the bench dataset, the graph row-sharded and its histories
   fetched through the exchange, val every 100 steps on 8192 targets,
   sharded `latest`/`best` (the sum pool's kernels launched, the run
   raising on any a2a_overflow): steps/s, s a val, test eval s; `latest`
   restored under the mesh bit-equal to the live state; a timed sharded
   save and restore and each file's bytes; `from_checkpoint('best',
   mesh=mesh)` against a whole read of `best`, scores bit-equal at 1 x
   101 and 16 x 4096, `score`'s p50 of both in turns and kernels a
   call; last `entry.dryrun_multichip(1)` in a process of its own.
11. The quality protocol ([quality]): `score_tpu_torch.scripts.ladder.main`
   on the card, configs3 and baseline_sasrec for 1 epoch at seed 0 on the
   ladder's Taobao crossattr dataset (3,000 users, 6,000 items, 400,000
   events, prepped in the temporary directory): its JSON holds the JAX
   script's fields and finite metrics, the gather, scatter-add and
   candidates forward and backward launched in the phase (no other
   kernel), and configs3's val AUC lies above the popularity baseline's
   pinned JAX 3-seed mean.
12. The reference-scale scripts ([scale]): each of
   `score_tpu_torch.scripts`' prep_bench, eval_scale, serve_bench (both
   modes), perf_sweep and scaling on the card at reduced knobs
   (`SCALE_*`: 1e6 prep events; 2e6 eval events over 2e4 users and 8e4
   items, 50 steps; a catalogue of ~1/10 of the reference's; the bench
   step b4096_bf16_inbatch_iw for 2 timed calls; scaling at N=1 in a
   one-rank NCCL world): each record holds its JAX script's keys (the
   pinned PREP_BENCH_r3, EVAL_SCALE_r5_bf16, SERVE_BENCH_r4 and
   SERVE_CATALOG_r5.json) with finite numbers and the card's line; the
   gather, scatter-add and candidates forward and backward launched in
   the phase (no other kernel). Then eval_scale's trained weights
   evaluated over the whole val split at eval_batch 2048 and at 8192,
   whose item side holds 2,382,888,960 elements a block, past 2^31: the
   AUC and ranking metrics agree within 1e-3 and each run's histogram
   totals equal the targets and the negatives; 8 blocks of 2048 profiled
   (wall and device ms, kernels and idle share a block, the costliest
   kernels). Last, the gather and the
   candidates forward at the reference-scale shapes (`SCALE_GATHERS`,
   `SCALE_CAND`: the 1e8 prep's tables and item graph, the catalogue's
   graph, eval blocks of 2048 and 8192, the catalogue's 16 x 8192 chunk)
   on random inputs, each launch against the same work in four launches
   (the gather bit-equal, the co-attention within 2e-2), its time beside
   its bound.

The [roster] and [trainer] summary lines give each run's step ms,
kernels a step, idle share and val AUC. The line before the last lists each kernel with
its launches in the
training run of its path (the sum-pool run for the gather, scatter-add and
candidates kernels, the mean-pool run for the per-pair kernels), its
largest error against the plain version, and its, the plain version's and
the library call's time beside its bound (the candidates forward also
gives its time and bound at the training shape, B=4096 C=2, where its
launches are counted, and the per-pair forward its mean pool's there, by
CUDA graph; the wide kernels their d=64 training shape's, sum pool, with
the launches of the [d64] sum-pool run; the scatter-add also its bf16
form's, `bf16_*`, with the launches of the [bf16params] run; the four
kernels of the quality protocol their launches in [quality],
`quality_launches`); the last line is
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
STORED_FAN = 20                       # [trainer]'s re-sampling dataset
EVAL_TARGETS, EVAL_CPU_TARGETS, EVAL_BATCH = 8192, 512, 256
F32_TOL = 1e-4
BF16_TOL = 2e-2
CPU_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
           "bfloat16": dict(rtol=2e-2, atol=2e-3)}
TRAIN_CPU_TOL = dict(rtol=1e-4, atol=1e-5)
# SASRec's attention key bias adds one constant to each query's logits,
# which the softmax cancels: its gradient is zero in exact arithmetic and
# roundoff on a device, so card and CPU are held to its Adam travel only
ZERO_GRAD_LEAF = "mha.key.bias"
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
        # the roster: a bias table one element wide over [positive |
        # negative], the same cast to bf16 as serving casts it, and the
        # presets' own 16-wide tables
        ("f32 [50048,1] ids [4096,2] (roster bias table)",
         torch.randn(50048, 1, generator=gen, device=dev), (BATCH, 2)),
        ("bf16 [90560,1] ids [16,4096] (roster bias table, bf16 serving)",
         torch.randn(90560, 1, generator=gen, device=dev).bfloat16(),
         (ROWS, WIDE)),
        ("f32 [90560,16] ids [4096,9,10] (roster presets' d=16)",
         torch.randn(90560, 16, generator=gen, device=dev),
         (BATCH, T, FAN)),
        # re-sampling gathers the stored fan-out (20): the item histories
        # of [positive | negative] and the user histories
        ("int32 [90560,180] ids [4096,2] (stored fan-out 20, item "
         "histories)",
         torch.randint(0, 1 << 30, (90560, T * STORED_FAN), generator=gen,
                       device=dev, dtype=torch.int32), (BATCH, 2)),
        ("int32 [50048,180] ids [4096] (stored fan-out 20, user histories)",
         torch.randint(0, 1 << 30, (50048, T * STORED_FAN), generator=gen,
                       device=dev, dtype=torch.int32), (BATCH,)),
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
    """One grouped scatter-add (the segments ids, src into a [V, W] table)
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
    W = src[0].shape[-1]
    zeros = torch.zeros(V, W, device=src[0].device)
    flat_ids = torch.cat([x.reshape(-1) for x in ids])
    flat_src = torch.cat([x.reshape(-1, W) for x in src])
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


def bf16_ulps(got: torch.Tensor, exact: torch.Tensor,
              floor: float = 2.0 ** -126) -> torch.Tensor:
    """|got - exact| in bf16 ulps of the larger magnitude, or of `floor`
    where both are below it (f64)."""
    got, exact = got.double(), exact.double()
    m = torch.maximum(got.abs(), exact.abs()).clamp_min(floor)
    return (got - exact).abs() / torch.exp2(torch.floor(torch.log2(m)) - 7)


def _bf16_scatter_line(card, label, ids, src, V) -> dict:
    """The scatter-add's bf16 form on the segments' gradients rounded to
    bf16, into a bf16 [V, W] table: every entry within 1 bf16 ulp of the
    f64 sum rounded to bf16, the largest distance from the plain version
    (index_add_ in f32, one rounding) given; timed eagerly and by CUDA
    graph, beside the plain version and bf16 `index_add_` of the same
    segments (one PyTorch call, which rounds at every add), and its bound
    by bytes: the bf16 sources, the ids and the bf16 table written
    once."""
    from score_tpu_torch.kernels.gather import (scatter_add_rows,
                                                scatter_add_rows_plain)
    src = [x.to(torch.bfloat16) for x in src]
    W = src[0].shape[-1]
    got = scatter_add_rows(ids, src, V)
    exact = torch.zeros(V, W, dtype=torch.float64, device=got.device)
    for i, x in zip(ids, src):
        exact.index_add_(0, i.reshape(-1), x.reshape(-1, W).double())
    ulps = bf16_ulps(got, exact).max().item()
    if got.dtype != torch.bfloat16 or ulps > 1.0:
        raise AssertionError(f"[scatter bf16] {label}: {got.dtype}, "
                             f"{ulps:.3f} bf16 ulps from the exact sum")
    want = scatter_add_rows_plain(ids, src, V)
    err = (got.double() - want.double()).abs().max().item()
    ms = cuda_ms(lambda: scatter_add_rows(ids, src, V))
    gms = graph_ms(lambda: scatter_add_rows(ids, src, V))
    plain_ms = cuda_ms(lambda: scatter_add_rows_plain(ids, src, V))
    zeros = torch.zeros(V, W, dtype=torch.bfloat16, device=got.device)
    flat_ids = torch.cat([x.reshape(-1) for x in ids])
    flat_src = torch.cat([x.reshape(-1, W) for x in src])
    lib_ms = cuda_ms(lambda: torch.index_add(zeros, 0, flat_ids, flat_src))
    b = bound(nbytes(*src, *ids, got),
              sum((x != 0).sum().item() for x in src))
    log(f"[scatter bf16] {label}: within {ulps:.3f} bf16 ulps of the "
        f"exact sum rounded (tol 1), max_abs_err against the plain version "
        f"{err:.3e}; kernel {ms:.4f} ms eagerly, {gms:.4f} ms by graph; "
        f"plain {plain_ms:.4f} ms, bf16 index_add {lib_ms:.4f} ms; bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]")
    return dict(bf16_max_abs_err=err, bf16_max_ulps=ulps, bf16_ms=ms,
                bf16_graph_ms=gms, bf16_plain_ms=plain_ms,
                bf16_library_ms=lib_ms, bf16_bound_ms=b["bound_ms"],
                bf16_bound_by=b["bound_by"])


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


def check_grouped_backward_kernels(card: str, dev,
                                   dtype=torch.float32) -> None:
    """The backward of one table's grouped lookups runs a memset and the
    scatter-add kernel (of a bf16 table, also its rounding pass) and
    nothing else: no fill and no add of a dense table gradient
    (torch.profiler's CUDA kernels of that backward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from score_tpu_torch.kernels.gather import gather_rows_grouped
    table = torch.randn(90560, D, device=dev).to(dtype).requires_grad_(True)
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
    want = ["scatter_add_kernel"] + (["scatter_add_round_kernel"]
                                     if dtype == torch.bfloat16 else [])
    kernels = [k for k in names if "memset" not in k.lower()]
    found = sorted(w for w in want if any(w in k for k in kernels))
    if (not names or found != sorted(want)
            or any(not any(w in k for w in want) for k in kernels)):
        raise AssertionError(f"[scatter] the grouped backward of a "
                             f"{dtype} table ran {names}; expected a memset "
                             f"and {want}")
    log(f"[scatter] the grouped backward of 2 lookups into a {dtype} "
        f"table runs {names} and no other kernel [{card}]")


def phase_scatter(card: str, dev, gen, ds) -> dict:
    """The table-gradient scatter-add: uniform ids at the shapes a step's
    lookups give (70% valid), then the grouped call as the step makes it on
    the real ids of one training batch of the bench dataset (configs3 with
    in-batch and with uniform negatives, configs0's shared table). Returns
    the kernels-line fields of the main path's call: configs3's item table
    with in-batch negatives, and (`bf16_*`) the bf16 form's on the same
    segments rounded to bf16."""
    # training's four lookups one at a time: (table rows, ids shape, width)
    cases = [("item [90560,32] ids [4096,9,10]", 90560, (BATCH, T, FAN), D),
             ("item [90560,32] ids [4096,1]", 90560, (BATCH, 1), D),
             ("user [50048,32] ids [4096,1,9,10]", 50048, (BATCH, 1, T, FAN),
              D),
             ("user [50048,32] ids [4096]", 50048, (BATCH,), D),
             # uniform negatives: configs3's user table over [positive |
             # negative], and configs0's shared table
             ("user [50048,32] ids [4096,2,9,10] (configs3 uniform)", 50048,
              (BATCH, 2, T, FAN), D),
             ("shared [140608,32] ids [4096,9,10] (configs0)", SHARED_ROWS,
              (BATCH, T, FAN), D),
             # the roster: a bias table one element wide, a 16-wide table
             ("bias [50048,1] ids [4096,2] (roster)", 50048, (BATCH, 2), 1),
             ("item [90560,16] ids [4096,9,10] (roster d=16)", 90560,
              (BATCH, T, FAN), 16)]
    worst = 0.0
    for label, V, shape, W in cases:
        ids = torch.randint(1, V, shape, generator=gen, device=dev,
                            dtype=torch.int32)
        pad = torch.rand(shape, generator=gen, device=dev) < 0.3
        ids[pad] = 0        # masked neighbour slots: pad id, zero gradient
        src = torch.randn(shape + (W,), generator=gen, device=dev)
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
            if (rung, neg) == ("configs3", "inbatch"):
                # the bf16 form at the shapes of bf16-parameter training
                out.update(_bf16_scatter_line(card, label, ids, src, V))
            if line is None:
                line = out
    check_grouped_backward_kernels(card, dev)
    check_grouped_backward_kernels(card, dev, torch.bfloat16)
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

def bench_dataset(fanout: int = FAN, tag: str = "[data]"):
    """The synthetic Taobao-scale events built into a dataset that stores
    `fanout` neighbours a slot (the same events and splits at any)."""
    from score_tpu_torch.data import synth
    from score_tpu_torch.data.prep_common import build_dataset
    t0 = time.perf_counter()
    user, item, ts = synth.synth_events(USERS, ITEMS, EVENTS, num_slots=T,
                                        seed=SEED)
    ds = build_dataset(user, item, ts, num_slots=T, user_fanout=fanout,
                       item_fanout=fanout, num_eval_neg=100, min_user=3,
                       min_item=3, seed=SEED, dataset_name="bench-taobao")
    log(f"{tag} {ds.num_users} users, {ds.num_items} items, "
        f"{len(ds.train)} train targets, stored fan-out {fanout}, built in "
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
    scatter_add_rows.launches_bf16 = 0      # of its launches, the bf16 form's
    return fns


def check_table_scatters(what: str, cfg, launches: dict, timed,
                         tables: int = 0) -> None:
    """One scatter-add a table on each table-update step of the steps
    `timed` (a range of step numbers), none on the others: `tables` a
    step, by default 2 with separate user and item tables, 1 with
    configs0's shared table."""
    stride = max(cfg.train.table_update_every, 1)
    updates = sum(1 for j in range(timed.start, timed.stop)
                  if j % stride == 0)
    tables = tables or (1 if cfg.model.shared_table else 2)
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
    kernels = sum(r[1] for r in rows) / active
    log(f"{tag} profile of {active} steps: "
        f"{kernels:.0f} kernels and {per_step:.3f} "
        f"ms of device time a step; idle share {1 - busy / wall:.3f} of the "
        f"profiled window ({wall / active:.3f} ms a step), "
        f"{1 - per_step / step_ms:.3f} of an unprofiled {step_ms:.3f} ms "
        f"step [{card}]")
    for ms, cnt, key in sorted(rows, reverse=True)[:15]:
        log(f"{tag}   {ms:8.3f} ms {100 * ms / busy:5.1f}% x{cnt:<5} "
            f"{key[:100]}")
    return dict(kernels=kernels, device_ms=per_step,
                idle=1 - per_step / step_ms)


def _train_run(card: str, state, graph, batches, steps: int, tag: str,
               want: set, full: bool = True, neg_iw=None, negatives=None,
               tables: int = 0):
    """Warm-up steps, in which the tables must change on steps 0 and 2
    only (not on a step whose scheduled learning rate is 0, as a warmup's
    first is); then `steps` steps through train_loop with the launches
    counted
    (the kernels in `want` and no other), in which the loss must stay
    finite and, when `full`, fall. `negatives`: the raw uniform draws for
    each batch; without them each step's in-batch shifts come from
    state.generator. `tables`: the scatter-adds a table-update step makes
    (check_table_scatters' default if 0). Returns the state, the launches
    and the step's ms by CUDA events."""
    from score_tpu_torch.train import draw_shifts, train_loop, train_step
    losses, aucs = [], []
    for j in range(WARMUP_STEPS):
        before = _tables(state)
        moves = j % 2 == 0 and state.opt.learning_rate() > 0
        state, m = train_step(
            state, graph, batches[j], neg_iw=neg_iw,
            negatives=None if negatives is None else negatives[j])
        losses.append(m["loss"])
        aucs.append(round(m["batch_auc"].item(), 5))
        after = dict(state.model.named_parameters())
        changed = any(not torch.equal(v, after[k]) for k, v in before.items())
        if changed != moves:
            raise AssertionError(f"{tag} step {j}: tables changed={changed}")
    log(f"{tag} warm-up: tables changed on steps 0 and 2 only (where the "
        f"learning rate is not 0); batch_auc {aucs}")

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
    check_table_scatters(tag, state.cfg, launches, timed, tables)
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
                 negatives=None, dropout_masks=None,
                 resample_keys=None) -> list:
    """3 steps of `cfg`, f32, batch 256, on the card and on the CPU from
    the same weights (the zero-initialised attention weights made non-zero
    and the tables widened as `random_weights` does: at their init scales
    the attention scores are near 0, the softmaxes near uniform, and every
    co-attention pool gives the same losses), batches and in-batch shifts
    or raw uniform negatives, and each step's dropout masks and
    re-sampling keys when given (host tensors); with bf16 parameters held
    as `bf16_params_close` holds them. Returns the first device's
    losses."""
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
            extra = {}
            if dropout_masks is not None:
                extra["dropout_masks"] = [x.to(device)
                                          for x in dropout_masks[j]]
            if resample_keys is not None:
                extra["resample_keys"] = [x.to(device)
                                          for x in resample_keys[j]]
            state, m = train_step(
                state, graph, b, shifts and shifts[j], neg_iw.to(device),
                negatives=None if negatives is None else negatives[j],
                **extra)
            losses.append(m["loss"].item())
        out[device] = (losses, {k: v.detach().cpu() for k, v in
                                state.model.named_parameters()})
    card, cpu = (out[d] for d in devices)
    if cfg.model.param_dtype == "bfloat16":
        bf16_params_close(tag, cfg, card, cpu, steps=len(batches))
        return card[0]
    np.testing.assert_allclose(card[0], cpu[0], **LOSS_TOL)
    worst, where = 0.0, None
    for k, want in cpu[1].items():
        got = card[1][k]
        if k.endswith(ZERO_GRAD_LEAF):
            # roundoff on each side: within 3 Adam steps of the start
            travel = max((x - sd[k]).abs().max().item() for x in (got, want))
            if travel > 3 * cfg.train.learning_rate:
                raise AssertionError(f"{tag} {k} moved {travel}")
            continue
        torch.testing.assert_close(got, want, msg=k, **TRAIN_CPU_TOL)
        err = (got - want).abs().max().item()
        if err >= worst:
            worst, where = err, k
    log(f"{tag} f32 card vs cpu, 3 steps of batch 256: losses "
        f"{card[0]} vs {cpu[0]}; params max_abs_err "
        f"{worst:.3e} ({where}; tol {TRAIN_CPU_TOL})")
    return card[0]


# bf16 parameters, one run against another (tests/test_torch_bf16_params.py's
# chained bounds): the share of a table's entries more than 1 bf16 ulp
# apart (ulps of the larger of the entry and an Adam step, lr x boost);
# every entry within 2 lr x boost a table step (Adam moves an entry by a
# full step whichever side of 0 its gradient lands), a dense leaf within
# 2 lr a step; the losses within bf16's rtol
BF16_TABLE_ULP_SHARE = 0.02
BF16_LOSS_RTOL = 2 ** -8


def bf16_params_close(tag: str, cfg, got, want, steps: int,
                      dense_tol=None, start: int = 0) -> None:
    """(losses, params) of a bf16-parameter run `got` against `want` from
    the same state after steps start, ..., start + steps - 1 (stride
    cfg.train's): the losses, tables and dense leaves within the bounds
    above (`dense_tol`: an assert_close tolerance for the dense leaves in
    place of theirs); the largest distances logged."""
    tc = cfg.train
    table_steps = sum(1 for j in range(start, start + steps)
                      if j % max(tc.table_update_every, 1) == 0)
    np.testing.assert_allclose(got[0], want[0], rtol=BF16_LOSS_RTOL)
    far = {}
    for k, w in want[1].items():
        g = got[1][k]
        if g.dtype != w.dtype:
            raise AssertionError(f"{tag} {k}: {g.dtype} against {w.dtype}")
        d = (g.double().cpu() - w.double().cpu()).abs().max().item()
        if "table" in k:
            if w.dtype != torch.bfloat16:
                raise AssertionError(f"{tag} {k} is {w.dtype}")
            step = tc.learning_rate * tc.table_lr_boost
            share = (bf16_ulps(g.cpu(), w.cpu(), step) > 1
                     ).double().mean().item()
            most = 2 * step * table_steps
            if share > BF16_TABLE_ULP_SHARE or d > most:
                raise AssertionError(f"{tag} {k}: {share:.4f} of entries "
                                     f"past 1 ulp, {d:.3e} apart (bounds "
                                     f"{BF16_TABLE_ULP_SHARE}, {most:.1e})")
            far[k] = (round(share, 5), d)
        elif dense_tol is not None:
            torch.testing.assert_close(g.cpu(), w.cpu(), msg=k, **dense_tol)
            far[k] = d
        elif d > 2 * tc.learning_rate * steps:
            raise AssertionError(f"{tag} {k}: {d:.3e} apart")
        else:
            far[k] = d
    dense = max((v, k) for k, v in far.items() if "table" not in k)
    log(f"{tag} bf16 parameters, {steps} steps: losses {got[0]} vs "
        f"{want[0]} (rtol {BF16_LOSS_RTOL:.2e}); tables (share past 1 ulp, "
        f"max |diff|) {({k: v for k, v in far.items() if 'table' in k})}; "
        f"dense max |diff| {dense[0]:.3e} ({dense[1]})")


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
    from score_tpu_torch.nn.model import build_model
    model = build_model(cfg, ds.num_users, ds.num_items)
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


def phase_ladder_rung(card: str, ds, dev, rung: str, tag: str = "",
                      want: set = frozenset(), tables: int = 0) -> dict:
    """Preset `rung` at the bench width with its uniform negatives:
    `_train_run`'s warm-up and 50 counted steps, in which the loss must
    fall and which launch the kernels `want` (default LADDER_KERNELS) and
    `tables` scatter-adds a table-update step; a val on EVAL_TARGETS
    targets; a torch.profiler window; serving card against CPU; 3 small
    f32 steps card against CPU from the same raw negatives. Returns the
    step's ms, the val AUC, the profile's numbers and the launches."""
    from score_tpu_torch.graph import device_graph
    from score_tpu_torch.params import init_params
    from score_tpu_torch.train import (draw_negatives, evaluate, init_state,
                                       make_eval_step)
    tag = tag or f"[ladder {rung}]"
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
    state, launches, ev_ms = _train_run(
        card, state, graph, batches, TIMED_STEPS, tag,
        want or LADDER_KERNELS[rung], negatives=negs, tables=tables)

    t0 = time.perf_counter()
    val = evaluate(make_eval_step(state.model), graph, ds.val,
                   max_targets=EVAL_TARGETS)
    val_s = time.perf_counter() - t0
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in val.values()):
        raise AssertionError(f"{tag} val metrics out of range: {val}")
    log(f"{tag} val after {WARMUP_STEPS + TIMED_STEPS} steps, "
        f"{EVAL_TARGETS} targets: auc {val['auc']:.4f} ndcg@10 "
        f"{val['ndcg@10']:.4f} in {val_s:.3f} s [{card}]")
    prof = _profile(state, graph, batches[-6:], None, card, ev_ms, tag,
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
    return dict(step_ms=ev_ms, val_auc=val["auc"], **prof,
                launches=launches)


def run_cli(card: str, tag: str, preset: str, data_dir: str) -> None:
    """`python -m score_tpu_torch.train <preset> <data_dir>` with
    LADDER_CLI_ARGS (the bench width and batch, one epoch, the preset's
    own negatives) in a subprocess: it must exit 0 and print one test
    line."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "score_tpu_torch.train", preset, data_dir,
         *LADDER_CLI_ARGS], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=DRIVER_TIMEOUT_S,
        env=dict(os.environ, PYTHONUNBUFFERED="1"))
    cli_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"{tag} cli {preset}: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"the {preset} CLI exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    if sum(line.startswith("test: auc")
           for line in proc.stdout.splitlines()) != 1:
        raise AssertionError(f"the {preset} CLI printed no test line")
    log(f"{tag} cli {preset}: exit 0 in {cli_s:.1f} s of wall clock "
        f"[{card}]")


def phase_ladder(card: str, ds, dev, data_dir: str) -> None:
    """Phase 7: every rung of the ladder, then the configs0 CLI for one
    epoch on the saved bench dataset, in a subprocess."""
    t_phase = time.perf_counter()
    out = {rung: phase_ladder_rung(card, ds, dev, rung) for rung in LADDER}
    run_cli(card, "[ladder]", "configs0", data_dir)
    for rung in out:
        out[rung].pop("launches")
    log(f"[ladder] {json.dumps(out)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")


# --- phase 8: the baseline roster ------------------------------------------

# per preset: the gather launches a step (the history gathers, two a side,
# and one a table's lookups) and the tables a table-update step
# scatter-adds into: MF's embedding and bias tables, SVD++'s implicit
# table too, DELF's two pairs, the ScoreModel flag sets' user and item
# tables
ROSTER = {"baseline_pop": (3, 1), "baseline_mf": (6, 4),
          "baseline_svdpp": (7, 5), "baseline_delf": (8, 4),
          "baseline_gru4rec": (5, 2), "baseline_caser": (5, 2),
          "baseline_sasrec": (5, 2), "baseline_rrn": (8, 2)}
ROSTER_KERNELS = {"gather_rows", "scatter_add_rows"}   # no co-attention
ROSTER_CLI = "baseline_delf"                           # the widest


def phase_roster(card: str, ds, dev, data_dir: str) -> dict:
    """Phase 8: each of the eight baseline presets as phase 7 runs a rung
    (the bench width, bf16, B=4096, stride 2 at 2x lr, its uniform
    negatives), its gathers and scatter-adds counted against ROSTER and no
    co-attention kernel launched; then ROSTER_CLI's CLI for one epoch on
    the saved bench dataset, in a subprocess."""
    t_phase = time.perf_counter()
    out = {}
    for preset, (gathers, tables) in ROSTER.items():
        tag = f"[roster {preset}]"
        res = phase_ladder_rung(card, ds, dev, preset, tag, ROSTER_KERNELS,
                                tables)
        got = res.pop("launches")["gather_rows"]
        if got != gathers * TIMED_STEPS:
            raise AssertionError(f"{tag} gather_rows launched {got} times "
                                 f"in {TIMED_STEPS} steps; expected "
                                 f"{gathers} a step")
        log(f"{tag} gather_rows: {got} launches, {gathers} a step")
        out[preset] = res
    run_cli(card, "[roster]", ROSTER_CLI, data_dir)
    log(f"[roster] {json.dumps(out)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return out


# --- phase 9: the trainer's optimizers, schedules, dropout, re-sampling -----

# configs3 (sum pool, in-batch IW) at the bench width with each optimizer
# and schedule beside phase 4's Adam at a constant rate
TRAINER_RUNS = {"adamw": dict(optimizer="adamw", weight_decay=1e-4),
                "adagrad": dict(optimizer="adagrad", learning_rate=1e-2),
                "sgd": dict(optimizer="sgd", learning_rate=0.5),
                "adam warmup": dict(warmup_steps=10),
                "adam cosine": dict(lr_schedule="cosine", warmup_steps=5,
                                    decay_steps=53)}
DROPOUT = 0.1
DROPOUT_SHARE_TOL = 0.01


def trainer_config(dtype: str, width: bool = True, neg: str = "inbatch_iw",
                   train: dict = (), model: dict = (), data: dict = ()):
    """configs3 (sum pool) at the bench width (or its own with
    width=False) with negatives `neg` ('uniform': the preset's) and the
    given overrides of its train, model and data sections."""
    cfg = ladder_config("configs3", dtype, width)
    return cfg.replace(
        train=dataclasses.replace(cfg.train, **dict(train)),
        model=dataclasses.replace(cfg.model, **dict(model)),
        data=dataclasses.replace(cfg.data, train_neg_mode=neg, **dict(data)))


def _trainer_run(card, ds, dev, tag: str, cfg, negatives: bool = False,
                 graph=None) -> tuple:
    """`_train_run`'s warm-up and 50 counted steps of `cfg` (the loss must
    fall; the sum pool's kernels, one scatter-add a table a table-update
    step), a val on EVAL_TARGETS targets at the graph's stored fan-out
    (its launches counted: the sum pool's serving kernels) and a profile
    window. Returns the summary, the state, the graph, the batches and
    the negatives' importance weights."""
    from score_tpu_torch.graph import device_graph
    from score_tpu_torch.params import init_params
    from score_tpu_torch.train import (draw_negatives, evaluate, init_state,
                                       item_importance_weights,
                                       make_eval_step)
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(SEED))
    state = init_state(cfg, ds.num_users, ds.num_items, sd, device=dev,
                       steps_per_epoch=len(ds.train) // BATCH)
    graph = graph or device_graph(ds.graph, dev)
    batches = _device_batches(ds, WARMUP_STEPS + TIMED_STEPS + 6, BATCH,
                              dev)
    neg_iw = negs = None
    if negatives:
        negs = torch.stack([draw_negatives(state.generator, BATCH,
                                           cfg.data.num_train_neg,
                                           ds.num_items)
                            for _ in batches]).to(dev)
    else:
        neg_iw = torch.from_numpy(
            item_importance_weights(ds.train, ds.num_items)).to(dev)
    state, launches, ev_ms = _train_run(
        card, state, graph, batches, TIMED_STEPS, tag, TRAIN_KERNELS["sum"],
        neg_iw=neg_iw, negatives=negs)
    fns = reset_counts()
    t0 = time.perf_counter()
    val = evaluate(make_eval_step(state.model), graph, ds.val,
                   max_targets=EVAL_TARGETS)
    val_s = time.perf_counter() - t0
    check_launches(f"{tag} val", {k: fn.launches for k, fn in fns.items()},
                   SERVE_KERNELS["sum"])
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in val.values()):
        raise AssertionError(f"{tag} val metrics out of range: {val}")
    log(f"{tag} val after {WARMUP_STEPS + TIMED_STEPS} steps, "
        f"{EVAL_TARGETS} targets at the stored fan-out "
        f"{graph.u2i.shape[-1]}: auc {val['auc']:.4f} ndcg@10 "
        f"{val['ndcg@10']:.4f} in {val_s:.3f} s [{card}]")
    prof = _profile(state, graph, batches[-6:], neg_iw, card, ev_ms, tag,
                    negatives=None if negs is None else negs[-6:])
    out = dict(step_ms=ev_ms, val_auc=val["auc"], **prof)
    return out, state, graph, batches, neg_iw


def _first_layer_dropped_share(state, graph, batch, neg_iw) -> float:
    """The share of the first hidden layer's non-zero activations that one
    training step's dropout zeroes (read at the scorer's first _drop)."""
    from score_tpu_torch.train import train_step
    scorer = state.model.scorer
    seen = []

    def spy(x, mask):
        y = type(scorer)._drop(scorer, x, mask)
        if not seen:
            live = x != 0
            seen.append(((y == 0) & live).sum().item() / live.sum().item())
        return y
    scorer._drop = spy
    try:
        train_step(state, graph, batch, neg_iw=neg_iw, with_auc=False)
    finally:
        del scorer._drop
    return seen[0]


def _check_resampled(tag: str, cfg, graph, batch, dev) -> float:
    """On one real batch on the card: the step's re-sample (its keys drawn
    from the step's generator) takes each row's sample from the row's
    valid prefix, no position twice, with counts min(cnt, k); the same
    keys applied to the positions give the sample's ids. Returns the
    re-sample's device ms (both sides, keys drawn, by CUDA events)."""
    from score_tpu_torch.graph import (gather_candidate_batch,
                                       subsample_neighbors)
    from score_tpu_torch.train import _resample, _step_generator
    u, i, t = (batch[k] for k in ("user", "item", "slot"))
    mb = gather_candidate_batch(graph, u, i[:, None], t)
    seed, step = cfg.train.seed, 7
    got = _resample(cfg, mb, None, seed, step)
    gen = _step_generator(seed, step, 2, dev)
    for hist, cnt, k in (("u_hist", "u_cnt", cfg.data.user_fanout),
                         ("i_hist", "i_cnt", cfg.data.item_fanout)):
        stored = mb[hist]
        keys = torch.rand(stored.shape, generator=gen, device=dev)
        pos = torch.arange(stored.shape[-1], dtype=torch.int32,
                           device=dev).expand(stored.shape).contiguous()
        sel, c = subsample_neighbors(pos, mb[cnt], k, keys)
        if not (torch.equal(c, got[cnt])
                and torch.equal(c, mb[cnt].clamp_max(k))):
            raise AssertionError(f"{tag} {hist}: counts not min(cnt, {k})")
        valid = torch.arange(k, device=dev) < c[..., None]
        if not torch.equal(torch.gather(stored, -1, sel.long())[valid],
                           got[hist][valid]):
            raise AssertionError(f"{tag} {hist}: the sample is not the "
                                 f"stored rows at the drawn positions")
        if (sel[valid] >= mb[cnt][..., None].expand(sel.shape)[valid]).any():
            raise AssertionError(f"{tag} {hist}: a sampled position past "
                                 f"its row's valid prefix")
        srt = torch.sort(torch.where(valid, sel, -1 - torch.arange(
            k, dtype=sel.dtype, device=dev)), dim=-1).values
        if (srt[..., 1:] == srt[..., :-1]).any():
            raise AssertionError(f"{tag} {hist}: a position sampled twice")
    log(f"{tag} re-sample of a batch's histories ([{BATCH},9,"
        f"{STORED_FAN}] and [{BATCH},1,9,{STORED_FAN}] to "
        f"{cfg.data.user_fanout}): each sample from its row's valid "
        f"prefix, no position twice, counts min(cnt, "
        f"{cfg.data.user_fanout})")
    return cuda_ms(lambda: _resample(cfg, mb, None, seed, step))


def phase_trainer(card: str, ds, dev) -> dict:
    """Phase 9: configs3 (sum pool, in-batch IW, the bench width) trained
    with each optimizer and schedule of TRAINER_RUNS, with scorer
    dropout, and re-sampling a dataset stored at STORED_FAN neighbours
    down to n=m=10 (the preset's uniform negatives and in-batch IW); each
    held against the CPU; then the debug and profiling tools on the
    card."""
    from score_tpu_torch.debug import checked_lookup
    from score_tpu_torch.graph import device_graph
    from score_tpu_torch.kernels import gather as kgather
    from score_tpu_torch.profiling import timed
    from score_tpu_torch.train import evaluate, make_eval_step, train_step
    t_phase = time.perf_counter()
    out = {}
    for name, kw in TRAINER_RUNS.items():
        tag = f"[trainer {name}]"
        out[name], state, *_ = _trainer_run(
            card, ds, dev, tag, trainer_config("bfloat16", train=kw))
        del state
        steps_vs_cpu(ds, trainer_config("float32", False, train=kw), tag,
                     (dev, "cpu"), shifts=[[17], [101], [3]])
    torch.cuda.empty_cache()

    # scorer dropout
    tag = "[trainer dropout]"
    cfg = trainer_config("bfloat16", model=dict(dropout=DROPOUT))
    out["dropout"], state, graph, batches, neg_iw = _trainer_run(
        card, ds, dev, tag, cfg)
    evals = [evaluate(make_eval_step(state.model), graph, ds.val,
                      max_targets=EVAL_TARGETS) for _ in range(2)]
    if evals[0] != evals[1]:
        raise AssertionError(f"{tag} two evals differ: {evals}")
    share = _first_layer_dropped_share(state, graph, batches[0], neg_iw)
    if abs(share - DROPOUT) > DROPOUT_SHARE_TOL:
        raise AssertionError(f"{tag} dropped {share:.4f} of the first "
                             f"hidden layer; expected {DROPOUT}")
    log(f"{tag} two evals of {EVAL_TARGETS} targets bit-equal (auc "
        f"{evals[0]['auc']:.6f}); one step dropped {share:.4f} of the "
        f"first hidden layer's non-zero activations (expected {DROPOUT} +- "
        f"{DROPOUT_SHARE_TOL})")
    out["dropout"]["dropped_share"] = share
    # the timing tool against the run's CUDA-event step time
    timed_ms = 1e3 * timed(lambda: train_step(state, graph, batches[1],
                                              neg_iw=neg_iw,
                                              with_auc=False),
                           reps=5, device=dev)
    log(f"{tag} profiling.timed of one step: {timed_ms:.3f} ms (CUDA "
        f"events around one step, median of 5), beside train_loop's "
        f"{out['dropout']['step_ms']:.3f} ms a step [{card}]")
    out["dropout"]["timed_ms"] = timed_ms
    del state, graph, batches
    torch.cuda.empty_cache()
    small = trainer_config("float32", False, model=dict(dropout=DROPOUT))
    gen = torch.Generator().manual_seed(SEED + 3)
    C = 1 + small.data.num_train_neg          # [positive | rolled]
    masks = [[torch.rand(256, C, w, generator=gen) >= DROPOUT
              for w in small.model.mlp_dims] for _ in range(3)]
    steps_vs_cpu(ds, small, tag, (dev, "cpu"), shifts=[[17], [101], [3]],
                 dropout_masks=masks)

    # re-sampling a wider stored fan-out down to the model's
    ds20 = bench_dataset(STORED_FAN, "[trainer resample]")
    graph20 = device_graph(ds20.graph, dev)
    resample = dict(user_fanout=FAN, item_fanout=FAN, neighbor_resample=True)
    launched = []
    real_launch = kgather._gather_launch

    def spy(table, ids):
        launched.append((table.shape[1], table.dtype))
        return real_launch(table, ids)
    for neg in ("uniform", "inbatch_iw"):
        tag = f"[trainer resample {neg}]"
        cfg = trainer_config("bfloat16", neg=neg, data=resample)
        res, state, _, batches, neg_iw = _trainer_run(
            card, ds20, dev, tag, cfg, negatives=neg == "uniform",
            graph=graph20)
        kgather._gather_launch = spy
        try:
            train_step(state, graph20, batches[0], neg_iw=neg_iw,
                       with_auc=False)
        finally:
            kgather._gather_launch = real_launch
        if (T * STORED_FAN, torch.int32) not in launched:
            raise AssertionError(f"{tag} no gather of [*, {T * STORED_FAN}]"
                                 f" int32 rows: {sorted(set(launched))}")
        res["resample_ms"] = _check_resampled(tag, cfg, graph20,
                                              batches[0], dev)
        log(f"{tag} a step gathers int32 [*, {T * STORED_FAN}] adjacency "
            f"rows; the re-sample of both sides {res['resample_ms']:.4f} ms "
            f"of device time a step [{card}]")
        out[f"resample {neg}"] = res
        del state, batches
        torch.cuda.empty_cache()
        small = trainer_config("float32", False, neg=neg, data=resample)
        C = 1 + small.data.num_train_neg if neg == "uniform" else 1
        gen = torch.Generator().manual_seed(SEED + 4)
        keys = [[torch.rand(256, T, STORED_FAN, generator=gen),
                 torch.rand(256, C, T, STORED_FAN, generator=gen)]
                for _ in range(3)]
        raw = None
        if neg == "uniform":
            from score_tpu_torch.train import draw_negatives
            raw = [draw_negatives(gen, 256, small.data.num_train_neg,
                                  ds20.num_items) for _ in range(3)]
        steps_vs_cpu(ds20, small, tag, (dev, "cpu"),
                     shifts=None if raw else [[17], [101], [3]],
                     negatives=raw, resample_keys=keys)
    del graph20, ds20

    # debug: the checked lookup raises on the card
    table = torch.randn(1000, D, device=dev)
    ids = torch.randint(0, 1000, (BATCH,), device=dev, dtype=torch.int32)
    if not torch.equal(checked_lookup(table, ids), table[ids.long()]):
        raise AssertionError("checked_lookup differs from table[ids]")
    for bad in (1000, -1):
        ids[7] = bad
        try:
            checked_lookup(table, ids)
        except ValueError as e:
            log(f"[trainer] checked_lookup of id {bad} on the card raises: "
                f"{e}")
        else:
            raise AssertionError(f"checked_lookup took id {bad}")
    torch.cuda.empty_cache()
    log(f"[trainer] {json.dumps(out)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return out


# --- phase 9b: [bf16params] -------------------------------------------------

# the bench run at f32 and bf16 parameters, its 50 steps in turns of 10
PARAMS_TURN = 10
PARAMS_ORDER = ("float32", "bfloat16", "bfloat16", "float32", "float32",
                "bfloat16", "bfloat16", "float32", "float32", "bfloat16")
PARAMS_SERVE_CALLS = 25        # `score` calls a turn, 4 turns
PARAMS_BATCH_CALLS = 5         # `score_batch` calls a turn


def params_config(param_dtype: str, dtype: str = "bfloat16",
                  width: bool = True):
    """bench_config(dtype) (configs3, sum pool, in-batch IW, stride 2 at
    2x) with model.param_dtype `param_dtype`."""
    cfg = bench_config(dtype, width)
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 param_dtype=param_dtype))


def _table_state_bytes(state) -> int:
    """The bytes of the tables and of their optimizer state."""
    tables = {k: p for k, p in state.model.named_parameters()
              if "table" in k}
    return nbytes(*tables.values(), *(getattr(state.opt, key)[k]
                                      for key in state.opt.state_keys
                                      for k in tables))


def phase_bf16params(card: str, ds, dev) -> dict:
    """Phase 9b ([bf16params]): configs3 with model.param_dtype bf16 (bf16
    tables and Adam moments). 3 small steps on the card against the CPU
    (f32 compute, batch 256); then at the bench width (bf16 compute,
    B=4096, in-batch IW, stride 2 at 2x) beside the same config at f32
    parameters, from the same init and shifts: the device bytes each
    init_state takes, 3 warm-up steps each (tables change on steps 0 and
    2 only), 50 steps each in turns of 10 (bf16 parameters' launches
    counted: the sum pool's kernels, two bf16 scatter-adds a table-update
    step and no f32 one), in which the loss must fall; step ms, a val on
    EVAL_TARGETS targets and a profile of each. Then a `latest`
    checkpoint of the bf16 state restored bit-equal into another, a 4 x
    256 request card against CPU, and ScoringService's score p50 (1 x
    101) and score_batch (16 x 4096) of both in turns."""
    from score_tpu_torch.checkpoint import CheckpointManager, apply_restore
    from score_tpu_torch.graph import device_graph
    from score_tpu_torch.kernels.gather import scatter_add_rows
    from score_tpu_torch.params import init_params
    from score_tpu_torch.serve import ScoringService
    from score_tpu_torch.train import (draw_shifts, evaluate, init_state,
                                       item_importance_weights,
                                       make_eval_step, train_loop,
                                       train_step)
    t_phase = time.perf_counter()
    tag = "[bf16params]"
    steps_vs_cpu(ds, params_config("bfloat16", "float32", width=False),
                 tag, (dev, "cpu"), shifts=[[17], [101], [3]])

    graph = device_graph(ds.graph, dev)
    neg_iw = torch.from_numpy(
        item_importance_weights(ds.train, ds.num_items)).to(dev)
    batches = _device_batches(ds, WARMUP_STEPS + TIMED_STEPS + 6, BATCH,
                              dev)
    shift_gen = torch.Generator().manual_seed(SEED + 9)
    shifts = [draw_shifts(shift_gen, 1, BATCH)
              for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    states, out = {}, {}
    for pdt in ("float32", "bfloat16"):
        cfg = params_config(pdt)
        sd = init_params(cfg, ds.num_users, ds.num_items,
                         torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        states[pdt] = init_state(cfg, ds.num_users, ds.num_items, sd,
                                 device=dev)
        torch.cuda.synchronize()
        out[pdt] = dict(init_bytes=torch.cuda.memory_allocated() - before,
                        table_state_bytes=_table_state_bytes(states[pdt]))
    dtypes = {k: p.dtype for k, p in states["bfloat16"].model.
              named_parameters() if p.dtype != torch.float32}
    if set(dtypes) != {"tables.user_table", "tables.item_table"}:
        raise AssertionError(f"{tag} non-f32 leaves {dtypes}")
    a, b = out["float32"], out["bfloat16"]
    log(f"{tag} init_state on the card: f32 parameters {a['init_bytes']} B "
        f"({a['table_state_bytes']} B of tables and their Adam moments), "
        f"bf16 parameters {b['init_bytes']} B ({b['table_state_bytes']} B)")

    losses = {pdt: [] for pdt in states}
    for pdt, st in states.items():
        for j in range(WARMUP_STEPS):
            before = _tables(st)
            st, m = train_step(st, graph, batches[j], shifts[j], neg_iw)
            losses[pdt].append(m["loss"].item())
            after = dict(st.model.named_parameters())
            changed = any(not torch.equal(v, after[k])
                          for k, v in before.items())
            if changed != (j % 2 == 0):
                raise AssertionError(f"{tag} {pdt} step {j}: tables "
                                     f"changed={changed}")
    timed = {pdt: [] for pdt in states}
    pos = dict.fromkeys(states, WARMUP_STEPS)
    launches, updates = None, 0
    for pdt in PARAMS_ORDER:
        lo = pos[pdt]
        chunk = slice(lo, lo + PARAMS_TURN)
        fns = reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        states[pdt], m = train_loop(states[pdt], graph, batches[chunk],
                                    shifts[chunk], neg_iw)
        end.record()
        torch.cuda.synchronize()
        timed[pdt].append(start.elapsed_time(end) / PARAMS_TURN)
        losses[pdt] += m["loss"].tolist()
        pos[pdt] += PARAMS_TURN
        if pdt == "bfloat16":
            counts = {k: fn.launches for k, fn in fns.items()}
            counts["scatter_add_rows bf16"] = scatter_add_rows.launches_bf16
            launches = (counts if launches is None else
                        {k: v + counts[k] for k, v in launches.items()})
            updates += sum(1 for j in range(lo, lo + PARAMS_TURN)
                           if j % 2 == 0)
    log(f"{tag} launches in the {TIMED_STEPS} counted bf16-parameter "
        f"steps: {launches}")
    bf16_scatters = launches.pop("scatter_add_rows bf16")
    check_launches(tag, launches, TRAIN_KERNELS["sum"])
    if not launches["scatter_add_rows"] == bf16_scatters == 2 * updates:
        raise AssertionError(f"{tag} {launches['scatter_add_rows']} "
                             f"scatter-adds, {bf16_scatters} bf16 ones, in "
                             f"{updates} table-update steps; expected 2 "
                             f"bf16 ones a step")
    for pdt, curve in losses.items():
        if not (np.isfinite(curve).all()
                and np.mean(curve[-10:]) < curve[0]):
            raise AssertionError(f"{tag} {pdt} parameters: the loss did not "
                                 f"fall: {curve}")
        log(f"{tag} {pdt} parameters, loss curve ({len(curve)} steps): "
            f"{[round(x, 5) for x in curve]}")
    for pdt, st in states.items():
        val = evaluate(make_eval_step(st.model), graph, ds.val,
                       max_targets=EVAL_TARGETS)
        step_ms = statistics.mean(timed[pdt])
        prof = _profile(st, graph, batches[-6:], neg_iw, card, step_ms,
                        f"{tag} {pdt}")
        out[pdt].update(step_ms=step_ms, rounds=timed[pdt],
                        val_auc=val["auc"], **prof)
    out["bfloat16"]["launches_bf16"] = bf16_scatters
    a, b = out["float32"], out["bfloat16"]
    log(f"{tag} f32 / bf16 parameters, B={BATCH}, {TIMED_STEPS} steps each "
        f"in turns of {PARAMS_TURN}: step {a['step_ms']:.3f} / "
        f"{b['step_ms']:.3f} ms (CUDA events), kernels a step "
        f"{a['kernels']:.1f} / {b['kernels']:.1f}, device ms "
        f"{a['device_ms']:.3f} / {b['device_ms']:.3f}, idle share "
        f"{a['idle']:.3f} / {b['idle']:.3f}, bf16 scatter-adds {bf16_scatters}"
        f", tables and moments {a['table_state_bytes']} / "
        f"{b['table_state_bytes']} B, val auc ({EVAL_TARGETS} targets) "
        f"{a['val_auc']:.4f} / {b['val_auc']:.4f} [{card}]")

    # `latest` of the bf16 state, restored into a state from other weights
    live = states["bfloat16"]
    with tempfile.TemporaryDirectory() as ck:
        mgr = CheckpointManager(ck)
        mgr.save("latest", live, (0, 0), 0.0, live.step, block=True)
        cfg = params_config("bfloat16")
        fresh = init_state(cfg, ds.num_users, ds.num_items, init_params(
            cfg, ds.num_users, ds.num_items,
            torch.Generator().manual_seed(SEED + 1)), device=dev)
        apply_restore(fresh, mgr.restore("latest", fresh))
        size = os.path.getsize(mgr.path("latest"))
    a, b = _state_tensors(live), _state_tensors(fresh)
    bad = [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(
        a[k], b[k])]
    if bad or set(a) != set(b) or fresh.step != live.step:
        raise AssertionError(f"{tag} `latest` restored differs: {bad}")
    log(f"{tag} `latest` ({size} B) restored bit-equal: every parameter "
        f"and moment ({sum(v.dtype == torch.bfloat16 for v in a.values())}"
        f" of them bf16), step {live.step}")
    del fresh, a, b

    # serving the trained weights: card against CPU, then timed in turns
    rng = np.random.default_rng(SEED + 10)
    sd = {k: v.detach().cpu() for k, v in live.model.state_dict().items()}
    serve_vs_cpu(ds, lambda dtype: params_config("bfloat16", dtype), sd, rng,
                 tag, device=dev)
    svcs = {pdt: ScoringService(params_config(pdt), ds,
                                states[pdt].model.state_dict(), device=dev)
            for pdt in states}
    user = int(ds.test.user[0])
    items = rng.integers(1, ds.num_items + 1, 101).astype(np.int32)
    users16 = np.unique(ds.test.user)[:ROWS].astype(np.int32)
    wide = rng.integers(1, ds.num_items + 1, (ROWS, WIDE)).astype(np.int32)
    for svc in svcs.values():
        for _ in range(5):
            svc.score(user, items)
        scores = svc.score_batch(users16, wide)
        if scores.shape != (ROWS, WIDE) or not np.isfinite(scores).all():
            raise AssertionError(f"{tag} score_batch {scores.shape}")
    lat = {pdt: [] for pdt in svcs}
    batch_ms = {pdt: [] for pdt in svcs}
    for pdt in ("float32", "bfloat16", "bfloat16", "float32"):
        svc = svcs[pdt]
        for _ in range(PARAMS_SERVE_CALLS):
            t0 = time.perf_counter()
            svc.score(user, items)
            lat[pdt].append((time.perf_counter() - t0) * 1e3)
        for _ in range(PARAMS_BATCH_CALLS):
            t0 = time.perf_counter()
            svc.score_batch(users16, wide)
            batch_ms[pdt].append((time.perf_counter() - t0) * 1e3)
    for pdt in svcs:
        out[pdt].update(score_p50_ms=statistics.median(lat[pdt]),
                        score_batch_ms=statistics.median(batch_ms[pdt]))
    a, b = out["float32"], out["bfloat16"]
    log(f"{tag} serving in turns (f32, bf16, bf16, f32 parameters): score "
        f"1 x 101 p50 {a['score_p50_ms']:.3f} / {b['score_p50_ms']:.3f} ms "
        f"({PARAMS_SERVE_CALLS} calls a turn), score_batch {ROWS} x {WIDE} "
        f"median {a['score_batch_ms']:.3f} / {b['score_batch_ms']:.3f} ms "
        f"[{card}]")
    del svcs, states, live, graph, batches
    torch.cuda.empty_cache()
    log(f"{tag} {json.dumps(out)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return out


# --- phase 10: [shard] -----------------------------------------------------

SHARD_CHECK_STEPS, SHARD_TIMED_STEPS, SHARD_ROUND = 3, 20, 5
SHARD_CAPACITY = 1000          # below every lookup's per-rank unique ids


def _device_kernels(fn, reps: int = 4) -> tuple:
    """(kernels, device ms) a call of fn: torch.profiler's CUDA events over
    `reps` calls after two it does not count, in a schedule as `_profile`
    takes a step's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=reps)) as prof:
        for _ in range(reps + 2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA and ev.self_device_time_total
           and not ev.key.startswith("ProfilerStep")]
    return (sum(ev.count for ev in evs) / reps,
            sum(ev.self_device_time_total for ev in evs) / 1e3 / reps)


def _shard_lookups(card: str, ds, dev, mesh, gen) -> dict:
    """configs3's item table and the real ids of one in-batch training
    batch (targets [4096, 1], histories [4096, 9, 10]): the a2a and psum
    lookups, each id tensor its own exchange, against the local grouped
    gather; forward bit-equal, the table gradient within 1e-5 relative of
    the local scatter-add's; CUDA-event ms, kernels a lookup and the dedup
    sorts' device ms."""
    from score_tpu_torch.kernels.gather import gather_rows_grouped
    from score_tpu_torch.sharding import ShardedLookup
    rows, ids, srcs = _real_segments(ds, dev, "configs3", "inbatch",
                                     gen)["item"]
    table = torch.randn(rows, D, generator=gen, device=dev,
                        requires_grad=True)
    local = gather_rows_grouped(table, ids)
    (g_local,) = torch.autograd.grad(local, [table], srcs, retain_graph=True)
    out = {"local": {}}
    with torch.no_grad():
        out["local"]["fwd_ms"] = cuda_ms(
            lambda: gather_rows_grouped(table, ids))
    out["local"]["bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
        local, [table], srcs, retain_graph=True))
    out["local"]["kernels"] = _device_kernels(
        lambda: torch.autograd.grad(gather_rows_grouped(table, ids),
                                    [table], srcs))[0] / len(ids)
    for mode in ("a2a", "psum"):
        fn = ShardedLookup(mesh, mode)
        got, ovf = fn.grouped(table, ids)
        for g, w in zip(got, local):
            if not torch.equal(g, w):
                raise AssertionError(f"[shard] {mode} rows differ from the "
                                     f"local gather")
        if ovf is not None and int(ovf.sum()) != 0:
            raise AssertionError(f"[shard] {mode} overflow {ovf.tolist()} "
                                 f"at the exact capacity")
        (g_tab,) = torch.autograd.grad(got, [table], srcs)
        scale = max(g_local.abs().max().item(), 1.0)
        torch.testing.assert_close(g_tab, g_local, rtol=1e-5,
                                   atol=1e-5 * scale)
        err = (g_tab - g_local).abs().max().item()
        r = {"max_abs_err": err}
        with torch.no_grad():
            r["fwd_ms"] = cuda_ms(lambda: fn.grouped(table, ids))
        got, _ = fn.grouped(table, ids)
        r["bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            got, [table], srcs, retain_graph=True))
        r["fwd_kernels"] = _device_kernels(
            lambda: fn.grouped(table, ids))[0] / len(ids)
        r["kernels"] = _device_kernels(
            lambda: torch.autograd.grad(fn.grouped(table, ids)[0], [table],
                                        srcs))[0] / len(ids)
        out[mode] = r
    # the dedup sort of each lookup's ids, alone
    out["a2a"]["sort_ms"] = [
        cuda_ms(lambda: torch.sort(i.reshape(-1), stable=True))
        for i in ids]
    a, p, lo = out["a2a"], out["psum"], out["local"]
    shapes = [tuple(i.shape) for i in ids]
    log(f"[shard] lookups into f32 [{rows},{D}], ids {shapes}: a2a and "
        f"psum rows bit-equal to the local grouped "
        f"gather, gradients within 1e-5 rel (max_abs_err "
        f"{a['max_abs_err']:.3e} / {p['max_abs_err']:.3e}); forward a2a "
        f"{a['fwd_ms']:.4f} "
        f"/ psum {p['fwd_ms']:.4f} / local {lo['fwd_ms']:.4f} ms, backward "
        f"{a['bwd_ms']:.4f} / {p['bwd_ms']:.4f} / {lo['bwd_ms']:.4f} ms "
        f"(CUDA events); kernels a lookup, forward and backward: a2a "
        f"{a['kernels']:.1f} ({a['fwd_kernels']:.1f} forward), psum "
        f"{p['kernels']:.1f}, local {lo['kernels']:.1f}; the dedup sort "
        f"of each id tensor alone {[round(x, 4) for x in a['sort_ms']]} ms "
        f"[{card}]")
    return out


def _host_overflow(mb: dict, capacity: int) -> int:
    """The uniques past `capacity` of each of a step's four lookups (users,
    item histories; candidates, user histories), counted on the host."""
    total = 0
    for key in ("user", "i_hist", "cand", "u_hist"):
        ids = mb[key].cpu().numpy().reshape(-1)
        total += max(np.unique(ids).size - min(capacity, ids.size), 0)
    return total


SHARD_DRIVER = dict(num_epochs=1, eval_every_steps=100,
                    eval_max_targets=EVAL_TARGETS)
SERVE_TURN_CALLS = 25          # `score` calls a turn, 4 turns


def _state_tensors(state) -> dict:
    """A TrainState's parameters and optimizer state, by name."""
    out = {f"param {k}": v for k, v in state.model.state_dict().items()}
    for key in state.opt.state_keys:
        out.update({f"{key} {k}": v
                    for k, v in getattr(state.opt, key).items()})
    return out


def _shard_driver(card: str, ds, dev, mesh, work: str) -> dict:
    """configs4(1, 1) at the bench width (a2a, sum pool, in-batch IW,
    B=4096, bf16, stride 2 at 2x) through `train(..., mesh=mesh)` for one
    epoch with sharded checkpoints; `latest` restored under the mesh
    bit-equal to the live state; a timed save and restore with each
    file's bytes; `best` served under the mesh and read whole, scores
    bit-equal, `score`'s p50 of both in turns; `entry.dryrun_multichip(1)`
    in a process of its own."""
    from score_tpu_torch import entry
    from score_tpu_torch.checkpoint import CheckpointManager, apply_restore
    from score_tpu_torch.config import configs4
    from score_tpu_torch.params import init_params
    from score_tpu_torch.serve import ScoringService
    from score_tpu_torch.train import init_state, train
    ck = os.path.join(work, "ck")
    base = bench_config("bfloat16")
    cfg = base.replace(sharding=configs4(1, 1).sharding,
                       train=dataclasses.replace(base.train,
                                                 checkpoint_dir=ck,
                                                 **SHARD_DRIVER))
    spe = len(ds.train) // BATCH
    fns = reset_counts()
    out = train(cfg, ds, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in fns.items()}
    log(f"[shard] launches in the sharded driver's run: {launches}")
    check_launches("[shard] driver", launches, TRAIN_KERNELS["sum"])
    tm = out["timing"]
    vals = out["history"]
    if (out["steps_run"] != spe or not vals
            or not all(np.isfinite(r["auc"]) for r in vals)
            or not np.isfinite(out["test"]["auc"])):
        raise AssertionError(f"[shard] driver ran {out['steps_run']} of "
                             f"{spe} steps; vals {vals}, test {out['test']}")
    log(f"[shard] train(configs4(1, 1), a2a, mesh=mesh), bf16 B={BATCH} "
        f"stride 2: {tm['steps']} steps in {tm['train_s']:.3f} s, "
        f"{tm['steps'] / tm['train_s']:.2f} steps/s; {len(tm['val_s'])} "
        f"vals of {EVAL_TARGETS} targets, "
        f"{statistics.mean(tm['val_s']):.3f} s each "
        f"({[round(v, 3) for v in tm['val_s']]}); test eval of "
        f"{len(ds.test)} targets {tm['test_s']:.3f} s; a2a_overflow 0 in "
        f"every chunk (overflow_action raise) [{card}]")
    log(f"[shard] val auc by step "
        f"{[(r['step'], round(r['auc'], 4)) for r in vals]}; best "
        f"{out['best_val_auc']:.4f} at step {out['best_step']}; test auc "
        f"{out['test']['auc']:.4f}")

    # `latest` (the epoch's last val, its last step) against the live state
    live = out["state"]
    fresh = init_state(cfg, ds.num_users, ds.num_items,
                       init_params(cfg, ds.num_users, ds.num_items,
                                   torch.Generator().manual_seed(SEED + 9)),
                       device=dev, mesh=mesh)
    apply_restore(fresh, CheckpointManager(ck, mesh).restore("latest",
                                                             fresh))
    a, b = _state_tensors(live), _state_tensors(fresh)
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    if set(a) != set(b) or bad or fresh.step != live.step:
        raise AssertionError(f"[shard] restored latest differs: {bad}")
    log(f"[shard] latest restored under the mesh: {len(a)} blocks and "
        f"optimizer states bit-equal to the live ones, step {fresh.step}")
    del fresh

    # a save and a restore, timed, and the bytes of each file
    mgr = CheckpointManager(os.path.join(work, "timed"), mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save("latest", live, (1, 0), out["best_val_auc"], live.step)
    snap_s = time.perf_counter() - t0
    mgr.wait()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = mgr.restore("latest", live)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    files = {os.path.relpath(f, mgr.directory): os.path.getsize(f)
             for f in mgr.files("latest")}
    ck_files = {name: {os.path.relpath(f, ck): os.path.getsize(f)
                       for f in CheckpointManager(ck, mesh).files(name)}
                for name in ("latest", "best")}
    log(f"[shard] sharded checkpoint: save {save_s:.3f} s ({snap_s:.3f} s "
        f"until the step may go on), restore {restore_s:.3f} s; bytes a "
        f"file {files}; the run's {ck_files} [{card}]")
    del restored, live, out
    torch.cuda.empty_cache()

    # `best` served under the mesh and read whole
    fns = reset_counts()
    sharded = ScoringService.from_checkpoint(cfg, ds, ck, "best",
                                             device=dev, mesh=mesh)
    whole = ScoringService.from_checkpoint(cfg, ds, ck, "best", device=dev)
    rng = np.random.default_rng(SEED + 8)
    user = int(ds.test.user[0])
    items = rng.integers(1, ds.num_items + 1, 101).astype(np.int32)
    users16 = np.unique(ds.test.user)[:ROWS].astype(np.int32)
    wide = rng.integers(1, ds.num_items + 1, (ROWS, WIDE)).astype(np.int32)
    for what, got, want in (
            ("1 x 101", sharded.score(user, items),
             whole.score(user, items)),
            (f"{ROWS} x {WIDE}", sharded.score_batch(users16, wide),
             whole.score_batch(users16, wide))):
        if not np.array_equal(got, want):
            raise AssertionError(
                f"[shard] mesh serving {what} differs from the whole read: "
                f"max |diff| {np.abs(got - want).max():.3e}")
    launches = {k: fn.launches for k, fn in fns.items()}
    check_launches("[shard] serving", launches, SERVE_KERNELS["sum"])
    times = {"mesh": [], "whole": []}
    for name in ("whole", "mesh", "mesh", "whole"):
        svc = sharded if name == "mesh" else whole
        for _ in range(SERVE_TURN_CALLS):
            t0 = time.perf_counter()
            svc.score(user, items)
            times[name].append((time.perf_counter() - t0) * 1e3)
    p50 = {k: statistics.median(v) for k, v in times.items()}
    kern = {k: _device_kernels(lambda s=s: s.score(user, items))[0]
            for k, s in (("mesh", sharded), ("whole", whole))}
    log(f"[shard] from_checkpoint('best', mesh=mesh) against the whole "
        f"read: scores bit-equal at 1 x 101 and {ROWS} x {WIDE}; score "
        f"p50 in turns (whole, mesh, mesh, whole x {SERVE_TURN_CALLS}) "
        f"mesh {p50['mesh']:.3f} ms / whole {p50['whole']:.3f} ms, "
        f"kernels a call {kern['mesh']:.1f} / {kern['whole']:.1f} [{card}]")
    del sharded, whole
    torch.cuda.empty_cache()

    # the entry point's dry run, a world of one in its own process
    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(1, device="cuda")
    log(f"[shard] entry.dryrun_multichip(1): psum step and 3 a2a steps, "
        f"losses {[round(x, 6) for x in dry]} in "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(steps_per_s=tm["steps"] / tm["train_s"], save_s=save_s,
                restore_s=restore_s, files=files, p50=p50)


def phase_shard(card: str, ds, dev) -> dict:
    """Phase 10 ([shard]): a one-rank NCCL world through
    `sharding.bringup`; the a2a and psum lookups at the training shape
    against the local gather; configs3 (sum pool, in-batch IW, B=4096,
    stride 2 at 2x) trained under the mesh with a2a lookups against the
    local step, then timed in turns with it and profiled; with bf16
    parameters, 3 a2a steps each from the local state; an a2a step at
    a capacity below the unique ids, its overflow against the host's
    count; then configs4(1, 1)'s driver, checkpoints, serving and the
    entry point's dry run (`_shard_driver`)."""
    import torch.distributed as dist
    from score_tpu_torch.config import ShardingConfig
    from score_tpu_torch.graph import device_graph, gather_candidate_batch
    from score_tpu_torch.kernels.gather import scatter_add_rows
    from score_tpu_torch.params import init_params
    from score_tpu_torch.sharding import bringup, full_tables
    from score_tpu_torch.train import (draw_shifts, init_state,
                                       item_importance_weights, train_loop,
                                       train_step)
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        mesh, lookup_fn = bringup(None, init_method=f"file://{tmp}/store",
                                  world_size=1, rank=0, device=dev)
        try:
            if lookup_fn is not None or mesh.size != 1:
                raise AssertionError(f"[shard] a world of one: {mesh}, "
                                     f"lookup {lookup_fn}")
            log(f"[shard] a {dist.get_backend()} world of "
                f"{dist.get_world_size()} rank, mesh {mesh.shape} on "
                f"{mesh.device}")
            gen = torch.Generator(device=dev).manual_seed(SEED)
            out["lookups"] = _shard_lookups(card, ds, dev, mesh, gen)
            graph = device_graph(ds.graph, dev)
            neg_iw = torch.from_numpy(
                item_importance_weights(ds.train, ds.num_items)).to(dev)
            batches = _device_batches(ds, 4 * SHARD_ROUND + 6, BATCH, dev)
            shift_gen = torch.Generator().manual_seed(SEED + 5)
            shifts = [draw_shifts(shift_gen, 1, BATCH)
                      for _ in range(len(batches))]

            def states(dtype, capacity=0, param_dtype="float32"):
                cfg = params_config(param_dtype, dtype)
                sd = init_params(cfg, ds.num_users, ds.num_items,
                                 torch.Generator().manual_seed(SEED))
                a2a = cfg.replace(sharding=ShardingConfig(
                    lookup_mode="a2a", a2a_capacity=capacity))
                return (init_state(a2a, ds.num_users, ds.num_items,
                                   {k: v.clone() for k, v in sd.items()},
                                   device=dev, mesh=mesh),
                        init_state(cfg, ds.num_users, ds.num_items, sd,
                                   device=dev))

            # f32: 3 sharded steps against 3 local ones
            sharded, plain = states("float32")
            for j in range(SHARD_CHECK_STEPS):
                sharded, ms = train_step(sharded, graph, batches[j],
                                         shifts[j], neg_iw)
                plain, mp = train_step(plain, graph, batches[j], shifts[j],
                                       neg_iw)
                np.testing.assert_allclose(ms["loss"].item(),
                                           mp["loss"].item(), **LOSS_TOL)
                if int(ms["a2a_overflow"]) != 0:
                    raise AssertionError(f"[shard] overflow "
                                         f"{int(ms['a2a_overflow'])}")
            got = full_tables(mesh, sharded)
            worst, where = 0.0, None
            for k, want in plain.model.named_parameters():
                torch.testing.assert_close(got[k], want.detach(), rtol=1e-4,
                                           atol=1e-6, msg=k)
                err = (got[k] - want.detach()).abs().max().item()
                if err >= worst:
                    worst, where = err, k
            log(f"[shard] f32, B={BATCH}: {SHARD_CHECK_STEPS} a2a steps "
                f"under the mesh against {SHARD_CHECK_STEPS} local steps "
                f"from the same weights and shifts: losses within "
                f"{LOSS_TOL}, params max_abs_err {worst:.3e} ({where}; tol "
                f"rtol 1e-4 atol 1e-6), a2a_overflow 0")
            del sharded, plain, got
            torch.cuda.empty_cache()

            # bf16, as phase 4 trains: the first step's loss bit-equal and
            # its dense weights within the f32 tolerance (the local step
            # sums a rolled negative's gradient into its positive's in
            # bf16, the sharded one in f32 in the scatter-add, so their
            # tables part from the first update); then timed in turns
            sharded, plain = states("bfloat16")
            sharded, ms = train_step(sharded, graph, batches[0], shifts[0],
                                     neg_iw)
            plain, mp = train_step(plain, graph, batches[0], shifts[0],
                                   neg_iw)
            if ms["loss"].item() != mp["loss"].item():
                raise AssertionError(f"[shard] bf16 first losses "
                                     f"{ms['loss'].item()} vs "
                                     f"{mp['loss'].item()}")
            got = full_tables(mesh, sharded)
            for k, want in plain.model.named_parameters():
                if "table" not in k:
                    torch.testing.assert_close(got[k], want.detach(),
                                               rtol=1e-4, atol=1e-6, msg=k)
            log(f"[shard] bf16: the first a2a step's loss bit-equal to the "
                f"local step's ({ms['loss'].item()}), its dense weights "
                f"within rtol 1e-4 atol 1e-6")
            timed = {"a2a": [], "local": []}
            fns = reset_counts()
            launches = None
            order = ["local", "a2a", "a2a", "local"]
            for r, name in enumerate(order):
                st = sharded if name == "a2a" else plain
                lo = 1 + SHARD_ROUND * r
                chunk = slice(lo, lo + SHARD_ROUND)
                if name == "a2a":
                    for fn in fns.values():
                        fn.launches = 0
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                st, m = train_loop(st, graph, batches[chunk], shifts[chunk],
                                   neg_iw)
                end.record()
                torch.cuda.synchronize()
                timed[name].append(start.elapsed_time(end) / SHARD_ROUND)
                if name == "a2a":
                    counts = {k: fn.launches for k, fn in fns.items()}
                    launches = (counts if launches is None else
                                {k: v + counts[k]
                                 for k, v in launches.items()})
                    if int(m["a2a_overflow"][0]) != 0:
                        raise AssertionError("[shard] bf16 overflow")
            log(f"[shard] launches in the {len(timed['a2a']) * SHARD_ROUND} "
                f"timed a2a steps: {launches}")
            check_launches("[shard]", launches, TRAIN_KERNELS["sum"])
            res = {}
            for name, st in (("a2a", sharded), ("local", plain)):
                step_ms = statistics.mean(timed[name])
                prof = _profile(st, graph, batches[-6:], neg_iw, card,
                                step_ms, f"[shard {name}]")
                res[name] = dict(step_ms=step_ms, rounds=timed[name], **prof)
            log(f"[shard] bf16 B={BATCH} steps in turns "
                f"{order} x {SHARD_ROUND}: a2a {res['a2a']['step_ms']:.3f}"
                f" ms a step {[round(x, 3) for x in timed['a2a']]}, local "
                f"{res['local']['step_ms']:.3f} ms "
                f"{[round(x, 3) for x in timed['local']]} (CUDA events); "
                f"kernels a step {res['a2a']['kernels']:.1f} vs "
                f"{res['local']['kernels']:.1f}, device ms "
                f"{res['a2a']['device_ms']:.3f} vs "
                f"{res['local']['device_ms']:.3f}, idle share "
                f"{res['a2a']['idle']:.3f} vs {res['local']['idle']:.3f} "
                f"[{card}]")
            out["steps"] = res
            del sharded, plain
            torch.cuda.empty_cache()

            # bf16 parameters (f32 compute), as the CPU test holds a
            # sharded bf16-parameter step to the unsharded one: 3 local
            # steps, and before each an a2a state under the mesh built
            # from the local state, which takes the same step (loss and
            # dense weights within the f32 tolerances, tables within 2 lr
            # x boost and 2% of entries past 1 ulp)
            _, plain = states("float32", param_dtype="bfloat16")
            a2a_cfg = plain.cfg.replace(sharding=ShardingConfig(
                lookup_mode="a2a"))
            bf16_scatters, worst = 0, {}
            for j in range(SHARD_CHECK_STEPS):
                sharded = init_state(
                    a2a_cfg, ds.num_users, ds.num_items,
                    {k: v.detach().clone() for k, v in
                     plain.model.state_dict().items()}, device=dev,
                    opt_state=plain.opt.state(), mesh=mesh)
                reset_counts()
                sharded, ms = train_step(sharded, graph, batches[j],
                                         shifts[j], neg_iw)
                bf16_scatters += scatter_add_rows.launches_bf16
                plain, mp = train_step(plain, graph, batches[j], shifts[j],
                                       neg_iw)
                got = full_tables(mesh, sharded)
                if got["tables.item_table"].dtype != torch.bfloat16:
                    raise AssertionError("[shard] the tables are not bf16")
                np.testing.assert_allclose(ms["loss"].item(),
                                           mp["loss"].item(), **LOSS_TOL)
                bf16_params_close(
                    f"[shard] step {j}", a2a_cfg, ([ms["loss"].item()], got),
                    ([mp["loss"].item()], {k: v.detach() for k, v in
                                           plain.model.named_parameters()}),
                    1, dense_tol=dict(rtol=1e-4, atol=1e-6), start=j)
                del sharded, got
            # at least the owners' scatter into each table block on each
            # of the 2 table-update steps (each lookup's pre-reduction is
            # one more)
            if bf16_scatters < 2 * 2:
                raise AssertionError(f"[shard] {bf16_scatters} bf16 "
                                     f"scatter-adds in the a2a steps")
            log(f"[shard] bf16 parameters, f32 compute: {SHARD_CHECK_STEPS}"
                f" a2a steps under the mesh, each from the local state, "
                f"against the local steps: losses within {LOSS_TOL}, dense "
                f"weights within rtol 1e-4 atol 1e-6; {bf16_scatters} bf16 "
                f"scatter-adds in the a2a steps")
            out["bf16_params_scatters"] = bf16_scatters
            del plain
            torch.cuda.empty_cache()

            # overflow below the per-rank unique ids, against the host
            sharded, _ = states("bfloat16", SHARD_CAPACITY)
            b = batches[0]
            cand = torch.stack([b["item"], torch.roll(b["item"],
                                                      -shifts[0][0])], 1)
            mb = gather_candidate_batch(graph, b["user"], cand, b["slot"])
            want = _host_overflow(mb, SHARD_CAPACITY)
            sharded, m = train_step(sharded, graph, b, shifts[0], neg_iw)
            got_ovf = int(m["a2a_overflow"])
            if got_ovf != want or want <= 0:
                raise AssertionError(f"[shard] overflow {got_ovf} at "
                                     f"capacity {SHARD_CAPACITY}; the host "
                                     f"counts {want}")
            log(f"[shard] an a2a step at a2a_capacity {SHARD_CAPACITY}: "
                f"a2a_overflow {got_ovf}, as the host counts the uniques "
                f"past it in the step's four lookups")
            out["overflow"] = got_ovf
            del sharded
            torch.cuda.empty_cache()
            out["driver"] = _shard_driver(card, ds, dev, mesh, tmp)
        finally:
            dist.destroy_process_group()
    log(f"[shard] phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return out


# --- phase 11: the quality protocol ---------------------------------------

QUALITY_MODELS = ("configs3", "baseline_sasrec")
QUALITY_ARGS = ("taobao", "1", "mode=crossattr", "seed=0",
                "models=" + ",".join(QUALITY_MODELS))
QUALITY_KERNELS = {"gather_rows", "scatter_add_rows", "cross_coattn_cand",
                   "cross_coattn_cand_bwd"}
# baseline_pop's val AUC, the mean of the JAX package's three seeds under
# the same protocol (LADDER_roster_r3.json "stats")
POP_VAL_AUC = 0.5953
# the JAX script's record of a preset, and its test metrics
# (LADDER_roster_r3.json)
LADDER_RECORD = {"best_val_auc", "test", "steps", "wall_s"}
LADDER_TEST = {"hr@1", "ndcg@1", "hr@5", "ndcg@5", "hr@10", "ndcg@10",
               "mrr", "gauc", "auc"}


def phase_quality(card: str, dev) -> dict:
    """Phase 11: the ladder script on the card, checked as the module
    docstring says."""
    from score_tpu_torch.scripts import ladder
    t_phase = time.perf_counter()
    launches = reset_counts()
    with tempfile.TemporaryDirectory() as work:
        out_path = os.path.join(work, "ladder.json")
        ladder.main([out_path, *QUALITY_ARGS], device=str(dev))
        with open(out_path) as f:
            res = json.load(f)
    check_launches("[quality]", {n: fn.launches
                                 for n, fn in launches.items()},
                   QUALITY_KERNELS)
    if tuple(res) != QUALITY_MODELS:
        raise AssertionError(f"[quality] presets {list(res)}, want "
                             f"{QUALITY_MODELS}")
    for name, rec in res.items():
        if set(rec) != LADDER_RECORD or set(rec["test"]) != LADDER_TEST:
            raise AssertionError(f"[quality] {name}: fields {sorted(rec)}, "
                                 f"test {sorted(rec['test'])}")
        vals = [rec["best_val_auc"], rec["wall_s"], *rec["test"].values()]
        if not (all(np.isfinite(vals)) and rec["steps"] > 0):
            raise AssertionError(f"[quality] {name}: {rec}")
    if not res["configs3"]["best_val_auc"] > POP_VAL_AUC:
        raise AssertionError(
            f"[quality] configs3 val AUC {res['configs3']['best_val_auc']} "
            f"not above the popularity baseline's {POP_VAL_AUC}")
    out = {n: dict(val_auc=r["best_val_auc"], test_auc=r["test"]["auc"],
                   ndcg10=r["test"]["ndcg@10"], steps=r["steps"],
                   wall_s=r["wall_s"]) for n, r in res.items()}
    counts = {n: fn.launches for n, fn in launches.items() if fn.launches}
    log(f"[quality] {json.dumps(out)}; launches {counts}; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return counts


# --- phase 12: the reference-scale scripts at reduced knobs ---------------

SCALE_PREP = ("events=1000000", "csv_rows=200000", "users=20000",
              "items=80000")
SCALE_EVAL = dict(events=2_000_000, users=20_000, items=80_000,
                  train_steps=50)
SCALE_SERVE = ("num_users=20000", "num_items=40000", "num_events=500000",
               "reps=8")
SCALE_CATALOG = ("users=100000", "items=370000", "events=1400000")
SCALE_SWEEP = ("b4096_bf16_inbatch_iw", "num_users=20000",
               "num_items=40000", "num_events=500000", "calls=2")
SCALE_BATCHES = (2048, 8192)    # eval blocks; 8192's item side past 2^31
SCALE_KERNELS = {"gather_rows", "scatter_add_rows", "cross_coattn_cand",
                 "cross_coattn_cand_bwd"}
SCALE_RECORDS = {"prep_bench": "PREP_BENCH_r3.json",
                 "eval_scale": "EVAL_SCALE_r5_bf16.json",
                 "serve_bench": "SERVE_BENCH_r4.json",
                 "serve_catalog": "SERVE_CATALOG_r5.json"}


def _check_record(what: str, got: dict, card: str) -> None:
    """`got` holds every key of the JAX record it stands beside, its
    numbers finite, and the card's line as its device."""
    root = Path(__file__).resolve().parent
    want = json.loads((root / SCALE_RECORDS[what]).read_text())
    missing = set(want) - set(got)
    if missing:
        raise AssertionError(f"[scale] {what}: keys {sorted(missing)} of "
                             f"{SCALE_RECORDS[what]} missing")
    if got["device"] != card:
        raise AssertionError(f"[scale] {what}: device {got['device']!r}")

    def numbers(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from numbers(v)
        elif isinstance(x, (int, float)) and not isinstance(x, bool):
            yield x
    if not all(np.isfinite(list(numbers(got)))):
        raise AssertionError(f"[scale] {what}: {got}")


# (label, rows, width, dtype, ids shape) of the gathers the reference
# scale gives: the 1e8 prep's tables (1,000,000 users, 2,682,999 items,
# rows rounded up to 64) and item graph, the catalogue's item graph
# (2,919,544 items), at the eval blocks of 2048 and 8192 targets x 101
# candidates and the catalogue's chunk of 16 x 8192
SCALE_GATHERS = [
    ("user table bf16 [1000064,32] ids [2048,101,9,10] (eval block 2048, "
     "item side)", 1000064, D, torch.bfloat16, (2048, 101, T, FAN)),
    ("user table bf16 [1000064,32] ids [8192,101,9,10] (eval block 8192, "
     "item side)", 1000064, D, torch.bfloat16, (8192, 101, T, FAN)),
    ("item table bf16 [2683008,32] ids [8192,101] (eval block 8192, "
     "candidates)", 2683008, D, torch.bfloat16, (8192, 101)),
    ("item graph int32 [2683008,90] ids [8192,101] (eval block 8192, item "
     "histories)", 2683008, T * FAN, torch.int32, (8192, 101)),
    ("item graph int32 [2919552,90] ids [16,8192] (catalogue chunk, item "
     "histories)", 2919552, T * FAN, torch.int32, (16, 8192)),
    ("user table bf16 [1000064,32] ids [16,8192,9,10] (catalogue chunk, "
     "item side)", 1000064, D, torch.bfloat16, (16, 8192, T, FAN)),
]
SCALE_CAND = [dict(B=2048, C=101), dict(B=8192, C=101), dict(B=16, C=8192)]


SCALE_PLAIN_ROWS = 2048    # the co-attention's plain version, B rows a call


def _scale_kernels(card: str, dev, gen) -> None:
    """The gather and the candidates forward at the reference-scale
    shapes, each held against its plain version on the same inputs (the
    gather bit for bit, the co-attention within bf16's tolerance, its
    plain version over SCALE_PLAIN_ROWS rows of B a call) and against the
    same work split in four launches along its first axis (each below
    2^31 elements where the whole passes it); its time beside its
    bound."""
    from score_tpu_torch.kernels.coattn_cand import (cross_coattn_cand,
                                                     cross_coattn_cand_plain)
    from score_tpu_torch.kernels.gather import gather_rows, gather_rows_plain
    for label, rows, width, dtype, shape in SCALE_GATHERS:
        if dtype == torch.int32:
            table = torch.randint(0, 1 << 30, (rows, width), generator=gen,
                                  device=dev, dtype=torch.int32)
        else:
            table = torch.randn(rows, width, generator=gen,
                                device=dev).to(dtype)
        ids = torch.randint(0, rows, shape, generator=gen, device=dev,
                            dtype=torch.int32)
        got = gather_rows(table, ids)
        if not torch.equal(got, gather_rows_plain(table, ids)):
            raise AssertionError(f"[scale] gather {label}: differs from "
                                 f"its plain version")
        parts = torch.cat([gather_rows(table, c)
                           for c in ids.chunk(4, dim=0)])
        if not torch.equal(got, parts):
            raise AssertionError(f"[scale] gather {label}: one launch and "
                                 f"four differ")
        del parts
        ms = cuda_ms(lambda: gather_rows(table, ids), iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: gather_rows_plain(table, ids), iters=5,
                           warmup=1)
        b = bound(torch.unique(ids).numel() * width * table.element_size()
                  + nbytes(ids, got), 0)
        log(f"[scale] gather {label}: {got.numel():,} elements out, equal "
            f"to the plain version and to four launches; kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}) [{card}]")
        del table, ids, got
        torch.cuda.empty_cache()
    for kw in SCALE_CAND:
        args = _cand_inputs(gen, dev, torch.bfloat16, **kw)
        got = cross_coattn_cand(*args)
        Wr = args[4]
        if not all(torch.isfinite(g).all() for g in got):
            raise AssertionError(f"[scale] coattn {kw}: non-finite")
        worst = 0.0
        for lo in range(0, kw["B"], SCALE_PLAIN_ROWS):
            rows = slice(lo, lo + SCALE_PLAIN_ROWS)
            want = cross_coattn_cand_plain(
                *[a if a is Wr else a[rows] for a in args])
            for g, w in zip(got, want):
                torch.testing.assert_close(g[rows], w, rtol=BF16_TOL,
                                           atol=BF16_TOL)
                worst = max(worst,
                            (g[rows].float() - w.float()).abs().max().item())
            del want
        split = [[a] * 4 if a is Wr else a.chunk(4) for a in args]
        parts = [cross_coattn_cand(*[s[j] for s in split]) for j in range(4)]
        diff = 0.0
        for g, p in zip(got, zip(*parts)):
            p = torch.cat(p)
            torch.testing.assert_close(g, p, rtol=BF16_TOL, atol=BF16_TOL)
            diff = max(diff, (g.float() - p.float()).abs().max().item())
        del parts, split
        ms = cuda_ms(lambda: cross_coattn_cand(*args), iters=5, warmup=1)
        b = bound(*_cand_work(args, kw["C"], backward=False))
        log(f"[scale] coattn {kw} bf16: item side {args[1].numel():,} "
            f"elements, against the plain version max |err| {worst:.3e} "
            f"(tol {BF16_TOL}), against four launches max |diff| "
            f"{diff:.3e}; kernel {ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}) [{card}]")
        del args, got
        torch.cuda.empty_cache()


# the device functions of the port's gather and co-attention kernels, as
# torch.profiler names them (csrc/gather.cu, csrc/coattn_cand.cuh)
EVAL_PORT_KERNELS = ("gather_rows_kernel", "gather_flat_kernel",
                     "cand_fwd_kernel")


def _eval_block_profile(card: str, cfg, ds, weights, dev) -> dict:
    """Where an eval block's time goes: `evaluate` over 8 blocks of
    SCALE_BATCHES[0] targets (after one such call as warm-up) under
    torch.profiler, on the [scale] phase's reduced dataset (SCALE_EVAL):
    the wall ms, kernels and device ms a block, the idle share, the
    device ms and launches a block of the port's kernels (EVAL_PORT_KERNELS)
    and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from score_tpu_torch.graph import device_graph
    from score_tpu_torch.nn.model import build_model
    from score_tpu_torch.params import assign_weights
    from score_tpu_torch.train import evaluate, make_eval_step
    B, blocks = SCALE_BATCHES[0], 8
    graph = device_graph(ds.graph, dev)
    model = build_model(cfg, ds.num_users, ds.num_items)
    assign_weights(model, {k: v.to(dev) for k, v in weights.items()})
    step = make_eval_step(model)
    del model
    evaluate(step, graph, ds.val, batch_size=B, max_targets=blocks * B)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate(step, graph, ds.val, batch_size=B, max_targets=blocks * B)
        wall_ms = (time.perf_counter() - t0) * 1e3 / blocks
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA and ev.self_device_time_total]
    kernels = sum(ev.count for ev in evs) / blocks
    dev_ms = sum(ev.self_device_time_total for ev in evs) / 1e3 / blocks
    port = {name: [ev for ev in evs if name in ev.key]
            for name in EVAL_PORT_KERNELS}
    port = {name: (sum(ev.self_device_time_total for ev in e) / 1e3 / blocks,
                   sum(ev.count for ev in e) / blocks)
            for name, e in port.items()}
    if not port["gather_rows_kernel"][1] + port["gather_flat_kernel"][1] or \
            not port["cand_fwd_kernel"][1]:
        raise AssertionError(f"[scale] eval profile: the port's kernels "
                             f"not found among {[ev.key for ev in evs]}")
    port_ms = sum(ms for ms, _ in port.values())
    top = sorted(evs, key=lambda ev: -ev.self_device_time_total)[:6]
    out = dict(wall_ms=wall_ms, kernels=kernels, device_ms=dev_ms,
               idle=1 - dev_ms / wall_ms, port_ms=port_ms)
    costliest = "; ".join(
        f"{ev.key[:48]} {ev.self_device_time_total / 1e3 / blocks:.3f} ms"
        for ev in top)
    ours = ", ".join(f"{name} {ms:.3f} ms x{n:g}"
                     for name, (ms, n) in port.items())
    log(f"[scale] eval block of {B} x 101 (profiled, {blocks} blocks, the "
        f"reduced dataset: {ds.num_users:,} users, {ds.num_items:,} "
        f"items): {wall_ms:.3f} ms a block, {kernels:.1f} kernels, device "
        f"{dev_ms:.3f} ms, idle share {out['idle']:.3f}; the port's "
        f"kernels {port_ms:.3f} ms a block ({ours}); most device time: "
        f"{costliest} [{card}]")
    return out


def phase_scale(card: str, dev) -> dict:
    """Phase 12 ([scale]): the reference-scale scripts at reduced knobs,
    and one set of weights evaluated at eval blocks of 2048 and 8192."""
    import torch.distributed as dist
    from score_tpu_torch.scripts import (eval_scale, perf_sweep,
                                         prep_bench, scaling, serve_bench)
    from score_tpu_torch.sharding import bringup
    t_phase = time.perf_counter()
    launches = reset_counts()
    out = {}
    with tempfile.TemporaryDirectory() as work:
        res = prep_bench.main([f"out={work}/prep.json", *SCALE_PREP],
                              device=str(dev))
        _check_record("prep_bench", res, card)
        out["prep_events_per_s"] = res["events_per_s"]
        log(f"[scale] prep_bench: {res['events']:,} events in "
            f"{res['build_dataset_s']} s ({res['events_per_s']:,}/s), kept "
            f"{res['events_kept']:,}; CSV {res['csv_rows_per_s']:,} rows/s "
            f"[{card}]")
        res, cfg, ds, weights = eval_scale.run(
            dict(eval_scale.DEFAULTS, **SCALE_EVAL), dev)
        _check_record("eval_scale", res, card)
        out["eval"] = {}
        for B in SCALE_BATCHES:
            ev = eval_scale.evaluate_weights(cfg, ds, weights, B, dev)
            n = len(ds.val)
            if (ev["hist_pos"], ev["hist_neg"]) != (n, n * 100):
                raise AssertionError(
                    f"[scale] eval_batch {B}: histogram totals "
                    f"{ev['hist_pos']}, {ev['hist_neg']}; want {n}, "
                    f"{n * 100}")
            out["eval"][B] = ev
            log(f"[scale] eval_batch {B}: {n:,} targets in "
                f"{ev['wall_s']:.3f} s ({n / ev['wall_s']:,.0f} targets/s, "
                f"{ev['blocks']} blocks; item side {B * 101 * T * FAN * D:,}"
                f" elements a block), auc {ev['metrics']['auc']:.6f}, "
                f"sum(hist_pos) {ev['hist_pos']:,} of {n:,}, sum(hist_neg) "
                f"{ev['hist_neg']:,} of {n * 100:,} [{card}]")
        a, b = (out["eval"][B]["metrics"] for B in SCALE_BATCHES)
        diff = max(abs(a[k] - b[k]) for k in a)
        if set(a) != set(b) or diff > EVAL_AUC_TOL:
            raise AssertionError(f"[scale] eval_batch {SCALE_BATCHES[0]} "
                                 f"{a} against {SCALE_BATCHES[1]} {b}")
        log(f"[scale] eval_batch {SCALE_BATCHES[0]} against "
            f"{SCALE_BATCHES[1]}: largest metric difference {diff:.2e} "
            f"(limit {EVAL_AUC_TOL})")
        out["eval_profile"] = _eval_block_profile(card, cfg, ds, weights,
                                                  dev)
        del ds, weights
        res = serve_bench.main([f"{work}/serve.json", *SCALE_SERVE],
                               device=str(dev))
        _check_record("serve_bench", res, card)
        out["serve_p50_ms"] = res["single_p50_ms"]
        res = serve_bench.main([f"{work}/catalog.json", "--catalog",
                                *SCALE_CATALOG], device=str(dev))
        _check_record("serve_catalog", res, card)
        out["catalog_topk_s"] = res["topk_warm_s"]
        rows = perf_sweep.main(list(SCALE_SWEEP), device=str(dev))
        if len(rows) != 1 or "error" in rows[0]:
            raise AssertionError(f"[scale] perf_sweep: {rows}")
        out["sweep_examples_per_s"] = rows[0]["examples_per_s"]
        mesh, _ = bringup(None, init_method=f"file://{work}/store",
                          world_size=1, rank=0, device=dev)
        try:
            rec = scaling.main(["256", "20"], device=str(dev))
        finally:
            dist.destroy_process_group()
        if list(rec["examples_per_s"]) != ["1"] or not (
                rec["examples_per_s"]["1"] > 0):
            raise AssertionError(f"[scale] scaling: {rec}")
        out["scaling_examples_per_s"] = rec["examples_per_s"]["1"]
    counts = {n: fn.launches for n, fn in launches.items()}
    check_launches("[scale]", counts, SCALE_KERNELS)
    log(f"[scale] launches {({n: c for n, c in counts.items() if c})} "
        f"[{card}]")
    _scale_kernels(card, dev, torch.Generator(device=dev).manual_seed(SEED))
    log(f"[scale] phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return out


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
        phase_roster(card, ds, dev, data_dir)
    mark("[roster]")
    phase_trainer(card, ds, dev)
    mark("[trainer]")
    bf16params = phase_bf16params(card, ds, dev)
    mark("[bf16params]")
    phase_shard(card, ds, dev)
    mark("[shard]")
    quality = phase_quality(card, dev)
    mark("[quality]")
    phase_scale(card, dev)
    mark("[scale]")
    kernels = [
        dict(name="gather_rows", route="cuda",
             source="score_tpu_torch/csrc/gather.cu",
             replaces="score_tpu/kernels/gather.py:67",
             launches=launches["gather_rows"],
             quality_launches=quality["gather_rows"], **gather),
        dict(name="scatter_add_rows", route="cuda",
             source="score_tpu_torch/csrc/scatter_add.cu",
             replaces="score_tpu/kernels/gather.py:67 (its transpose, "
                      "XLA's scatter-add)",
             launches=launches["scatter_add_rows"],
             quality_launches=quality["scatter_add_rows"],
             bf16_launches=bf16params["bfloat16"]["launches_bf16"],
             **scatter),
        dict(name="cross_coattn_cand", route="cuda",
             source="score_tpu_torch/csrc/coattn_cand.cu",
             replaces="score_tpu/kernels/coattn_cand.py:275",
             launches=launches["cross_coattn_cand"],
             quality_launches=quality["cross_coattn_cand"], **coattn),
        dict(name="cross_coattn_cand_bwd", route="cuda",
             source="score_tpu_torch/csrc/coattn_cand_bwd.cu",
             replaces="score_tpu/kernels/coattn_cand.py:301",
             launches=launches["cross_coattn_cand_bwd"],
             quality_launches=quality["cross_coattn_cand_bwd"],
             **coattn_bwd),
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
