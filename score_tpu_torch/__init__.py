"""score_tpu_torch — the PyTorch and CUDA port of score_tpu for NVIDIA
Hopper (H100).

The JAX package `score_tpu` is the reference; this package mirrors its
module names. It imports torch and numpy, and never JAX nor anything of
score_tpu: it keeps its own copy of the JAX-free host layer (config.py,
data/, native/).

Layout:
    config.py  configuration dataclasses and presets (copy)
    data/      dataset schema, synthetic events, prep, batch iterator (copy)
    native/    the C++ adjacency construction prep uses (copy)
    kernels/   hand-written CUDA kernels (sources in csrc/), each with a
               plain PyTorch version for CPU tensors and a launch counter
    graph.py   device graph store and history gathers
    nn/        embed, slot aggregation (mean, slot attention,
               co-attention), encoders, scorer, model (configs0-3)
    params.py  flax <-> torch weight and optimizer-state bridge,
               flax-faithful init
    metrics.py auc
    serve.py   ScoringService: score, score_batch, topk, topk_batch
    optim.py   adam, adamw, adagrad, sgd; constant, warmup and
               warmup-cosine learning rates; the table boost
    train.py   the train step and loop (uniform or in-batch negatives,
               stride-K tables, neighbour re-sampling, scorer dropout),
               eval, the train() driver, CLI
    debug.py   batch bounds, a checked lookup, autograd NaN checks
    profiling.py  a profiler window, timing, a FLOP count

Entry points run on the CUDA card unless the caller passes device="cpu".
"""
