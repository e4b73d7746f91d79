"""The port's counterparts of the JAX package's scripts/, each run as

    python -m score_tpu_torch.scripts.<name> [arguments] [--device D]

with the arguments and JSON output of scripts/<name>.py, on the card
unless `--device cpu` is given:

- the quality protocol: the ablation ladder with its baseline roster,
  and the four quality gates (table stride, neighbour re-sampling, bf16
  compute, negative mode); `ladder` holds the protocol (generator knobs,
  dataset keying, train section, one run's record) that the gates reuse;
- the reference-scale scripts: `prep_bench` (the 1e8-event prep and the
  CSV path), `eval_scale` (the streaming eval of the whole val split),
  `serve_bench` (the serving envelope; `--catalog`, the 2.92M-item
  top-k), `perf_sweep` (the train-step variants) and `scaling` (1 against
  N ranks), each record naming its card and host (`machine`).
"""
