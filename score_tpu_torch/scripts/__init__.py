"""The quality protocol on the port: the ablation ladder with its baseline
roster, and the four quality gates (table stride, neighbour re-sampling,
bf16 compute, negative mode). Each module runs as

    python -m score_tpu_torch.scripts.<name> [arguments] [--device D]

with the arguments and JSON output of the JAX package's scripts/<name>.py,
on the card unless `--device cpu` is given. `ladder` holds the protocol
(generator knobs, dataset keying, train section, one run's record) that
the gates reuse.
"""
