"""The whole step's model FLOPs over the traced wall time, as a share of
the card's bf16 dense peak, in %."""

from portbench.harness.work import BF16_FLOPS_PER_S


def read(t):
    if t.window_s <= 0 or t.flops <= 0 or not t.kernels:
        return None
    return 100.0 * t.flops / t.window_s / BF16_FLOPS_PER_S
