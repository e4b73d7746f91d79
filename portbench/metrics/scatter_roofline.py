"""Table gradients (`kernels/gather.py` scatter_add_rows): the scatter-add
kernels' bound time over their device time, in %."""

KERNELS = ("scatter_add_kernel", "scatter_add_round_kernel")


def read(t):
    return t.roofline("scatter", KERNELS)
