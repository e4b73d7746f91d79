"""History gathers and lookups (`graph.py`, `nn/embed.py`,
`kernels/gather.py`): the gather kernels' bound time over their device
time, in %."""

KERNELS = ("gather_rows_kernel", "gather_flat_kernel")


def read(t):
    return t.roofline("gather", KERNELS)
