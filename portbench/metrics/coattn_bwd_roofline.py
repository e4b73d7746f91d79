"""Co-attention backward (`kernels/coattn_cand.py` cross_coattn_cand_bwd):
the shared backward and its partial sums' bound time over their device
time, in %."""

KERNELS = ("coattn_bwd_kernel", "sum_partials_kernel")


def read(t):
    return t.roofline("coattn_bwd", KERNELS)
