"""Co-attention forward (`nn/coattn.py`, `kernels/coattn_cand.py`): the
candidates kernel's bound time over its device time, in %."""

KERNELS = ("cand_fwd_kernel",)


def read(t):
    return t.roofline("coattn_fwd", KERNELS)
