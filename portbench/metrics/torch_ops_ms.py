"""Encoders, scorer, loss and optimizer (torch ops and cuBLAS): device ms,
a unit, of every kernel that is not one of the program's own."""


def read(t):
    kernels = t.kernel_list()
    if not t.units or not kernels:
        return None
    spent = sum(d for k, _, d in kernels if not t.is_own(k))
    return 1e3 * spent / t.units
