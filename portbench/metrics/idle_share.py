"""The device's idle share of the traced wall time: 1 - the union of its
operations' intervals over the wall time."""


def read(t):
    if t.window_s <= 0 or not t.kernels:
        return None
    return 1.0 - t.busy_s() / t.window_s
