"""The step on the host (`train.train_step`, `optim.py`, autograd, the
service's and eval's dispatch): kernels in the device trace a block."""


def read(t):
    kernels = t.kernel_list()
    if not t.units or not kernels:
        return None
    return len(kernels) / t.units
