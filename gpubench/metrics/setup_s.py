"""setup_s: process start to the window, on the host's clock: ``import
torch`` and the CUDA context, the port's kernels (nvcc on a checkout's
first run, loaded after), one warm request of the cell's traffic."""


def read(run):
    return run.setup_s
