"""kernels_roofline: the least time the card could take for the port's
kernel passes of the traced window (``roofline.bound_s``), as a share of
their summed device time.  Each pass is taken to sweep the cell's 2^n
state, as every pass of the single-card dense tiers does."""
from gpubench import roofline


def read(run):
    if run.trace is None:
        return None
    least = spent = 0.0
    for name, _, dur in run.trace.kernels:
        k = roofline.kernel_of(name)
        if k is not None:
            least += roofline.bound_s(k, run.n)
            spent += dur * 1e-6
    return 100.0 * least / spent if spent else None
