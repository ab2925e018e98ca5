"""The least time the card could take for a pass of the port's kernels.

Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
power limit): 3.35 TB/s of HBM, 495 TFLOP/s of TF32 on the tensor cores,
the highest rate at which it multiplies float32-class operands.  No
measured number is used, so no implementation can read over 100%.

A pass of a kernel sweeps the whole state once: both float32 planes
read once and written once, 16 B an amplitude (copied from the port's
``bench.work``; a panel's W and a straddler's U, at most 256 KiB against
4.3 GB at n = 28, are left out, so the bound is never over-counted).
Its operations: 8 real flop per complex multiply-add, and the kernel's
shape fixes how many it does per amplitude (:data:`KERNELS`), at the
TF32 rate whatever precision the kernel uses.  The bound is the larger
of the two: at n = 28, 1.282 ms by bytes for every kernel, since a dual
panel's 256 multiply-adds an amplitude take 1.110 ms.
"""
from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
BYTES_PER_AMP = 16
FLOP_PER_CMA = 8

# Complex multiply-adds an amplitude of each kernel of ``csrc/``, the
# least its shape allows: a tensor-core panel is 128 wide, a dual two of
# them; a SIMT panel at least 2; a 4x4 pair gate 4; a diagonal run, a
# straddler-free permutation or transpose none.  ``bitperm_involution``
# moves only the rows of its 2-cycles, which its name does not say, so
# it is not counted.
KERNELS = {
    "panel_tc_kernel": 128,
    "dual_tc_kernel": 256,
    "lane_panel_kernel": 2,
    "positioned_panel_kernel": 2,
    "pair_gate_kernel": 4,
    "fused_diag_kernel": 0,
    "bitperm_swap_kernel": 0,
    "tile_cross_kernel": 0,
    "tiled_transpose_kernel": 0,
}
_NAME = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(KERNELS)
                   + r")(?![A-Za-z0-9_])")


def kernel_of(trace_name: str) -> str | None:
    """The ``csrc`` kernel a device trace's name is an instance of."""
    m = _NAME.search(trace_name)
    return m.group(1) if m else None


def bound_s(kernel: str, n: int) -> float:
    """Seconds the card needs at least for one pass over 2^n amplitudes."""
    amps = 1 << n
    t_bytes = BYTES_PER_AMP * amps / HBM_BYTES_PER_S
    t_ops = FLOP_PER_CMA * KERNELS[kernel] * amps / TF32_FLOP_PER_S
    return max(t_bytes, t_ops)
