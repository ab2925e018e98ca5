#!/usr/bin/env python3
"""Time the tensor-core panels of ``csrc/panels.cu`` on one card, with
the dual kernel's variants.

    python3 panel_variants.py        # needs a CUDA card and nvcc

Each variant is the source built with one of its measurement macros
(``-D<name>=1``, see the note above namespace ``tc``), through
``cuda_build`` beside the package's own build (one nvcc each, all started
together), and called through the same C entries:

- ``base``: no macro, the kernels the package runs;
- ``gauss`` (``QST_TC_GAUSS``): the dual's k8 step with Gauss's three
  real products (nine TF32 products a complex multiply-add instead of
  twelve), its error and time;
- ``dualunroll`` / ``dualunroll2`` (``QST_TC_DUAL_UNROLL`` = 4 / 2): the
  dual kernel's four k8 steps a chunk unrolled fully / by 2 (the package
  runs them as a loop).

The macros change the dual only: the lane / positioned kernel
(``panel_tc_kernel``, warpgroup MMA) reads the same in every variant.
Beside its times the script prints the floor of the mma.sync core it
replaced, measured with the split and the per-step fold both off
(``lean``, 3.5-3.7 ms at n = 28; PR 6's panel_variants.py, on an H100
SXM at 700 W).

At n = 28 (the (2^21, 128) lane view, plain and rotated, the positioned
view at pos 14, 21 and 11, and the (0, 7) dual panel) it prints each
variant's median CUDA-event ms and its ||diff||_2 against the float64
twin on a unit-norm state (lane panel and dual), the library call
``x @ W.T`` and a copy of both planes (the bytes floor as the card runs
it), then the card's name, power limit and SM clock.
"""
from __future__ import annotations

import statistics
import subprocess
import sys

VARIANTS = {
    "base": (),
    "gauss": ("QST_TC_GAUSS=1",),
    "dualunroll": ("QST_TC_DUAL_UNROLL=4",),
    "dualunroll2": ("QST_TC_DUAL_UNROLL=2",),
}
LEAN_MS = "3.5-3.7"  # the mma.sync core's floor at n = 28 (PR 6)


def ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def main() -> int:
    import numpy as np
    import torch

    from quantum_simulations_tpu_torch.ops import cuda_build
    from quantum_simulations_tpu_torch.ops import panel_kernels as pk

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 2
    cuda_build.build([("panels", d) for d in VARIANTS.values()])
    libs = {name: pk.variant_library(d) for name, d in VARIANTS.items()}
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    n = 28
    N = 1 << n
    rng = np.random.default_rng(7)
    re = torch.from_numpy(rng.standard_normal(N, dtype=np.float32)).to(dev)
    im = torch.from_numpy(rng.standard_normal(N, dtype=np.float32)).to(dev)
    scale = float(torch.sqrt((re.double() ** 2).sum() + (im.double() ** 2).sum()))
    re /= scale
    im /= scale
    q, r = np.linalg.qr(rng.standard_normal((128, 128))
                        + 1j * rng.standard_normal((128, 128)))
    W = q * (np.diag(r) / np.abs(np.diag(r)))
    w1 = pk.w_planes(W, dev, torch.float32)
    wr, wi = w1
    wtc = pk.tc_operand(w1)
    w2r, w2i = pk.w_planes(W.conj(), dev, torch.float32)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    want = pk.lane_panel_plain(re.double(), im.double(), W)
    want2 = pk.dual_panel_plain(re.double(), im.double(), W, 0, W.conj(), 7)

    def l2(w):
        return float(torch.sqrt(((ore.double() - w[0]) ** 2).sum()
                                + ((oim.double() - w[1]) ** 2).sum()))

    def check(err: int, entry: str) -> None:
        if err:
            raise RuntimeError(f"{entry}: CUDA error {err}")

    def lane(lib, rotate=0):
        check(lib.qst_lane_panel(re.data_ptr(), im.data_ptr(), wr.data_ptr(),
                                 wi.data_ptr(), wtc.data_ptr(), ore.data_ptr(),
                                 oim.data_ptr(), N // 128, 128, rotate, None,
                                 0, 0, 0, stream), "qst_lane_panel")

    def pos(lib, p):
        check(lib.qst_positioned_panel(
            re.data_ptr(), im.data_ptr(), wr.data_ptr(), wi.data_ptr(),
            wtc.data_ptr(), ore.data_ptr(), oim.data_ptr(), N >> (7 + p),
            128, 1 << p, None, 0, 0, 0, stream), "qst_positioned_panel")

    def dual(lib):
        check(lib.qst_dual_panel(
            re.data_ptr(), im.data_ptr(), wr.data_ptr(), wi.data_ptr(), 0,
            w2r.data_ptr(), w2i.data_ptr(), 1, None, 0, None, 0,
            ore.data_ptr(), oim.data_ptr(), N >> 14, None, 0, 0, 0, stream),
            "qst_dual_panel")

    for name, lib in libs.items():
        lane(lib)
        torch.cuda.synchronize()
        err = l2(want)
        dual(lib)
        torch.cuda.synchronize()
        err2 = l2(want2)
        t = {"lane": ms(lambda: lane(lib)), "rotate": ms(lambda: lane(lib, 1)),
             "pos14": ms(lambda: pos(lib, 14)), "pos21": ms(lambda: pos(lib, 21)),
             "pos11": ms(lambda: pos(lib, 11)), "dual": ms(lambda: dual(lib))}
        print(f"variant {name:8s} l2_vs_f64={err:.3e} dual_l2_vs_f64={err2:.3e} "
              + " ".join(f"{k}_ms={v:.3f}" for k, v in t.items()), flush=True)
    print(f"mma.sync panel core's floor (lean, PR 6, quoted) ms={LEAN_MS}")
    xl = torch.complex(re, im).view(-1, 128)
    Wt = torch.as_tensor(W, dtype=torch.complex64, device=dev).T.contiguous()
    print(f"library x @ W.T ms={ms(lambda: xl @ Wt):.3f}")
    print(f"copy of both planes ms={ms(lambda: (ore.copy_(re), oim.copy_(im))):.3f}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
