"""Headline benchmark of the port: nonstab28 in window mode on the card.

Workload: the reference's scaling benchmark family, the non-stabilizer
H+T+CNOT layered circuit at n = 28 (``non_stabilizer(28, depth=4,
seed=7)``: 223 gates, 2^28 complex64 amplitudes), the JAX package's
headline (its root ``bench.py``).  It runs as the window schedule (5
passes) on planar float32 planes, reps chained on the card.

t is the two-point estimate (t(2R) - t(R)) / R, R = 3, each t the
minimum of 3 runs from |0> closed by a norm fetched to the host, so the
fixed cost of a run cancels.

Prints ONE JSON line:
  metric       amplitude-updates per second (223 x 2^28 / t)
  vs_baseline  the reference's out-of-core n = 28 wall time (139 s) / t
  device       the card's name and power limit (nvidia-smi)

    python -m quantum_simulations_tpu_torch.bench.headline
"""
from __future__ import annotations

import json
import time

from . import describe, force, setup_platform, warm_grant

N_QUBITS = 28
REF_WALL_S = 139.0  # reference out-of-core n = 28 (v3_comparison.md:60)


def run(n: int = N_QUBITS, R: int = 3) -> dict:
    import torch

    from ..circuit import library as lib
    from ..ops import dense
    from ..runtime import simulator

    dev = setup_platform()
    warm_grant(dev)
    cd = lib.non_stabilizer(n, depth=4, seed=7)
    gates = len(cd["gates"])
    fn = simulator.build_window_circuit_fn(cd, planar_io=True, device=dev)

    def chain(k: int) -> tuple[float, float]:
        st = dense.zero_state_planar(n, torch.float32, dev)
        force(*st)
        t0 = time.perf_counter()
        for _ in range(k):
            st = fn(*st)
        norm = force(*st)
        return time.perf_counter() - t0, norm

    chain(1)  # warm
    t1 = min(chain(R)[0] for _ in range(3))
    runs2 = [chain(2 * R) for _ in range(3)]
    t2 = min(t for t, _ in runs2)
    dt = (t2 - t1) / R
    return {
        "metric": gates * (1 << n) / dt,
        "unit": "amp-updates/s",
        "workload": f"n={n} non-stabilizer ({gates} gates), window mode",
        "vs_baseline": REF_WALL_S / dt,
        "wall_s": dt,
        "t_R_s": t1,
        "t_2R_s": t2,
        "R": R,
        "n_gates": gates,
        "norm2": runs2[-1][1],
        "device": describe(dev),
    }


def main() -> int:
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
