"""GB/s by op class against the card's byte rate.

For each op class (a 1q gate at a low and at the top bit, a 2q gate on
two high bits and on a low and a high bit, a 128-wide 8-gate panel, the
bit rotation by 7, a crossing CZ, the CUDA lane panel and the CUDA fused
diagonal of 6 gates) one pass is timed on (re, im) planes of 2^n
amplitudes: ``iters`` chained calls between two CUDA events, the median
of ``reps`` such runs.  Each gate goes through the port's planar gate
path (``runtime/simulator.apply_gate``: a kernel where one takes the
gate, else the plain torch paths of ``ops/dense.py``), and ``route``
names which; ``panel128_8gates`` is the framework's own product (``x @
W.T`` on the complex64 view, the counterpart of the JAX package's XLA
panel), ``rotate7`` the panel mode's rotation step (``tiled_transpose``).
A pass reads and writes the state once: GB/s = 2 x 8 x 2^n / s, beside
its share of the card's 3.35 TB/s.  A kernel that fails raises.
"""
from __future__ import annotations

import json

from . import HBM_BYTES_PER_S, describe, device_s, setup_platform, warm_grant


def _diag_terms(n: int) -> tuple:
    """The merged Möbius terms of 6 random diagonal gates on mixed bits."""
    import numpy as np

    from ..circuit.panelize import diag_phase_terms

    rng = np.random.default_rng(7)
    terms: dict = {}
    for qs in [(3, n - 3), (n - 1,), (5,), (8, 2), (n - 2, 9), (0,)]:
        dv = np.exp(1j * rng.uniform(-np.pi, np.pi, size=1 << len(qs)))
        for k, c in diag_phase_terms(qs, dv).items():
            k = tuple(sorted(k))
            terms[k] = terms.get(k, 0.0) + c
    return tuple(terms.items())


def run(n: int = 26, reps: int = 3, iters: int = 16) -> dict:
    import torch

    from ..circuit import gates as G
    from ..ops import bitperm_kernels as bk
    from ..ops import dense
    from ..ops import diag_kernels as dk
    from ..ops import panel_kernels as pk
    from ..runtime import simulator

    dev = setup_platform()
    warm_grant(dev)
    N = 1 << n
    nbytes = N * 8

    H = G.H()
    W = dense.compose_low_panel(
        [((q,), H) for q in range(7)] + [((0, 1), G.CNOT())], 7)
    wp = pk.w_planes(W, dev, torch.float32)
    Wt = torch.as_tensor(W.T.copy(), dtype=torch.complex64, device=dev)
    terms = dk.DiagTerms.of(_diag_terms(n))
    if dev.type == "cuda":
        terms.operand(dev)

    def gate(qubits, U):
        return (lambda re, im: simulator.apply_gate(re, im, qubits, U),
                simulator.gate_route(qubits, U, n))

    def matmul(re, im):
        out = torch.complex(re, im).view(-1, pk.LANES) @ Wt
        return pk.to_planar(out.view(-1))

    cases = {
        "1q_plane_q8": gate((8,), H),
        f"1q_plane_q{n-1}": gate((n - 1,), H),
        "2q_plane_hi": gate((n - 2, 9), G.CNOT()),
        "2q_mixed_lo_hi": gate((2, n - 2), G.CNOT()),
        "panel128_8gates": (matmul, "torch matmul"),
        "rotate7": (lambda re, im: bk.tiled_transpose(re, im, N >> 7, 128),
                    "tiled_transpose"),
        "diag_cz_crossing": gate((3, n - 3), G.CZ()),
        "cuda_lane_panel": (lambda re, im: pk.lane_panel(re, im, wp),
                            "lane_panel"),
        "cuda_fused_diag_6gates": (
            lambda re, im: dk.fused_diag(re, im, terms, inplace=True),
            "fused_diag in place"),
    }

    results = {}
    for name, (op, route) in cases.items():
        state = list(dense.zero_state_planar(n, torch.float32, dev))
        state[0].fill_(0.5)
        state[1].fill_(0.5)

        def step(op=op, state=state):
            state[:] = op(*state)

        per = device_s(step, iters, reps, dev)
        gbs = 2 * nbytes / per / 1e9
        results[name] = {
            "route": route,
            "s_per_pass": per,
            "GBs": round(gbs, 1),
            "pct_of_bound": round(100 * gbs * 1e9 / HBM_BYTES_PER_S, 1),
        }
    return {"n": n, "dtype": "complex64", "iters": iters,
            "device": describe(dev), "bound_GBs": HBM_BYTES_PER_S / 1e9,
            "ops": results}


if __name__ == "__main__":
    print(json.dumps(run(), indent=1))
