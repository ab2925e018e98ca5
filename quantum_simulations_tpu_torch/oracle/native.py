"""Fast native-CPU simulator: the large-n oracle / CPU performance tier
(a copy of ``quantum_simulations_tpu/oracle/native.py``).

Same semantics as :mod:`oracle.dense_numpy` but runs on the C++/OpenMP
kernels (``native/host_engine.cpp``), in-place on one buffer — practical
to n ~ 32 in complex64 on a large host.  Fills the role of the
reference's in-RAM C++ engine (hisvsim) for verification and CPU runs.

Diagonal gates use the fused diag kernel; everything else uses the
strided pair/quad kernels.  Gates of arity >= 3 fall back to numpy.
"""
from __future__ import annotations

import numpy as np

from ..circuit import gates as G
from ..circuit.contract import validate_circuit_dict
from .. import native
from . import dense_numpy


def available() -> bool:
    return native.available()


def simulate(
    circuit_dict: dict,
    *,
    dtype=np.complex128,
    initial_state: np.ndarray | None = None,
) -> np.ndarray:
    """Run a circuit on the native CPU engine; returns the final state."""
    if not native.available():
        raise RuntimeError("native engine unavailable")
    cd = validate_circuit_dict(circuit_dict)
    n = cd["number_of_qubits"]
    if initial_state is None:
        psi = np.zeros(1 << n, dtype=dtype)
        psi[0] = 1.0
    else:
        psi = np.array(initial_state, dtype=dtype, copy=True)

    for g in cd["gates"]:
        U = G.gate_matrix(g["gate"], g["params"])
        qs = g["qubits"]
        if G.is_diagonal(U):
            native.apply_diag(psi, qs, np.diag(U))
        elif len(qs) == 1:
            native.apply_1q(psi, qs[0], U)
        elif len(qs) == 2:
            native.apply_2q(psi, qs[0], qs[1], U)
        else:
            psi = dense_numpy.apply_gate(psi, qs, U).astype(dtype)
    return psi


def prob_qubit(psi: np.ndarray, q: int) -> float:
    """P(qubit q == 1) on the native kernels."""
    return native.prob_qubit(psi, q)


def measure_qubit(
    psi: np.ndarray, q: int, rng: np.random.Generator | None = None,
) -> tuple[int, np.ndarray]:
    """Projective measurement of qubit q: (outcome, collapsed state).

    Collapse + renormalization run in-place on the buffer (which is
    modified!) via the native project kernel — parity with the
    reference's state_vector measure path
    (hisvsim_repo/state_vector.hpp:829-897).
    """
    rng = rng or np.random.default_rng()
    p1 = native.prob_qubit(psi, q)
    outcome = int(rng.random() < p1)
    p = p1 if outcome else 1.0 - p1
    if p <= 0.0:
        raise ValueError(f"measurement outcome {outcome} has probability 0")
    native.project_qubit(psi, q, outcome, 1.0 / np.sqrt(p))
    return outcome, psi


def measure_all(
    psi: np.ndarray, n: int, rng: np.random.Generator | None = None,
) -> str:
    """Measure every qubit (in-place collapse); returns the bitstring
    little-endian (character i = qubit i)."""
    rng = rng or np.random.default_rng()
    bits = []
    for q in range(n):
        outcome, psi = measure_qubit(psi, q, rng)
        bits.append(str(outcome))
    return "".join(bits)
