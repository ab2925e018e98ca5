"""Gate matrix library (numpy, complex128).

A copy of ``quantum_simulations_tpu/circuit/gates.py``: the port
imports nothing of the JAX package.

Conventions (compatible with the reference circuit contract,
``wenbo_engine/kernel/gates.py:1-11`` and
``wenbo_engine/docs/circuit_contract.md``):

* 1-qubit gates are 2x2 complex128 ndarrays.
* 2-qubit gates are 4x4 complex128 ndarrays in **big-endian subspace
  order**: row/col index = 2*b_a + b_b where ``q_a = qubits[0]`` and
  ``q_b = qubits[1]`` from the gate entry.  (Row 0 = |q_a=0, q_b=0>.)
* The statevector itself is **little-endian**: qubit 0 is bit 0 (the
  LSB) of the amplitude index.

The *core* gate set is the reference's 15 gates: H X Y Z S T, RY(theta)
R(k) G(p), CNOT SWAP CZ CY, CR(k) CU(U, exponent).  On top of that we
expose an *extended* set (RX RZ P SDG TDG SX U U2, CP RXX RYY RZZ CRX
CRY CRZ, CCX CCZ CSWAP) so that QASM / Qiskit / QAOA workloads (e.g.
the BASELINE QAOA-MaxCut config with RZZ/RX layers) run natively
through the same engine.  Extended gates are a strict superset; the
core contract is unchanged.

Structure metadata (``is_diagonal``, ``block_structure``) drives the
execution planner: diagonal gates on device-resident qubits need no
inter-chip communication, and control-block-diagonal gates whose
control sits on a device bit reduce to a per-device conditional local
op (cf. the "insular"/sparse-gate relaxation in the reference's
staging, ``wenbo_engine/circuit/staging.py:65-98`` — here we exploit it
at runtime, not only during scheduling).
"""
from __future__ import annotations

import numpy as np

_INV_SQRT2 = 1.0 / np.sqrt(2.0)


def _m(*rows) -> np.ndarray:
    return np.array(rows, dtype=np.complex128)


# ---------------------------------------------------------------------------
# 1-qubit fixed
# ---------------------------------------------------------------------------

def H() -> np.ndarray:
    return _m([_INV_SQRT2, _INV_SQRT2], [_INV_SQRT2, -_INV_SQRT2])


def X() -> np.ndarray:
    return _m([0, 1], [1, 0])


def Y() -> np.ndarray:
    return _m([0, -1j], [1j, 0])


def Z() -> np.ndarray:
    return _m([1, 0], [0, -1])


def S() -> np.ndarray:
    return _m([1, 0], [0, 1j])


def T() -> np.ndarray:
    return _m([1, 0], [0, np.exp(1j * np.pi / 4)])


def SDG() -> np.ndarray:
    return _m([1, 0], [0, -1j])


def TDG() -> np.ndarray:
    return _m([1, 0], [0, np.exp(-1j * np.pi / 4)])


def SX() -> np.ndarray:
    return 0.5 * _m([1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j])


# ---------------------------------------------------------------------------
# 1-qubit parameterised
# ---------------------------------------------------------------------------

def RY(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2.0), np.sin(theta / 2.0)
    return _m([c, -s], [s, c])


def RX(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2.0), np.sin(theta / 2.0)
    return _m([c, -1j * s], [-1j * s, c])


def RZ(theta: float) -> np.ndarray:
    return _m([np.exp(-0.5j * theta), 0], [0, np.exp(0.5j * theta)])


def R(k: int) -> np.ndarray:
    """Phase gate exp(2*pi*i / 2^k) on |1> (QFT-style binary phase)."""
    return _m([1, 0], [0, np.exp(2j * np.pi / (1 << k))])


def P(phi: float) -> np.ndarray:
    """Arbitrary-angle phase gate diag(1, e^{i phi})."""
    return _m([1, 0], [0, np.exp(1j * phi)])


def G(p: int) -> np.ndarray:
    """Grover-style rotation: [[sqrt(1/p), -sqrt(1-1/p)], [sqrt(1-1/p), sqrt(1/p)]]."""
    a = np.sqrt(1.0 / p)
    b = np.sqrt(1.0 - 1.0 / p)
    return _m([a, -b], [b, a])


def U(theta: float, phi: float, lam: float) -> np.ndarray:
    """Generic SU(2) gate (OpenQASM u3 convention)."""
    c, s = np.cos(theta / 2.0), np.sin(theta / 2.0)
    return _m(
        [c, -np.exp(1j * lam) * s],
        [np.exp(1j * phi) * s, np.exp(1j * (phi + lam)) * c],
    )


def U2(phi: float, lam: float) -> np.ndarray:
    return U(np.pi / 2.0, phi, lam)


# ---------------------------------------------------------------------------
# 2-qubit fixed (big-endian subspace: row = 2*b_qa + b_qb)
# ---------------------------------------------------------------------------

def CNOT() -> np.ndarray:
    return _m([1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0])


def SWAP() -> np.ndarray:
    return _m([1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1])


def CZ() -> np.ndarray:
    return _m([1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, -1])


def CY() -> np.ndarray:
    return _m([1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, -1j], [0, 0, 1j, 0])


# ---------------------------------------------------------------------------
# 2-qubit parameterised
# ---------------------------------------------------------------------------

def CR(k: int) -> np.ndarray:
    """Controlled binary phase: phase exp(2*pi*i / 2^k) on |11>."""
    return _m(
        [1, 0, 0, 0],
        [0, 1, 0, 0],
        [0, 0, 1, 0],
        [0, 0, 0, np.exp(2j * np.pi / (1 << k))],
    )


def CP(phi: float) -> np.ndarray:
    return _m(
        [1, 0, 0, 0],
        [0, 1, 0, 0],
        [0, 0, 1, 0],
        [0, 0, 0, np.exp(1j * phi)],
    )


def CU(U_mat, exponent: int = 1) -> np.ndarray:
    """Controlled-U^exponent: control = qubits[0], target = qubits[1]."""
    Up = np.linalg.matrix_power(np.asarray(U_mat, dtype=np.complex128), exponent)
    out = np.eye(4, dtype=np.complex128)
    out[2:4, 2:4] = Up
    return out


def _controlled(U1q: np.ndarray) -> np.ndarray:
    out = np.eye(4, dtype=np.complex128)
    out[2:4, 2:4] = U1q
    return out


def CRX(theta: float) -> np.ndarray:
    return _controlled(RX(theta))


def CRY(theta: float) -> np.ndarray:
    return _controlled(RY(theta))


def CRZ(theta: float) -> np.ndarray:
    return _controlled(RZ(theta))


def RZZ(theta: float) -> np.ndarray:
    """exp(-i theta/2 Z(x)Z) — diagonal; the QAOA MaxCut cost layer."""
    e_m = np.exp(-0.5j * theta)
    e_p = np.exp(0.5j * theta)
    return np.diag([e_m, e_p, e_p, e_m]).astype(np.complex128)


def RXX(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2.0), -1j * np.sin(theta / 2.0)
    out = np.zeros((4, 4), dtype=np.complex128)
    for i in range(4):
        out[i, i] = c
        out[i, 3 - i] = s
    return out


def RYY(theta: float) -> np.ndarray:
    c = np.cos(theta / 2.0)
    m = -1j * np.sin(theta / 2.0)
    return np.array(
        [
            [c, 0, 0, -m],
            [0, c, m, 0],
            [0, m, c, 0],
            [-m, 0, 0, c],
        ],
        dtype=np.complex128,
    )


# ---------------------------------------------------------------------------
# 3-qubit fixed (row = 4*b_q0 + 2*b_q1 + b_q2, big-endian subspace)
# ---------------------------------------------------------------------------

def CCX() -> np.ndarray:
    out = np.eye(8, dtype=np.complex128)
    out[[6, 7]] = out[[7, 6]]
    return out


def CCZ() -> np.ndarray:
    out = np.eye(8, dtype=np.complex128)
    out[7, 7] = -1
    return out


def CSWAP() -> np.ndarray:
    out = np.eye(8, dtype=np.complex128)
    out[[5, 6]] = out[[6, 5]]
    return out


# ---------------------------------------------------------------------------
# Registry & dispatch
# ---------------------------------------------------------------------------

# Core contract gates (reference parity).
FIXED_1Q = {"H": H, "X": X, "Y": Y, "Z": Z, "S": S, "T": T}
PARAM_1Q = {"RY": RY, "R": R, "G": G}
FIXED_2Q = {"CNOT": CNOT, "SWAP": SWAP, "CZ": CZ, "CY": CY}
PARAM_2Q = {"CR": CR, "CU": CU}

# Extended gates (superset; documented, not in the core contract).
EXT_FIXED_1Q = {"SDG": SDG, "TDG": TDG, "SX": SX}
EXT_PARAM_1Q = {"RX": RX, "RZ": RZ, "P": P, "U": U, "U2": U2}
EXT_PARAM_2Q = {
    "CP": CP,
    "CRX": CRX,
    "CRY": CRY,
    "CRZ": CRZ,
    "RXX": RXX,
    "RYY": RYY,
    "RZZ": RZZ,
}
EXT_FIXED_3Q = {"CCX": CCX, "CCZ": CCZ, "CSWAP": CSWAP}

PARAM_SPEC: dict[str, tuple[str, ...]] = {
    "RY": ("theta",),
    "R": ("k",),
    "G": ("p",),
    "CR": ("k",),
    "CU": ("U", "exponent"),
    "RX": ("theta",),
    "RZ": ("theta",),
    "P": ("phi",),
    "U": ("theta", "phi", "lam"),
    "U2": ("phi", "lam"),
    "CP": ("phi",),
    "CRX": ("theta",),
    "CRY": ("theta",),
    "CRZ": ("theta",),
    "RXX": ("theta",),
    "RYY": ("theta",),
    "RZZ": ("theta",),
}

ALL_1Q = set(FIXED_1Q) | set(PARAM_1Q) | set(EXT_FIXED_1Q) | set(EXT_PARAM_1Q)
ALL_2Q = set(FIXED_2Q) | set(PARAM_2Q) | set(EXT_PARAM_2Q)
ALL_3Q = set(EXT_FIXED_3Q)
ALL_GATES = ALL_1Q | ALL_2Q | ALL_3Q
CORE_GATES = (
    set(FIXED_1Q) | set(PARAM_1Q) | set(FIXED_2Q) | set(PARAM_2Q)
)

_FIXED = {**FIXED_1Q, **FIXED_2Q, **EXT_FIXED_1Q, **EXT_FIXED_3Q}
_PARAM = {**PARAM_1Q, **PARAM_2Q, **EXT_PARAM_1Q, **EXT_PARAM_2Q}


def arity(name: str) -> int:
    if name in ALL_1Q:
        return 1
    if name in ALL_2Q:
        return 2
    if name in ALL_3Q:
        return 3
    raise ValueError(f"unknown gate {name!r}")


def gate_matrix(name: str, params: dict | None = None) -> np.ndarray:
    """Return the unitary for a gate entry (complex128 ndarray)."""
    params = params or {}
    if name in _FIXED:
        return _FIXED[name]()
    fn = _PARAM.get(name)
    if fn is None:
        raise ValueError(f"unknown gate {name!r}")
    spec = PARAM_SPEC[name]
    try:
        args = [params[p] for p in spec]
    except KeyError as e:
        raise ValueError(f"gate {name} missing param {e.args[0]!r}") from None
    return fn(*args)


def is_2q(name: str) -> bool:
    return name in ALL_2Q


# ---------------------------------------------------------------------------
# Structure analysis (drives the communication planner)
# ---------------------------------------------------------------------------

def is_diagonal(U: np.ndarray, atol: float = 1e-12) -> bool:
    """True if U is diagonal (phase-only); such gates never need comm."""
    return bool(np.allclose(U, np.diag(np.diag(U)), atol=atol))


def block_diagonal_in(U: np.ndarray, sub_bit: int, atol: float = 1e-12) -> bool:
    """True if the m-qubit unitary U never flips sub-space bit ``sub_bit``.

    ``sub_bit`` indexes into the gate's big-endian subspace index (bit 0 =
    the *last* qubit of the gate entry).  If U is block-diagonal w.r.t.
    that bit, a shard whose device bit carries this qubit can apply the
    gate without exchanging amplitudes: the per-device block is selected
    by the device's own bit value.
    """
    dim = U.shape[0]
    idx = np.arange(dim)
    b = (idx >> sub_bit) & 1
    off = (b[:, None] != b[None, :])
    return bool(np.max(np.abs(U * off)) <= atol)


def sub_block(U: np.ndarray, sub_bit: int, value: int) -> np.ndarray:
    """Extract the diagonal block of U for subspace bit ``sub_bit`` == value.

    Only meaningful when ``block_diagonal_in(U, sub_bit)`` holds.  The
    result is the (dim/2 x dim/2) unitary acting on the remaining qubits.
    """
    dim = U.shape[0]
    idx = np.arange(dim)
    sel = idx[((idx >> sub_bit) & 1) == value]
    return U[np.ix_(sel, sel)]
