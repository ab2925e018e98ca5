"""Circuit dict -> OpenQASM 2.0 exporter (a copy of
``quantum_simulations_tpu/circuit/export_qasm.py``: the same text).

Completes the QASM round trip with :mod:`.import_qasm` (the reference
ships a parser-only frontend, ``hisvsim_repo/qasm_assembler_standalone.py``,
and exchanges circuits with its QASMBench corpus as .qasm files; this
exporter lets users move circuits the other way — contract dicts out to
any QASM toolchain).

Every contract gate maps to qelib1 (plus the common ``sx``/``ccz``
extensions the importer also accepts):

* name-encoded binary phases ``R(k)``/``CR(k)`` -> ``p``/``cp`` with
  the explicit angle ``2*pi/2^k``;
* ``G(p)`` (Grover rotation) is an RY by ``2*acos(sqrt(1/p))``;
* ``CU(U, exponent)`` has no QASM primitive — it is emitted as the
  exact ABC decomposition (Barenco et al.): controlled-U^e =
  ``p(alpha)`` on the control plus ``rz/ry`` conjugated between two
  ``cx``, preserving the global phase exactly.
"""
from __future__ import annotations

import cmath
import math

import numpy as np

from .contract import validate_circuit_dict

_DIRECT_0 = {
    "H": "h", "X": "x", "Y": "y", "Z": "z", "S": "s", "T": "t",
    "SDG": "sdg", "TDG": "tdg", "SX": "sx",
    "CNOT": "cx", "SWAP": "swap", "CZ": "cz", "CY": "cy",
    "CCX": "ccx", "CCZ": "ccz", "CSWAP": "cswap",
}
_DIRECT_ANGLE = {
    "RX": ("rx", "theta"), "RY": ("ry", "theta"), "RZ": ("rz", "theta"),
    "P": ("p", "phi"), "CP": ("cp", "phi"),
    "CRX": ("crx", "theta"), "CRY": ("cry", "theta"), "CRZ": ("crz", "theta"),
    "RXX": ("rxx", "theta"), "RYY": ("ryy", "theta"), "RZZ": ("rzz", "theta"),
}


def _f(x: float) -> str:
    """Full-precision float literal (round-trips through the parser)."""
    return format(float(x), ".17g")


def _zyz(M: np.ndarray) -> tuple[float, float, float, float]:
    """M = e^{i alpha} Rz(beta) Ry(gamma) Rz(delta) for a 2x2 unitary."""
    M = np.asarray(M, dtype=np.complex128)
    det = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    alpha = 0.5 * cmath.phase(det)
    V = M * np.exp(-1j * alpha)  # det(V) = 1
    gamma = 2.0 * math.atan2(abs(V[1, 0]), abs(V[0, 0]))
    if abs(V[0, 0]) < 1e-12:        # pure off-diagonal: only beta-delta fixed
        half_diff = cmath.phase(V[1, 0])
        beta, delta = half_diff, -half_diff
    elif abs(V[1, 0]) < 1e-12:      # diagonal: only beta+delta fixed
        half_sum = cmath.phase(V[1, 1])
        beta, delta = half_sum, half_sum
    else:
        half_sum = cmath.phase(V[1, 1])
        half_diff = cmath.phase(V[1, 0])
        beta, delta = half_sum + half_diff, half_sum - half_diff
    return alpha, beta, gamma, delta


def _cu_lines(qc: int, qt: int, U_mat, exponent: int) -> list[str]:
    """ABC decomposition of controlled-(U^exponent) into qelib1 gates."""
    M = np.linalg.matrix_power(
        np.asarray(U_mat, dtype=np.complex128), int(exponent))
    alpha, beta, gamma, delta = _zyz(M)
    lines = []
    # C, cx, B, cx, A (time order), then the phase on the control.
    if abs((delta - beta) / 2) > 1e-15:
        lines.append(f"rz({_f((delta - beta) / 2)}) q[{qt}];")
    lines.append(f"cx q[{qc}],q[{qt}];")
    if abs((delta + beta) / 2) > 1e-15:
        lines.append(f"rz({_f(-(delta + beta) / 2)}) q[{qt}];")
    if abs(gamma / 2) > 1e-15:
        lines.append(f"ry({_f(-gamma / 2)}) q[{qt}];")
    lines.append(f"cx q[{qc}],q[{qt}];")
    if abs(gamma / 2) > 1e-15:
        lines.append(f"ry({_f(gamma / 2)}) q[{qt}];")
    if abs(beta) > 1e-15:
        lines.append(f"rz({_f(beta)}) q[{qt}];")
    if abs(alpha) > 1e-15:
        lines.append(f"p({_f(alpha)}) q[{qc}];")
    return lines


def to_qasm(circuit_dict: dict) -> str:
    """Serialise a circuit dict to OpenQASM 2.0 text."""
    cd = validate_circuit_dict(circuit_dict)
    n = cd["number_of_qubits"]
    out = ['OPENQASM 2.0;', 'include "qelib1.inc";', f"qreg q[{n}];"]
    for gate in cd["gates"]:
        name = gate["gate"]
        qs = gate["qubits"]
        params = gate.get("params", {}) or {}
        args = ",".join(f"q[{q}]" for q in qs)
        if name in _DIRECT_0:
            out.append(f"{_DIRECT_0[name]} {args};")
        elif name in _DIRECT_ANGLE:
            qasm_name, key = _DIRECT_ANGLE[name]
            out.append(f"{qasm_name}({_f(params[key])}) {args};")
        elif name == "R":
            out.append(f"p({_f(2 * math.pi / (1 << params['k']))}) {args};")
        elif name == "CR":
            out.append(f"cp({_f(2 * math.pi / (1 << params['k']))}) {args};")
        elif name == "G":
            theta = 2.0 * math.acos(math.sqrt(1.0 / params["p"]))
            out.append(f"ry({_f(theta)}) {args};")
        elif name == "U":
            out.append(
                f"u3({_f(params['theta'])},{_f(params['phi'])},"
                f"{_f(params['lam'])}) {args};")
        elif name == "U2":
            out.append(f"u2({_f(params['phi'])},{_f(params['lam'])}) {args};")
        elif name == "CU":
            out.extend(_cu_lines(qs[0], qs[1], params["U"],
                                 params.get("exponent", 1)))
        else:  # pragma: no cover - contract validation precludes this
            raise ValueError(f"no QASM mapping for gate {name!r}")
    return "\n".join(out) + "\n"
