"""A plain statevector simulator and its readouts.

The state is a 1-D complex tensor of 2^n amplitudes; qubit q is bit q of
the index (little-endian), and a 2-qubit gate's 4x4 matrix is in the
circuit contract's big-endian subspace order, row 2 * b_a + b_b for
``qubits = [a, b]``.  Every gate is applied to the whole state with
plain torch operations: a diagonal gate as products in place, a
permutation as block copies, any other gate as a linear combination of
cloned blocks.

``GATES`` holds every 1- and 2-qubit gate of the circuit contract, under
the contract's names and parameter names: the core set (H X Y Z S T,
RY(theta) R(k) G(p), CNOT SWAP CZ CY, CR(k) CU(U, exponent)), the
extended set (SDG TDG SX, RX RZ P U U2, CP CRX CRY CRZ RXX RYY RZZ),
and FSIM(theta, phi), the coupler of Google's Sycamore processor (Arute
et al., Nature 574, 505 (2019), supplement; Cirq's ``FSimGate``).  Each
is written from its published definition: the contract's own for R, G,
CY, CR and CU, OpenQASM 2's ``u3`` and ``u2`` for U and U2,
exp(-i theta/2 P(x)P) for RXX, RYY and RZZ.  The 3-qubit gates (CCX
CCZ CSWAP) are not here: ``apply_gate`` takes 1- and 2-qubit gates only.

``tf32=True`` is the control: the state in complex64, and before every
gate both the state and the gate's entries are rounded to TF32 (10
mantissa bits, to nearest), so each product is what a TF32 tensor core
forms and each sum is a float32 sum.
"""
from __future__ import annotations

import cmath
import math

import numpy as np
import torch

_R2 = 1.0 / math.sqrt(2.0)


def _rz(theta):
    return np.diag([cmath.exp(-0.5j * theta), cmath.exp(0.5j * theta)])


def _controlled(u) -> np.ndarray:
    """The 4x4 of ``u`` on qubits[1] controlled by qubits[0] = 1."""
    out = np.eye(4, dtype=np.complex128)
    out[2:, 2:] = u
    return out


def _u3(theta, phi, lam):
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array([[c, -cmath.exp(1j * lam) * s],
                     [cmath.exp(1j * phi) * s, cmath.exp(1j * (phi + lam)) * c]])


def _pauli_pair(theta, p):
    """exp(-i theta/2 P(x)P) = cos(theta/2) I - i sin(theta/2) P(x)P, as
    (P(x)P)^2 = I."""
    return (math.cos(theta / 2) * np.eye(4)
            - 1j * math.sin(theta / 2) * np.kron(p, p))


GATES = {
    "H": lambda: np.array([[_R2, _R2], [_R2, -_R2]]),
    "X": lambda: np.array([[0, 1], [1, 0]]),
    "Y": lambda: np.array([[0, -1j], [1j, 0]]),
    "Z": lambda: np.diag([1, -1]),
    "S": lambda: np.diag([1, 1j]),
    "SDG": lambda: np.diag([1, -1j]),
    "T": lambda: np.diag([1, cmath.exp(0.25j * math.pi)]),
    "TDG": lambda: np.diag([1, cmath.exp(-0.25j * math.pi)]),
    "SX": lambda: 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]]),
    "RX": lambda theta: np.array(
        [[math.cos(theta / 2), -1j * math.sin(theta / 2)],
         [-1j * math.sin(theta / 2), math.cos(theta / 2)]]),
    "RY": lambda theta: np.array(
        [[math.cos(theta / 2), -math.sin(theta / 2)],
         [math.sin(theta / 2), math.cos(theta / 2)]]),
    "RZ": _rz,
    "P": lambda phi: np.diag([1, cmath.exp(1j * phi)]),
    "CNOT": lambda: np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]]),
    "CZ": lambda: np.diag([1, 1, 1, -1]),
    "SWAP": lambda: np.array(
        [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]]),
    "CP": lambda phi: np.diag([1, 1, 1, cmath.exp(1j * phi)]),
    "RZZ": lambda theta: np.diag(
        [cmath.exp(-0.5j * theta), cmath.exp(0.5j * theta),
         cmath.exp(0.5j * theta), cmath.exp(-0.5j * theta)]),
    "R": lambda k: np.diag([1, cmath.exp(2j * math.pi / (1 << k))]),
    "G": lambda p: np.array(
        [[math.sqrt(1 / p), -math.sqrt(1 - 1 / p)],
         [math.sqrt(1 - 1 / p), math.sqrt(1 / p)]]),
    "U": _u3,
    "U2": lambda phi, lam: _R2 * np.array(
        [[1, -cmath.exp(1j * lam)],
         [cmath.exp(1j * phi), cmath.exp(1j * (phi + lam))]]),
    "CY": lambda: _controlled(GATES["Y"]()),
    "CR": lambda k: np.diag([1, 1, 1, cmath.exp(2j * math.pi / (1 << k))]),
    "CU": lambda U, exponent: _controlled(np.linalg.matrix_power(
        np.asarray(U, dtype=np.complex128), exponent)),
    "CRX": lambda theta: _controlled(GATES["RX"](theta)),
    "CRY": lambda theta: _controlled(GATES["RY"](theta)),
    "CRZ": lambda theta: _controlled(GATES["RZ"](theta)),
    "RXX": lambda theta: _pauli_pair(theta, GATES["X"]()),
    "RYY": lambda theta: _pauli_pair(theta, GATES["Y"]()),
    "FSIM": lambda theta, phi: np.array(
        [[1, 0, 0, 0],
         [0, math.cos(theta), -1j * math.sin(theta), 0],
         [0, -1j * math.sin(theta), math.cos(theta), 0],
         [0, 0, 0, cmath.exp(-1j * phi)]]),
}


def gate_matrix(gate: dict) -> np.ndarray:
    """The complex128 matrix of one gate entry of a circuit dict."""
    name = gate["gate"]
    if name not in GATES:
        raise NotImplementedError(f"the reference has no gate {name!r}")
    return np.asarray(GATES[name](**gate.get("params", {})), dtype=np.complex128)


def round_tf32_(x: torch.Tensor) -> torch.Tensor:
    """Round a complex64 (or float32) tensor in place to TF32: 10 mantissa
    bits, to nearest with ties away from zero (``cvt.rna.tf32.f32``)."""
    bits = torch.view_as_real(x) if x.is_complex() else x
    bits = bits.view(torch.int32)
    bits.add_(0x1000).bitwise_and_(~0x1FFF)
    return x


def _tf32_scalar(z: complex) -> complex:
    t = torch.tensor([z], dtype=torch.complex64)
    return complex(round_tf32_(t)[0])


def _blocks(psi: torch.Tensor, n: int, a: int, b: int):
    """The four (b_a, b_b) sub-blocks of the state, as views, in the
    matrix's row order 2 * b_a + b_b."""
    hi, lo = max(a, b), min(a, b)
    v = psi.view(1 << (n - hi - 1), 2, 1 << (hi - lo - 1), 2, 1 << lo)
    out = []
    for ba in (0, 1):
        for bb in (0, 1):
            bhi, blo = (ba, bb) if a == hi else (bb, ba)
            out.append(v[:, bhi, :, blo, :])
    return out


def apply_gate(psi: torch.Tensor, n: int, qubits, U: np.ndarray,
               tf32: bool = False) -> None:
    """Apply ``U`` to ``qubits`` of ``psi`` in place."""
    if tf32:
        round_tf32_(psi)
        U = np.vectorize(_tf32_scalar, otypes=[np.complex128])(U)
    if len(qubits) == 1:
        v = psi.view(-1, 2, 1 << qubits[0])
        blocks = [v[:, 0], v[:, 1]]
    elif len(qubits) == 2:
        blocks = _blocks(psi, n, qubits[0], qubits[1])
    else:
        raise NotImplementedError("the reference applies 1- and 2-qubit gates")
    d = len(blocks)
    off = U - np.diag(np.diag(U))
    if not off.any():
        for r in range(d):
            if U[r, r] != 1:
                blocks[r].mul_(complex(U[r, r]))
        return
    nz = [[c for c in range(d) if U[r, c] != 0] for r in range(d)]
    perm = all(len(cs) == 1 and U[r, cs[0]] == 1 for r, cs in enumerate(nz))
    moved = sorted({c for r, cs in enumerate(nz) for c in cs if cs != [r]})
    olds = {c: blocks[c].clone() for c in (moved if perm else range(d))}
    for r in range(d):
        if perm:
            if nz[r] != [r]:
                blocks[r].copy_(olds[nz[r][0]])
            continue
        acc = None
        for c in nz[r]:
            term = olds[c] * complex(U[r, c])
            acc = term if acc is None else acc.add_(term)
        if acc is None:  # a zero row: a cut reference's factor, never a gate
            blocks[r].zero_()
        else:
            blocks[r].copy_(acc)
    del olds


def simulate(cd: dict, device, tf32: bool = False) -> torch.Tensor:
    """The final state of ``cd`` from |0...0>: complex128, or complex64
    with TF32 products for the control."""
    n = cd["number_of_qubits"]
    dtype = torch.complex64 if tf32 else torch.complex128
    psi = torch.zeros(1 << n, dtype=dtype, device=device)
    psi[0] = 1
    for g in cd["gates"]:
        apply_gate(psi, n, list(g["qubits"]), gate_matrix(g), tf32)
    return psi


def probabilities(psi: torch.Tensor) -> torch.Tensor:
    """|psi|^2 in float64."""
    p = psi.real.double().square_()
    return p.add_(psi.imag.double().square_())


def z_expectation(probs: torch.Tensor, n: int, qubits) -> float:
    """<Z_q1 Z_q2 ...> from the float64 probabilities: the marginal over
    ``qubits``, then the signed sum over its 2^k entries."""
    keep = {n - 1 - q for q in qubits}
    others = tuple(d for d in range(n) if d not in keep)
    m = probs.view([2] * n)
    if others:
        m = m.sum(dim=others)
    while m.dim() > 0:
        m = m[0] - m[1]
    return float(m)


def maxcut_energy(probs: torch.Tensor, n: int, edges) -> float:
    """sum over edges of (1 - <Z_i Z_j>) / 2."""
    return sum(0.5 * (1.0 - z_expectation(probs, n, [i, j]))
               for i, j in edges)


def sample_bits(probs: torch.Tensor, n: int, shots: int,
                generator: torch.Generator) -> np.ndarray:
    """(shots, n) int8 samples of |psi|^2 by inverse CDF, column q = qubit q."""
    cdf = torch.cumsum(probs, 0)
    u = torch.rand(shots, generator=generator, dtype=torch.float64,
                   device=probs.device) * cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True).clamp_(max=(1 << n) - 1)
    del cdf
    shifts = torch.arange(n, device=probs.device)
    return ((idx[:, None] >> shifts) & 1).to(torch.int8).cpu().numpy()
