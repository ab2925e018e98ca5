"""A reference that never holds the state: the circuit cut in two halves.

Half A is qubits 0 … c−1, half B qubits c … n−1, so amplitude
b · 2^c + a is a sum over paths p of A_p[a] · B_p[b] (a
Schrödinger–Feynman sum).  A gate inside one half acts on that half's
states alone.  A 2-qubit gate across the cut is written as its
operator-Schmidt sum Σ_k M_k ⊗ N_k, from the SVD of its realigned 4×4
(rank ≤ 4; CNOT, CZ and RZZ have rank 2), and every path picks one
summand of each such gate, so the terms are the product of their ranks.
Each half runs its gates with ``statevector.apply_gate``, in the
conventions of ``statevector.py``: little-endian, the 4×4 in the rows
2 · b_a + b_b for ``qubits = [a, b]``.

Nothing here is ever as large as the state: a term's halves take
2^c and 2^(n−c) amplitudes, the amplitudes come out a chunk at a time
as a small matrix product of B's rows with A (:meth:`chunks`), and
<Z_S> and the norm come out exactly from the Gram sums of the halves
(:meth:`z_expectation`, :meth:`norm2`).

``tf32=True`` is the control: each half in complex64, rounded to TF32
before every gate, as ``statevector.apply_gate(tf32=True)`` rounds the
whole state.
"""
from __future__ import annotations

import numpy as np
import torch

from . import statevector as sv

MAX_TERMS = 256
_RANK_TOL = 1e-12


def schmidt(U: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
    """The operator-Schmidt sum of a 4×4 two-qubit gate: ``[(M_k, N_k)]``
    with U = Σ_k M_k ⊗ N_k, M_k on ``qubits[0]`` and N_k on
    ``qubits[1]``; singular values under 1e-12 of the largest dropped."""
    R = U.reshape(2, 2, 2, 2).transpose(0, 2, 1, 3).reshape(4, 4)
    X, s, Yh = np.linalg.svd(R)
    keep = s > _RANK_TOL * s[0]
    return [(np.sqrt(s[k]) * X[:, k].reshape(2, 2),
             np.sqrt(s[k]) * Yh[k, :].reshape(2, 2))
            for k in np.flatnonzero(keep)]


def _signs(bits: int, qubits, device) -> torch.Tensor:
    """(-1)^(parity of the index's ``qubits``) over 2^bits indices, float64;
    a qubit named twice counts once, as in ``statevector.z_expectation``."""
    idx = torch.arange(1 << bits, device=device)
    parity = torch.zeros_like(idx)
    for q in set(qubits):
        parity ^= (idx >> q) & 1
    return 1.0 - 2.0 * parity.to(torch.float64)


class CutReference:
    """The final state of ``cd`` from |0…0> as ``terms`` pairs of halves
    cut before qubit ``cut``: ``A`` (terms, 2^cut) and ``Bt``
    (2^(n−cut), terms), complex128, or complex64 with TF32 rounding."""

    def __init__(self, cd: dict, cut: int, device, tf32: bool = False):
        n = cd["number_of_qubits"]
        if not 0 < cut < n:
            raise ValueError(f"a cut before qubit {cut} does not split "
                             f"{n} qubits")
        self.n, self.cut = n, cut
        self.device = torch.device(device)
        plan, terms = [], 1
        for g in cd["gates"]:
            qubits, U = list(g["qubits"]), sv.gate_matrix(g)
            if all(q < cut for q in qubits):
                plan.append(("A", qubits, U))
            elif all(q >= cut for q in qubits):
                plan.append(("B", [q - cut for q in qubits], U))
            elif len(qubits) == 2:
                factors = schmidt(U)
                if qubits[0] >= cut:  # A's factor acts on qubits[1]
                    factors = [(N, M) for M, N in factors]
                plan.append(("AB", (min(qubits), max(qubits) - cut), factors))
                terms *= len(factors)
            else:
                raise NotImplementedError(
                    f"the cut reference splits 2-qubit gates, not {g['gate']} "
                    f"on {qubits}")
        if terms > MAX_TERMS:
            raise ValueError(f"a cut before qubit {cut} gives {terms} terms, "
                             f"over the cap of {MAX_TERMS}")
        self.terms = terms
        dtype = torch.complex64 if tf32 else torch.complex128
        pairs = [(self._basis(cut, dtype), self._basis(n - cut, dtype))]
        for side, qubits, op in plan:
            if side == "A":
                for a, _ in pairs:
                    sv.apply_gate(a, cut, qubits, op, tf32)
            elif side == "B":
                for _, b in pairs:
                    sv.apply_gate(b, n - cut, qubits, op, tf32)
            else:
                qa, qb = qubits
                split = []
                for a, b in pairs:
                    for M, N in op:
                        a2, b2 = a.clone(), b.clone()
                        sv.apply_gate(a2, cut, [qa], M, tf32)
                        sv.apply_gate(b2, n - cut, [qb], N, tf32)
                        split.append((a2, b2))
                pairs = split
        self.A = torch.stack([a for a, _ in pairs])
        self.Bt = torch.stack([b for _, b in pairs], dim=1)

    def _basis(self, bits: int, dtype) -> torch.Tensor:
        psi = torch.zeros(1 << bits, dtype=dtype, device=self.device)
        psi[0] = 1
        return psi

    def chunks(self, size: int):
        """``(start, amplitudes)`` over the whole state in index order,
        index = b · 2^cut + a, at most ``size`` amplitudes at a time."""
        N, L = 1 << self.n, 1 << self.cut
        for start in range(0, N, size):
            stop = min(start + size, N)
            out = torch.empty(stop - start, dtype=self.A.dtype,
                              device=self.device)
            pos = start
            while pos < stop:
                b, a0 = divmod(pos, L)
                if a0 == 0 and stop - pos >= L:
                    rows = (stop - pos) // L
                    torch.mm(self.Bt[b:b + rows], self.A,
                             out=out[pos - start:pos - start + rows * L]
                             .view(rows, L))
                    pos += rows * L
                else:
                    a1 = min(L, a0 + stop - pos)
                    out[pos - start:pos - start + a1 - a0] = (
                        self.Bt[b] @ self.A[:, a0:a1])
                    pos += a1 - a0
            yield start, out

    def _gram_sum(self, qubits) -> float:
        """Σ_{p,q} <a_p|Z_SA|a_q> <b_p|Z_SB|b_q> in float64: <Z_S>, and
        the norm² for no qubits."""
        A = self.A.to(torch.complex128)
        Bt = self.Bt.to(torch.complex128)
        sa = _signs(self.cut, [q for q in qubits if q < self.cut],
                    self.device)
        sb = _signs(self.n - self.cut,
                    [q - self.cut for q in qubits if q >= self.cut],
                    self.device)
        ga = A.conj() @ (A * sa).T
        gb = Bt.conj().T @ (Bt * sb[:, None])
        return float((ga * gb).sum().real)

    def z_expectation(self, qubits) -> float:
        """<Z_q1 Z_q2 …> of the normalised final state."""
        return self._gram_sum(list(qubits))

    def norm2(self) -> float:
        return self._gram_sum([])
