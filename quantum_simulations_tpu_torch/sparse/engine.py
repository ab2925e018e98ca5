"""Sparse statevector engine — GHZ/W-class circuits far beyond dense reach.

Port of ``quantum_simulations_tpu/sparse/engine.py``.  The state is a
set of (index, amplitude) pairs; a gate expands each amplitude into its
out-pattern contributions (zero matrix entries elided), merges
duplicates, and prunes below threshold.  Two tiers:

* **COO** (n <= 62, ``force_tier="numpy"`` as in the reference): int64
  index and complex128 amplitude tensors on ``device`` (the card by
  default).  Per gate: ``torch.isin`` selects the amplitudes each
  out-pattern takes, ``torch.unique(sorted=True, return_inverse=True)``
  merges the duplicates, and ``index_add_`` into the float64
  ``view_as_real`` of the sums stands for the reference's ``np.add.at``
  (the same sum, on every device).
* **bigint dict** (any n): arbitrary-precision Python ints on the host.
  A card cannot hold such indices, so this tier is host-only by nature
  (1000-qubit GHZ in milliseconds), as in the reference.

A run ends in a :class:`SparseState`, a dict index -> complex built in
ascending index order (the order ``np.unique`` leaves the reference's),
so :meth:`SparseState.sample` draws the reference's bits for a seed.
"""
from __future__ import annotations

import numpy as np
import torch

from ..circuit import gates as G
from ..circuit.contract import validate_circuit_dict
from ..utils.device import resolve_device

NUMPY_MAX_QUBITS = 62
DEFAULT_THRESHOLD = 1e-15


class SparseState:
    """Final state as a mapping index -> complex amplitude."""

    def __init__(self, n: int, items: dict):
        self.n = n
        self._items = items

    def __len__(self) -> int:
        return len(self._items)

    def items(self):
        return self._items.items()

    def amplitude(self, idx: int) -> complex:
        return complex(self._items.get(idx, 0.0))

    def norm(self) -> float:
        return float(np.sqrt(sum(abs(a) ** 2 for a in self._items.values())))

    def to_dense(self) -> np.ndarray:
        if self.n > 26:
            raise ValueError(f"refusing dense export of 2^{self.n} amplitudes")
        out = np.zeros(1 << self.n, dtype=np.complex128)
        for i, a in self._items.items():
            out[i] = a
        return out

    def top_amplitudes(self, k: int = 16):
        return sorted(self._items.items(), key=lambda kv: -abs(kv[1]))[:k]

    def sample(self, shots: int, *, seed: int = 0) -> list:
        """Draw bitstring samples (as Python ints) from |amp|^2.

        Samples directly over the nnz support — no dense expansion, so
        this works at any n (e.g. 1000-qubit GHZ).
        """
        indices = list(self._items.keys())
        probs = np.array([abs(a) ** 2 for a in self._items.values()])
        probs = probs / probs.sum()
        rng = np.random.default_rng(seed)
        draws = rng.choice(len(indices), size=shots, p=probs)
        return [indices[i] for i in draws]

    def sample_bits(self, shots: int, n: int | None = None, *, seed: int = 0
                    ) -> np.ndarray:
        """Samples as a (shots, n) int8 bit matrix (little-endian)."""
        n = self.n if n is None else n
        idxs = self.sample(shots, seed=seed)
        out = np.empty((shots, n), dtype=np.int8)
        for r, idx in enumerate(idxs):
            for q in range(n):
                out[r, q] = (idx >> q) & 1
        return out


def coo_state(n: int, idx: torch.Tensor, amp: torch.Tensor) -> SparseState:
    """The :class:`SparseState` of COO tensors (indices ascending, as
    ``torch.unique`` leaves them)."""
    return SparseState(n, dict(zip(idx.tolist(), amp.tolist())))


# ---------------------------------------------------------------------------
# COO tier (n <= 62), torch on the device
# ---------------------------------------------------------------------------

def _out_offset(o: int, qubits) -> int:
    """The index bits of out-pattern ``o`` (big-endian over ``qubits``)."""
    m = len(qubits)
    offs = 0
    for j, q in enumerate(qubits):
        if (o >> (m - 1 - j)) & 1:
            offs |= 1 << q
    return offs


def _apply_gate_coo(idx: torch.Tensor, amp: torch.Tensor, qubits, U,
                    threshold):
    """One gate on COO tensors (int64 ``idx``, complex128 ``amp``).

    Index arithmetic stays below bit 63: the masks are Python ints of at
    most 63 bits and ``~clear_mask`` only clears bits of non-negative
    indices, so the sign bit stays clear up to qubit 62.
    """
    m = len(qubits)
    U = np.asarray(U, dtype=np.complex128)
    clear_mask = 0
    for q in qubits:
        clear_mask |= 1 << q
    base = idx & ~clear_mask

    # in-subspace pattern of each amplitude (big-endian over `qubits`).
    in_pat = torch.zeros_like(idx)
    for j, q in enumerate(qubits):
        in_pat |= ((idx >> q) & 1) << (m - 1 - j)

    out_idx_parts = []
    out_amp_parts = []
    for o in range(1 << m):
        coeffs = U[o]  # row o: coefficient per in-pattern
        nz_in = np.nonzero(coeffs)[0]
        if len(nz_in) == 0:
            continue
        sel = torch.isin(in_pat, torch.as_tensor(nz_in, device=idx.device))
        table = torch.as_tensor(coeffs, device=idx.device)
        out_idx_parts.append(torch.where(sel, base | _out_offset(o, qubits), -1))
        out_amp_parts.append(table[in_pat] * amp)

    # One selection of the contributions (the reference's per-pattern
    # masks), in the reference's order: pattern by pattern.
    all_idx = torch.cat(out_idx_parts)
    live = all_idx >= 0
    all_idx = all_idx[live]
    all_amp = torch.cat(out_amp_parts)[live]
    uniq, inv = torch.unique(all_idx, sorted=True, return_inverse=True)
    merged = torch.zeros(len(uniq), 2, dtype=torch.float64, device=idx.device)
    merged.index_add_(0, inv, torch.view_as_real(all_amp))
    merged = torch.view_as_complex(merged)
    keep = merged.abs() > threshold
    return uniq[keep], merged[keep]


def coo_zero_state(device) -> tuple[torch.Tensor, torch.Tensor]:
    """|0> as COO tensors on ``device``."""
    return (torch.zeros(1, dtype=torch.int64, device=device),
            torch.ones(1, dtype=torch.complex128, device=device))


# ---------------------------------------------------------------------------
# bigint dict tier (any n): host Python, by nature
# ---------------------------------------------------------------------------

def _apply_gate_dict(state: dict, qubits, U, threshold):
    m = len(qubits)
    out: dict = {}
    clear_mask = 0
    for q in qubits:
        clear_mask |= 1 << q
    offsets = [_out_offset(o, qubits) for o in range(1 << m)]

    for idx, a in state.items():
        in_pat = 0
        for j, q in enumerate(qubits):
            in_pat |= ((idx >> q) & 1) << (m - 1 - j)
        base = idx & ~clear_mask
        for o in range(1 << m):
            c = U[o, in_pat]
            if c == 0:
                continue
            t = base | offsets[o]
            v = out.get(t, 0.0) + c * a
            out[t] = v
    return {i: a for i, a in out.items() if abs(a) > threshold}


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def simulate_sparse(
    circuit_dict: dict,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    force_tier: str | None = None,
    nnz_history: list | None = None,
    device="cuda",
) -> SparseState:
    """Run a circuit sparsely; returns a :class:`SparseState`.

    The COO tier (``"numpy"``, n <= 62 unless forced) runs on ``device``,
    the card unless ``device="cpu"``; the bigint tier (``"bigint"``,
    n > 62) runs on the host whatever ``device`` says.  Pass a list as
    ``nnz_history`` to record the nonzero count after every gate (the
    intermediate-sparsity profile — the signal that decides when a
    circuit should switch to the dense tier).
    """
    cd = validate_circuit_dict(circuit_dict)
    n = cd["number_of_qubits"]
    tier = force_tier or ("numpy" if n <= NUMPY_MAX_QUBITS else "bigint")

    if tier == "numpy":
        idx, amp = coo_zero_state(resolve_device(device))
        for g in cd["gates"]:
            U = G.gate_matrix(g["gate"], g["params"])
            idx, amp = _apply_gate_coo(idx, amp, g["qubits"], U, threshold)
            if nnz_history is not None:
                nnz_history.append(len(idx))
        return coo_state(n, idx, amp)

    state = {0: 1.0 + 0.0j}
    for g in cd["gates"]:
        U = G.gate_matrix(g["gate"], g["params"])
        state = _apply_gate_dict(state, g["qubits"], U, threshold)
        if nnz_history is not None:
            nnz_history.append(len(state))
    return SparseState(n, state)
