"""Adaptive sparse -> dense tier switching.

Port of ``quantum_simulations_tpu/sparse/adaptive.py``.  A circuit
starts on the COO sparse engine (``sparse/engine.py``, on the device)
and, the moment the live nonzero count crosses a density threshold, the
COO state is scattered into a dense complex tensor on the same device
(no host round trip) and the REMAINING gates run on the dense tier
(``runtime.simulator.simulate`` in fused or window mode, through the
kernels on the card).

The switch rule is work-based: sparse gate cost is O(nnz), dense gate
cost is O(2^n); once nnz is a meaningful fraction of 2^n the dense
engine's constant factor wins.  GHZ / W-class circuits never switch
(nnz stays O(1)/O(n)); H-wall or QFT-like circuits switch within the
first few gates.
"""
from __future__ import annotations

import torch

from ..circuit import gates as G
from ..circuit.contract import validate_circuit_dict
from ..utils.device import complex_dtype, resolve_device
from .engine import (
    DEFAULT_THRESHOLD,
    NUMPY_MAX_QUBITS,
    _apply_gate_coo,
    coo_state,
    coo_zero_state,
    simulate_sparse,
)

# Switch when nnz > DENSITY_SWITCH * 2^n (and dense fits memory).
DENSITY_SWITCH = 1.0 / 16.0
DENSE_MAX_QUBITS = 26


class AdaptiveResult:
    """Outcome of an adaptive run.

    ``state`` is a dense complex tensor on the run's device if the run
    switched (or a :class:`SparseState` if it stayed sparse to the end);
    ``switched_at`` is the gate index at which the dense tier took over
    (``None`` = never); ``nnz_history`` is the intermediate sparsity
    profile up to the switch point.
    """

    def __init__(self, state, switched_at, nnz_history):
        self.state = state
        self.switched_at = switched_at
        self.nnz_history = nnz_history

    @property
    def is_dense(self) -> bool:
        return isinstance(self.state, torch.Tensor)

    def to_dense(self):
        """The state as a host numpy complex vector."""
        if self.is_dense:
            return self.state.cpu().numpy()
        return self.state.to_dense()


def simulate_adaptive(
    circuit_dict: dict,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    density_switch: float = DENSITY_SWITCH,
    dense_max_qubits: int = DENSE_MAX_QUBITS,
    dtype: str = "complex64",
    mode: str = "fused",
    device="cuda",
) -> AdaptiveResult:
    """Run sparsely until the state densifies, then switch tiers.  Runs
    on the card unless ``device="cpu"`` (above 62 qubits: the host's
    bigint tier, with no dense escape hatch)."""
    cd = validate_circuit_dict(circuit_dict)
    n = cd["number_of_qubits"]
    gates = cd["gates"]
    can_switch = n <= min(dense_max_qubits, NUMPY_MAX_QUBITS)
    nnz_limit = int(density_switch * (1 << n)) if can_switch else None

    if n > NUMPY_MAX_QUBITS:
        hist: list = []
        st = simulate_sparse(cd, threshold=threshold, nnz_history=hist)
        return AdaptiveResult(st, None, hist)

    dev = resolve_device(device)
    idx, amp = coo_zero_state(dev)
    hist = []
    for gi, g in enumerate(gates):
        U = G.gate_matrix(g["gate"], g["params"])
        idx, amp = _apply_gate_coo(idx, amp, g["qubits"], U, threshold)
        hist.append(len(idx))
        if nnz_limit is not None and len(idx) > nnz_limit:
            rest = gates[gi + 1:]
            # The reference scatters in complex128 and casts to ``dtype``
            # only to hand the state on.
            cdt = complex_dtype(dtype) if rest else torch.complex128
            psi = torch.zeros(1 << n, dtype=cdt, device=dev)
            psi.index_put_((idx,), amp.to(cdt))
            del idx, amp
            if rest:
                from ..runtime import simulator

                psi = simulator.simulate(
                    {"number_of_qubits": n, "gates": rest}, dtype=dtype,
                    mode=mode, initial_state=psi, device=dev)
            return AdaptiveResult(psi, gi + 1, hist)

    return AdaptiveResult(coo_state(n, idx, amp), None, hist)
