"""Gate ops bound to their unitaries.

Only ``GateOp`` of ``quantum_simulations_tpu/circuit/fusion.py`` is
copied: it is the one name the window scheduler imports.  The fused and
panel step compilers wait for the port's later slices.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class GateOp:
    """A gate bound to its unitary. U: complex128, big-endian subspace."""
    qubits: tuple[int, ...]
    U: np.ndarray
    name: str = "?"

    @property
    def arity(self) -> int:
        return len(self.qubits)
