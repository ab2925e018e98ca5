"""The ``locality`` partition used by
``runtime.simulator.simulate(segment_gates=...)``.

The one strategy of ``quantum_simulations_tpu/circuit/dag.py``'s
``partition`` that the window path calls, copied: the port imports
nothing of the JAX package.
"""
from __future__ import annotations

from .contract import validate_circuit_dict


def partition(circuit_dict: dict, n_partitions: int) -> list[list[int]]:
    """Split gate indices into ``n_partitions`` contiguous groups, cut at
    the n-1 boundaries where neighbouring gates share the fewest qubits
    (ties -> earlier): the reference's ``strategy='locality'``."""
    gates = validate_circuit_dict(circuit_dict)["gates"]
    n_gates = len(gates)
    if n_gates == 0:
        return [[] for _ in range(n_partitions)]
    n_partitions = max(1, min(n_partitions, n_gates))
    overlaps = []
    for i in range(1, n_gates):
        a = set(gates[i - 1]["qubits"])
        b = set(gates[i]["qubits"])
        overlaps.append((len(a & b), i))
    cuts = sorted(i for _, i in sorted(overlaps)[: n_partitions - 1])
    parts = []
    prev = 0
    for c in cuts:
        parts.append(list(range(prev, c)))
        prev = c
    parts.append(list(range(prev, n_gates)))
    return parts
