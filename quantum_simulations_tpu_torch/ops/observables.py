"""Pauli strings for ``api.expectation_pauli`` (a copy of
``parse_pauli`` from ``quantum_simulations_tpu/ops/observables.py``).

``api.expectation_pauli`` rotates each X / Y axis into Z by appending the
basis-change gates (H for X, S-dagger then H for Y) to the circuit and
takes the Z-string expectation of the result, so the capacity tier reads
it out on its planes.
"""
from __future__ import annotations


def parse_pauli(pauli: str | dict[int, str]) -> dict[int, str]:
    """'XZIY...' (character q names the Pauli on qubit q, little-endian as
    the contract's qubit order) or {q: P}, with 'I' entries dropped."""
    if isinstance(pauli, str):
        out = {q: p.upper() for q, p in enumerate(pauli) if p.upper() != "I"}
    else:
        out = {int(q): p.upper() for q, p in pauli.items() if p.upper() != "I"}
    bad = sorted(set(out.values()) - {"X", "Y", "Z"})
    if bad:
        raise ValueError(f"unknown Pauli letters {bad}")
    return out
