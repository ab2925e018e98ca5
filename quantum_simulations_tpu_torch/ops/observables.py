"""Pauli-string observables (``parse_pauli``, ``expectation_pauli``,
``expectation_sum`` and ``maxcut_energy`` of
``quantum_simulations_tpu/ops/observables.py``).

A Pauli string P (P_q in {I, X, Y, Z}) is evaluated by rotating each X /
Y axis into Z with a basis-change layer (H for X, S-dagger then H for Y)
and taking the Z-string expectation of the rotated state:
<psi| P |psi> = <psi'| Z-string |psi'>, psi' = B |psi>.
``api.expectation_pauli`` appends that layer to the circuit instead, so
every tier reads it out on its own planes.
"""
from __future__ import annotations

from ..circuit import gates as G
from ..utils import timing
from . import dense, sampling


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


def expectation_pauli(psi, pauli: str | dict[int, str]) -> float:
    """<psi| P |psi> for one Pauli string, ``psi`` a complex tensor or its
    ``(re, im)`` planes (not written: the basis change makes new ones)."""
    ps = parse_pauli(pauli)
    re, im = sampling._planes(psi)
    if not ps:
        return sampling.norm2_planar(re, im)
    change = {"X": G.H(), "Y": G.H() @ G.SDG()}
    for q, p in ps.items():
        if p in change:
            re, im = dense.apply_gate_planar(re, im, (q,), change[p])
    return sampling.expectation_z_planar(re, im, sorted(ps))


def expectation_sum(psi, terms: list[tuple[float, str | dict[int, str]]]) -> float:
    """Expectation of a Hamiltonian given as (coeff, pauli-string) terms."""
    return sum((coeff * expectation_pauli(psi, pauli) for coeff, pauli in terms),
               0.0)


@timing.spanned("qst.readout.maxcut_energy")
def maxcut_energy(psi, edges: list[tuple[int, int]],
                  weights: list[float] | None = None) -> float:
    """QAOA MaxCut objective  sum_e w_e (1 - <Z_i Z_j>) / 2.  One span for
    the whole sum: the edges' ``<Z_i Z_j>`` read the planes directly."""
    w = weights or [1.0] * len(edges)
    re, im = sampling._planes(psi)
    zz = sampling.expectation_z_planar
    return sum((0.5 * wij * (1.0 - zz(re, im, [i, j]))
               for (i, j), wij in zip(edges, w)), 0.0)
