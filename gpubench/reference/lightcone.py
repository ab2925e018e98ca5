"""<Z_S> of a circuit from the gates in the backward light cone of S.

<psi|Z_S|psi> = <0|U^dag Z_S U|0>.  Walking the gates from the last to
the first, a gate that touches the cone is kept and widens the cone by
its qubits; any other gate commutes with what Z_S has become under the
later gates, so it cancels against its adjoint and is dropped.  The kept
gates, in their order, on the cone's qubits alone from |0...0>, give
the same <Z_S> as the whole state, exactly.  The cone's qubits are
renumbered in their order, so a 2-qubit gate's big-endian row order is
kept, and the gates are applied by ``statevector`` as they are.

A Z-string of a few qubits after a shallow circuit has a cone far
narrower than the circuit, so every answer of a window can be checked,
each in a state of 2^|cone| amplitudes; a cone as wide as the circuit
costs what the whole state does.
"""
from __future__ import annotations

import torch

from . import statevector as sv


def cone(cd: dict, qubits) -> tuple[list[int], list[dict]]:
    """(the cone's qubits, ascending; the gates kept, in circuit order)."""
    live = set(qubits)
    kept = []
    for g in reversed(cd["gates"]):
        if live.intersection(g["qubits"]):
            live.update(g["qubits"])
            kept.append(g)
    kept.reverse()
    return sorted(live), kept


def z_expectation(cd: dict, qubits, device) -> float:
    """<Z_q1 Z_q2 ...> of ``cd``'s final state, complex128, from the
    gates of the cone of ``qubits`` alone."""
    order, kept = cone(cd, qubits)
    pos = {q: i for i, q in enumerate(order)}
    sub = {"number_of_qubits": len(order),
           "gates": [{**g, "qubits": [pos[q] for q in g["qubits"]]}
                     for g in kept]}
    psi = sv.simulate(sub, device)
    probs = sv.probabilities(psi)
    del psi
    out = sv.z_expectation(probs, len(order), [pos[q] for q in qubits])
    del probs
    if isinstance(device, torch.device) and device.type == "cuda":
        torch.cuda.empty_cache()
    return out
