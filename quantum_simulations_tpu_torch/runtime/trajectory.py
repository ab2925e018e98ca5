"""Trajectory tier: circuits with RESET / mid-circuit MEASURE /
classically-conditioned gates.

Port of ``quantum_simulations_tpu/runtime/trajectory.py``.  A
statevector cannot represent the post-measurement *mixture*, so the
tier simulates one seeded **trajectory**: the circuit is segmented at
non-unitary instructions, each maximal unitary run goes through the
fused mode's ops (:func:`runtime.simulator.build_circuit_fn`: lane
panels and pair kernels on the card), and at each boundary the host
reads ONE probability scalar, draws the outcome from a seeded ``numpy``
Generator (outcome 1 iff ``u < P(1)``), and collapses the state in
place.  Classical conditions are resolved on the host when the
following segment is built.

The state stays as its two float planes from the first segment to the
last (no complex <-> planar conversion at a boundary).  P(1) is summed
in float32 whatever the dtype, as the reference sums it; the collapse
zeroes the discarded half of the (A, 2, B) view, moves the kept half to
|0> for RESET, and scales by rsqrt of the new norm2
(``ops/sampling.collapse_planar_``).

The oracle twin is :func:`oracle.dense_numpy.simulate_trajectory`; the
port, the JAX tier and the oracle consume identical uniform draws in
identical order, so a shared seed pins the whole trajectory.
"""
from __future__ import annotations

import numpy as np
import torch

from ..circuit.contract import validate_circuit_dict
from ..ops import dense
from ..ops import panel_kernels as pk
from ..ops import sampling
from ..utils.device import complex_dtype, float_dtype, resolve_device


def split_segments(gates: list[dict]):
    """Split a gate list at non-unitary instructions.

    Yields ``(unitary_run, boundary)`` pairs where ``boundary`` is the
    RESET/MEASURE dict that follows the run (``None`` after the last
    run).  Gates keep their ``cond`` annotations — the caller resolves
    them against the classical registers *at build time*.
    """
    run: list[dict] = []
    out = []
    for g in gates:
        if g["gate"] in ("RESET", "MEASURE"):
            out.append((run, g))
            run = []
        else:
            run.append(g)
    out.append((run, None))
    return out


def simulate_trajectory(
    circuit_dict: dict,
    *,
    seed: int = 0,
    dtype="complex64",
    use_fusion: bool = True,
    panel_width: int | None = 7,
    initial_state=None,
    device="cuda",
):
    """Run one seeded trajectory on ``device`` (the card unless
    ``device="cpu"``); returns ``(psi, cregs, outcomes)``.

    ``psi`` is the final statevector, a complex tensor on ``device``;
    ``cregs`` the classical register values, ``outcomes`` the
    per-measurement bits in circuit order.  Deterministic given ``seed``
    (and reproduced by the numpy oracle with the same seed).
    """
    from .simulator import _as_state, build_circuit_fn

    cd = validate_circuit_dict(circuit_dict, allow_nonunitary=True)
    n = cd["number_of_qubits"]
    dev = resolve_device(device)
    cdtype = complex_dtype(dtype)
    if initial_state is None:
        state = list(dense.zero_state_planar(n, float_dtype(cdtype), dev))
    else:
        state = list(pk.to_planar(_as_state(initial_state, n, cdtype, dev)))
    rng = np.random.default_rng(seed)
    cregs: dict[str, int] = {}
    outcomes: list[int] = []

    for run, boundary in split_segments(cd["gates"]):
        live = []
        for g in run:
            cond = g.get("cond")
            if cond is not None and cregs.get(cond["creg"], 0) != cond["value"]:
                continue
            live.append({k: v for k, v in g.items() if k != "cond"})
        if live:
            fn = build_circuit_fn(
                {"number_of_qubits": n, "gates": live}, dtype=cdtype,
                use_fusion=use_fusion, panel_width=panel_width,
                planar_io=True, device=dev)
            state = list(fn.consume(state))
        if boundary is None:
            continue
        q = boundary["qubits"][0]
        p1 = sampling.qubit_probability_planar(*state, q,
                                               acc_dtype=torch.float32)
        u = float(rng.random())
        outcome = int(u < p1)
        outcomes.append(outcome)
        sampling.collapse_planar_(*state, q, outcome,
                                  to_zero=boundary["gate"] == "RESET")
        if boundary["gate"] == "MEASURE":
            p = boundary["params"]
            val = cregs.get(p["creg"], 0)
            bit = 1 << p["cbit"]
            cregs[p["creg"]] = (val & ~bit) | (bit if outcome else 0)
    return pk.from_planar(*state), cregs, outcomes
