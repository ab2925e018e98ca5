"""``api.run(circuit, cfg)``, then ``ops.observables.maxcut_energy`` over
the configuration's MaxCut edges: one energy, as a QAOA loop reads it."""
from __future__ import annotations

from ..reference import statevector as sv

NUMBER = "energy_err"


def draw(stream, rng) -> dict:
    return {"edges": stream.edges}


def call(port, req, cfg, spanning) -> float:
    psi = port.run(req.circuit, cfg)
    with spanning("gpubench.readout"):
        return float(port.module("ops.observables").maxcut_energy(
            psi, req.args["edges"]))


def control(ctl, req, cfg, spanning) -> float:
    psi = ctl.run(req.circuit, cfg)
    with spanning("gpubench.readout"):
        return sv.maxcut_energy(ctl.probs(psi),
                                req.circuit["number_of_qubits"],
                                req.args["edges"])


def error(answer, req, probs, n, config) -> float:
    return abs(answer - sv.maxcut_energy(probs, n, req.args["edges"]))
