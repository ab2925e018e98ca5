"""``api.expectation_z(circuit, S, cfg)``: <Z_S> of a Z-string S of
``z_weight = [lo, hi]`` distinct qubits, the weight drawn uniformly."""
from __future__ import annotations

from ..reference import lightcone as lc
from ..reference import statevector as sv

NUMBER = "z_err"


def draw(stream, rng) -> dict:
    lo, hi = stream.traffic["z_weight"]
    k = int(rng.integers(lo, hi + 1))
    return {"qubits": sorted(int(q) for q in
                             rng.choice(stream.n, k, replace=False))}


def call(port, req, cfg, spanning) -> float:
    return float(port.api.expectation_z(req.circuit, req.args["qubits"], cfg,
                                        device=port.device))


def control(ctl, req, cfg, spanning) -> float:
    psi = ctl.run(req.circuit, cfg)
    return sv.z_expectation(ctl.probs(psi), req.circuit["number_of_qubits"],
                            req.args["qubits"])


def error(answer, req, probs, n, config) -> float:
    return abs(answer - sv.z_expectation(probs, n, req.args["qubits"]))


def cut_control(ctl, req, cfg, spanning) -> float:
    ctl.run(req.circuit, cfg)
    return ctl.halves().z_expectation(req.args["qubits"])


def cut_error(answer, req, ref) -> float:
    return abs(answer - ref.z_expectation(req.args["qubits"]))


def cone_error(answer, req, device) -> float:
    return abs(answer - lc.z_expectation(req.circuit, req.args["qubits"],
                                         device))
