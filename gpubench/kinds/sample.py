"""``api.sample(circuit, shots, seed=s, cfg)``: ``shots`` bitstrings, the
sampler's seed drawn per request.  The answer is held to the reference by
every single-qubit <Z_q> and every edge's <Z_i Z_j> (the MaxCut edges, or
neighbouring qubits without them) that the shots estimate: the largest
|m - m_ref| / sd, sd = sqrt((1 - m_ref^2) / shots)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import statevector as sv

NUMBER = "sample_z"


def draw(stream, rng) -> dict:
    return {"shots": int(stream.traffic["shots"]),
            "seed": int(rng.integers(0, 1 << 62)),
            "pairs": stream.edges or [(q, q + 1) for q in range(stream.n - 1)]}


def call(port, req, cfg, spanning) -> np.ndarray:
    a = req.args
    return port.api.sample(req.circuit, a["shots"], seed=a["seed"],
                           config=cfg, device=port.device)


def control(ctl, req, cfg, spanning) -> np.ndarray:
    a = req.args
    psi = ctl.run(req.circuit, cfg)
    gen = torch.Generator(device=ctl.device).manual_seed(a["seed"])
    return sv.sample_bits(ctl.probs(psi), req.circuit["number_of_qubits"],
                          a["shots"], gen)


def error(answer, req, probs, n, config) -> float:
    shots = answer.shape[0]
    z = 1.0 - 2.0 * answer.astype(np.float64)
    worst = 0.0
    for qs in [[q] for q in range(n)] + [list(p) for p in req.args["pairs"]]:
        est = float(np.prod(z[:, qs], axis=1).mean())
        ref = sv.z_expectation(probs, n, qs)
        sd = math.sqrt(max(1.0 - ref * ref, 1.0 / shots) / shots)
        worst = max(worst, abs(est - ref) / sd)
    return worst
