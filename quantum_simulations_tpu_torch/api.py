"""High-level user API of the port: the dense single-device tier.

Routes like ``quantum_simulations_tpu/api.py``; the tiers the port has
not reached yet raise ``NotImplementedError`` naming the tier.

.. code-block:: python

    from quantum_simulations_tpu_torch import api, library, SimulatorConfig
    psi = api.simulate(library.non_stabilizer(28),
                       SimulatorConfig(mode="window"))  # on the card
"""
from __future__ import annotations

import numpy as np

from .circuit.contract import has_nonunitary, validate_circuit_dict
from .utils.config import SimulatorConfig


def _tier(name: str) -> NotImplementedError:
    return NotImplementedError(f"the {name} tier is not ported yet: the port "
                               f"runs the dense single-device tier only")


def simulate(circuit_dict: dict, config: SimulatorConfig | None = None,
             *, work_dir=None, device="cuda") -> np.ndarray:
    """Run a circuit under the given config; returns the final state as a
    host numpy complex vector.  Runs on the card unless ``device="cpu"``.
    """
    cfg = config or SimulatorConfig()
    if has_nonunitary(circuit_dict):
        raise _tier("trajectory")
    cd = validate_circuit_dict(circuit_dict)
    if cfg.sparse == "auto":
        raise _tier("adaptive sparse")
    if cfg.sparse:
        raise _tier("sparse")
    n = cd["number_of_qubits"]
    if cfg.mode == "capacity" or (cfg.mode == "auto" and n >= 29):
        raise _tier("capacity")
    if cfg.stripe_qubits is not None:
        raise _tier("out-of-core spill")
    if work_dir is not None:
        raise _tier("runner (WAL)")
    if (cfg.n_devices or 1) > 1:
        raise _tier("sharded")

    from .runtime import simulator

    psi = simulator.simulate(
        cd, dtype=cfg.dtype, mode=cfg.mode, use_fusion=cfg.use_fusion,
        panel_width=cfg.panel_width, segment_gates=cfg.segment_gates,
        device=device,
    )
    return psi.cpu().numpy()
