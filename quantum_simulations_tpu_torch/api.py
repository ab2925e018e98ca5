"""High-level user API of the port: the dense single-device tier and the
capacity tier.

Routes like ``quantum_simulations_tpu/api.py``; the tiers the port has
not reached yet raise ``NotImplementedError`` naming the tier.

.. code-block:: python

    from quantum_simulations_tpu_torch import api, library, SimulatorConfig
    psi = api.simulate(library.non_stabilizer(28),
                       SimulatorConfig(mode="window"))  # on the card
    res = api.simulate(library.qft(33),
                       SimulatorConfig(mode="capacity"))  # in place
    res.norm2(), res.top_amplitudes(4), res.sample_bits(100)
"""
from __future__ import annotations

import numpy as np

from .circuit.contract import has_nonunitary, validate_circuit_dict
from .utils.config import SimulatorConfig


def _tier(name: str) -> NotImplementedError:
    return NotImplementedError(f"the {name} tier is not ported yet: the port "
                               f"runs the dense single-device and capacity "
                               f"tiers only")


def _is_capacity(cfg: SimulatorConfig, n: int, work_dir=None) -> bool:
    """The reference's single-chip capacity route (api.py:76-85)."""
    capacity = cfg.mode == "capacity" or (cfg.mode == "auto" and n >= 29)
    return (capacity and not cfg.sparse and cfg.stripe_qubits is None
            and (cfg.n_devices or 1) == 1 and work_dir is None)


def _unported(circuit_dict: dict, cfg: SimulatorConfig, work_dir=None):
    """The error of a tier the port does not run yet, or None."""
    if has_nonunitary(circuit_dict):
        return _tier("trajectory")
    if cfg.sparse == "auto":
        return _tier("adaptive sparse")
    if cfg.sparse:
        return _tier("sparse")
    n = validate_circuit_dict(circuit_dict)["number_of_qubits"]
    if _is_capacity(cfg, n, work_dir):
        return None
    if cfg.stripe_qubits is not None:
        return _tier("out-of-core spill")
    if work_dir is not None:
        return _tier("runner (WAL)")
    if (cfg.n_devices or 1) > 1:
        return _tier("sharded")
    return None


def simulate(circuit_dict: dict, config: SimulatorConfig | None = None,
             *, work_dir=None, device="cuda"):
    """Run a circuit under the given config.  Runs on the card unless
    ``device="cpu"``.

    The dense tier returns the final state as a host numpy complex
    vector.  The capacity tier (``mode="capacity"``, or ``"auto"`` at
    n >= 29) returns a :class:`runtime.capacity.CapacityResult`: the
    planes stay on the device, read out by norm, top amplitudes,
    sampling and Z-string expectations.
    """
    cfg = config or SimulatorConfig()
    err = _unported(circuit_dict, cfg, work_dir)
    if err is not None:
        raise err
    cd = validate_circuit_dict(circuit_dict)
    if _is_capacity(cfg, cd["number_of_qubits"], work_dir):
        from .runtime.capacity import simulate_capacity

        return simulate_capacity(cd, dtype=cfg.dtype, device=device)

    from .runtime import simulator

    psi = simulator.simulate(
        cd, dtype=cfg.dtype, mode=cfg.mode, use_fusion=cfg.use_fusion,
        panel_width=cfg.panel_width, segment_gates=cfg.segment_gates,
        device=device,
    )
    return psi.cpu().numpy()


def _capacity_result(circuit_dict: dict, cfg: SimulatorConfig, device, what):
    """The capacity tier's result; the other tiers' readout is not
    ported yet."""
    err = _unported(circuit_dict, cfg)
    if err is not None:
        raise err
    n = validate_circuit_dict(circuit_dict)["number_of_qubits"]
    if not _is_capacity(cfg, n):
        raise NotImplementedError(
            f"{what} of a dense-tier state is not ported yet: the port reads "
            f"out the capacity tier's planes (SimulatorConfig(mode="
            f"'capacity'), or 'auto' at n >= 29)")
    return simulate(circuit_dict, cfg, device=device)


def sample(circuit_dict: dict, shots: int, *, seed: int = 0,
           config: SimulatorConfig | None = None,
           device="cuda") -> np.ndarray:
    """Simulate then draw bitstring samples; (shots, n) int8 matrix,
    column q = qubit q."""
    cfg = config or SimulatorConfig()
    res = _capacity_result(circuit_dict, cfg, device, "sampling")
    return res.sample_bits(shots, res.n, seed=seed)


def expectation_z(circuit_dict: dict, qubits: list[int],
                  config: SimulatorConfig | None = None, *,
                  device="cuda") -> float:
    """<Z_q1 Z_q2 ...> of the circuit's final state."""
    cfg = config or SimulatorConfig()
    res = _capacity_result(circuit_dict, cfg, device, "expectation_z")
    return res.expectation_z(qubits)


def expectation_pauli(circuit_dict: dict, pauli: str | dict[int, str],
                      config: SimulatorConfig | None = None, *,
                      device="cuda") -> float:
    """<psi| P |psi> for a Pauli string ('XZIY...' little-endian or
    {qubit: letter}).

    Non-Z axes are rotated into Z by APPENDING the basis-change layer
    (H for X, S-dagger then H for Y) to the circuit, then taking the
    Z-string expectation through :func:`expectation_z`, so the capacity
    tier stays planar.
    """
    from .ops.observables import parse_pauli

    cfg = config or SimulatorConfig()
    cd = validate_circuit_dict(circuit_dict)
    ps = parse_pauli(pauli)
    basis: list[dict] = []
    for q in sorted(ps):
        if ps[q] == "Y":
            basis.append({"qubits": [q], "gate": "SDG"})
        if ps[q] in ("X", "Y"):
            basis.append({"qubits": [q], "gate": "H"})
    rotated = {"number_of_qubits": cd["number_of_qubits"],
               "gates": list(cd["gates"]) + basis}
    return expectation_z(rotated, sorted(ps), cfg, device=device)
