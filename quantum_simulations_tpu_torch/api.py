"""High-level user API of the port: one facade over every tier.

Routes like ``quantum_simulations_tpu/api.py``: a circuit with RESET /
mid-circuit MEASURE / ``if`` goes to the trajectory tier (seeded by
``trajectory_seed``), ``sparse="auto"`` to the adaptive tier,
``sparse=True`` to the sparse tier, then the single-device capacity tier,
the spill tier (``stripe_qubits`` set: the state in host DRAM or disk
chunks, streamed through the card), the sharded tier (``n_devices`` > 1:
a mesh of that many cards, or positions on the CPU with
``device="cpu"``) and the WAL runner (``work_dir``: checkpoints, crash
recovery; capacity with a ``work_dir`` is the runner in place), and last
the dense single-device tier (modes fused, panel, window and auto).
Sharded ``sample`` and ``expectation_z`` read out on the mesh, with no
gather of the 2^n vector.

.. code-block:: python

    from quantum_simulations_tpu_torch import api, library, SimulatorConfig
    psi = api.simulate(library.non_stabilizer(28))  # fused, on the card
    psi = api.simulate(library.qft(28), SimulatorConfig(mode="panel"))
    bits = api.sample(library.ghz(28), shots=100, seed=1)
    res = api.simulate(library.qft(33),
                       SimulatorConfig(mode="capacity"))  # in place
    res.norm2(), res.top_amplitudes(4), res.sample_bits(100)
    st = api.simulate(library.ghz(62), SimulatorConfig(sparse=True))
    len(st), st.top_amplitudes(2)                         # a SparseState
    psi = api.simulate(library.ghz(33), SimulatorConfig(
        stripe_qubits=28))             # 64 GiB in host DRAM, 2 GiB stripes
    psi = api.simulate(library.qft(20), SimulatorConfig(
        stripe_qubits=16, spill_backend="disk"), work_dir="wd")
    psi = api.simulate(library.qft(20), SimulatorConfig(
        n_devices=8, mode="window"), device="cpu")   # 8 positions
    psi = api.simulate(library.qft(20), work_dir="wd")  # WAL + checkpoints
"""
from __future__ import annotations

import numpy as np
import torch

from .circuit.contract import has_nonunitary, validate_circuit_dict
from .utils import timing
from .utils.config import SimulatorConfig


def _wants_capacity(cfg: SimulatorConfig, n: int) -> bool:
    return cfg.mode == "capacity" or (cfg.mode == "auto" and n >= 29)


def _is_capacity(cfg: SimulatorConfig, n: int, work_dir=None) -> bool:
    """The reference's single-chip capacity route (api.py:76-85)."""
    return (_wants_capacity(cfg, n) and not cfg.sparse
            and cfg.stripe_qubits is None and (cfg.n_devices or 1) == 1
            and work_dir is None)


def _sharded_mode(cfg: SimulatorConfig) -> str:
    """The sharded tier's mode: window, else fused (the reference's)."""
    return "window" if cfg.mode == "window" else "fused"


def _on_mesh(cfg: SimulatorConfig) -> bool:
    """Whether a readout stays on the mesh (the reference's rule)."""
    return ((cfg.n_devices or 1) > 1 and not cfg.sparse
            and cfg.stripe_qubits is None)


def _simulate_sharded(cd: dict, cfg: SimulatorConfig, device):
    from .parallel import executor as E
    from .parallel import mesh as M

    mesh = M.make_mesh(cfg.n_devices, device=device)
    return E.simulate_sharded(
        mesh, cd, dtype=cfg.dtype, use_fusion=cfg.use_fusion,
        panel_width=cfg.panel_width, mode=_sharded_mode(cfg))


@timing.spanned("qst.api.run")
def run(circuit_dict: dict, cfg: SimulatorConfig, *, work_dir=None,
        device="cuda"):
    """Run a circuit and keep the result where its tier keeps it: the
    trajectory, dense and switched adaptive tiers' final state as a
    complex tensor on ``device``, the capacity tier's ``CapacityResult``,
    the spill tier's host numpy state (read back from the disk chunks
    for ``spill_backend="disk"``, which needs ``work_dir``), the sharded
    tier's and the runner's host numpy state (gathered, or read from the
    committed checkpoint), or the sparse tiers' ``SparseState`` (host
    dict)."""
    if has_nonunitary(circuit_dict):
        from .runtime.trajectory import simulate_trajectory

        psi, _, _ = simulate_trajectory(
            circuit_dict, seed=cfg.trajectory_seed, dtype=cfg.dtype,
            use_fusion=cfg.use_fusion, panel_width=cfg.panel_width,
            device=device)
        return psi
    cd = validate_circuit_dict(circuit_dict)

    if cfg.log_level:
        import logging

        from .utils.logging import setup_logging

        setup_logging(getattr(logging, cfg.log_level.upper(), logging.INFO))

    if cfg.sparse == "auto":
        from .sparse.adaptive import simulate_adaptive

        return simulate_adaptive(
            cd, threshold=cfg.sparse_threshold, dtype=cfg.dtype,
            mode=cfg.mode if cfg.mode in ("fused", "window") else "fused",
            device=device).state
    if cfg.sparse:
        from .sparse.engine import simulate_sparse

        return simulate_sparse(cd, threshold=cfg.sparse_threshold,
                               device=device)

    if _is_capacity(cfg, cd["number_of_qubits"], work_dir):
        from .runtime.capacity import simulate_capacity

        return simulate_capacity(cd, dtype=cfg.dtype, device=device)

    if cfg.stripe_qubits is not None:
        from .runtime import spill

        out = spill.run_out_of_core(
            cd, stripe_qubits=cfg.stripe_qubits, backend=cfg.spill_backend,
            work_dir=work_dir, dtype=cfg.dtype, use_fusion=cfg.use_fusion,
            panel_width=cfg.panel_width, use_staging=cfg.use_staging,
            staging_method=cfg.staging_method, transfer=cfg.spill_transfer,
            device=device)
        if cfg.spill_backend == "disk":
            return spill.collect_state(out)
        return out

    n = cd["number_of_qubits"]
    if (cfg.n_devices or 1) > 1 or work_dir is not None:
        from .parallel import executor as E
        from .parallel import mesh as M
        from .runtime import runner

        if work_dir is None:
            return E.collect_state(_simulate_sharded(cd, cfg, device))
        runner.run(
            cd, work_dir, mesh=M.make_mesh(cfg.n_devices or 1, device=device),
            dtype=cfg.dtype,
            mode=("capacity" if _wants_capacity(cfg, n)
                  else _sharded_mode(cfg)),
            use_wal=cfg.use_wal, use_fencing=cfg.use_fencing,
            use_fusion=cfg.use_fusion, panel_width=cfg.panel_width,
            use_staging=cfg.use_staging, staging_method=cfg.staging_method,
            checkpoint_every=cfg.checkpoint_every,
            max_levels_per_step=cfg.max_levels_per_step,
            event_log=cfg.event_log)
        return runner.collect_state(work_dir)

    from .runtime import simulator

    return simulator.simulate(
        cd, dtype=cfg.dtype, mode=cfg.mode, use_fusion=cfg.use_fusion,
        panel_width=cfg.panel_width, segment_gates=cfg.segment_gates,
        device=device,
    )


def _on_device(res, device):
    """The spill tier's host numpy state as a tensor on ``device`` (the
    reference's ``jnp.asarray`` before its readout); any other result as
    it is."""
    if isinstance(res, np.ndarray):
        from .utils.device import resolve_device

        return torch.from_numpy(res).to(resolve_device(device))
    return res


@timing.spanned("qst.api.simulate")
def simulate(circuit_dict: dict, config: SimulatorConfig | None = None,
             *, work_dir=None, device="cuda"):
    """Run a circuit under the given config.  Runs on the card unless
    ``device="cpu"``.

    The dense, spill and trajectory tiers (and an adaptive run that
    switched to dense) return the final state as a host numpy complex
    vector.
    The capacity tier (``mode="capacity"``, or ``"auto"`` at n >= 29)
    returns a :class:`runtime.capacity.CapacityResult`: the planes stay
    on the device, read out by norm, top amplitudes, sampling and
    Z-string expectations.  The sparse tiers return a
    :class:`sparse.engine.SparseState`.
    """
    res = run(circuit_dict, config or SimulatorConfig(), work_dir=work_dir,
              device=device)
    if isinstance(res, torch.Tensor):
        return res.cpu().numpy()
    return res


@timing.spanned("qst.api.sample")
def sample(circuit_dict: dict, shots: int, *, seed: int = 0,
           config: SimulatorConfig | None = None,
           device="cuda") -> np.ndarray:
    """Simulate then draw bitstring samples; (shots, n) int8 matrix,
    column q = qubit q.  A state on the device (the dense and trajectory
    tiers, an adaptive run that switched) is sampled there with a
    ``torch.Generator`` seeded by ``seed``, and so is the spill tier's
    host state once moved to ``device`` (the reference's readout); a
    ``SparseState`` samples over its nonzeros (numpy, the reference's
    bits), the capacity tier from its planes, the sharded tier on the
    mesh (``sampling.sample_bits_sharded``)."""
    from .ops import sampling

    cfg = config or SimulatorConfig()
    n = validate_circuit_dict(
        circuit_dict, allow_nonunitary=has_nonunitary(circuit_dict),
    )["number_of_qubits"]
    if _on_mesh(cfg) and not has_nonunitary(circuit_dict):
        return sampling.sample_bits_sharded(
            _simulate_sharded(circuit_dict, cfg, device), shots,
            seed).numpy()
    res = _on_device(run(circuit_dict, cfg, device=device), device)
    if isinstance(res, torch.Tensor):
        gen = torch.Generator(device=res.device).manual_seed(seed)
        return sampling.sample_bits(res, gen, shots, n).cpu().numpy()
    return res.sample_bits(shots, n, seed=seed)


@timing.spanned("qst.api.expectation_z")
def expectation_z(circuit_dict: dict, qubits: list[int],
                  config: SimulatorConfig | None = None, *,
                  device="cuda") -> float:
    """<Z_q1 Z_q2 ...> of the circuit's final state."""
    from .ops import sampling

    cfg = config or SimulatorConfig()
    if _on_mesh(cfg):
        return sampling.expectation_z_sharded(
            _simulate_sharded(circuit_dict, cfg, device), qubits)
    res = _on_device(run(circuit_dict, cfg, device=device), device)
    if isinstance(res, torch.Tensor):
        return sampling.expectation_z(res, qubits)
    return res.expectation_z(qubits)


@timing.spanned("qst.api.expectation_pauli")
def expectation_pauli(circuit_dict: dict, pauli: str | dict[int, str],
                      config: SimulatorConfig | None = None, *,
                      device="cuda") -> float:
    """<psi| P |psi> for a Pauli string ('XZIY...' little-endian or
    {qubit: letter}).

    Non-Z axes are rotated into Z by APPENDING the basis-change layer
    (H for X, S-dagger then H for Y) to the circuit, then taking the
    Z-string expectation through :func:`expectation_z`, so every tier
    reads it out on its own state (the capacity tier stays planar).
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
