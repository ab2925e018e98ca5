"""Step compiler of ``mode="fused"``: levelization -> fused execution steps.

A jax-free copy of ``quantum_simulations_tpu/circuit/fusion.py``.
Consecutive all-local levels are batched into one step, runs of 1Q gates
on the same qubit are pre-multiplied into a single 2x2 matrix, and runs
of gates whose qubits all sit below ``panel_width`` (<= 7) index bits
are composed into one 2^w x 2^w unitary (:class:`LowPanelOp`), which the
executor applies as one ``lane_panel`` pass.  ``GateOp`` is also the
gate type of the panel schedulers (``circuit/panelize.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import gates as G
from .contract import levelize, validate_circuit_dict


@dataclass(frozen=True)
class GateOp:
    """A gate bound to its unitary. U: complex128, big-endian subspace."""
    qubits: tuple[int, ...]
    U: np.ndarray
    name: str = "?"

    @property
    def arity(self) -> int:
        return len(self.qubits)


@dataclass(frozen=True)
class LowPanelOp:
    """A fused unitary over the low `width` index bits (one panel pass)."""
    width: int
    W: np.ndarray  # (2^width, 2^width) complex128, little-endian over bits 0..w-1
    n_fused: int = 1

    @property
    def qubits(self) -> tuple[int, ...]:
        return tuple(range(self.width))


@dataclass
class Step:
    """One execution step: all local ops then all non-local ops.

    ``local_ops`` entries are GateOp or LowPanelOp; ``nonlocal_ops`` are
    GateOp touching at least one qubit >= k (the shard width).
    """
    local_ops: list = field(default_factory=list)
    nonlocal_ops: list = field(default_factory=list)
    level_indices: list = field(default_factory=list)


def compile_gate(g: dict) -> GateOp:
    return GateOp(
        qubits=tuple(g["qubits"]),
        U=G.gate_matrix(g["gate"], g.get("params") or {}),
        name=g["gate"],
    )


def _split_local(level_gates: list[dict], k: int) -> tuple[list[GateOp], list[GateOp]]:
    local: list[GateOp] = []
    nonloc: list[GateOp] = []
    for g in level_gates:
        op = compile_gate(g)
        (local if all(q < k for q in op.qubits) else nonloc).append(op)
    return local, nonloc


# ---------------------------------------------------------------------------
# 1Q fusion
# ---------------------------------------------------------------------------

def fuse_1q_ops(ops: list[GateOp]) -> list[GateOp]:
    """Fuse runs of 1Q gates on the same qubit into one 2x2 matrix.

    Each open run is accumulated IN PLACE at the position of its first
    gate (any op between that position and the run's closing
    multi-qubit gate acts on other qubits, so the placement is
    unitarily equivalent); a multi-qubit gate closes the runs on its
    qubits.
    """
    out: list[GateOp] = []
    open_at: dict[int, int] = {}  # qubit -> index in `out` of its run
    for op in ops:
        if op.arity != 1:
            for q in op.qubits:
                open_at.pop(q, None)
            out.append(op)
            continue
        (q,) = op.qubits
        slot = open_at.get(q)
        if slot is None:
            open_at[q] = len(out)
            out.append(GateOp(qubits=(q,), U=op.U.copy(), name="fused1q"))
        else:
            out[slot] = GateOp(qubits=(q,), U=op.U @ out[slot].U,
                               name="fused1q")
    return out


# ---------------------------------------------------------------------------
# Low-panel packing
# ---------------------------------------------------------------------------

def pack_low_panels(
    ops: list, panel_width: int, min_fuse: int = 2,
) -> list:
    """Greedily fuse consecutive ops with all qubits < panel_width.

    A run of >= min_fuse such gates becomes one LowPanelOp (a single
    panel pass); shorter runs stay as individual gate passes (a panel
    pass is only a win once it replaces several passes).
    """
    from ..ops.dense import compose_low_panel  # local import: avoid cycle

    out: list = []
    run: list[GateOp] = []

    def flush() -> None:
        nonlocal run
        if len(run) >= min_fuse:
            W = compose_low_panel([(op.qubits, op.U) for op in run], panel_width)
            out.append(LowPanelOp(width=panel_width, W=W, n_fused=len(run)))
        else:
            out.extend(run)
        run = []

    for op in ops:
        if isinstance(op, GateOp) and all(q < panel_width for q in op.qubits):
            run.append(op)
        else:
            flush()
            out.append(op)
    flush()
    return out


# ---------------------------------------------------------------------------
# Level batching -> steps
# ---------------------------------------------------------------------------

def batch_levels(levels: list[list[dict]], k: int,
                 max_levels_per_step: int | None = None) -> list[Step]:
    """Batch maximal runs of all-local levels into fused steps.

    A level containing any non-local gate is its own step; between
    such levels, every consecutive all-local level pours into one
    step whose local ops are then 1Q-fused.  ``max_levels_per_step``
    (``None``: unbounded, else >= 1; a cap of 0 is rejected rather
    than silently meaning "unbounded") caps how many levels one step
    may absorb.
    """
    if max_levels_per_step is not None and max_levels_per_step < 1:
        raise ValueError(
            f"max_levels_per_step must be None or >= 1, "
            f"got {max_levels_per_step!r}")
    split = [(_split_local(lv, k) if lv else ([], []), i)
             for i, lv in enumerate(levels)]
    steps: list[Step] = []
    i = 0
    while i < len(split):
        (local, nonloc), idx = split[i]
        if not local and not nonloc:
            i += 1
            continue
        if nonloc:
            steps.append(Step(local_ops=local, nonlocal_ops=nonloc,
                              level_indices=[idx]))
            i += 1
            continue
        # Maximal all-local run starting here (bounded if requested).
        run_ops, run_idx = list(local), [idx]
        i += 1
        while i < len(split):
            if max_levels_per_step is not None \
                and len(run_idx) >= max_levels_per_step:
                break
            (loc2, non2), idx2 = split[i]
            if non2:
                break
            if loc2:
                run_ops.extend(loc2)
                run_idx.append(idx2)
            i += 1
        steps.append(Step(local_ops=fuse_1q_ops(run_ops), nonlocal_ops=[],
                          level_indices=run_idx))
    return steps


def compile_steps(
    circuit_dict: dict,
    k: int,
    *,
    use_fusion: bool = True,
    panel_width: int | None = None,
    panel_min_fuse: int = 2,
    max_levels_per_step: int | None = None,
) -> list[Step]:
    """Full pipeline: validate -> levelize -> batch/fuse -> low-panel pack."""
    circuit_dict = validate_circuit_dict(circuit_dict)
    levels = levelize(circuit_dict)
    if use_fusion:
        steps = batch_levels(levels, k, max_levels_per_step)
    else:
        steps = []
        for lv_idx, level_gates in enumerate(levels):
            if not level_gates:
                continue
            local, nonloc = _split_local(level_gates, k)
            steps.append(Step(local_ops=local, nonlocal_ops=nonloc,
                              level_indices=[lv_idx]))
    if panel_width:
        width = min(panel_width, k)
        if width >= 1:
            for step in steps:
                step.local_ops = pack_low_panels(
                    step.local_ops, width, panel_min_fuse
                )
    return steps


def fusion_stats(circuit_dict: dict, k: int, panel_width: int | None = None) -> dict:
    """I/O-pass reduction statistics (benchmark aid, reference parity)."""
    circuit_dict = validate_circuit_dict(circuit_dict)
    levels = levelize(circuit_dict)
    steps = compile_steps(circuit_dict, k, use_fusion=True, panel_width=panel_width)
    n_levels = sum(1 for lv in levels if lv)
    n_steps = len(steps)
    ops_before = sum(len(lv) for lv in levels)
    ops_after = sum(len(s.local_ops) + len(s.nonlocal_ops) for s in steps)
    return {
        "original_levels": n_levels,
        "fused_steps": n_steps,
        "local_only_steps": sum(1 for s in steps if not s.nonlocal_ops),
        "io_reduction": f"{n_levels} levels -> {n_steps} passes "
                        f"({(1 - n_steps / max(n_levels, 1)) * 100:.0f}% saved)",
        "ops_before": ops_before,
        "ops_after": ops_after,
    }
