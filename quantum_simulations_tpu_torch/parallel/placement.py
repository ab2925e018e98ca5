"""Shard-placement reporting and verification (port of
``quantum_simulations_tpu/parallel/placement.py``).

Given a mesh, and optionally a sharded state, report where every
amplitude range lives (position, device, process, and whether flipping
each mesh bit moves data between processes) and verify the placement
invariants the sharded tiers rely on:

* the mesh is a power-of-two 1-D amplitude mesh;
* each process's positions are CONTIGUOUS on the mesh (low mesh bits
  stay inside a process, only top bits cross processes:
  ``distributed.make_pod_mesh``);
* a sharded state's shards cover exactly the index ranges the mesh
  formula assigns (position s holds [s*2^k, (s+1)*2^k)), on the
  position's own device.

``python -m quantum_simulations_tpu_torch placement`` prints the report.
The link names are the reference's: "ICI" within a process, "DCN"
between processes.
"""
from __future__ import annotations

import torch

from . import distributed
from .mesh import AXIS, device_bits, shard_width


def _processes(mesh) -> list[int]:
    """The process of each position (duck-typed: a ``Mesh``, or any
    object with ``.positions`` of (rank, device) pairs)."""
    return [r for r, _ in mesh.positions]


def placement_report(mesh, n: int | None = None) -> dict:
    """Describe where every shard of an n-qubit state lives: per-position
    rows (mesh position, device, process, amplitude range), a mesh-bit
    table (which qubit each mesh bit carries and whether flipping it
    crosses processes) and the checked placement invariants."""
    procs = _processes(mesh)
    d = device_bits(mesh)
    k = shard_width(mesh, n) if n is not None else None
    costs = distributed.device_bit_costs(mesh)

    rows = []
    for s, (rank, dev) in enumerate(mesh.positions):
        row = {"mesh_pos": s, "device": str(dev), "process": int(rank)}
        if k is not None:
            row["amp_range"] = [s << k, (s + 1) << k]
        rows.append(row)

    bit_table = []
    for b in range(d):
        bit_table.append({
            "device_bit": b,
            "qubit": (k + b) if k is not None else None,
            "link": "DCN" if costs[b] == distributed.DCN_COST else "ICI",
            "rel_cost": costs[b],
        })

    return {
        "n_devices": len(procs),
        "n_processes": len(set(procs)),
        "n_qubits": n,
        "local_qubits": k,
        "axis": AXIS,
        "devices": rows,
        "device_bits": bit_table,
        "invariants": check_invariants(mesh),
    }


def check_invariants(mesh) -> dict:
    """Placement invariants the sharded tiers assume.

    host_contiguous: every process's positions occupy one contiguous run
    of the mesh, so the process boundary is a clean bit split (the
    ``make_pod_mesh`` ordering contract).
    """
    procs = _processes(mesh)
    size = len(procs)
    pow2 = size & (size - 1) == 0

    first_last: dict[int, list[int]] = {}
    counts: dict[int, int] = {}
    for s, p in enumerate(procs):
        counts[p] = counts.get(p, 0) + 1
        lo_hi = first_last.setdefault(p, [s, s])
        lo_hi[0] = min(lo_hi[0], s)
        lo_hi[1] = max(lo_hi[1], s)
    host_contig = all(hi - lo + 1 == counts[p]
                      for p, (lo, hi) in first_last.items())
    equal_per_host = len(set(counts.values())) <= 1
    return {
        "power_of_two": pow2,
        "host_contiguous": host_contig,
        "equal_devices_per_host": equal_per_host,
        "ok": pow2 and host_contig and equal_per_host,
    }


def verify_sharded_array(state, mesh, n: int) -> dict:
    """Check a real sharded state against the mesh placement formula.

    Every position this process owns must hold a shard, and nothing else
    may: each shard two planes of shape (2^k,), contiguous, on the
    position's device, for the index range [s*2^k, (s+1)*2^k) (a state of
    another width, or one whose shards are the whole vector, fails).
    Returns ``{"ok": bool, "violations": [...], "addressable": int}``;
    metadata only, no amplitude is read.
    """
    k = shard_width(mesh, n)
    violations = []
    if state.n != n:
        violations.append(f"state of {state.n} qubits, expected {n}")
    if state.mesh.key() != mesh.key():
        violations.append("state is on another mesh")
    want = set(mesh.local)
    for s in sorted(set(state.shards) - want):
        violations.append(f"position {s} is not this process's")
    for s in sorted(want - set(state.shards)):
        violations.append(f"position {s} has no shard")
    for s in sorted(set(state.shards) & want):
        dev = mesh.device(s)
        for name, plane in zip(("re", "im"), state.shards[s]):
            if plane.device != dev:
                violations.append(f"position {s} {name}: on {plane.device}, "
                                  f"expected {dev}")
            if tuple(plane.shape) != (1 << k,) or not plane.is_contiguous():
                violations.append(
                    f"position {s} {name}: shard shape {tuple(plane.shape)}, "
                    f"expected {(1 << k,)} (amplitudes "
                    f"[{s << k}, {(s + 1) << k}))")
    return {
        "ok": not violations,
        "addressable": len(state.shards),
        "violations": violations,
    }


def main(n_devices: int | None = None, n: int | None = None, *,
         device="cuda") -> dict:
    """Build the ambient mesh (every process's, when a process group is
    configured) and return the report, with a check of |0...0> placed on
    it."""
    from .mesh import make_mesh, zero_state_sharded

    on_cpu = torch.device(device).type == "cpu"
    distributed.init_distributed(backend="gloo" if on_cpu else None)
    if distributed.is_multihost():
        mesh = distributed.make_pod_mesh(n_devices, device=device)
    else:
        mesh = make_mesh(n_devices, device=device)
    if n is None:
        n = device_bits(mesh) + 2
    rep = placement_report(mesh, n)
    psi = zero_state_sharded(mesh, n)
    rep["sharded_array_check"] = verify_sharded_array(psi, mesh, n)
    return rep
