"""Sharded circuit execution over the mesh (port of
``quantum_simulations_tpu/parallel/executor.py``).

The reference runs one SPMD program per step under ``shard_map``; here
one process drives every position it owns: each step's local ops run on
every shard through the single-device tier's kernels, then its
cross-shard ("non-local") ops through the collectives of ``comm.py``:

* ``mode="fused"``: each shard runs the step compiler's local ops as
  fused mode does (``lane_panel`` for a packed low panel, the pair
  kernels through ``simulator.gate_route``); then the step's boundary
  SWAPs as one reshard (``reshard.swap_device_bits``) and every other
  non-local gate by the XOR-offset exchange (``exchange.apply_nonlocal``).
* ``mode="window"``: each shard runs the window schedule of its step's
  local ops over the k shard-local qubits (``compile_window_ops`` at
  width k, ``pair_panel_diag``, ``simulator.apply_window_op``: the
  panels, the dual, ``fused_diag``, the pair kernels and the bit
  permutations); the non-local phase keeps program order between
  exchanging gates (the XOR-offset exchange) and zero-traffic ones (mesh
  bits never flipped: each position applies its own block W_0, chosen on
  the host by its bit values, through ``simulator.apply_gate``).
  ``inplace=True`` (the sharded capacity tier) runs every kernel's
  in-place instance, reshards in the shards' own memory, and refuses at
  build time, with the reference's ``ValueError``, a genuinely
  exchanging gate on shards of at least ``QST_CAPACITY_GUARD_MIN``
  amplitudes (its contributions need a second copy of the shard).

The state is planar throughout (``mesh.ShardedState``).  A function
built here consumes the state it is given: it updates the shards in
place or replaces them, and returns the state.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..circuit.contract import circuit_hash, validate_circuit_dict
from ..circuit.fusion import Step, compile_steps
from ..circuit.panelize import PhysGateOp, compile_window_ops
from ..ops import exchange
from ..runtime import simulator
from ..utils.device import complex_dtype, float_dtype
from . import comm
from .mesh import ShardedState, put_state, shard_width, zero_state_sharded
from .reshard import plan_boundary_reshard, swap_device_bits


def _reshard(mesh, shards: dict, k: int, pairs) -> None:
    """Boundary SWAPs as one all_to_all per plane, in place."""
    for plane in (0, 1):
        swap_device_bits(mesh, {s: pl[plane] for s, pl in shards.items()},
                         k, pairs)


def _apply_nonlocal_phase(mesh, shards: dict, step: Step, k: int) -> dict:
    """Fused mode: reshard-collapsed boundary SWAPs, then per-gate
    exchanges."""
    pairs, rest = plan_boundary_reshard(step.nonlocal_ops, k)
    if pairs:
        _reshard(mesh, shards, k, pairs)
    for op in rest:
        shards = exchange.apply_nonlocal(mesh, shards, k, op.qubits, op.U)
    return shards


def _apply_nonlocal_phase_planar(mesh, shards: dict, step: Step, k: int,
                                 inplace: bool, plain: bool) -> dict:
    """Window mode's non-local phase: boundary SWAPs as a reshard of each
    plane, then the rest in program order, zero-traffic gates through
    each position's W_0 and runs of exchanging gates through the
    XOR-offset exchange."""
    pairs, rest = plan_boundary_reshard(step.nonlocal_ops, k)
    if pairs:
        _reshard(mesh, shards, k, pairs)
    exchanging = []
    for op in rest:
        if exchange.exchange_cost(np.asarray(op.U), tuple(op.qubits), k) == 0:
            if exchanging:
                shards = _planar_exchange(mesh, shards, exchanging, k, inplace)
                exchanging = []
            shards = _planar_zero_traffic(shards, op, k, inplace, plain)
        else:
            exchanging.append(op)
    if exchanging:
        shards = _planar_exchange(mesh, shards, exchanging, k, inplace)
    return shards


def capacity_exchange_error(ops) -> ValueError:
    names = [getattr(op, "name", "?") for op in ops]
    return ValueError(
        f"capacity mode: non-SWAP cross-shard gates {names} need the "
        f"complex exchange path, which materializes a second copy of "
        f"the shard (2x memory) and does not fit at n >= 29 shard "
        f"sizes. Enable staging (use_staging=True) so cross-shard "
        f"traffic collapses into boundary SWAP reshards."
    )


def _planar_exchange(mesh, shards: dict, ops, k: int, inplace: bool) -> dict:
    """Genuinely exchanging gates, each by the XOR-offset exchange; in
    place the results are copied back into the shards once every
    position's contributions are computed."""
    if inplace and (1 << k) >= simulator._capacity_guard_min():
        raise capacity_exchange_error(ops)
    out = shards
    for op in ops:
        out = exchange.apply_nonlocal(mesh, out, k, op.qubits, op.U)
    if not inplace:
        return out
    mine = {id(pl): s for s, pls in shards.items() for pl in pls}
    # A result may be another position's old plane (a permutation
    # gate): take a copy before any shard is written.
    out = {s: tuple(x.clone() if mine.get(id(x), s) != s else x for x in pls)
           for s, pls in out.items()}
    for s, pls in shards.items():
        for dst, src in zip(pls, out[s]):
            if dst is not src:
                dst.copy_(src)
    return shards


def _zero_block(op, k: int, s: int):
    """Position s's W_0 of a zero-traffic gate and its local qubits."""
    qubits = tuple(op.qubits)
    dev_pos = [j for j, q in enumerate(qubits) if q >= k]
    a = exchange.bit_value(s, qubits, dev_pos, k)
    loc = tuple(q for q in qubits if q < k)
    return exchange.zero_offset_block(np.asarray(op.U), qubits, k, a), loc


def _scale_(c: complex, re, im, chunk: int = 1 << 26):
    """psi *= c in place, a chunk of temporary at a time."""
    for lo in range(0, re.numel(), chunk):
        r, i = re[lo:lo + chunk], im[lo:lo + chunk]
        if c.imag == 0:
            r.mul_(c.real)
            i.mul_(c.real)
            continue
        t = r.clone()
        r.mul_(c.real).sub_(i * c.imag)
        i.mul_(c.real).add_(t * c.imag)
    return re, im


def _planar_zero_traffic(shards: dict, op, k: int, inplace: bool,
                         plain: bool) -> dict:
    """A zero-traffic cross-shard gate: its mesh-bit qubits are never
    flipped, so each position applies the W_0 block its own bit values
    select (the reference picks it with ``lax.switch``; here the host
    knows each position's bits): a scalar phase when no qubit is local,
    else one gate through ``simulator.apply_gate``.  An identity block
    is skipped."""
    out = {}
    for s, (re, im) in shards.items():
        W, loc = _zero_block(op, k, s)
        if np.array_equal(W, np.eye(len(W))):
            out[s] = (re, im)
        elif not loc:
            c = complex(W[0, 0])
            out[s] = (_scale_(c, re, im) if inplace
                      else exchange.scale_planes(c, re, im))
        else:
            out[s] = simulator.apply_gate(re, im, loc, W, inplace=inplace,
                                          plain=plain, name=op.name)
    return out


def window_ops(steps: list[Step], k: int, inplace: bool) -> list:
    """Each step's local ops window-scheduled over the k shard-local
    qubits: ``[[(op, diag_terms | None), ...] per step]``.  Terms-only
    diag merges in place and from k = 10 (``QST_DIAG_TERMS_ONLY=0``
    reverts), as the single-device tier."""
    terms_only = inplace or (
        k >= 10 and os.environ.get("QST_DIAG_TERMS_ONLY", "1") == "1")
    return [
        simulator.pair_panel_diag(compile_window_ops(
            [(op.qubits, op.U, getattr(op, "name", "panel"))
             for op in s.local_ops],
            k, diag_terms_only=terms_only))
        for s in steps
    ]


def check_capacity(steps: list[Step], paired: list, mesh, k: int) -> None:
    """The in-place tier's refusals, before anything runs: a local gate
    or a zero-traffic gate's local block with no in-place path
    (``simulator.capacity_guard``), and an exchanging gate on shards of
    at least ``QST_CAPACITY_GUARD_MIN`` amplitudes."""
    for step, ops in zip(steps, paired):
        for op, _ in ops:
            if (isinstance(op, PhysGateOp)
                    and simulator.gate_route(op.qubits, op.U, k, True) == "dense"):
                simulator.capacity_guard(op.qubits, op.U, k, op.name)
        _, rest = plan_boundary_reshard(step.nonlocal_ops, k)
        exchanging = []
        for op in rest:
            if exchange.exchange_cost(np.asarray(op.U), tuple(op.qubits), k):
                exchanging.append(op)
                continue
            for s in range(mesh.size):
                W, loc = _zero_block(op, k, s)
                if loc and simulator.gate_route(loc, W, k, True) == "dense":
                    simulator.capacity_guard(loc, W, k, op.name)
        if exchanging and (1 << k) >= simulator._capacity_guard_min():
            raise capacity_exchange_error(exchanging)


def build_steps_fn(mesh, n: int, steps: list[Step], *, mode: str = "fused",
                   inplace: bool = False, dtype="complex64"):
    """``fn(state) -> state`` applying ``steps`` to a sharded state.

    ``mode='window'`` runs each shard's local ops through the window
    schedule's kernels, ``inplace`` every pass through their in-place
    instances (window only); any other mode is fused.  complex128 runs
    the plain torch twins (``simulator.plain_route``).  A one-position
    mesh runs the body with no collective: its steps have no non-local
    ops.
    """
    k = shard_width(mesh, n)
    fdtype = float_dtype(complex_dtype(dtype))
    plain = simulator.plain_route(False, fdtype)
    devices = {mesh.device(s) for s in mesh.local}
    if mode == "window":
        paired = window_ops(steps, k, inplace)
        if inplace:
            check_capacity(steps, paired, mesh, k)
        prepared = {d: [simulator.prepare_schedule(p, d, fdtype)
                        for p in paired] for d in devices}

        def local(re, im, ops):
            for op, dterms in ops:
                re, im = simulator.apply_window_op(
                    re, im, op, dterms, inplace=inplace, plain=plain)
            return re, im

        def nonlocal_phase(shards, step):
            return _apply_nonlocal_phase_planar(mesh, shards, step, k,
                                                inplace, plain)
    else:
        if inplace:
            raise ValueError("inplace requires mode='window'")
        prepared = {d: [simulator.prepare_passes(
            [(op, False) for op in s.local_ops], d, fdtype) for s in steps]
            for d in devices}

        def local(re, im, ops):
            for op, _ in ops:
                re, im = simulator.apply_panel_op(re, im, op, plain=plain)
            return re, im

        def nonlocal_phase(shards, step):
            return _apply_nonlocal_phase(mesh, shards, step, k)

    def fn(state: ShardedState) -> ShardedState:
        shards = state.shards
        for i, step in enumerate(steps):
            for s in list(shards):
                # Popped, so an out-of-place pass releases the old planes.
                shards[s] = local(*shards.pop(s),
                                  prepared[mesh.device(s)][i])
            if step.nonlocal_ops:
                shards = nonlocal_phase(shards, step)
        state.shards = shards
        return state

    return fn


_CACHE: dict = {}


def build_circuit_fns(
    mesh,
    circuit_dict: dict,
    *,
    use_fusion: bool = True,
    panel_width: int | None = 7,
    per_step: bool = False,
    mode: str = "fused",
    inplace: bool = False,
    dtype="complex64",
    max_levels_per_step: int | None = None,
):
    """Compile a circuit for the mesh: ``(steps, fns)``, ``fns`` one
    function for the whole circuit (per_step=False) or one per step (the
    WAL runner's granularity).  ``mode='window'`` schedules its own
    panels (``panel_width`` is not used); ``max_levels_per_step`` bounds
    how many circuit levels one step absorbs (``fusion.batch_levels``).
    Cached by the circuit, the mesh's (rank, device) layout and every
    option.
    """
    cd = validate_circuit_dict(circuit_dict)
    n = cd["number_of_qubits"]
    k = shard_width(mesh, n)
    if mode == "window":
        panel_width = None
    key = (circuit_hash(cd), mesh.key(), mesh.rank, use_fusion, panel_width,
           per_step, mode, inplace, str(complex_dtype(dtype)),
           max_levels_per_step, simulator._switches())
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    steps = compile_steps(cd, k=k, use_fusion=use_fusion,
                          panel_width=panel_width,
                          max_levels_per_step=max_levels_per_step)
    kw = dict(mode=mode, inplace=inplace, dtype=dtype)
    if per_step:
        fns = [build_steps_fn(mesh, n, [s], **kw) for s in steps]
    else:
        fns = build_steps_fn(mesh, n, steps, **kw)
    _CACHE[key] = (steps, fns)
    return steps, fns


def simulate_sharded(
    mesh,
    circuit_dict: dict,
    *,
    dtype="complex64",
    use_fusion: bool = True,
    panel_width: int | None = 7,
    initial_state=None,
    mode: str = "fused",
) -> ShardedState:
    """Run a circuit on the mesh from |0...0> (or the host vector
    ``initial_state``); returns the sharded state."""
    cd = validate_circuit_dict(circuit_dict)
    n = cd["number_of_qubits"]
    _, fn = build_circuit_fns(mesh, cd, use_fusion=use_fusion,
                              panel_width=panel_width, mode=mode,
                              dtype=dtype)
    if initial_state is None:
        state = zero_state_sharded(mesh, n, dtype)
    else:
        state = put_state(mesh, initial_state, dtype)
    return fn(state)


def gather_planes(state: ShardedState):
    """The whole state as host (2, 2^n) planes on rank 0 (None on the
    other ranks): card shards copied into pinned memory."""
    from ..utils.transfer import pinned_empty

    mesh, n, k = state.mesh, state.n, state.k
    host = None
    dests = None
    if mesh.rank == 0:
        dev = next((d for d in mesh.devices if d.type == "cuda"),
                   torch.device("cpu"))
        npdt = np.dtype(str(state.fdtype).removeprefix("torch."))
        flat, _ = pinned_empty(2 << n, npdt, dev)
        host = flat.reshape(2, 1 << n)
        t = torch.from_numpy(host)
        dests = {s: (t[0, s << k:(s + 1) << k], t[1, s << k:(s + 1) << k])
                 for s in range(mesh.size)}
    comm.gather_into(mesh, state.shards, dests)
    if any(d.type == "cuda" for d in mesh.devices):
        torch.cuda.synchronize()
    return host


def complex_of(planes: np.ndarray, dtype=None) -> np.ndarray:
    """Host (2, 2^n) planes as a complex vector of ``dtype`` (by default
    the planes' own precision), with no temporary beyond the result."""
    if dtype is None:
        dtype = np.complex64 if planes.dtype == np.float32 else np.complex128
    out = np.empty(planes.shape[1], dtype=dtype)
    out.real = planes[0]
    out.imag = planes[1]
    return out


def collect_state(state: ShardedState) -> np.ndarray | None:
    """Gather the sharded state to a host complex vector (rank 0; None
    on the other ranks)."""
    host = gather_planes(state)
    return None if host is None else complex_of(host)
