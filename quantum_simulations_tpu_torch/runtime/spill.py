"""Out-of-core runner: states beyond the card's memory, streamed through it.

Port of ``quantum_simulations_tpu/runtime/spill.py`` (the analogue of the
reference's out-of-core engine, ``wenbo_engine/runner/single_node.py`` +
``runner/pipeline.py``): the amplitude vector lives in host DRAM (or on
disk in chunk files) and streams through the card in stripes of 2^m
amplitudes, each step of ``compile_steps(cd, k=m)`` one pass over it.

Cross-stripe ("non-local") gates by **stack-and-relabel**: a step whose
non-local gates touch stripe-index bits B loads the whole 2^|B| stripe
group as ONE device array of 2^(m+|B|) amplitudes in which bit m+t
carries group bit B[t]; every gate then becomes a local gate with
remapped qubits (:func:`_remap_ops`), run by fused mode's passes
(``simulator.prepare_passes`` / ``run_passes``) on the (re, im) planes
of the group: ``lane_panel`` for a ``LowPanelOp``, the pair kernels and
``bitperm_swap`` through ``simulator.gate_route``, the plain torch gate
paths for what no kernel takes; complex128 through the plain twins
(``plain_route``).  Each member stripe goes up as interleaved complex
straight into its slot of the device array, is split into planes on the
card, joined again, and comes down straight into its stripe
(``utils/transfer.StripeIO``).

Depth-2 pipeline over two device slots: group k+1's upload is enqueued
(on its copy stream) before group k's compute, and group k+1's compute
before group k's download is waited for, so PCIe both ways and the
card's compute overlap; ``pipeline=False`` uploads, computes and waits
for each group before the next, with the same result bit for bit.

``mesh`` (the reference's distributed out-of-core composition) shards
every stripe group over the positions of a mesh in this process: each
position holds, for every member stripe, its 2^(m-d) sub-block, so stripe
bits [0, m-d) stay shard-local, bits [m-d, m) are mesh bits (the
XOR-offset exchange of ``ops/exchange.apply_nonlocal``) and stripe-index
bits are stacked as above (:func:`_remap_ops_mesh`).  Each position's
sub-blocks cross PCIe through its own ``StripeIO`` (pinned host buffers,
copy streams, 256 MiB pieces) with one device slot: a group goes up,
runs and comes down before the next, with no pipelining.

Durability (disk backend): the same step-WAL + a/b double buffer as the
reference; ``QST_CRASH_AFTER_STRIPE`` hard-kills after N+1 stripe writes
(a stripe counts as written once its bytes are on the host and, on disk,
its file is written), the reference's WE_CRASH_AFTER_CHUNK analogue.
"""
from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch

from ..circuit.contract import validate_circuit_dict
from ..circuit.fusion import GateOp, Step, compile_steps
from ..utils.device import complex_dtype, float_dtype, resolve_device
from ..utils.transfer import StripeIO
from . import simulator
from .chunk_store import DiskBuffer, HostBuffer
from .wal import WAL

CRASH_ENV = "QST_CRASH_AFTER_STRIPE"


def _group_bits(step: Step, m: int) -> list[int]:
    bits: set[int] = set()
    for op in step.nonlocal_ops:
        for q in op.qubits:
            if q >= m:
                bits.add(q - m)
    return sorted(bits)


def _remap_ops(step: Step, m: int, bits: list[int]) -> list:
    """All of a step's ops as local ops on the stacked 2^(m+r) array."""
    pos = {b: m + t for t, b in enumerate(bits)}
    out = list(step.local_ops)
    for op in step.nonlocal_ops:
        qs = tuple(q if q < m else pos[q - m] for q in op.qubits)
        out.append(GateOp(qubits=qs, U=op.U, name=op.name))
    return out


def _remap_ops_mesh(step: Step, m: int, bits: list[int], d: int) -> list:
    """Step ops in the SHARDED stacked frame (distributed out-of-core).

    The stacked group of 2^r stripes is held as 2^d shards, each holding
    every member's contiguous 2^(m-d) sub-block, so the per-shard bit
    layout is

        [0, m-d)            stripe-local bits   (global qubits 0..m-d)
        [m-d, m-d+r)        host group bits     (global qubits m+bits[t])
        >= k_eff = m-d+r    mesh bits           (global qubits m-d..m)

    Host-group gates become plain local gates; mesh-bit gates keep qubits
    >= k_eff, so ``exchange.apply_nonlocal`` sees mesh bit ``q - k_eff``.
    """
    lo = m - d
    k_eff = lo + len(bits)
    pos = {b: lo + t for t, b in enumerate(bits)}

    def remap(q: int) -> int:
        if q < lo:
            return q
        if q >= m:
            return pos[q - m]
        return k_eff + (q - lo)  # mesh bit

    out = []
    for op in list(step.local_ops) + list(step.nonlocal_ops):
        if isinstance(op, GateOp):
            out.append(GateOp(qubits=tuple(remap(q) for q in op.qubits),
                              U=op.U, name=op.name))
        else:  # LowPanelOp: qubits all < panel width <= m-d
            out.append(op)
    return out


def _run_group_mesh(mesh, ios: dict, stripes: list, outs: list, m: int,
                    k_eff: int, ops: list, plain: bool) -> None:
    """One stripe group through the mesh: each position's shard (its
    sub-block of every member stripe, in member order) goes up into its
    ``StripeIO`` slot and is split into planes, the ops run (mesh-bit
    gates by the XOR-offset exchange, the rest on each shard as fused
    mode's passes), and each position's sub-blocks come down into
    ``outs`` (the host stripes, in member order), waited for."""
    from ..ops import exchange

    sub = 1 << (m - (mesh.size.bit_length() - 1))

    def blocks(arrays, s):
        return [a[s * sub:(s + 1) * sub] for a in arrays]

    for s in mesh.local:
        ios[s].upload(0, blocks(stripes, s))
    shards = {s: ios[s].planes(0, sub * len(stripes)) for s in mesh.local}
    for op, prepared in ops:
        if isinstance(op, GateOp) and max(op.qubits) >= k_eff:
            shards = exchange.apply_nonlocal(mesh, shards, k_eff, op.qubits,
                                             op.U)
        else:
            for s in mesh.local:
                shards[s] = simulator.apply_panel_op(
                    *shards[s], prepared[mesh.device(s)], plain=plain)
    for s in mesh.local:
        ios[s].store(0, *shards.pop(s))
        ios[s].download(0, blocks(outs, s))
    for s in mesh.local:
        ios[s].wait(0)


def _groups(stripe_bits: int, bits: list[int]):
    """The stripe groups of a step with group bits ``bits``, in the
    reference's order: each a list of 2^r member stripes, member ``pat``
    carrying group bit t = bit t of ``pat``.  With r = 0, the stripes
    0, 1, 2, ... one at a time."""
    r = len(bits)
    free_bits = [b for b in range(stripe_bits) if b not in bits]
    for base_sel in range(1 << len(free_bits)):
        base = 0
        for t, b in enumerate(free_bits):
            if (base_sel >> t) & 1:
                base |= 1 << b
        members = []
        for pat in range(1 << r):
            s = base
            for t in range(r):
                if (pat >> t) & 1:
                    s |= 1 << bits[t]
            members.append(s)
        yield members


def run_out_of_core(
    circuit_dict: dict,
    *,
    stripe_qubits: int,
    backend: str = "host",
    work_dir=None,
    dtype="complex64",
    use_wal: bool = True,
    use_fusion: bool = True,
    panel_width: int | None = 7,
    use_staging: bool = False,
    staging_method: str = "auto",
    pipeline: bool = True,
    transfer: str = "native",
    mesh=None,
    initial_state=None,
    single_copy: bool = False,
    device="cuda",
    stats: dict | None = None,
) -> np.ndarray | Path:
    """Simulate with the state held outside the card's memory; runs on
    the card unless ``device="cpu"``.

    backend='host': amplitudes in host DRAM (pinned on the card; returns
    the final numpy state; ``use_wal`` is ignored — host buffers don't
    survive the process anyway).  backend='disk': chunk files under
    ``work_dir`` with WAL + double buffer (returns the work dir; read
    with :func:`collect_state`).

    ``use_staging`` remaps qubits so hot qubits stay stripe-local,
    trading SWAP passes for fewer stripe-GROUP steps (``staging_method``
    'auto' takes the heuristic plan when it cuts the exchanges).
    Host-backend results are un-permuted before returning (in place
    where the layout allows: ``staging.permute_state_inplace``); disk
    runs record ``qubit_mapping.json``, applied by :func:`collect_state`.

    ``initial_state``: a 1-D array of 2^n amplitudes, ADOPTED as the
    working buffer (overwritten; pinned only if the caller's array is,
    as a result of an earlier run is), or a callable ``s -> stripe s``.  ``single_copy`` writes results back into
    the buffer they were read from (valid: within one step every stripe
    or group is read once, then written), halving host RAM.  Both are
    host-backend only.

    ``transfer='f32'`` moves stripes as their interleaved float32 views
    (the reference's interface for backends without complex transfers):
    the same bytes, so the same result; complex64 only.

    ``mesh`` (a ``parallel.mesh.Mesh`` whose positions this process owns
    all of) shards every stripe group over its positions: the reference's
    composition of the sharded and out-of-core tiers.  It needs
    ``stripe_qubits`` above the mesh's bits and the native transfer.

    ``stats``, when given, is filled with ``steps`` (run here),
    ``groups``, ``bytes_up``, ``bytes_down``, ``pinned`` (the host
    buffer's route), ``alloc_s`` (host seconds allocating, pinning and
    zeroing the host buffers) and ``wait_s`` (host seconds blocked on
    downloads).
    """
    cd = validate_circuit_dict(circuit_dict)
    dev = resolve_device(device)
    n = cd["number_of_qubits"]
    m = min(stripe_qubits, n)

    d = 0
    if mesh is not None:
        d = int(np.log2(mesh.size))
        if (1 << d) != mesh.size:
            raise ValueError("mesh size must be a power of two")
        if m - d < 1:
            raise ValueError(
                f"stripe_qubits={m} leaves no shard-local bits on a "
                f"{mesh.size}-device mesh")
        if transfer == "f32":
            raise ValueError("transfer='f32' is single-device only")
        if mesh.world > 1:
            raise ValueError("the out-of-core tier runs a mesh of one "
                             "process's positions")
        if panel_width is not None:
            # low panels must stay within the shard-local bits
            panel_width = max(1, min(panel_width, m - d))

    log2phys = None
    if use_staging and m < n:
        from ..circuit import staging as S

        method = staging_method
        if method == "auto":
            st = S.staging_stats(cd, m, "heuristic")
            method = ("heuristic"
                      if st["exchanges_staged"] < st["exchanges_unstaged"]
                      else None)
        if method:
            cd, log2phys, _ = S.stage_circuit(cd, m, method)
            if log2phys == list(range(n)):
                log2phys = None

    f32_io = transfer == "f32"
    if f32_io and np.dtype(dtype) != np.complex64:
        raise ValueError("transfer='f32' supports dtype=complex64 only")
    if (initial_state is not None or single_copy) and backend != "host":
        raise ValueError("initial_state/single_copy are host-backend only")
    cdtype = complex_dtype(dtype)
    fdtype = float_dtype(cdtype)
    npdt = np.dtype(str(cdtype).removeprefix("torch."))
    plain = simulator.plain_route(False, fdtype)

    steps = compile_steps(cd, k=m, use_fusion=use_fusion,
                          panel_width=panel_width)
    crash_after = int(os.environ.get(CRASH_ENV, "-1"))
    writes = 0

    t_alloc = time.perf_counter()
    if backend == "host":
        adopt = initial_state is not None and not callable(initial_state)
        src = HostBuffer(n, m, dtype=npdt, device=None if adopt else dev)
        if initial_state is not None:
            if log2phys is not None:
                raise ValueError("initial_state with use_staging is "
                                 "unsupported (state is in logical order)")
            if callable(initial_state):
                # Stripe generator: fills the buffer without a second
                # full-state array co-live (n=33 = 64 GiB at c64).
                for s in range(src.n_stripes):
                    src.write(s, np.asarray(initial_state(s), dtype=npdt))
            else:
                arr = np.asarray(initial_state)
                if arr.size != 1 << n:
                    raise ValueError("initial_state size mismatch")
                if arr.ndim != 1:
                    raise ValueError("initial_state must be 1-D "
                                     "(stripe addressing slices axis 0)")
                # ADOPTED, not copied (a second 2^n copy defeats the
                # tier's memory point): the caller's array becomes the
                # working buffer and is OVERWRITTEN with simulation
                # state.  Pass arr.copy() to keep the original.
                src.data = arr if arr.dtype == npdt else arr.astype(npdt)
                src.pinned = (dev.type == "cuda"
                              and torch.from_numpy(src.data).is_pinned())
        dst = src if single_copy else HostBuffer(
            n, m, dtype=npdt, init_zero_state=False, device=dev)
        wal = None
        start = 0
    elif backend == "disk":
        if work_dir is None:
            raise ValueError("disk backend requires work_dir")
        work_dir = Path(work_dir)
        work_dir.mkdir(parents=True, exist_ok=True)
        plan = f"ooc,m={m},fusion={use_fusion},steps={len(steps)}"
        wal = WAL(work_dir / "wal.json", cd, plan=plan) if use_wal else None
        bufs = {}
        for name in ("a", "b"):
            path = work_dir / f"buf_{name}"
            if (path / "manifest.json").exists():
                bufs[name] = DiskBuffer.open(path)
            else:
                bufs[name] = DiskBuffer(path, n, m)
        start = wal.done_steps if wal else 0
        committed = (wal.committed_buf if wal else None) or "a"
        src, dst = bufs[committed], bufs["a" if committed == "b" else "b"]
    else:
        raise ValueError(f"unknown backend {backend!r}")

    alloc_s = time.perf_counter() - t_alloc
    L = src.stripe_len
    todo = steps[start:]
    slot_len = max((L << len(_group_bits(s, m)) for s in todo), default=L)
    if mesh is None:
        io = StripeIO(dev, cdtype, slot_len, f32=f32_io)
        ios = {}
    else:
        # One slot a position: a group goes up, runs and comes down
        # before the next.
        io = None
        ios = {s: StripeIO(mesh.device(s), cdtype, slot_len >> d, slots=1)
               for s in mesh.local}
    n_groups = 0
    wait_s = 0.0

    def _written() -> None:
        nonlocal writes
        writes += 1
        if 0 <= crash_after < writes:
            os._exit(1)

    def _drain(i: int, members: list, outs: list) -> None:
        """Wait for slot ``i``'s download, then count (and, on disk,
        write) its member stripes in order."""
        nonlocal wait_s
        t0 = time.perf_counter()
        io.wait(i)
        wait_s += time.perf_counter() - t0
        for s, a in zip(members, outs):
            if backend == "disk":
                dst.write(s, a.numpy())
            _written()

    for step_idx in range(start, len(steps)):
        step = steps[step_idx]
        bits = _group_bits(step, m)
        if mesh is not None:
            ops = [(op, {dv: simulator.prepare_passes([(op, False)], dv,
                                                      fdtype)[0][0]
                         for dv in set(mesh.devices)})
                   for op in _remap_ops_mesh(step, m, bits, d)]
            for members in _groups(n - m, bits):
                outs = ([dst.read(t) for t in members] if backend == "host"
                        else ios[mesh.local[0]].staging(len(members), L))
                _run_group_mesh(mesh, ios, [src.read(t) for t in members],
                                outs, m, m - d + len(bits), ops, plain)
                n_groups += 1
                for t, a in zip(members, outs):
                    if backend == "disk":
                        dst.write(t, a.numpy())
                    _written()
            if wal:
                dst.write_manifest()
                wal.commit_step(step_idx, "a" if dst is bufs["a"] else "b")
            src, dst = dst, src
            continue
        body = simulator.run_passes(simulator.prepare_passes(
            [(op, False) for op in _remap_ops(step, m, bits)], dev, fdtype),
            plain)
        count = L << len(bits)
        groups = list(_groups(n - m, bits))
        prev = None
        for k, members in enumerate(groups):
            i = k % 2
            if k == 0 or not pipeline:
                io.upload(i, [src.read(s) for s in members])
            if pipeline and k + 1 < len(groups):
                # The next group's upload is queued before this group's
                # compute: the host may block inside the compute (a plain
                # gate's small pageable upload syncs the stream), and the
                # copy engines must not wait for it.
                io.upload(1 - i, [src.read(s) for s in groups[k + 1]])
            io.compute_slot(i, count, body)
            outs = ([dst.read(s) for s in members] if backend == "host"
                    else io.staging(len(members), L))
            io.download(i, outs)
            n_groups += 1
            if not pipeline:
                _drain(i, members, outs)
                continue
            if prev is not None:
                _drain(*prev)
            prev = (i, members, outs)
        if prev is not None:
            _drain(*prev)

        if wal:
            dst.write_manifest()
            name = "a" if dst is bufs["a"] else "b"
            wal.commit_step(step_idx, name)
        src, dst = dst, src

    if stats is not None:
        every = [io] if io else list(ios.values())
        stats.update(steps=len(todo), groups=n_groups,
                     bytes_up=sum(x.bytes_up for x in every),
                     bytes_down=sum(x.bytes_down for x in every),
                     pinned=backend == "host" and src.pinned,
                     alloc_s=alloc_s, wait_s=wait_s)
    del io, ios
    if backend == "host":
        out = src.to_array()  # src/dst swapped after last step
        if log2phys is not None:
            from ..circuit.staging import permute_state_inplace

            out = permute_state_inplace(out, log2phys)
        return out
    if log2phys is not None:
        from .wal import atomic_write_json

        atomic_write_json(work_dir / "qubit_mapping.json",
                          {"log2phys": log2phys})
    return work_dir


def collect_state(work_dir, *, apply_permutation: bool = True) -> np.ndarray:
    """Final state of a finished disk-backed run (un-permutes staging)."""
    import json

    work_dir = Path(work_dir)
    rec = json.loads((work_dir / "wal.json").read_text())
    buf = rec["committed_buf"] or "a"
    psi = DiskBuffer.open(work_dir / f"buf_{buf}").to_array()
    mapping_path = work_dir / "qubit_mapping.json"
    if apply_permutation and mapping_path.exists():
        l2p = json.loads(mapping_path.read_text()).get("log2phys")
        if l2p:
            from ..circuit.staging import permute_state_inplace

            psi = permute_state_inplace(psi, l2p)
    return psi
