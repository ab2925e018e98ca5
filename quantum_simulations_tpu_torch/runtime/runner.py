"""Fault-tolerant circuit runner: sharded execution + WAL + checkpoints
(port of ``quantum_simulations_tpu/runtime/runner.py``).

The state lives on the mesh (``parallel/mesh.py``; one position by
default); after each committed step the runner snapshots it to an
alternating pair of host-side buffer files (a/b double buffer, atomic
writes), then commits the step to the WAL.  A crash at any point loses at
most the uncommitted step; resume re-loads the last committed buffer and
continues.  Crash injection for tests: ``QST_CRASH_AFTER_STEP`` (the
process hard-kills itself after writing step N's buffer but before the
WAL commit, the worst spot) and ``QST_CRASH_MID_CHECKPOINT`` (it dies with
the buffer half written).

The work dir is the reference's, file for file: ``wal.json``,
``manifest.json``, ``qubit_mapping.json``, ``metadata.sqlite``,
``events.jsonl`` and the buffers ``state_{a,b}.npy`` (a complex vector
in fused mode, (2, 2^n) float planes in window and capacity mode, the
bytes ``np.save`` writes), so each package's :func:`collect_state` reads
the other's work dir.  A checkpoint copies the shards into pinned host
memory (``utils/transfer.pinned_empty``), then streams the ``.npy`` to
disk in pieces while hashing them (sha256, recorded in the metadata
ledger and checked on resume), then fsyncs and renames.  On a mesh over
several processes rank 0 gathers the shards and writes every file; every
rank reads the committed buffer on resume (the work dir is shared).
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..circuit.contract import circuit_hash, validate_circuit_dict
from ..parallel import executor as E
from ..parallel import mesh as M
from ..utils import timing
from ..utils.device import complex_dtype, float_dtype
from ..utils.logging import EventLog, get_logger
from .wal import WAL, FencingLock, atomic_write_json

CRASH_ENV = "QST_CRASH_AFTER_STEP"
# Crash MID checkpoint write: a partial .tmp is left behind, the
# destination buffer keeps its previous (older) content, nothing was
# renamed or committed.  Recovery must ignore the garbage tmp and
# resume from the last committed buffer.
CRASH_MID_ENV = "QST_CRASH_MID_CHECKPOINT"
# Bytes hashed and written at a time.
WRITE_CHUNK = 64 << 20

log = get_logger("runner")


def _buf_path(work_dir: Path, name: str) -> Path:
    return work_dir / f"state_{name}.npy"


def save_npy(path: Path, arr: np.ndarray) -> str:
    """Write ``arr`` as ``np.save`` does, atomically (tmp + fsync +
    rename); returns the sha256 hex digest of the bytes, computed on a
    second thread while they are written (both release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    tmp = path.with_name(path.name + ".tmp")
    header = _npy_header(arr)
    flat = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    pieces = [flat[lo:lo + WRITE_CHUNK] for lo in range(0, len(flat), WRITE_CHUNK)]
    sha = hashlib.sha256(header)

    def digest():
        for piece in pieces:
            sha.update(piece)

    with ThreadPoolExecutor(1) as pool:
        hashed = pool.submit(digest)
        with open(tmp, "wb") as f:
            f.write(header)
            for piece in pieces:
                f.write(piece)
            f.flush()
            os.fsync(f.fileno())
        hashed.result()
    os.replace(tmp, path)
    return sha.hexdigest()


def _npy_header(arr: np.ndarray) -> bytes:
    import io

    from numpy.lib import format as npf

    bio = io.BytesIO()
    npf.write_array_header_1_0(bio, npf.header_data_from_array_1_0(arr))
    return bio.getvalue()


def _save_state(work_dir: Path, name: str, state, planar: bool):
    """Write a state buffer; returns (sha256 hex digest, bytes) on rank 0,
    (None, 0) on the others."""
    host = E.gather_planes(state) if planar else E.collect_state(state)
    if host is None:
        return None, 0
    return save_npy(_buf_path(work_dir, name), host), host.nbytes


def _load_state(work_dir: Path, name: str,
                want_sha: str | None = None) -> np.ndarray:
    """A checkpoint buffer, its bytes read once: checked against the
    recorded sha256 (when there is one), then parsed."""
    import io

    blob = _buf_path(work_dir, name).read_bytes()
    if want_sha:
        got = hashlib.sha256(blob).hexdigest()
        if got != want_sha:
            raise RuntimeError(
                f"checkpoint buffer {name!r} corrupt: sha256 {got[:12]}... != "
                f"recorded {want_sha[:12]}..."
            )
    return np.load(io.BytesIO(blob), allow_pickle=False)


def run(
    circuit_dict: dict,
    work_dir,
    *,
    mesh=None,
    dtype="complex64",
    mode: str = "fused",
    use_wal: bool = True,
    use_fencing: bool = False,
    use_fusion: bool = True,
    panel_width: int | None = 7,
    use_staging: bool = False,
    staging_method: str = "auto",
    checkpoint_every: int = 1,
    max_levels_per_step: int | None = None,
    resume: bool = True,
    event_log: str | None = None,
    device="cuda",
    stats: dict | None = None,
) -> Path:
    """Run a circuit with durability; returns the work dir.

    The final state is in the buffer named by the WAL's
    ``committed_buf`` (read it back with :func:`collect_state`, which
    also undoes the staging qubit permutation when staging was used).
    ``mesh`` defaults to one position on ``device``.

    ``mode`` selects the kernels under the WAL, as the reference's:

    * ``'fused'``    the fused mode's kernels; complex checkpoints;
    * ``'window'``   the window schedule's kernels; the state stays
      planar between steps and checkpoints are written from the planes;
    * ``'capacity'`` the window kernels' in-place instances (the
      single-copy tier) under the same durability.

    ``max_levels_per_step`` bounds how many circuit levels one durable
    step may absorb (one device folds a whole circuit into one step
    otherwise, and ``checkpoint_every`` would see one step).
    ``staging_method='auto'`` takes the mesh-aware portfolio
    (``staging.choose_staging``) and keeps the staged circuit only where
    it cuts the weighted exchange bytes.

    ``stats``, when given, gets ``steps`` (run here), ``resume_s`` (host
    seconds reading, checking and uploading the committed buffer),
    ``checkpoints``, ``checkpoint_s`` (host seconds writing them, the copy
    to the host included) and ``checkpoint_bytes`` (what rank 0 wrote).
    """
    cd = validate_circuit_dict(circuit_dict)
    work_dir = Path(work_dir)
    work_dir.mkdir(parents=True, exist_ok=True)
    if mesh is None:
        mesh = M.make_mesh(1, device=device)

    log2phys = None
    if use_staging and mesh.size > 1:
        from ..circuit import staging as S
        from ..parallel.distributed import device_bit_costs

        n = cd["number_of_qubits"]
        k = M.shard_width(mesh, n)
        bit_costs = device_bit_costs(mesh)
        if staging_method == "auto":
            cd, log2phys, _ = S.choose_staging(cd, k, bit_costs=bit_costs)
        else:
            cd, log2phys, _ = S.stage_circuit(
                cd, k, staging_method, bit_costs=bit_costs)
        if log2phys == list(range(n)):
            log2phys = None
    if mesh.rank == 0:
        atomic_write_json(work_dir / "qubit_mapping.json", {
            "log2phys": log2phys if log2phys else None,
        })

    lock = FencingLock(work_dir) if use_fencing else None
    if lock:
        lock.acquire()
    try:
        return _run_inner(
            cd, work_dir, mesh, dtype, mode, use_wal, use_fusion,
            panel_width, checkpoint_every, resume, event_log,
            max_levels_per_step, stats if stats is not None else {},
        )
    finally:
        if lock:
            lock.release()


def _sync(mesh) -> None:
    if any(d.type == "cuda" for d in mesh.devices):
        torch.cuda.synchronize()


def _barrier(mesh) -> None:
    """Every rank of a multi-process mesh waits for the others (rank 0
    writes the work dir's files; the others read them after)."""
    if mesh.world > 1:
        import torch.distributed as dist

        dist.barrier()


def _run_inner(cd, work_dir, mesh, dtype, mode, use_wal, use_fusion,
               panel_width, checkpoint_every, resume, event_log,
               max_levels_per_step, stats):
    from .metadata import MetadataStore

    if mode not in ("fused", "window", "capacity"):
        raise ValueError(f"runner mode must be fused|window|capacity, "
                         f"got {mode!r}")
    planar = mode in ("window", "capacity")
    inplace = mode == "capacity"
    writer = mesh.rank == 0
    fdtype = float_dtype(complex_dtype(dtype))

    events = EventLog(event_log or (work_dir / "events.jsonl"))
    with timing.timer("runner.compile"):
        steps, fns = E.build_circuit_fns(
            mesh, cd, use_fusion=use_fusion, panel_width=panel_width,
            per_step=True, mode="window" if planar else "fused",
            inplace=inplace, dtype=dtype,
            max_levels_per_step=max_levels_per_step,
        )
    n = cd["number_of_qubits"]

    run_id = circuit_hash(cd)[:16]
    meta = MetadataStore(work_dir / "metadata.sqlite") if writer else None
    prior = meta.get_run(run_id) if meta else None
    if meta:
        stale = meta.reconcile(run_id)  # PENDING left by a crash -> FAILED
        if stale:
            log.info("recovery: %d stale PENDING step(s) marked FAILED",
                     len(stale))
            events.emit("recovery", run_id=run_id, failed_steps=stale)
        if prior is None or not resume:
            meta.create_run(run_id, circuit_hash(cd), n, len(cd["gates"]),
                            config={"mesh": int(mesh.size), "dtype": str(dtype),
                                    "use_fusion": use_fusion,
                                    "panel_width": panel_width})
        events.emit("run_start", run_id=run_id, n_qubits=n,
                    n_steps=len(steps), mesh=int(mesh.size),
                    resumed=bool(prior and resume))

    plan_sig = (
        f"mesh={mesh.size},mode={mode},fusion={use_fusion},"
        f"panel={panel_width},steps={len(steps)}"
    )
    wal = None
    if use_wal and writer:
        wal = WAL(work_dir / "wal.json", cd, plan=plan_sig)
        if not resume:
            wal.done_steps = 0
            wal.committed_buf = None
            wal._flush()
    _barrier(mesh)
    if use_wal and not writer:
        wal = WAL(work_dir / "wal.json", cd, plan=plan_sig)

    stats.update(steps=0, resume_s=0.0, checkpoints=0, checkpoint_s=0.0,
                 checkpoint_bytes=0)
    start_step = wal.done_steps if wal else 0
    if start_step >= len(steps) and wal and wal.committed_buf:
        if meta:
            meta.close()
        return work_dir  # already complete

    if wal and wal.committed_buf and start_step > 0:
        t0 = time.perf_counter()
        ck = meta.latest_checkpoint(run_id) if meta else None
        want_sha = (ck["sha256"] if ck and ck["path"] == wal.committed_buf
                    else None)
        # A complex vector or (2, 2^n) planes: either loads as planes.
        saved = _load_state(work_dir, wal.committed_buf, want_sha)
        state = M.put_state_planar(mesh, saved, fdtype)
        del saved
        _sync(mesh)
        stats["resume_s"] = time.perf_counter() - t0
        cur_buf = wal.committed_buf
    else:
        state = M.zero_state_planar_sharded(mesh, n, fdtype)
        start_step = 0
        cur_buf = "b"  # first write goes to "a"

    crash_after = int(os.environ.get(CRASH_ENV, "-1"))
    crash_mid = int(os.environ.get(CRASH_MID_ENV, "-1"))

    if not steps:  # empty circuit: the zero state is the result
        _save_state(work_dir, "a", state, planar)
        if wal and writer:
            wal.committed_buf = "a"
            wal._flush()
        elif writer:
            atomic_write_json(work_dir / "result.json", {"committed_buf": "a"})
        cur_buf = "a"

    if writer:
        atomic_write_json(work_dir / "manifest.json", {
            "n_qubits": n,
            "dtype": str(np.dtype(dtype)),
            "mode": mode,
            "state_format": "planar" if planar else "complex",
            "n_steps": len(steps),
            "circuit_hash": circuit_hash(cd),
            "mesh_devices": int(mesh.size),
        })

    for step_idx in range(start_step, len(steps)):
        with timing.timer("runner.step"):
            state = fns[step_idx](state)
        last = step_idx == len(steps) - 1
        if not (use_wal or last):
            continue
        if use_wal and not last and (step_idx + 1 - start_step) % checkpoint_every:
            continue
        dst = "a" if cur_buf == "b" else "b"
        if meta:
            meta.wal_pending(run_id, step_idx)
        with timing.timer("runner.sync"):
            _sync(mesh)
        if crash_mid >= 0 and step_idx >= crash_mid:
            # Die with the checkpoint half-written: truncated bytes in
            # the .tmp, no rename, WAL untouched.
            tmp = _buf_path(work_dir, dst).with_name(
                _buf_path(work_dir, dst).name + ".tmp")
            tmp.write_bytes(b"\x93NUMPY<truncated mid-write>")
            os._exit(1)
        t0 = time.perf_counter()
        with timing.timer("runner.checkpoint"):
            sha, nbytes = _save_state(work_dir, dst, state, planar)
        stats["checkpoints"] += 1
        stats["checkpoint_s"] += time.perf_counter() - t0
        stats["checkpoint_bytes"] += nbytes
        if crash_after >= 0 and step_idx >= crash_after:
            os._exit(1)  # crash injection: buffer written, WAL NOT committed
        if wal and writer:
            # Commit possibly several steps at once (checkpoint cadence).
            for s in range(wal.done_steps, step_idx + 1):
                wal.commit_step(s, dst)
        elif wal:
            wal.done_steps, wal.committed_buf = step_idx + 1, dst
        if meta:
            meta.wal_commit(run_id, step_idx, dst)
            meta.add_checkpoint(run_id, step_idx, dst, sha256=sha,
                                size_bytes=_buf_path(work_dir, dst).stat().st_size)
            events.emit("step_commit", run_id=run_id, step=step_idx, buf=dst)
        cur_buf = dst

    snap = timing.snapshot()["timers_s"]
    stats.update(steps=len(steps) - start_step)
    if writer and not use_wal:
        atomic_write_json(work_dir / "result.json", {"committed_buf": cur_buf})
    if meta:
        meta.finish_run(run_id, "DONE")
        meta.close()
        events.emit("run_done", run_id=run_id, metrics=snap)
    _barrier(mesh)
    log.info("run %s done: %d steps", run_id, len(steps))
    return work_dir


def recover(circuit_dict: dict, work_dir, **kw) -> Path:
    """Crash recovery = resume the run (double-buffer makes this safe)."""
    return run(circuit_dict, work_dir, resume=True, **kw)


def collect_state(work_dir, *, apply_permutation: bool = True) -> np.ndarray:
    """Read the final committed state from a finished run's work dir.

    Undoes the staging qubit permutation (recorded in
    qubit_mapping.json) unless ``apply_permutation=False``.
    """
    work_dir = Path(work_dir)
    wal_path = work_dir / "wal.json"
    if wal_path.exists():
        buf = json.loads(wal_path.read_text())["committed_buf"]
    else:
        buf = json.loads((work_dir / "result.json").read_text())["committed_buf"]
    if buf is None:
        raise RuntimeError(
            f"run in {work_dir} has no committed state yet (it crashed "
            f"before its first checkpoint, or is still running) — "
            f"resume it with runner.recover() before collecting")
    psi = np.load(_buf_path(work_dir, buf), allow_pickle=False)
    if psi.ndim == 2:  # planar (window/capacity) checkpoint: (2, 2^n) f32
        # The reference's (psi[0] + 1j * psi[1]).astype(np.complex64).
        psi = E.complex_of(psi, np.complex64)
    mapping_path = work_dir / "qubit_mapping.json"
    if apply_permutation and mapping_path.exists():
        l2p = json.loads(mapping_path.read_text()).get("log2phys")
        if l2p:
            from ..circuit.staging import permute_state

            psi = permute_state(psi, l2p)
    return psi
