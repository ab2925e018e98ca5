"""Per-process entry point of a multi-process sharded run (the port's
counterpart of ``deploy/pod_worker.py``).

Run the SAME command in every process: under torchrun, one process per
card,

    torchrun --nproc-per-node=G -m quantum_simulations_tpu_torch.parallel.pod_worker \\
        circuit.json [--devices D] [--work-dir /shared/run1] [--shots 32]

or, for a rehearsal without torchrun (gloo, the CPU or positions sharing
one card), with ``QST_COORDINATOR`` (``host:port`` or ``file:///path``),
``QST_NUM_PROCESSES`` and ``QST_PROCESS_ID`` set in each process.
``--devices`` is the whole mesh (one position per process by default);
``--work-dir`` runs the WAL runner on a directory every process sees.
Process 0 prints one JSON object: the reference's keys, plus every
shard's sha256 (``shards_sha256``, by position), the kernel launches
summed over the processes (``launches``), the plain torch gate calls
summed over the processes (``dense_gate_calls``), the seconds from the
mesh to the result (``run_s``; ``run_s_by_process``) and the bytes and seconds
of the exchanges (``exchange``: process 0's; ``exchange_by_process``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _load_circuit(path: str) -> dict:
    p = Path(path)
    if p.suffix == ".qasm":
        from ..circuit.import_qasm import load_qasm

        return load_qasm(p)
    return json.loads(p.read_text())


def shard_digests(state) -> dict:
    """sha256 of each shard this process owns (its re plane's bytes, then
    its im plane's), by position: what two runs compare to be equal bit
    for bit without moving their states."""
    import hashlib

    out = {}
    for s, (re, im) in sorted(state.shards.items()):
        h = hashlib.sha256()
        for pl in (re, im):
            h.update(pl.cpu().numpy().tobytes())
        out[s] = h.hexdigest()
    return out


def kernel_launches() -> dict:
    """The kernel launches of this process by key (those not 0)."""
    from ..ops import bitperm_kernels, diag_kernels, pair_kernels, panel_kernels

    return {k: v for m in (panel_kernels, diag_kernels, bitperm_kernels,
                           pair_kernels) for k, v in m.LAUNCHES.items() if v}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("circuit", help="circuit JSON (or .qasm) path")
    ap.add_argument("--devices", type=int, default=None,
                    help="total mesh size (default: one per process)")
    ap.add_argument("--dtype", default="complex64")
    ap.add_argument("--mode", default="fused", choices=["fused", "window"],
                    help="the sharded tier's mode")
    ap.add_argument("--work-dir", default=None,
                    help="shared dir for WAL + checkpoints (durability)")
    ap.add_argument("--shots", type=int, default=0,
                    help="sample bitstrings after the run (on the mesh)")
    ap.add_argument("--device", default="cuda",
                    help="each process's device (default: the card "
                         "LOCAL_RANK; 'cpu' for a gloo rehearsal)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from ..ops import dense, sampling
    from . import comm
    from . import executor as E
    from .distributed import init_distributed, make_pod_mesh

    on_cpu = args.device == "cpu"
    multihost = init_distributed(backend="gloo" if on_cpu else None)
    cd = _load_circuit(args.circuit)
    mesh = make_pod_mesh(args.devices, device=args.device)
    out = {
        "process": mesh.rank,
        "processes": mesh.world,
        "multihost": multihost,
        "mesh_devices": mesh.size,
    }
    comm.reset_counts()
    dense.GATE_CALLS = 0
    t0 = time.perf_counter()
    if args.work_dir:
        from ..runtime.runner import run as run_wal

        run_wal(cd, args.work_dir, mesh=mesh, dtype=args.dtype,
                mode=args.mode, use_fencing=False)
        out["work_dir"] = str(args.work_dir)
    else:
        state = E.simulate_sharded(mesh, cd, dtype=args.dtype, mode=args.mode)
        out["norm2"] = comm.psum(mesh, {s: sampling.norm2_planar(*pl)
                                        for s, pl in state.shards.items()})
        if args.shots:
            bits = sampling.sample_bits_sharded(state, args.shots)
            out["samples"] = bits[:8].tolist()
        out["shards_sha256"] = shard_digests(state)
    out["run_s"] = time.perf_counter() - t0
    out["launches"] = kernel_launches()
    out["dense_gate_calls"] = dense.GATE_CALLS
    out["exchange"] = dict(comm.TRAFFIC)
    if multihost:
        # Every rank's digests, launches and traffic, for process 0.
        recs = [None] * mesh.world
        dist.all_gather_object(recs, out)
        out["shards_sha256"] = {s: h for r in recs
                                for s, h in r.get("shards_sha256", {}).items()}
        out["launches"] = {}
        for r in recs:
            for key, v in r["launches"].items():
                out["launches"][key] = out["launches"].get(key, 0) + v
        out["dense_gate_calls"] = sum(r["dense_gate_calls"] for r in recs)
        out["exchange_by_process"] = [r["exchange"] for r in recs]
        out["run_s_by_process"] = [r["run_s"] for r in recs]
    if mesh.rank == 0:
        print(json.dumps(out, indent=1), flush=True)
    if multihost:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
