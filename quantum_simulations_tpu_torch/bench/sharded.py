"""Sharded-tier benchmarks: the n = 30 mesh configs, the 16-position
dry run and pod program, and one shard's timing.

Positions are (rank, device) pairs (``parallel/mesh.py``); here all of a
mesh's positions share ``cuda:0`` (or the CPU), so the rows show the
sharded program's results and its exchanges at full shard size, and
their wall times are one card's, not a pod's.

* :func:`run` — ghz30 and sycamore30 (depth 2) on 8 positions, and the
  sycamore14 rows in fused and window mode in complex128 against the
  numpy oracle.  Each row is printed as it finishes.
* :func:`dryrun_mesh` — the five tiers of the sharded program on a mesh
  of ``positions``, each against the oracle: the fused exchange cases,
  window mode with the staged boundary reshard, the in-place capacity
  tier, the runner's crash and resume (two subprocesses), and spill
  across the mesh.
* :func:`run16` — :func:`dryrun_mesh` on 16 positions, then the n = 14
  pod program (:func:`pod14`).

:func:`shard_timing` runs the per-position half of the sharded program
on the card: every step's local window ops over one 2^(n - log2 P) shard
(what each position executes between exchanges), and accounts the
exchange half exactly (``ops/exchange.offset_traffic`` per non-local op
x shard bytes), converted to time at a link rate the caller passes.  The
default rate is the H100 SXM data sheet's NVLink 4, 450 GB/s each way:
a data-sheet figure, not a measurement (the machine has one card).

Run: ``python -m quantum_simulations_tpu_torch.bench.sharded
[n] [ghz|sycamore|oracle]``, ``... sharded mesh16`` or
``... sharded shard_timing [n]``.
"""
from __future__ import annotations

import json
import math
import time

from . import (
    NVLINK_BYTES_PER_S, describe, force, setup_platform, timeit, warm_grant,
)

DRYRUN_TIERS = ("fused_exchange", "window_staged_reshard",
                "capacity_inplace", "wal_crash_resume", "mesh_x_spill")


def _mesh(dev, positions: int):
    from ..parallel.mesh import make_mesh

    return make_mesh(positions, devices=[dev] * positions)


def run(n: int = 30, *, with_window_row: bool = True,
        only: tuple = ()) -> dict:
    """ghz(n) (each pole's error), sycamore_like(n, depth 2) (its norm)
    and sycamore_like(14, depth 4) in fused and window mode in
    complex128 (the largest error against the oracle), on 8 positions of
    the device.  ``only``: a subset of {"ghz", "sycamore", "oracle"}."""
    import numpy as np

    from ..circuit import library as lib
    from ..oracle import dense_numpy as oracle
    from ..parallel import executor as E

    dev = setup_platform()
    warm_grant(dev)
    mesh = _mesh(dev, 8)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    def wanted(tag: str) -> bool:
        return not only or tag in only

    if wanted("ghz"):
        cd = lib.ghz(n)
        t0 = time.perf_counter()
        st = E.simulate_sharded(mesh, cd)
        a0 = complex(float(st.shards[0][0][0]), float(st.shards[0][1][0]))
        last = st.shards[mesh.size - 1]
        aN = complex(float(last[0][-1]), float(last[1][-1]))
        wall = time.perf_counter() - t0
        inv = 1 / math.sqrt(2)
        emit({"config": f"ghz{n}_sharded8", "gates": len(cd["gates"]),
              "wall_s": wall, "amp0_err": abs(a0 - inv),
              "ampN_err": abs(aN - inv), "shard_amplitudes": 1 << st.k})
        del st, last

    if wanted("sycamore"):
        cd = lib.sycamore_like(n, depth=2, seed=11)
        t0 = time.perf_counter()
        st = E.simulate_sharded(mesh, cd)
        norm2 = sum(force(*pl) for pl in st.shards.values())
        wall = time.perf_counter() - t0
        emit({"config": f"sycamore{n}_d2_sharded8",
              "gates": len(cd["gates"]), "wall_s": wall, "norm2": norm2})
        del st

    if wanted("oracle"):
        cd = lib.sycamore_like(14, depth=4, seed=3)
        want = oracle.simulate(cd)
        for mode in ("fused",) + (("window",) if with_window_row else ()):
            t0 = time.perf_counter()
            got = E.collect_state(E.simulate_sharded(
                mesh, cd, dtype="complex128", mode=mode))
            emit({"config": f"sycamore14_d4_sharded8_{mode}",
                  "wall_s": time.perf_counter() - t0,
                  "max_err_vs_oracle": float(np.max(np.abs(got - want)))})

    return {"device": describe(dev), "n_devices": 8, "rows": rows}


# argv: root, work dir, device, positions[, go file: wait for it to exist
# after start-up, before the run]
_CRASH_RUN = (
    "import os, sys, time\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import torch\n"
    "from quantum_simulations_tpu_torch.circuit import library as lib\n"
    "from quantum_simulations_tpu_torch.parallel.mesh import make_mesh\n"
    "from quantum_simulations_tpu_torch.runtime import runner\n"
    "torch.zeros(1, device=sys.argv[3])\n"
    "while len(sys.argv) > 5 and not os.path.exists(sys.argv[5]):\n"
    "    time.sleep(0.02)\n"
    "runner.run(lib.qft(6), sys.argv[2],\n"
    "           mesh=make_mesh(devices=[sys.argv[3]] * int(sys.argv[4])),\n"
    "           mode='window', dtype='complex64')\n")


def dryrun_mesh(positions: int, work_dir=None) -> dict:
    """The sharded program's five tiers on ``positions`` positions of the
    device, each held to the numpy oracle within 1e-4 (complex64); raises
    AssertionError naming the tier that fails.  Returns each tier's
    error.  The runner's crash (``QST_CRASH_AFTER_STEP=1``: exit 1 after
    its first checkpoint) and its resume (exit 0) are subprocesses on one
    work directory under ``work_dir`` (a new temporary directory when
    None), removed after; both start before the first tier, the resume
    held at a go file until the crash has exited."""
    import os
    import shutil
    import subprocess
    import sys
    import tempfile
    from pathlib import Path

    import numpy as np

    from ..circuit import library as lib
    from ..circuit import staging as S
    from ..oracle import dense_numpy as oracle
    from ..parallel import executor as E
    from ..parallel import mesh as M
    from ..parallel.reshard import plan_boundary_reshard
    from ..runtime import runner, spill

    dev = setup_platform()
    mesh = _mesh(dev, positions)
    d = int(math.log2(mesh.size))
    errs = {}

    def hold(tier: str, got, want, norm: bool = True) -> None:
        err = float(np.max(np.abs(got - want.astype(np.complex64))))
        if norm:
            nrm = float(np.vdot(got, got).real)
            assert abs(nrm - 1.0) < 1e-4, f"{tier}: norm {nrm}"
        assert err < 1e-4, f"{tier}: {err} from the oracle"
        errs[tier] = err

    # 4's two processes start first, so that their start-up (interpreter,
    # torch, the device's context) overlaps tiers 1-3: the crash runs at
    # once, the resume waits for its go file until the crash has exited
    root = str(Path(__file__).resolve().parents[2])
    base = Path(tempfile.mkdtemp(prefix="qst_dryrun_") if work_dir is None
                else work_dir)
    wd, go = base / f"wal{positions}", base / f"wal{positions}.go"
    shutil.rmtree(wd, ignore_errors=True)
    go.unlink(missing_ok=True)
    argv = [sys.executable, "-c", _CRASH_RUN, root, str(wd), str(dev),
            str(positions)]
    env = {k: v for k, v in os.environ.items() if k != "QST_CRASH_AFTER_STEP"}
    pipes = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    crash = subprocess.Popen(argv, env=dict(env, QST_CRASH_AFTER_STEP="1"),
                             **pipes)
    resume = subprocess.Popen(argv + [str(go)], env=env, **pipes)
    try:
        # 1. every exchange case across the shard boundary, fused mode
        n = max(6, d + 3)
        gates = [{"qubits": [q], "gate": "H"} for q in range(n)]
        gates += [
            {"qubits": [n - 1], "gate": "T"},                       # device-bit diag
            {"qubits": [0, n - 1], "gate": "CNOT"},                 # target on device bit
            {"qubits": [n - 1, 0], "gate": "CNOT"},                 # control on device bit
            {"qubits": [n - 1], "gate": "H"},                       # 1q butterfly
            {"qubits": [0, n - 1], "gate": "SWAP"},                 # swap across boundary
            {"qubits": [n - 1, n - 2], "gate": "CR", "params": {"k": 2}},
        ]
        if d >= 2:
            gates.append({"qubits": [n - 1, n - 2], "gate": "SWAP"})  # both device bits
        cd = {"number_of_qubits": n, "gates": gates}
        hold("fused_exchange", E.collect_state(E.simulate_sharded(mesh, cd)),
             oracle.simulate(cd))

        # 2. window kernels + staging whose boundary SWAPs are one reshard
        n2 = max(10, d + 7)
        k2 = n2 - d
        g2 = [{"qubits": [q], "gate": "H"} for q in range(n2)]
        for q in range(n2 - 1):
            g2.append({"qubits": [q, q + 1], "gate": "CNOT"})
        for q in range(k2, n2):  # gates on the device-bit qubits
            g2.append({"qubits": [q], "gate": "T"})
            g2.append({"qubits": [q % k2, q], "gate": "SWAP"})
            g2.append({"qubits": [q], "gate": "H"})
        cd2 = {"number_of_qubits": n2, "gates": g2}
        staged, log2phys, _ = S.stage_circuit(cd2, k2, "heuristic")
        steps, _ = E.build_circuit_fns(mesh, staged, mode="window")
        pairs = sum(len(plan_boundary_reshard(s.nonlocal_ops, k2)[0])
                    for s in steps)
        assert pairs > 0, "window_staged_reshard: the plan has no boundary reshard"
        got = S.permute_state(E.collect_state(E.simulate_sharded(
            mesh, staged, mode="window")), log2phys)
        hold("window_staged_reshard", got, oracle.simulate(cd2))

        # 3. the sharded capacity tier: planar, every pass in place
        cd3 = lib.qft(n2)
        _, fn3 = E.build_circuit_fns(mesh, cd3, mode="window", inplace=True)
        hold("capacity_inplace",
             E.collect_state(fn3(M.zero_state_planar_sharded(mesh, n2))),
             oracle.simulate(cd3), norm=False)

        # 4. the runner on the mesh: a real crash, then a resume
        _, err = crash.communicate(timeout=600)
        assert crash.returncode == 1, (f"wal_crash_resume: the crash hook "
                                       f"did not fire (exit "
                                       f"{crash.returncode})\n{err[-2000:]}")
        go.touch()
        _, err = resume.communicate(timeout=600)
        assert resume.returncode == 0, (f"wal_crash_resume: the resume "
                                        f"exited {resume.returncode}\n"
                                        f"{err[-2000:]}")
        hold("wal_crash_resume", runner.collect_state(wd),
             oracle.simulate(lib.qft(6)))
    finally:
        for p in (crash, resume):
            if p.poll() is None:
                p.kill()
                p.wait()
        go.unlink(missing_ok=True)
        shutil.rmtree(base if work_dir is None else wd, ignore_errors=True)

    # 5. host stripes streamed through the mesh
    n5, m5 = d + 5, d + 3  # 2 host bits, d mesh bits, 3 local bits
    g5 = [{"qubits": [q], "gate": "H"} for q in range(n5)]
    g5 += [
        {"qubits": [0, 1], "gate": "CNOT"},            # local
        {"qubits": [2, m5 - 1], "gate": "CNOT"},       # local-device
        {"qubits": [m5 - 1], "gate": "T"},             # device diag
        {"qubits": [n5 - 1, n5 - 2], "gate": "CZ"},    # host-host
        {"qubits": [1, n5 - 1], "gate": "CNOT"},       # local-host
        {"qubits": [m5 - 1, n5 - 1], "gate": "SWAP"},  # device-host
        {"qubits": [0], "gate": "H"},
    ]
    cd5 = {"number_of_qubits": n5, "gates": g5}
    hold("mesh_x_spill", spill.run_out_of_core(
        cd5, stripe_qubits=m5, backend="host", mesh=mesh, use_wal=False,
        device=dev), oracle.simulate(cd5))
    return errs


def pod14(positions: int = 16) -> dict:
    """The 34-qubit pod program's shape at n = 14 on ``positions``
    positions: heuristic staging at k = n - 4, the in-place window body,
    the final state against the oracle (1e-4), then 64 shots from
    ``sample_bits_sharded`` scored against the staged oracle's
    probabilities (none may be impossible)."""
    import numpy as np

    from ..circuit import library as lib
    from ..circuit import staging as S
    from ..oracle import dense_numpy as oracle
    from ..ops.sampling import sample_bits_sharded
    from ..parallel import executor as E
    from ..parallel import mesh as M

    dev = setup_platform()
    n = 14
    mesh = _mesh(dev, positions)
    k = M.shard_width(mesh, n)
    assert k == n - 4, k
    cd = lib.sycamore_like(n, depth=2, seed=5)
    staged, log2phys, stats = S.stage_circuit(cd, k, "heuristic")
    t0 = time.perf_counter()
    _, fn = E.build_circuit_fns(mesh, staged, mode="window", inplace=True)
    got = E.collect_state(fn(M.zero_state_planar_sharded(mesh, n)))
    got = S.permute_state(got, log2phys)
    err = float(np.max(np.abs(got - oracle.simulate(cd).astype(np.complex64))))
    assert err < 1e-4, f"pod14: {err} from the oracle"
    wall = time.perf_counter() - t0

    t0 = time.perf_counter()
    psi = E.simulate_sharded(mesh, staged, mode="window")
    shots = sample_bits_sharded(psi, 64, seed=0).numpy()
    assert shots.shape == (64, n), shots.shape
    p2 = np.abs(oracle.simulate(staged)) ** 2
    idx = (shots.astype(np.int64) << np.arange(n, dtype=np.int64)).sum(1)
    min_p = float(p2[idx].min())
    assert min_p > 1e-12, f"pod14: sampled a state of probability {min_p}"
    return {"config": f"pod34q_program_n14_sharded{positions}_capacity",
            "stages": stats["stages"], "gates": len(cd["gates"]),
            "max_err_vs_oracle": err, "wall_s": wall,
            "sampler_shots": 64, "sampler_min_prob_sampled": min_p,
            "sampler_wall_s": time.perf_counter() - t0}


def run16(work_dir=None) -> dict:
    """16-position rows: :func:`dryrun_mesh` (a fourth device bit and
    reshard groups two bits deeper than on 8) and :func:`pod14`."""
    dev = setup_platform()
    warm_grant(dev)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    t0 = time.perf_counter()
    errs = dryrun_mesh(16, work_dir)
    emit({"config": "dryrun_5tier_sharded16", "ok": True,
          "tiers": list(DRYRUN_TIERS), "max_err": errs,
          "wall_s": time.perf_counter() - t0})
    emit(pod14(16))
    return {"device": describe(dev), "n_devices": 16, "rows": rows}


def shard_timing(n: int = 30, n_devices: int = 8, *, depth: int = 8,
                 reps: int = 3,
                 link_GBs: float = NVLINK_BYTES_PER_S / 1e9) -> dict:
    """Measured per-shard compute of the n-qubit sycamore-like circuit on
    ``n_devices`` positions, on one card, plus the exchange bytes each
    position sends, over ``link_GBs``."""
    import math

    import numpy as np
    import torch

    from ..circuit import library as lib
    from ..circuit.fusion import compile_steps
    from ..circuit.panelize import compile_window_ops
    from ..ops.exchange import offset_traffic
    from ..runtime import simulator

    dev = setup_platform()
    warm_grant(dev)
    d = int(math.log2(n_devices))
    k = n - d
    cd = lib.sycamore_like(n, depth=depth, seed=11)
    steps = compile_steps(cd, k=k)

    terms_only = k >= 10
    win_ops = [
        simulator.prepare_schedule(
            [(op, None) for op in compile_window_ops(
                [(op.qubits, op.U, getattr(op, "name", "panel"))
                 for op in s.local_ops],
                k, diag_terms_only=terms_only)],
            dev, torch.float32)
        for s in steps
    ]

    # The exchange, exactly: bytes each position sends per non-local op.
    shard_bytes = (1 << k) * 8  # complex64
    n_collectives = 0
    exchange_bytes = 0.0
    for s in steps:
        for op in s.nonlocal_ops:
            for _off, frac in offset_traffic(
                    np.asarray(op.U), tuple(op.qubits), k):
                n_collectives += 1
                exchange_bytes += frac * shard_bytes

    gen = torch.Generator(device=dev).manual_seed(0)
    re0 = torch.randn(1 << k, generator=gen, device=dev) * 1e-4
    im0 = torch.zeros(1 << k, device=dev)

    def prog() -> float:
        re, im = re0, im0
        for wops in win_ops:
            for op, dterms in wops:
                re, im = simulator.apply_window_op(re, im, op, dterms)
        return force(re, im)

    shard_s = timeit(prog, reps)
    link_s = exchange_bytes / (link_GBs * 1e9)
    return {
        "device": describe(dev),
        "config": f"sycamore{n}_d{depth}_{n_devices}shards",
        "n": n,
        "n_devices": n_devices,
        "shard_amplitudes": 1 << k,
        "gates": len(cd["gates"]),
        "steps": len(steps),
        "local_window_passes": sum(len(w) for w in win_ops),
        "measured_shard_compute_s": shard_s,
        "collectives": n_collectives,
        "exchange_bytes_per_position": int(exchange_bytes),
        "link_model_GBs": link_GBs,
        "accounted_link_s": link_s,
        "pod_estimate_s": shard_s + link_s,
        "note": ("shard compute measured on the device named; the exchange "
                 "is exact bytes over the link rate given (default: H100 "
                 "SXM data sheet, NVLink 4, 450 GB/s each way; not "
                 "measured: one card)"),
    }


if __name__ == "__main__":
    import sys

    args = sys.argv[1:]
    ns = [int(a) for a in args if a.isdigit()]
    if "shard_timing" in args:
        print(json.dumps(shard_timing(ns[0] if ns else 30), indent=1))
    elif "mesh16" in args:
        words = [a for a in args if a != "mesh16"]
        print(json.dumps(run16(words[0] if words else None), indent=1))
    else:
        only = tuple(a for a in args if not a.isdigit())
        print(json.dumps(run(*(ns or [30]), only=only), indent=1))
