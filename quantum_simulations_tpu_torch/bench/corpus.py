"""QASMBench cluster-corpus ingestion + differential matrix.

The port of ``quantum_simulations_tpu/bench/corpus.py``: the same
policies, row keys and status strings.  Every corpus file is parsed
through :mod:`circuit.import_qasm` and each circuit is verified against
an independent oracle under a per-size policy, one matrix row per
circuit: ``parsed / verified / skipped`` with method and reason.  The
engine under test runs on the card (``bench.setup_platform``; the CPU
only under ``QST_BENCH_PLATFORM=cpu``), the numpy oracle on the host.
complex128 runs through the kernels' plain twins on the card
(``simulator.plain_route``): the kernels are float32.

Verification policies (all double precision, tol 1e-10):

``e2e``        n <= 20 — full end-to-end c128 differential vs the numpy
               oracle, across the fused AND window tiers (and, for a
               spot subset, the sharded tier on 8 positions sharing the
               card).
``segments``   21 <= n <= 31 — sampled segment restarts: K evenly-spaced
               windows of S gates; both engines start from the same
               random c128 state at the FULL 2^n dimension, so every
               checked gate is a genuine n-qubit c128 check.
``trajectory`` non-unitary circuits (reset / mid-circuit measure / if):
               full oracle-twin trajectory where tractable, else
               segment checks on the unitary runs between boundaries.
               Both engines draw their outcomes from a host
               ``np.random.default_rng(seed)``.
``classical``  X/CX/CCX-only circuits (e.g. adder_n37): the sparse tier
               runs them exactly (basis states, nnz=1) at ANY n and is
               checked against a 20-line classical bit simulator.
``parse_only`` states whose c128 twin exceeds host RAM (n >= 32 dense
               non-classical): recorded with the skip reason.

The corpus is QASMBench's ``cluster/`` tree, named by ``QST_QASMBENCH``
(each circuit as ``<name>/<name>.qasm``).

Usage::

    python -m quantum_simulations_tpu_torch.bench.corpus --tier small
    python -m quantum_simulations_tpu_torch.bench.corpus --tier segments --max-n 28
    python -m quantum_simulations_tpu_torch.bench.corpus --write-manifest \\
        --bench-local BENCH_LOCAL.json --manifest-out manifest.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import time

import numpy as np

from . import setup_platform

# The JAX package's default (its bench/corpus.py), so that one
# QST_QASMBENCH setting, or none, names the same corpus for both packages.
CLUSTER = os.environ.get(
    "QST_QASMBENCH",
    "/root/reference/v3_hisvsim_spark/hisvsim_repo/QASMBench/cluster")

TOL = 1e-10
_CLASSICAL = frozenset({"X", "CNOT", "CCX"})
_CHUNK = 1 << 24  # amplitudes per host-side comparison chunk


def discover() -> list[tuple[str, str]]:
    """(name, path) for every unique .qasm in the corpus tree."""
    out, seen = [], set()
    for root, _dirs, files in os.walk(CLUSTER):
        for f in sorted(files):
            if f.endswith(".qasm") and f[:-5] not in seen:
                seen.add(f[:-5])
                out.append((f[:-5], os.path.join(root, f)))
    return sorted(out)


def parse_one(path: str) -> tuple[dict | None, str, str]:
    """-> (circuit_dict | None, mode, error)."""
    from ..circuit.import_qasm import QasmError, qasm_to_dict

    with open(path) as f:
        src = f.read()
    try:
        return qasm_to_dict(src), "unitary", ""
    except QasmError:
        pass
    try:
        return qasm_to_dict(src, nonunitary="trajectory"), "trajectory", ""
    except QasmError as e:
        return None, "", str(e)


def _policy(name: str, cd: dict, mode: str) -> str:
    n = cd["number_of_qubits"]
    if mode == "trajectory":
        return "trajectory"
    if all(g["gate"] in _CLASSICAL for g in cd["gates"]):
        return "classical"
    if n <= 20:
        return "e2e"
    if n <= 31:
        return "segments"
    return "parse_only"


def _rand_state(n: int, seed: int) -> np.ndarray:
    """Normalized random c128 state with a 1x-state memory peak: the
    interleaved (re, im) float64 view filled in place by a uniform draw
    (a full-support generic state; Haar-ness is not needed for an
    amplitude differential)."""
    rng = np.random.default_rng(seed)
    psi = np.empty(1 << n, np.complex128)
    v = psi.view(np.float64)
    rng.random(out=v)
    v -= 0.5
    psi /= np.linalg.norm(v)
    return psi


def _seg_plan(n_gates: int, n: int, seg_gates: int | None = None,
              k: int | None = None) -> tuple[int, list[int]]:
    """Segment size + evenly-spaced segment indices, scaled so the
    host oracle's c128 cost stays bounded as n grows (K drops to 1 at
    n >= 30).  ``--seg-k`` / ``--seg-gates`` widen coverage; the
    verification METHOD is identical at any K."""
    if seg_gates is None:
        seg_gates = 32 if n <= 26 else (24 if n <= 28 else 12)
    if k is None:
        k = 6 if n <= 26 else (4 if n <= 28 else (2 if n <= 29 else 1))
    n_seg = -(-n_gates // seg_gates)
    if k >= n_seg:
        return seg_gates, list(range(n_seg))
    if k == 1:
        return seg_gates, [n_seg // 2]
    idxs = sorted({round(i * (n_seg - 1) / (k - 1)) for i in range(k)})
    return seg_gates, idxs


class _Split(dict):
    """Seconds of a row by part: ``with split("oracle"): ...`` adds the
    block's wall time to ``split["oracle"]``; given the device, after
    synchronising it (the card's work is asynchronous)."""

    @contextlib.contextmanager
    def __call__(self, key: str, dev=None):
        import torch

        t0 = time.perf_counter()
        yield
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self[key] = self.get(key, 0.0) + time.perf_counter() - t0

    def rounded(self) -> dict:
        return {k: round(v, 3) for k, v in self.items()}


def _max_diff(got: np.ndarray, want: np.ndarray) -> float:
    m = 0.0
    for i in range(0, got.size, _CHUNK):
        m = max(m, float(np.max(np.abs(got[i:i + _CHUNK]
                                       - want[i:i + _CHUNK]))))
    return m


def _verify_e2e(name: str, cd: dict, spot_sharded: bool) -> dict:
    from ..oracle import dense_numpy as oracle
    from ..runtime import simulator

    dev = setup_platform()
    t0 = time.time()
    want = oracle.simulate(cd)
    errs = {}
    for tier in ("pergate", "fused", "window"):
        got = simulator.simulate_np(
            cd, dtype="complex128",
            mode="fused" if tier == "pergate" else tier,
            use_fusion=tier != "pergate",
            panel_width=None if tier == "pergate" else 7, device=dev)
        errs[tier] = float(np.max(np.abs(got - want)))
    if spot_sharded:
        # 8 positions sharing the device (the JAX package asks for 8)
        from ..parallel import executor as E
        from ..parallel import mesh as M

        mesh = M.make_mesh(8, devices=[dev] * 8)
        got = E.collect_state(E.simulate_sharded(mesh, cd, dtype="complex128"))
        errs["sharded8"] = float(np.max(np.abs(got - want)))
    worst = max(errs.values())
    return {"method": "e2e_c128", "tiers": errs, "max_amp_err": worst,
            "status": "verified" if worst < TOL else "FAILED",
            "wall_s": round(time.time() - t0, 2)}


def _mount(path: str) -> tuple[str, str]:
    """(mount point, file system type) of the mount that holds ``path``."""
    path = os.path.realpath(path)
    best = ("/", "")
    with open("/proc/mounts") as f:
        for line in f:
            _dev, mnt, fstype = line.split()[:3]
            if ((path == mnt or path.startswith(mnt.rstrip("/") + "/"))
                    and len(mnt) >= len(best[0])):
                best = (mnt, fstype)
    return best


def _mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) << 10
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def _host_refusal(n: int, big: bool, scratch: str) -> str | None:
    """Why a segment row at n cannot run on this host (None if it can):
    the host holds the oracle's state and, below ``QST_SEG_DISK_MIN``,
    the engine's result beside it; above, the result streams to a
    memmap in ``scratch``, which must have room for it, and which holds
    it in RAM if it is a tmpfs.  A refusal names the numbers, where
    running on would end in the kernel's OOM kill."""
    state = 16 << n
    ram = 2 * state
    if big:
        free = shutil.disk_usage(scratch).free
        mnt, fstype = _mount(scratch)
        if free < state:
            return (f"memmap of {state >> 30} GiB does not fit in {scratch} "
                    f"({fstype} at {mnt}, {free / 2**30:.1f} GiB free)")
        if fstype not in ("tmpfs", "ramfs"):
            ram = state
    avail = _mem_available()
    if avail < ram:
        return (f"host needs {ram >> 30} GiB for the oracle's state"
                f"{' and the result' if ram > state else ''}, "
                f"MemAvailable {avail / 2**30:.1f} GiB")
    return None


def _verify_segments(name: str, cd: dict, seg_gates=None, k=None) -> dict:
    """Each sampled segment: the engine (fused tier, the path users run)
    from a random c128 state on the device, the numpy oracle in place
    (``simulate_lean``: O(MB) temporaries) from the same state
    regenerated on the host, compared chunk by chunk.  From
    ``QST_SEG_DISK_MIN`` qubits (default 31) the engine's result streams
    through a disk memmap under ``QST_SCRATCH`` (by default the temporary
    directory) and the engine runs the segment as sub-programs of
    ``QST_SEG_ENGINE_CHUNK`` gates, so at most one full state is in host
    RAM at a time.  A host without room for that (:func:`_host_refusal`)
    skips the row with the reason."""
    import tempfile

    import torch

    from ..oracle import dense_numpy as oracle
    from ..runtime import simulator

    dev = setup_platform()
    n, gates = cd["number_of_qubits"], cd["gates"]
    seg_gates, idxs = _seg_plan(len(gates), n, seg_gates, k)
    t0, worst = time.time(), 0.0
    big = n >= int(os.environ.get("QST_SEG_DISK_MIN", "31"))
    refusal = _host_refusal(n, big, os.environ.get("QST_SCRATCH")
                            or tempfile.gettempdir())
    if refusal is not None:
        return {"method": f"segment_restart_c128[{seg_gates}]_fusedtier",
                "status": "skipped", "reason": refusal,
                "wall_s": round(time.time() - t0, 2)}
    split = _Split()
    for s in idxs:
        seg = gates[s * seg_gates:(s + 1) * seg_gates]
        sub = {"number_of_qubits": n, "gates": seg}
        with split("draws"):
            host = _rand_state(n, 1000 + s)
        with split("upload", dev):
            box = [torch.from_numpy(host).to(dev)]
        del host
        # No name holds the input: donate_input drops the call's
        # reference once the planes are built (torch has no donation).
        with split("engine", dev):
            g = simulator.simulate(
                sub, dtype="complex128", use_fusion=True, panel_width=7,
                mode="fused", initial_state=box.pop(), donate_input=True,
                segment_gates=(int(os.environ.get("QST_SEG_ENGINE_CHUNK", "4"))
                               if big else None),
                device=dev)
        with split("download"):
            if big:
                tmp = tempfile.NamedTemporaryFile(  # by default under TMPDIR
                    dir=os.environ.get("QST_SCRATCH"), delete=False)
                tmp.close()
                got = np.memmap(tmp.name, dtype=np.complex128, mode="w+",
                                shape=(1 << n,))
                for i in range(0, 1 << n, _CHUNK):
                    got[i:i + _CHUNK] = g[i:i + _CHUNK].cpu().numpy()
                got.flush()
            else:
                got = g.cpu().numpy()
        del g
        with split("draws"):
            psi0 = _rand_state(n, 1000 + s)
        with split("oracle"):
            want = oracle.simulate_lean(sub, initial_state=psi0)  # aliases
        with split("compare"):
            worst = max(worst, _max_diff(got, want))
        del got, want, psi0
        if big:
            os.unlink(tmp.name)
    n_seg = -(-len(gates) // seg_gates)
    return {"method": f"segment_restart_c128[{seg_gates}]_fusedtier",
            "segments_checked": idxs, "segments_total": n_seg,
            "gates_checked": min(len(gates), len(idxs) * seg_gates),
            "max_amp_err": worst,
            "status": "verified" if worst < TOL else "FAILED",
            "wall_s": round(time.time() - t0, 2), "split_s": split.rounded()}


def _verify_trajectory(name: str, cd: dict, full_n_max: int | None = None,
                       seeds=(0, 1)) -> dict:
    """Full oracle-twin trajectory when 2^n c128 twins fit comfortably
    (``QST_TRAJ_FULL_NMAX``, default 28, and at most 400 gates);
    otherwise segment checks on the unitary runs between boundaries.
    The outcomes and registers must equal the oracle's: both draw from a
    host ``np.random.default_rng(seed)``."""
    if full_n_max is None:
        full_n_max = int(os.environ.get("QST_TRAJ_FULL_NMAX", "28"))
    from ..oracle import dense_numpy as oracle
    from ..runtime import trajectory as T

    n, gates = cd["number_of_qubits"], cd["gates"]
    t0 = time.time()
    if n <= full_n_max and len(gates) <= 400:
        dev = setup_platform()
        worst, split = 0.0, _Split()
        for seed in seeds:
            with split("engine", dev):
                psi, cregs, outs = T.simulate_trajectory(
                    cd, seed=seed, dtype="complex128",
                    use_fusion=True, panel_width=7, device=dev)
            with split("oracle"):
                want, cregs_o, outs_o = oracle.simulate_trajectory(cd, seed=seed)
            if outs != outs_o or cregs != cregs_o:
                return {"method": "trajectory_twin_c128",
                        "status": "FAILED",
                        "detail": "outcome/creg divergence",
                        "wall_s": round(time.time() - t0, 2)}
            with split("download"):
                got = psi.cpu().numpy()
            with split("compare"):
                worst = max(worst, float(np.max(np.abs(got - want))))
            del psi, got, want
        return {"method": "trajectory_twin_c128", "seeds": list(seeds),
                "boundaries": sum(g["gate"] in ("RESET", "MEASURE")
                                  for g in gates),
                "max_amp_err": worst,
                "status": "verified" if worst < TOL else "FAILED",
                "wall_s": round(time.time() - t0, 2), "split_s": split.rounded()}
    if n >= 32:
        return {"method": "parse_only", "status": "skipped",
                "reason": f"c128 twin needs {3 * 16 * (1 << n) >> 30} GiB "
                          "host RAM (>125); trajectory-runnable at c64 "
                          "via spill tier",
                "wall_s": round(time.time() - t0, 2)}
    # unitary-run segment checks: the gates between boundaries are
    # ordinary unitaries — sample segments from the longest runs.
    runs = [r for r, _b in T.split_segments(cd["gates"]) if len(r) >= 4]
    runs.sort(key=len, reverse=True)
    sub_gates = [dict(g) for r in runs[:3] for g in r]
    for g in sub_gates:
        g.pop("cond", None)
    res = _verify_segments(name, {"number_of_qubits": n,
                                  "gates": sub_gates})
    res["method"] = "unitary_runs_" + res["method"]
    res["note"] = (f"{len(runs)} unitary runs between "
                   "reset/measure boundaries; longest 3 sampled")
    return res


def _classical_oracle(cd: dict) -> int:
    """Bit-level simulator for X/CX/CCX circuits on |0...0>."""
    bits = 0
    for g in cd["gates"]:
        q = g["qubits"]
        if g["gate"] == "X":
            bits ^= 1 << q[0]
        elif g["gate"] == "CNOT":
            if bits >> q[0] & 1:
                bits ^= 1 << q[1]
        elif g["gate"] == "CCX":
            if (bits >> q[0] & 1) and (bits >> q[1] & 1):
                bits ^= 1 << q[2]
        else:  # pragma: no cover
            raise ValueError(g["gate"])
    return bits


def _verify_classical(name: str, cd: dict) -> dict:
    from ..sparse.engine import simulate_sparse

    t0 = time.time()
    st = simulate_sparse(cd, device=setup_platform())
    want = _classical_oracle(cd)
    items = list(st.items())
    ok = (len(items) == 1 and int(items[0][0]) == want
          and abs(complex(items[0][1]) - 1.0) < TOL)
    return {"method": "sparse_exact_vs_classical_oracle",
            "basis_state": hex(want), "nnz": len(items),
            "status": "verified" if ok else "FAILED",
            "wall_s": round(time.time() - t0, 2)}


def verify_one(name: str, path: str, *, spot_sharded: bool = False,
               seg_gates=None, seg_k=None, parsed=None) -> dict:
    cd, mode, err = parsed if parsed is not None else parse_one(path)
    row = {"circuit": name}
    if cd is None:
        row.update(status="PARSE_FAIL", error=err)
        return row
    row.update(n=cd["number_of_qubits"], gates=len(cd["gates"]), mode=mode)
    pol = _policy(name, cd, mode)
    try:
        if pol == "e2e":
            row.update(_verify_e2e(name, cd, spot_sharded))
        elif pol == "segments":
            row.update(_verify_segments(name, cd, seg_gates, seg_k))
        elif pol == "trajectory":
            row.update(_verify_trajectory(name, cd))
        elif pol == "classical":
            row.update(_verify_classical(name, cd))
        else:
            row.update(
                method="parse_only", status="skipped",
                reason=f"c128 twin needs {3 * 16 * (1 << row['n']) >> 30} "
                       "GiB host RAM (>125); runnable at c64 via spill "
                       "tier")
    except MemoryError:
        row.update(status="skipped", reason="MemoryError on dev host")
    return row


def run(tier: str = "small", max_n: int | None = None,
        names: list[str] | None = None, spot_sharded_for=("cc_n18",),
        out_path: str | None = None, seg_gates: int | None = None,
        seg_k: int | None = None) -> dict:
    """tier: small (n<=20 + classical), segments (the 21..31 set),
    trajectory, all."""
    setup_platform()  # no card and no QST_BENCH_PLATFORM=cpu: raise first
    rows = []
    for name, path in discover():
        if names is not None and name not in names:
            continue
        cd, mode, err = parse_one(path)
        if cd is None:
            rows.append({"circuit": name, "status": "PARSE_FAIL",
                         "error": err})
            continue
        n = cd["number_of_qubits"]
        pol = _policy(name, cd, mode)
        want = (tier == "all"
                or (tier == "small" and pol in ("e2e", "classical"))
                or (tier == "segments" and pol == "segments")
                or (tier == "trajectory" and pol == "trajectory"))
        if names is not None:
            want = name in names
        if not want:
            continue
        if max_n is not None and n > max_n:
            rows.append({"circuit": name, "n": n, "gates": len(cd["gates"]),
                         "mode": mode, "status": "skipped",
                         "reason": f"--max-n {max_n}"})
            continue
        row = verify_one(name, path, spot_sharded=name in spot_sharded_for,
                         seg_gates=seg_gates, seg_k=seg_k,
                         parsed=(cd, mode, err))
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out_path:  # incremental: survive interruption
            with open(out_path, "w") as f:
                json.dump({"rows": rows}, f, indent=1)

    summary = {
        "corpus": CLUSTER, "total_files": len(discover()),
        "checked": len(rows),
        "verified": sum(str(r.get("status")).startswith("verified")
                        for r in rows),
        "failed": sum("FAIL" in str(r.get("status")) for r in rows),
        "skipped": sum(r.get("status") == "skipped" for r in rows),
        "rows": rows,
    }
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    return summary


def write_manifest(bench_local_path: str, out_path: str) -> dict:
    """Freeze a verified corpus matrix (``qasmbench_corpus`` of the JSON
    at ``bench_local_path``) as a manifest at ``out_path``: per circuit
    the method, status and an error BOUND (the observed max_amp_err
    rounded up a decade, then one more for re-run seed slack, capped at
    TOL), so a regression that degrades a 1e-14 circuit to 1e-11 fails
    its guard although 1e-11 < TOL.  Reads and writes only those two
    paths."""
    with open(bench_local_path) as f:
        d = json.load(f)
    rows = d["qasmbench_corpus"]["rows"]
    man = {}
    for r in sorted(rows, key=lambda r: r["circuit"]):
        e = {"n": r.get("n"), "gates": r.get("gates"),
             "method": r.get("method"), "status": r.get("status")}
        err = r.get("max_amp_err",
                    r.get("max_amp_err_vs_exact_lightcone"))
        if isinstance(err, float):
            e["max_amp_err"] = err
            e["max_amp_err_bound"] = min(
                TOL, 10.0 ** (np.ceil(np.log10(max(err, 1e-17))) + 1))
        if r.get("status") == "skipped":
            e["reason"] = r.get("reason")
        man[r["circuit"]] = e
    out = {"tol": TOL, "circuits": man,
           # "verified_c64" (the n=33 spill/lightcone rows) counts as
           # verified — same convention as bench/corpus33.py.
           "verified": sum(str(v["status"]).startswith("verified")
                           for v in man.values()),
           "skipped": sum(v["status"] == "skipped" for v in man.values())}
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    print(f"manifest: {out['verified']} verified / {out['skipped']} "
          f"skipped -> {out_path}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m quantum_simulations_tpu_torch.bench.corpus")
    ap.add_argument("--tier", default="small",
                    choices=["small", "segments", "trajectory", "all"])
    ap.add_argument("--max-n", type=int, default=None)
    ap.add_argument("--names", default=None,
                    help="comma-separated circuit names (overrides tier)")
    ap.add_argument("--out", default=None, help="incremental JSON path")
    ap.add_argument("--seg-gates", type=int, default=None,
                    help="override segment size (default: size policy)")
    ap.add_argument("--seg-k", type=int, default=None,
                    help="override number of sampled segments")
    ap.add_argument("--write-manifest", action="store_true",
                    help="freeze --bench-local's qasmbench_corpus rows "
                         "as --manifest-out")
    ap.add_argument("--bench-local", default=None,
                    help="the JSON whose qasmbench_corpus rows to freeze")
    ap.add_argument("--manifest-out", default=None,
                    help="where --write-manifest writes")
    a = ap.parse_args(argv)
    if a.write_manifest:
        if not (a.bench_local and a.manifest_out):
            ap.error("--write-manifest needs --bench-local and --manifest-out")
        write_manifest(a.bench_local, a.manifest_out)
        return 0
    res = run(tier=a.tier, max_n=a.max_n,
              names=a.names.split(",") if a.names else None,
              out_path=a.out, seg_gates=a.seg_gates, seg_k=a.seg_k)
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
