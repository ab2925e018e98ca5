"""Cross-tier differential correctness x perf matrix (MQT-bench style).

Every circuit family in the library is run through every applicable
execution tier and checked against the complex128 numpy oracle; the
native C++ engine is a fully separate implementation, so this is a
dual-oracle validation (qiskit is used too when installed).

Tiers:
  oracle   numpy complex128 reference (ground truth)
  native   C++/OpenMP host engine (independent implementation)
  fused    the step compiler's panels and gates
  window   the fixed-window schedule
  panel    the rotating-panel schedule
  sharded  8 positions of one device (n >= 10); on the card they share
           cuda:0
  spill    out-of-core host-stripe runner (n <= 18)
  sparse   the COO engine (dense export for comparison)

complex128 (the default, tolerance 1e-10) runs through the kernels'
plain twins on the card too (``simulator.plain_route``); complex64 runs
the kernels, at 1e-4.
"""
from __future__ import annotations

import json
import time

import numpy as np

from . import describe, setup_platform

TOL_C128 = 1e-10
TOL_C64 = 1e-4

# Size caps per tier: spill/sparse are exercised for correctness, not
# capacity, and the sparse engine is dense-workload-hostile by design.
SPARSE_MAX_NNZ = 1 << 18
POSITIONS = 8


def _tiers(n: int, dtype: str, mesh, dev):
    """tier name -> callable(cd) returning a dense numpy state."""
    from ..oracle import native as native_oracle
    from ..parallel import executor as E
    from ..runtime import simulator, spill

    np_dtype = np.complex128 if dtype == "complex128" else np.complex64

    def dense_mode(mode):
        return lambda cd: simulator.simulate(
            cd, dtype=dtype, mode=mode, device=dev).cpu().numpy()

    tiers = {}
    if native_oracle.available():
        tiers["native"] = lambda cd: native_oracle.simulate(
            cd, dtype=np_dtype)
    tiers["fused"] = dense_mode("fused")
    tiers["window"] = dense_mode("window")
    tiers["panel"] = dense_mode("panel")
    if (1 << n) >= POSITIONS * 128:
        tiers["sharded"] = lambda cd: E.collect_state(
            E.simulate_sharded(mesh, cd, dtype=dtype))
    if n <= 18:
        tiers["spill"] = lambda cd: np.asarray(spill.run_out_of_core(
            cd, stripe_qubits=max(n - 2, 4), backend="host", dtype=dtype,
            device=dev))
    return tiers


def _sparse_state(cd, dev):
    from ..sparse.engine import simulate_sparse

    st = simulate_sparse(cd, device=dev)
    if len(st) > SPARSE_MAX_NNZ:
        return None
    return st.to_dense()


def run(sizes=(8, 12, 16), dtype_name="complex128", families=None) -> dict:
    from ..circuit import library as lib
    from ..oracle import dense_numpy as oracle
    from ..parallel.mesh import make_mesh

    dev = setup_platform()
    tol = TOL_C128 if dtype_name == "complex128" else TOL_C64
    mesh = make_mesh(POSITIONS, devices=[dev] * POSITIONS)

    fams = families or list(lib.FAMILIES)
    rows = []
    for fam in fams:
        build = lib.FAMILIES[fam]
        for n in sizes:
            try:
                cd = build(n)
            except Exception as e:  # family not defined at this n
                rows.append({"family": fam, "n": n, "status": f"skip: {e}"})
                continue
            n_actual = cd["number_of_qubits"]  # fixed-size families (bell)
            want = oracle.simulate(cd)
            row = {"family": fam, "n": n_actual, "gates": len(cd["gates"]),
                   "tiers": {}, "status": "ok"}
            for tier, fn in _tiers(n_actual, dtype_name, mesh, dev).items():
                t0 = time.perf_counter()
                got = fn(cd)
                err = float(np.max(np.abs(np.asarray(got) - want)))
                row["tiers"][tier] = {
                    "max_err": err,
                    "wall_s": round(time.perf_counter() - t0, 6),
                }
                if err >= tol:
                    row["status"] = "MISMATCH"
            sp = _sparse_state(cd, dev)
            if sp is not None:
                err = float(np.max(np.abs(sp - want)))
                row["tiers"]["sparse"] = {"max_err": err}
                if err >= tol:
                    row["status"] = "MISMATCH"
            rows.append(row)
    n_bad = sum(1 for r in rows if r["status"] == "MISMATCH")
    return {
        "device": describe(dev),
        "positions": POSITIONS,
        "dtype": dtype_name,
        "tol": tol,
        "rows": rows,
        "n_bad": n_bad,
        "tiers_seen": sorted({t for r in rows for t in r.get("tiers", {})}),
    }


if __name__ == "__main__":
    import sys

    sizes = tuple(int(a) for a in sys.argv[1:]) or (8, 12, 16)
    out = run(sizes=sizes)
    print(json.dumps(out, indent=1))
    raise SystemExit(1 if out["n_bad"] else 0)
