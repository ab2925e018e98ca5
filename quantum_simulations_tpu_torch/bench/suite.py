"""Correctness + performance matrix over the circuit library.

Every family in the library at several sizes, the engine's output
checked against the complex128 numpy oracle (max |amplitude error| and
phase-invariant overlap), wall time recorded.  When qiskit is installed
the external-oracle overlap is checked too.  complex128 runs through the
kernels' plain twins (``simulator.plain_route``), on the card too.
"""
from __future__ import annotations

import json
import time

import numpy as np

from . import describe, setup_platform


def run(sizes=(6, 10, 14), dtype="complex64", mode="panel") -> dict:
    from ..circuit import library as lib
    from ..circuit.import_qiskit import HAVE_QISKIT, overlap_with_qiskit
    from ..oracle import dense_numpy as oracle
    from ..runtime import simulator

    dev = setup_platform()
    tol = 1e-10 if dtype == "complex128" else 1e-4

    rows = []
    for fam, build in lib.FAMILIES.items():
        for n in sizes:
            try:
                cd = build(n)
            except Exception as e:  # family not defined at this n
                rows.append({"family": fam, "n": n, "status": f"skip: {e}"})
                continue
            t0 = time.perf_counter()
            got = simulator.simulate(cd, dtype=dtype, mode=mode,
                                     device=dev).cpu().numpy()
            wall = time.perf_counter() - t0
            want = oracle.simulate(cd)
            err = float(np.max(np.abs(got - want)))
            overlap = float(abs(np.vdot(want, got)))
            row = {
                "family": fam, "n": n, "gates": len(cd["gates"]),
                "wall_s": round(wall, 6), "max_err": err,
                "overlap": round(overlap, 12),
                "status": "ok" if err < tol else "MISMATCH",
            }
            if HAVE_QISKIT:
                row["qiskit_overlap"] = overlap_with_qiskit(cd, got)
            rows.append(row)
    n_bad = sum(1 for r in rows if r.get("status") == "MISMATCH")
    return {"device": describe(dev), "rows": rows, "n_mismatch": n_bad}


if __name__ == "__main__":
    out = run()
    print(json.dumps(out, indent=1))
    raise SystemExit(1 if out["n_mismatch"] else 0)
