"""Frozen external-anchor amplitude fingerprints for corpus circuits.

The port of ``quantum_simulations_tpu/bench/fingerprints.py``.  A THIRD,
independently-written statevector engine (:func:`torch_simulate`: torch
tensor ops on the CPU, an axis-permutation formulation with no code
shared with the numpy oracle's strided-plane updates or the port's
planar kernels) computes each circuit's state ONCE; its norm, top-k
amplitudes and random probe amplitudes are frozen into
``tests/data/corpus_fingerprints.json``, and the port's engine
(:func:`runtime.simulator.simulate_np` on the card, complex128) is held
to the frozen values.  A regression that slipped into both live engines'
shared assumptions would still trip against them.

Build (rewrites the frozen file — only when adding circuits; reads the
corpus named by ``QST_QASMBENCH``):

    python -m quantum_simulations_tpu_torch.bench.fingerprints --build

Verify:

    python -m quantum_simulations_tpu_torch.bench.fingerprints --verify
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from . import setup_platform

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "tests", "data",
    "corpus_fingerprints.json")

#: small corpus members (fast at c128 on one core) + two library builds
CIRCUITS = ["qpe_n9", "adder_n10", "sat_n11", "multiply_n13", "bv_n14",
            "simple", "qf21_n15", "qft_n15", "dnn_n16", "vqe_uccsd_n8",
            "cc_n18"]
TOPK = 12
PROBES = 16
TOL = 1e-10


def torch_simulate(cd: dict) -> np.ndarray:
    """Independent engine: torch on the CPU, axis-permutation formulation.

    State as an n-axis (2,)*n complex128 tensor, axis i = qubit
    (n-1-i); a gate pulls its qubit axes to the front with ``permute``,
    contracts with the gate matrix via ``matmul`` over the flattened
    front block, and permutes back.  No strided planes, no lane
    matmuls, no shared code with the other engines.
    """
    import torch

    from ..circuit import gates as G
    from ..circuit.contract import validate_circuit_dict

    cd = validate_circuit_dict(cd)
    n = cd["number_of_qubits"]
    psi = torch.zeros((2,) * n, dtype=torch.complex128)
    psi.reshape(-1)[0] = 1.0
    for g in cd["gates"]:
        U = torch.tensor(
            np.asarray(G.gate_matrix(g["gate"], g.get("params", {})),
                       dtype=np.complex128))
        qs = g["qubits"]
        m = len(qs)
        axes = [n - 1 - q for q in qs]  # axis of each gate qubit
        rest = [a for a in range(n) if a not in axes]
        perm = axes + rest
        inv = np.argsort(perm).tolist()
        x = psi.permute(perm).reshape(1 << m, -1)
        # gate qubit j is the MOST significant bit of the 2^m block
        # index when j comes first in `axes` — matches gate_matrix's
        # big-endian qubit-order convention.
        x = U @ x
        psi = x.reshape((2,) * n).permute(inv)
    return psi.reshape(-1).numpy()


def _fingerprint(psi: np.ndarray, rng: np.random.Generator) -> dict:
    n = int(np.log2(psi.size))
    probs = np.abs(psi) ** 2
    top = np.argsort(probs)[::-1][:TOPK]
    probes = rng.integers(0, psi.size, size=PROBES)
    return {
        "n": n,
        "norm2": float(probs.sum()),
        "topk": [[int(i), float(psi[i].real), float(psi[i].imag)]
                 for i in top],
        "probes": [[int(i), float(psi[i].real), float(psi[i].imag)]
                   for i in probes],
    }


def build(path: str = DATA) -> dict:
    from .corpus import CLUSTER, parse_one

    out = {"engine": "torch axis-permutation statevector (complex128)",
           "tol": TOL, "circuits": {}}
    for name in CIRCUITS:
        qasm = os.path.join(CLUSTER, name, f"{name}.qasm")
        cd, mode, err = parse_one(qasm)
        assert cd is not None and mode == "unitary", (name, err)
        psi = torch_simulate(cd)
        fp = _fingerprint(psi, np.random.default_rng(42))
        fp["gates"] = len(cd["gates"])
        out["circuits"][name] = fp
        print(f"{name}: n={fp['n']} norm2={fp['norm2']:.12f}", flush=True)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def verify_circuit(name: str, fp: dict, psi: np.ndarray) -> float:
    """Max |amp err| of ``psi`` against a frozen fingerprint."""
    assert abs(float(np.vdot(psi, psi).real) - fp["norm2"]) < 1e-8
    worst = 0.0
    for i, re, im in fp["topk"] + fp["probes"]:
        worst = max(worst, abs(psi[i] - complex(re, im)))
    return worst


def verify(path: str = DATA) -> dict:
    """Run the port's engine (c128, on the card) against every frozen
    fingerprint of ``path``; each circuit read from the corpus."""
    from ..runtime import simulator
    from .corpus import CLUSTER, parse_one

    dev = setup_platform()
    with open(path) as f:
        frozen = json.load(f)
    rows = []
    for name, fp in frozen["circuits"].items():
        cd, _mode, _err = parse_one(
            os.path.join(CLUSTER, name, f"{name}.qasm"))
        psi = simulator.simulate_np(cd, dtype="complex128", device=dev)
        err = verify_circuit(name, fp, psi)
        rows.append({"circuit": name, "max_amp_err": err,
                     "ok": bool(err < TOL)})
        print(json.dumps(rows[-1]), flush=True)
    ok = all(r["ok"] for r in rows)
    print(json.dumps({"all_ok": ok, "circuits": len(rows)}))
    return {"rows": rows, "all_ok": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m quantum_simulations_tpu_torch.bench.fingerprints")
    ap.add_argument("--build", action="store_true")
    ap.add_argument("--verify", action="store_true")
    a = ap.parse_args(argv)
    if a.build:
        build()
    if a.verify or not a.build:
        return 0 if verify()["all_ok"] else 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
