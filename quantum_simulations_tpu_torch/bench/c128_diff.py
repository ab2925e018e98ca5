"""complex128 differential against the numpy oracle at large n.

The dual-oracle matrix (``bench/matrix.py``) checks every tier at 1e-10
at small n; this probe pushes the same double-precision differential to
larger n, gate for gate against the independent numpy oracle
(``oracle/dense_numpy.py``): end to end at each size in ``sizes``, and,
with ``segmented_n``, as a segmented differential: K circuit segments,
each applied by both engines to the same random-state restart, so every
gate of a large circuit is checked in complex128 without either engine
drifting.  complex128 runs through the kernels' plain twins
(``simulator.plain_route``), on the card too; the oracle runs on the
host's cores, which bounds the sizes.

    python -m quantum_simulations_tpu_torch.bench.c128_diff \
        --sizes 22,24 --families qft,nonstab

Prints one JSON line per (family, n) with max |amp diff| and norm
error, then a summary verdict against the 1e-10 bar (the last line).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from . import describe, setup_platform


def _rand_state(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return (psi / np.linalg.norm(psi)).astype(np.complex128)


def run(sizes=(22, 24), families=("qft", "nonstab"),
        segmented_n: int | None = None, segment_gates: int = 64,
        max_segments: int | None = None, seed: int = 7) -> dict:
    from ..circuit import library as lib
    from ..oracle import dense_numpy as oracle
    from ..runtime import simulator

    dev = setup_platform()

    def engine(cd, initial_state=None) -> np.ndarray:
        return simulator.simulate(cd, dtype="complex128",
                                  initial_state=initial_state,
                                  device=dev).cpu().numpy()

    rows = []
    for fam in families:
        build = lib.FAMILIES[fam]
        for n in sizes:
            cd = build(n)
            t0 = time.perf_counter()
            got = engine(cd)
            t_fw = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = oracle.simulate(cd)
            t_or = time.perf_counter() - t0
            row = {
                "family": fam, "n": int(cd["number_of_qubits"]),
                "gates": len(cd["gates"]),
                "max_amp_err": float(np.max(np.abs(got - want))),
                "norm2_err": float(abs(np.vdot(got, got).real - 1.0)),
                "framework_s": round(t_fw, 4), "oracle_s": round(t_or, 4),
                "mode": "end_to_end",
            }
            rows.append(row)
            print(json.dumps(row), flush=True)

    # Segmented differential: restart both engines from the same random
    # state every `segment_gates` gates.  ``max_segments`` checks that
    # many evenly spaced segments instead of all of them; the row records
    # which were checked.
    if segmented_n is not None:
        for fam in families:
            cd = lib.FAMILIES[fam](segmented_n)
            gates = cd["gates"]
            worst = 0.0
            n_seg = -(-len(gates) // segment_gates)
            if max_segments is not None and max_segments < n_seg:
                idxs = [round(i * (n_seg - 1) / (max_segments - 1))
                        for i in range(max_segments)] if max_segments > 1 \
                    else [0]
                idxs = sorted(set(idxs))
            else:
                idxs = list(range(n_seg))
            t0 = time.perf_counter()
            for s in idxs:
                seg = gates[s * segment_gates:(s + 1) * segment_gates]
                sub = {"number_of_qubits": segmented_n, "gates": seg}
                psi0 = _rand_state(segmented_n, seed + s)
                got = engine(sub, psi0)
                want = oracle.simulate(sub, initial_state=psi0)
                err = float(np.max(np.abs(got - want)))
                worst = max(worst, err)
                print(json.dumps({"family": fam, "n": segmented_n,
                                  "segment": s, "segments": n_seg,
                                  "gates": len(seg),
                                  "max_amp_err": err}), flush=True)
            rows.append({
                "family": fam, "n": segmented_n, "gates": len(gates),
                "segments": n_seg, "segments_checked": idxs,
                "max_amp_err": worst,
                "framework_s": round(time.perf_counter() - t0, 4),
                "mode": f"segmented_restart[{segment_gates}]",
            })
            print(json.dumps(rows[-1]), flush=True)

    worst = max(r["max_amp_err"] for r in rows)
    out = {"device": describe(dev), "rows": rows, "worst_amp_err": worst,
           "tol": 1e-10, "met": bool(worst < 1e-10)}
    print(json.dumps({"worst_amp_err": worst, "met": out["met"],
                      "device": out["device"]}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m quantum_simulations_tpu_torch.bench.c128_diff")
    ap.add_argument("--sizes", default="22,24")
    ap.add_argument("--families", default="qft,nonstab")
    ap.add_argument("--segmented-n", type=int, default=None)
    ap.add_argument("--segment-gates", type=int, default=64)
    ap.add_argument("--max-segments", type=int, default=None)
    a = ap.parse_args(argv)
    sizes = tuple(int(s) for s in a.sizes.split(",") if s)
    out = run(sizes=sizes, families=tuple(a.families.split(",")),
              segmented_n=a.segmented_n, segment_gates=a.segment_gates,
              max_segments=a.max_segments)
    return 0 if out["met"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
