"""The five BASELINE.md workload configs, end to end on the device.

GHZ-20 dense; QFT-26 with CR + fusion; a Sycamore-style random circuit
(n = 26, the single-device stand-in for the 30q mesh config); QAOA
MaxCut with RZZ/RX layers; and the reference's n = 28 non-stabilizer
scaling tier.  Each runs in window mode on planar planes, ``reps``
chained runs closed by one norm fetched to the host.  The 40q
out-of-core config is exercised structurally by ``spill_bw``.

Run: ``python -m quantum_simulations_tpu_torch.bench.baseline_configs [tag ...]``.
"""
from __future__ import annotations

import json
import sys
import time

from . import describe, force, setup_platform, warm_grant


def configs() -> list:
    from ..circuit import library as lib

    return [
        ("ghz20", lib.ghz(20)),
        ("qft26", lib.qft(26)),
        ("sycamore26_d8", lib.sycamore_like(26, depth=8, seed=11)),
        ("qaoa26_p2", lib.qaoa_maxcut(26, p=2)),
        ("nonstab28", lib.non_stabilizer(28, depth=4, seed=7)),
    ]


def _build(build, retries: int):
    """``build()``, attempted up to ``retries`` times: a kernel build
    (``nvcc``) that fails is retried, the last failure raised."""
    for i in range(retries):
        try:
            return build()
        except RuntimeError as e:
            if i == retries - 1:
                raise
            print(f"build attempt {i + 1} failed, retrying: {e}",
                  file=sys.stderr, flush=True)
            time.sleep(2 * (i + 1))


def run(reps: int = 4, retries: int = 3, only: tuple = (),
        stream: bool = False) -> dict:
    import torch

    from ..ops import dense
    from ..runtime import simulator

    dev = setup_platform()
    warm_grant(dev)

    todo = [c for c in configs() if not only or c[0] in only]
    rows = []
    for tag, cd in todo:
        n = cd["number_of_qubits"]
        row = {"config": tag, "n": n, "gates": len(cd["gates"])}
        t0 = time.perf_counter()
        fn = _build(lambda cd=cd: simulator.build_window_circuit_fn(
            cd, dtype="complex64", planar_io=True, device=dev), retries)
        state = dense.zero_state_planar(n, torch.float32, dev)
        state = fn(*state)  # the first run: operands uploaded, kernels loaded
        force(*state)
        row["first_call_s"] = round(time.perf_counter() - t0, 4)

        t0 = time.perf_counter()
        for _ in range(reps):
            state = fn(*state)
        norm = force(*state)
        dt = (time.perf_counter() - t0) / reps
        row.update({
            "steady_s": round(dt, 6),
            "amp_updates_per_s": round(len(cd["gates"]) * (1 << n) / dt, 1),
            "norm2": round(norm, 6),
        })
        del state
        rows.append(row)
        if stream:  # one JSON line per finished config
            print(json.dumps(row), flush=True)
    return {"device": describe(dev), "rows": rows}


if __name__ == "__main__":
    out = run(only=tuple(sys.argv[1:]), stream=True)
    print(json.dumps(out, indent=1))
