"""Out-of-core streaming throughput (host-DRAM and disk backends).

MB/s of state streamed through the device per applied step, for a
layered workload at a given stripe width, through
``runtime/spill.run_out_of_core`` (the state in pinned host memory, or
in chunk files under a temporary directory).
"""
from __future__ import annotations

import json
import tempfile
import time

from . import describe, setup_platform, warm_grant


def run(n: int = 22, stripe_qubits: int = 18, dtype="complex64") -> dict:
    import numpy as np

    from ..circuit import library as lib
    from ..circuit.fusion import compile_steps
    from ..runtime import spill

    dev = setup_platform()
    warm_grant(dev)
    cd = lib.non_stabilizer(n, depth=2, seed=3)
    state_bytes = (1 << n) * np.dtype(dtype).itemsize
    n_steps = len(compile_steps(cd, k=stripe_qubits))
    rows = []

    st: dict = {}
    t0 = time.perf_counter()
    out = spill.run_out_of_core(cd, stripe_qubits=stripe_qubits,
                                backend="host", dtype=dtype, device=dev,
                                stats=st)
    host_s = time.perf_counter() - t0
    rows.append({
        "backend": "host", "wall_s": round(host_s, 6),
        "MB_per_s": round(state_bytes * n_steps * 2 / host_s / 1e6, 1),
        "norm": float(np.vdot(out, out).real),
        "bytes_up": st["bytes_up"], "bytes_down": st["bytes_down"],
    })

    with tempfile.TemporaryDirectory() as td:
        st = {}
        t0 = time.perf_counter()
        spill.run_out_of_core(cd, stripe_qubits=stripe_qubits,
                              backend="disk", work_dir=td, dtype=dtype,
                              device=dev, stats=st)
        disk_s = time.perf_counter() - t0
        rows.append({
            "backend": "disk", "wall_s": round(disk_s, 6),
            "MB_per_s": round(state_bytes * n_steps * 2 / disk_s / 1e6, 1),
            "bytes_up": st["bytes_up"], "bytes_down": st["bytes_down"],
        })
    return {"n": n, "stripe_qubits": stripe_qubits, "steps": n_steps,
            "device": describe(dev), "rows": rows}


if __name__ == "__main__":
    print(json.dumps(run(), indent=1))
