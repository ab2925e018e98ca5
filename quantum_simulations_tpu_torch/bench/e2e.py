"""End-to-end circuit throughput across families and modes.

Wall time and amplitude-updates/s for GHZ / QFT / non-stabilizer /
Sycamore at a range of n, in window, panel and fused mode, on planar
planes.  There is no compile step: ``first_call_s`` is the build of the
schedule (its operands uploaded) and its first run.
"""
from __future__ import annotations

import json
import time

from . import describe, force, setup_platform, timeit, warm_grant

BUILDERS = {"window": "build_window_circuit_fn",
            "panel": "build_panel_circuit_fn",
            "fused": "build_circuit_fn"}


def run(sizes=(20, 24), families=("ghz", "qft", "nonstab", "sycamore"),
        modes=("window", "panel", "fused"), dtype="complex64",
        reps: int = 3) -> dict:
    from ..circuit import library as lib
    from ..ops import dense
    from ..runtime import simulator
    from ..utils.device import complex_dtype, float_dtype

    dev = setup_platform()
    warm_grant(dev)
    fdtype = float_dtype(complex_dtype(dtype))
    out: dict = {"device": describe(dev), "dtype": dtype, "results": []}
    for n in sizes:
        psi = dense.zero_state_planar(n, fdtype, dev)
        force(*psi)
        for fam in families:
            cd = lib.FAMILIES[fam](n)
            for mode in modes:
                t0 = time.perf_counter()
                fn = getattr(simulator, BUILDERS[mode])(
                    cd, dtype=dtype, planar_io=True, device=dev)
                force(*fn(*psi))
                first_s = time.perf_counter() - t0
                dt = timeit(lambda: force(*fn(*psi)), reps)
                out["results"].append({
                    "family": fam, "n": n, "mode": mode,
                    "gates": len(cd["gates"]),
                    "first_call_s": round(first_s, 4),
                    "wall_s": round(dt, 6),
                    "amp_updates_per_s": round(
                        len(cd["gates"]) * (1 << n) / dt, 1),
                })
    return out


if __name__ == "__main__":
    print(json.dumps(run(), indent=1))
