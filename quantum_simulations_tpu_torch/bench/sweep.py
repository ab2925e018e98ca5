"""Sweep over execution knobs on one workload: panel mode, and fused
mode with fusion on and off at panel widths None and 7; wall time per
configuration on ``non_stabilizer(n, depth=3, seed=5)``."""
from __future__ import annotations

import json
import time

from . import describe, force, setup_platform, timeit, warm_grant


def run(n: int = 22, dtype="complex64", reps: int = 3) -> dict:
    from ..circuit import library as lib
    from ..ops import dense
    from ..runtime import simulator
    from ..utils.device import complex_dtype, float_dtype

    dev = setup_platform()
    warm_grant(dev)
    cd = lib.non_stabilizer(n, depth=3, seed=5)
    psi = dense.zero_state_planar(n, float_dtype(complex_dtype(dtype)), dev)
    force(*psi)

    rows = []
    configs = (
        [{"mode": "panel"}]
        + [{"mode": "fused", "use_fusion": f, "panel_width": w}
           for f in (True, False) for w in (None, 7)]
    )
    for cfg in configs:
        t0 = time.perf_counter()
        kw = dict(dtype=dtype, planar_io=True, device=dev)
        if cfg["mode"] == "panel":
            fn = simulator.build_panel_circuit_fn(cd, **kw)
        else:
            fn = simulator.build_circuit_fn(
                cd, use_fusion=cfg["use_fusion"],
                panel_width=cfg["panel_width"], **kw)
        force(*fn(*psi))
        first_s = time.perf_counter() - t0
        dt = timeit(lambda: force(*fn(*psi)), reps)
        rows.append({**cfg, "first_call_s": round(first_s, 4),
                     "wall_s": round(dt, 6)})
    return {"n": n, "gates": len(cd["gates"]), "device": describe(dev),
            "rows": rows}


if __name__ == "__main__":
    print(json.dumps(run(), indent=1))
