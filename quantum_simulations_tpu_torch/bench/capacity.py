"""Single-device capacity tier: n >= 29 in place on planar planes.

The window schedule runs with ``inplace=True`` (every pass through a
kernel's aliasing instance) on planes born on the device
(``runtime/capacity.simulate_capacity``): the state is the two float32
planes and nothing of its size beside them.  The peak the caching
allocator held (``torch.cuda.max_memory_allocated``) proves the fit.
Each row also goes to stderr as it finishes.

Run: ``python -m quantum_simulations_tpu_torch.bench.capacity [n ...] [tag ...]``.
"""
from __future__ import annotations

import json
import sys
import time

from . import describe, force, setup_platform, warm_grant

GIB = 1 << 30


def run(ns=(30,), reps: int = 3, only=None) -> dict:
    """``only``: optional subset of config tags (e.g. {"qft30"})."""
    import gc

    import torch

    from ..circuit import library as lib
    from ..runtime import simulator
    from ..runtime.capacity import simulate_capacity

    dev = setup_platform()
    warm_grant(dev)
    cuda = dev.type == "cuda"

    rows = []
    for n in ns:
        todo = [
            (f"ghz{n}", lib.ghz(n), True),
            (f"nonstab{n}", lib.non_stabilizer(n, depth=4, seed=7), False),
            # QFT exercises the remaining in-place op classes: merged diag
            # runs and the bit-reversal as involution passes.
            (f"qft{n}", lib.qft(n), False),
        ]
        for tag, cd, check_amps in (c for c in todo
                                    if not only or c[0] in only):
            row = {"config": tag, "n": n, "gates": len(cd["gates"])}
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            res = simulate_capacity(cd, device=dev)  # warm + first run
            force(res.re, res.im)
            row["first_call_s"] = round(time.perf_counter() - t0, 4)
            if check_amps:
                inv = 2.0 ** -0.5
                row["amp0_err"] = abs(float(res.re[0]) - inv)
                row["ampN_err"] = abs(float(res.re[-1]) - inv)
            fn = simulator.build_window_circuit_fn(
                cd, planar_io=True, inplace=True, device=dev)
            re, im = res.re, res.im
            t0 = time.perf_counter()
            for _ in range(reps):
                re, im = fn(re, im)
            norm = force(re, im)
            dt = (time.perf_counter() - t0) / reps
            row.update({
                "steady_s": round(dt, 6),
                "amp_updates_per_s": round(
                    len(cd["gates"]) * (1 << n) / dt, 1),
                "norm2": round(norm, 6),
                "planes_gib": 2 * re.numel() * re.element_size() / GIB,
            })
            if cuda:
                row["peak_gib"] = (torch.cuda.max_memory_allocated(dev)
                                   - base) / GIB
            # The planes are a large share of the card: they must not
            # live into the next config's allocation.
            del res, re, im
            gc.collect()
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
    return {"device": describe(dev), "rows": rows}


if __name__ == "__main__":
    # Args: ints select n values; tags like "qft30" select single configs
    # (implying their n).
    ns, only = [], set()
    for a in sys.argv[1:]:
        if a.isdigit():
            ns.append(int(a))
        else:
            only.add(a)
            ns.append(int("".join(ch for ch in a if ch.isdigit())))
    ns = tuple(dict.fromkeys(ns)) or (30,)
    print(json.dumps(run(ns=ns, only=only or None), indent=1))
