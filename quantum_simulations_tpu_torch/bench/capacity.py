"""Single-device capacity tier: n >= 29 in place on planar planes.

The window schedule runs with ``inplace=True`` (every pass through a
kernel's aliasing instance) on planes born on the device
(``runtime/capacity.simulate_capacity``): the state is the two float32
planes and nothing of its size beside them.  The peak the caching
allocator held (``torch.cuda.max_memory_allocated``) proves the fit.
Each row also goes to stderr as it finishes.

:func:`sample_run` draws shots on the card from such a state.

Run: ``python -m quantum_simulations_tpu_torch.bench.capacity [n ...] [tag ...]``
or ``... capacity sample [n [shots]]``.
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


def sample_run(n: int = 30, shots: int = 1_000_000, reps: int = 3,
               depth: int = 8, seed: int = 0) -> dict:
    """On-card sampling from a capacity-tier state.

    sycamore_like(n, depth, seed=11) runs in place on the planes, then
    ``shots`` bitstrings are drawn by the hierarchical inverse-CDF planar
    sampler (``ops/sampling.sample_bits_planar``: no 2^n probability
    vector, no (shots, blocks) noise tensor), from a ``torch.Generator``
    seeded by ``seed + rep``, and the per-qubit one-counts are reduced on
    the card.  ``peak_gib`` is ``torch.cuda.max_memory_allocated`` over
    the circuit and the draws, the planes included; ``p1`` is each
    qubit's exact P(1) from the same planes and ``ones_z_max`` the
    largest |count - shots * p1| / sqrt(shots * p1 * (1 - p1)) of the
    last draw."""
    import math

    import torch

    from ..circuit import library as lib
    from ..ops import dense, sampling
    from ..runtime import simulator

    dev = setup_platform()
    warm_grant(dev)
    cuda = dev.type == "cuda"
    cd = lib.sycamore_like(n, depth=depth, seed=11)
    row = {"config": f"sycamore{n}", "n": n, "gates": len(cd["gates"]),
           "shots": shots, "device": describe(dev)}
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fn = simulator.build_window_circuit_fn(cd, planar_io=True, inplace=True,
                                           device=dev)
    row["circuit_compile_s"] = time.perf_counter() - t0
    row["passes"] = len(simulator.schedule(cd, inplace=True))
    re, im = dense.zero_state_planar(n, device=dev)
    row["planes_gib"] = 2 * re.numel() * re.element_size() / GIB
    t0 = time.perf_counter()
    re, im = fn(re, im)
    row["norm2"] = force(re, im)
    row["circuit_s"] = time.perf_counter() - t0

    def draw(r: int):
        gen = torch.Generator(device=dev).manual_seed(seed + r)
        bits = sampling.sample_bits_planar(re, im, gen, shots, n)
        return bits.sum(dim=0, dtype=torch.int64)

    draw(0).cpu()  # warm
    t0 = time.perf_counter()
    for r in range(reps):
        counts = draw(r + 1)
    counts = counts.cpu().numpy()  # the (n,) fetch is the barrier
    dt = (time.perf_counter() - t0) / reps
    if cuda:
        row["peak_gib"] = torch.cuda.max_memory_allocated(dev) / GIB
    p1 = [sampling.qubit_probability_planar(re, im, q) for q in range(n)]
    frac = counts / shots
    row.update({
        "sample_s": dt,
        "shots_per_s": shots / dt,
        "ones_frac_min": float(frac.min()),
        "ones_frac_max": float(frac.max()),
        "counts": [int(c) for c in counts],
        "p1": p1,
        "ones_z_max": max(
            abs(c - shots * p) / math.sqrt(shots * p * (1 - p))
            if 0 < p < 1 else (0.0 if c == round(shots * p) else math.inf)
            for c, p in zip(counts, p1)),
    })
    print(json.dumps(row), file=sys.stderr, flush=True)
    return row


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "sample":
        n = int(sys.argv[2]) if len(sys.argv) > 2 else 30
        shots = int(sys.argv[3]) if len(sys.argv) > 3 else 1_000_000
        print(json.dumps(sample_run(n=n, shots=shots), indent=1))
        sys.exit(0)
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
