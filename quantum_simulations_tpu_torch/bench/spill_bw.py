"""Out-of-core streaming throughput (host-DRAM and disk backends).

MB/s of state streamed through the device per applied step, for a
layered workload at a given stripe width, through
``runtime/spill.run_out_of_core`` (the state in pinned host memory, or
in chunk files under a temporary directory).

* :func:`run` — host and disk backends at n = 22;
* :func:`overlap` — the depth-2 pipeline against the synchronous loop;
* :func:`slice_run` — the first local and the first non-local step of
  qft40 at m = 26 (an 8 TiB state no host holds), timed stripe by
  stripe, extrapolated over the run's stripe passes;
* :func:`real_chip` — n = 24 streamed with ``transfer="f32"``, held to
  the window run in the card's memory;
* :func:`real_chip_ghz` — GHZ-31, 16 GiB in pinned host memory, held to
  its closed form.

Run: ``python -m quantum_simulations_tpu_torch.bench.spill_bw
[slice40 | overlap | ghz [n m] | real [n m]]``.
"""
from __future__ import annotations

import json
import tempfile
import time

from . import describe, force, setup_platform, warm_grant


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


def overlap(n: int = 20, stripe_qubits: int = 16, dtype="complex64") -> dict:
    """Pipelined against synchronous spill: the copy / compute overlap.
    Both give the same state bit for bit (``bit_equal``)."""
    import numpy as np

    from ..circuit import library as lib
    from ..runtime import spill

    dev = setup_platform()
    warm_grant(dev)
    cd = lib.non_stabilizer(n, depth=2, seed=3)
    out: dict = {}
    states = []
    for label, pipe in (("pipelined", True), ("synchronous", False)):
        t0 = time.perf_counter()
        st = spill.run_out_of_core(cd, stripe_qubits=stripe_qubits,
                                   backend="host", dtype=dtype,
                                   pipeline=pipe, device=dev)
        out[label] = {"wall_s": time.perf_counter() - t0,
                      "norm": float(np.vdot(st, st).real)}
        states.append(st)
    out["bit_equal"] = bool(np.array_equal(states[0], states[1]))
    out["overlap_speedup"] = (out["synchronous"]["wall_s"]
                              / out["pipelined"]["wall_s"])
    out["device"] = describe(dev)
    return out


def slice_run(n: int = 40, stripe_qubits: int = 26,
              stripes_measured: int = 4, dtype="complex64") -> dict:
    """A measured slice of an n-qubit out-of-core run and the full run
    extrapolated from it.

    At n = 40 the complex64 state is 8 TiB, beyond any one host, so this
    runs the spill tier's own step bodies for QFT-n at the given stripe
    width (``compile_steps``, ``_group_bits`` / ``_remap_ops``, fused
    mode's passes) on the first local step and the first non-local step,
    each group going up, through the card and down through the tier's
    ``StripeIO`` from pinned host stripes, ``stripes_measured`` times.
    Every stripe of a step runs the same passes, so the per-stripe time
    times ``total_stripe_passes`` (steps x 2^(n - m): every step touches
    the whole state once) estimates the run."""
    import numpy as np
    import torch

    from ..circuit import library as lib
    from ..circuit.fusion import compile_steps
    from ..runtime import simulator
    from ..runtime.spill import _group_bits, _remap_ops
    from ..utils.device import complex_dtype, float_dtype
    from ..utils.transfer import StripeIO, pinned_empty

    dev = setup_platform()
    warm_grant(dev)
    m = stripe_qubits
    cdtype = complex_dtype(dtype)
    fdtype = float_dtype(cdtype)
    plain = simulator.plain_route(False, fdtype)
    cd = lib.qft(n)
    steps = compile_steps(cd, k=m)
    stripe_bytes = (1 << m) * np.dtype(dtype).itemsize
    total_passes = len(steps) * (1 << (n - m))

    rng = np.random.default_rng(0)
    base = rng.normal(size=1 << m) + 1j * rng.normal(size=1 << m)
    base = (base / np.linalg.norm(base)).astype(dtype)

    rows = []
    for label, step in (("local", next(s for s in steps
                                       if not s.nonlocal_ops)),
                        ("nonlocal", next(s for s in steps
                                          if s.nonlocal_ops))):
        bits = _group_bits(step, m)
        r = len(bits)
        body = simulator.run_passes(simulator.prepare_passes(
            [(op, False) for op in _remap_ops(step, m, bits)], dev, fdtype),
            plain)
        members, outs = [], []
        for _ in range(1 << r):
            a, _ = pinned_empty(1 << m, dtype, dev)
            a[:] = base
            members.append(a)
            outs.append(pinned_empty(1 << m, dtype, dev)[0])
        io = StripeIO(dev, cdtype, (1 << m) << r, slots=1)

        def group():
            io.upload(0, members)
            io.compute_slot(0, (1 << m) << r, body)
            io.download(0, outs)
            io.wait(0)

        group()  # warm
        t0 = time.perf_counter()
        for _ in range(stripes_measured):
            group()
        dt = (time.perf_counter() - t0) / stripes_measured
        per_stripe = dt / (1 << r)
        rows.append({
            "step_kind": label,
            "group_stripes": 1 << r,
            "group_GiB": ((1 << r) * stripe_bytes) / (1 << 30),
            "stripe_GB_s": stripe_bytes * 2 / per_stripe / 1e9,
            "per_stripe_s": per_stripe,
            "norm2": sum(force(torch.from_numpy(o)) for o in outs) / (1 << r),
        })
        del io, members, outs
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    mean_stripe_s = sum(x["per_stripe_s"] for x in rows) / len(rows)
    est_wall_s = mean_stripe_s * total_passes
    return {
        "n": n,
        "stripe_qubits": m,
        "state_TiB": (1 << n) * np.dtype(dtype).itemsize / 2**40,
        "steps": len(steps),
        "total_stripe_passes": total_passes,
        "device": describe(dev),
        "measured": rows,
        "est_full_run_s": est_wall_s,
        "est_full_run_h": est_wall_s / 3600,
        "note": ("extrapolated: measured per-stripe wall (up, compute, "
                 "down from pinned host memory) x total stripe passes; "
                 "the 8 TiB of host storage is the deployment's "
                 "constraint, not measured"),
    }


def real_chip(n: int = 24, stripe_qubits: int = 21, depth: int = 2,
              verify: bool = True) -> dict:
    """A full out-of-core run on the card with ``transfer="f32"`` (each
    stripe moved as its interleaved float32 view): every spill code path
    (stripes, stacked groups, the depth-2 pipeline), then the final state
    against the window run held in the card's memory
    (``l2_vs_inhbm``, ``max_abs_diff_vs_inhbm``)."""
    import numpy as np
    import torch

    from ..circuit import library as lib
    from ..circuit.fusion import compile_steps
    from ..runtime import simulator, spill

    dev = setup_platform()
    warm_grant(dev)
    m = stripe_qubits
    cd = lib.non_stabilizer(n, depth=depth, seed=3)
    state_bytes = (1 << n) * 8  # complex64
    steps = compile_steps(cd, k=m)

    st: dict = {}
    t0 = time.perf_counter()
    out = spill.run_out_of_core(cd, stripe_qubits=m, backend="host",
                                transfer="f32", device=dev, stats=st)
    wall = time.perf_counter() - t0

    res = {
        "n": n, "stripe_qubits": m, "device": describe(dev),
        "steps": len(steps),
        "group_steps": sum(1 for s in steps if s.nonlocal_ops),
        "state_MB": state_bytes / 1e6,
        "wall_s": wall,
        "MB_per_s_streamed": state_bytes * len(steps) * 2 / wall / 1e6,
        "bytes_up": st["bytes_up"], "bytes_down": st["bytes_down"],
        "pinned": st["pinned"],
        "norm2": float(np.vdot(out, out).real),
        "transfer": "f32",
    }
    if verify:
        ref = simulator.simulate(cd, mode="window", device=dev)
        got = torch.from_numpy(out).to(dev)
        d = got - ref
        res["l2_vs_inhbm"] = force(d) ** 0.5
        res["max_abs_diff_vs_inhbm"] = float(d.abs().max())
        res["ref_norm2"] = force(ref)
    return res


def real_chip_ghz(n: int = 31, stripe_qubits: int = 28) -> dict:
    """GHZ-n out of core: at n = 31 the complex64 state is 16 GiB, held
    in pinned host memory (two buffers: read and written) and streamed
    through the card stripe by stripe with ``transfer="f32"``.  GHZ has a
    closed form: the two poles |0...0> and |1...1> at 1/sqrt(2) and every
    other amplitude 0, checked over chunks of 2^24 amplitudes copied back
    to the device, the norm in float64."""
    import numpy as np
    import torch

    from ..circuit import library as lib
    from ..circuit.fusion import compile_steps
    from ..runtime import spill

    dev = setup_platform()
    warm_grant(dev)
    cd = lib.ghz(n)
    m = stripe_qubits
    steps = compile_steps(cd, k=m)
    state_bytes = (1 << n) * 8

    st: dict = {}
    t0 = time.perf_counter()
    out = spill.run_out_of_core(cd, stripe_qubits=m, backend="host",
                                transfer="f32", device=dev, stats=st)
    wall = time.perf_counter() - t0

    inv = 1.0 / np.sqrt(2.0)
    flat = torch.from_numpy(out.view(np.float32))
    norm2 = torch.zeros((), dtype=torch.float64, device=dev)
    maxoff = torch.zeros((), dtype=torch.float64, device=dev)  # off the poles
    chunk = 1 << 24
    for i in range(0, out.size, chunk):  # each chunk on the device
        seg = flat[2 * i:2 * (i + chunk)].to(dev, non_blocking=True)
        p = seg.double().view(-1, 2).square_().sum(dim=1)
        norm2 += p.sum()
        if i == 0:
            p[0] = 0.0
        if i + chunk >= out.size:
            p[-1] = 0.0
        maxoff = torch.maximum(maxoff, p.max())
    return {
        "n": n, "stripe_qubits": m, "device": describe(dev),
        "steps": len(steps),
        "group_steps": sum(1 for s in steps if s.nonlocal_ops),
        "state_GiB": state_bytes / (1 << 30),
        "wall_s": wall,
        "alloc_s": st["alloc_s"],
        "pinned": st["pinned"],
        "MB_per_s_streamed": state_bytes * len(steps) * 2 / wall / 1e6,
        "amp0_err": abs(float(np.abs(out[0])) - inv),
        "ampN_err": abs(float(np.abs(out[-1])) - inv),
        "max_offpole_amp": float(maxoff) ** 0.5,
        "norm2": float(norm2),
        "transfer": "f32",
    }


if __name__ == "__main__":
    import sys

    args = sys.argv[1:]
    kw = dict(zip(("n", "stripe_qubits"), map(int, args[1:3])))
    if args[:1] == ["slice40"]:
        print(json.dumps(slice_run(), indent=1))
    elif args[:1] == ["overlap"]:
        print(json.dumps(overlap(), indent=1))
    elif args[:1] == ["ghz"]:
        print(json.dumps(real_chip_ghz(**kw), indent=1))
    elif args[:1] == ["real"]:
        print(json.dumps(real_chip(**kw), indent=1))
    else:
        print(json.dumps(run(), indent=1))
