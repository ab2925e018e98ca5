"""Where a window run's time goes beyond its kernels.

* :func:`nonstab_variants` — the headline circuit (nonstab28) through
  ``simulator.build_window_circuit_fn`` with complex I/O (the state split
  into planes and joined again around every call: two full passes the
  pass count never shows), planar I/O, and planar I/O in place.  The JAX
  package's two ``*_donate`` variants have no counterpart: torch has no
  buffer donation (out of place, each pass frees its input planes as the
  next pass binds its output; in place, the kernels write their input).
* :func:`wal_tax` — the durability tax: the same circuit under the WAL
  runner (``runtime/runner.py``) without a WAL, with a WAL and one final
  checkpoint, and with a checkpoint every c steps, split by the runner's
  own timers (``runner.compile`` / ``step`` / ``sync`` / ``checkpoint``)
  into compile, steps and checkpoint writes, with the measured rate of
  the checkpoint writes.
* :func:`panel_scaling` — k chained lane-panel passes for k in (2, 4, 8,
  16); a straight-line fit gives the marginal cost of one pass (slope)
  and the fixed cost of a chain (intercept).
* :func:`diag_variants` — ``fused_diag`` on qft28's largest merged diag
  run: all its terms, its row terms only, one constant term.  The JAX
  package's ``full_scalar_cross`` variant picks between two Pallas
  layouts of the lane terms (``group_min``); ``csrc/diag.cu`` always
  groups the terms by their lane-bit subset, so it has no counterpart.

Device work is timed with CUDA events (:func:`bench.device_s`) or with
the host clock closed by :func:`bench.force`.

Run: ``python -m quantum_simulations_tpu_torch.bench.overhead
[variants | wal [work_dir [n]] | scaling | diag | all]`` (``all``:
variants, scaling and diag, as in the JAX package; ``wal`` runs
nonstab(n), by default n = 28, and writes its checkpoints under
``work_dir``, by default a new temporary directory).
"""
from __future__ import annotations

import json
import time

import numpy as np

from . import describe, device_s, force, setup_platform, warm_grant


def nonstab_variants(n: int = 28, reps: int = 10) -> list:
    """Rows per I/O policy: ``steady_s`` of one call (host clock over
    ``reps`` chained calls, closed by :func:`force`), ``ms_per_pass`` over
    the schedule's own ``passes``, ``norm2``, and ``l2_vs_planar_io``: the
    distance of the state one call makes from |0...0> to planar I/O's."""
    import torch

    from ..circuit import library as lib
    from ..ops import dense
    from ..ops import panel_kernels as pk
    from ..runtime import simulator

    dev = setup_platform()
    cd = lib.non_stabilizer(n, depth=4, seed=7)
    variants = [
        ("planar_io", dict(planar_io=True, inplace=False)),
        ("complex_io", dict(planar_io=False, inplace=False)),
        ("planar_io_inplace", dict(planar_io=True, inplace=True)),
    ]
    rows = []
    ref = None
    for tag, kw in variants:
        t0 = time.perf_counter()
        fn = simulator.build_window_circuit_fn(cd, device=dev, **kw)
        compile_s = time.perf_counter() - t0
        passes = len(simulator.schedule(cd, inplace=kw["inplace"]))
        planar = kw["planar_io"]

        def call(state, fn=fn, planar=planar):  # planes, or (psi,)
            return fn(*state) if planar else (fn(*state),)

        state = call(dense.zero_state_planar(n, device=dev) if planar
                     else (dense.zero_state(n, device=dev),))
        one = state if planar else pk.to_planar(state[0])
        if ref is None:
            ref = tuple(x.clone() for x in one)
        l2 = force(one[0] - ref[0], one[1] - ref[1]) ** 0.5
        del one
        t0 = time.perf_counter()
        for _ in range(reps):
            state = call(state)
        norm = force(*state)
        dt = (time.perf_counter() - t0) / reps
        del state
        row = {"variant": tag, "n": n, "gates": len(cd["gates"]),
               "compile_s": compile_s, "steady_s": dt, "passes": passes,
               "ms_per_pass": dt / passes * 1e3, "norm2": norm,
               "l2_vs_planar_io": l2}
        rows.append(row)
        print(json.dumps(row), flush=True)
    del ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rows


def wal_tax(n: int = 28, checkpoint_every: int = 4,
            max_levels_per_step: int = 1, work_dir=None) -> list:
    """The durability tax: nonstab(n) in window mode under the runner, per
    configuration (the first runs cold, the rest find the step functions
    compiled):

    * ``no_wal_cold`` / ``no_wal`` — no WAL, one final state save;
    * ``wal_final`` — a WAL, only the final state checkpointed;
    * ``wal_ck{c}`` — a WAL and a checkpoint every c steps.

    Each configuration writes into its own directory under ``work_dir``
    (a new temporary directory when None), removed after it."""
    import shutil
    import tempfile
    from pathlib import Path

    from ..circuit import library as lib
    from ..runtime import runner
    from ..utils import timing

    dev = setup_platform()
    cd = lib.non_stabilizer(n, depth=4, seed=7)
    base = Path(tempfile.mkdtemp(prefix="qst_waltax_") if work_dir is None
                else work_dir)
    configs = [
        ("no_wal_cold", dict(use_wal=False)),
        ("no_wal", dict(use_wal=False)),
        ("wal_final", dict(use_wal=True, checkpoint_every=10**9)),
        (f"wal_ck{checkpoint_every}",
         dict(use_wal=True, checkpoint_every=checkpoint_every)),
    ]
    rows = []
    try:
        for tag, kw in configs:
            wd = base / tag
            shutil.rmtree(wd, ignore_errors=True)
            timing.reset()
            st: dict = {}
            t0 = time.perf_counter()
            try:
                runner.run(cd, wd, mode="window", resume=False,
                           max_levels_per_step=max_levels_per_step,
                           device=dev, stats=st, **kw)
                wall = time.perf_counter() - t0
            finally:
                shutil.rmtree(wd, ignore_errors=True)
            t = timing.snapshot()
            timers, counts = t["timers_s"], t["counts"]
            ck_s = timers.get("runner.checkpoint", 0.0)
            row = {
                "config": tag, "n": n, "gates": len(cd["gates"]),
                "wall_s": wall,
                "compile_s": timers.get("runner.compile", 0.0),
                "steps_s": timers.get("runner.step", 0.0),
                "sync_s": timers.get("runner.sync", 0.0),
                "exec_s": (timers.get("runner.step", 0.0)
                           + timers.get("runner.sync", 0.0)),
                "n_steps": counts.get("runner.step.calls", 0),
                "checkpoint_s": ck_s,
                "n_checkpoints": counts.get("runner.checkpoint.calls", 0),
                "checkpoint_bytes": st["checkpoint_bytes"],
                "checkpoint_MB_s": (st["checkpoint_bytes"] / 1e6 / ck_s
                                    if ck_s else None),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        if work_dir is None:
            shutil.rmtree(base, ignore_errors=True)
    return rows


def panel_scaling(n: int = 28, ks=(2, 4, 8, 16), reps: int = 6) -> dict:
    """k chained lane-panel passes; fit t(k) = intercept + slope * k."""
    import torch

    from ..ops import dense
    from ..ops import panel_kernels as pk

    dev = setup_platform()
    rng = np.random.default_rng(0)
    W, _ = np.linalg.qr(rng.standard_normal((128, 128))
                        + 1j * rng.standard_normal((128, 128)))
    Wp = pk.w_planes(W, dev, torch.float32)
    state = list(dense.zero_state_planar(n, device=dev))

    rows = []
    for k in ks:
        def prog(k=k):
            for _ in range(k):
                state[:] = pk.lane_panel(*state, Wp)

        dt = device_s(prog, 1, reps, dev)
        row = {"k": k, "steady_s": dt, "ms_per_pass": dt / k * 1e3}
        rows.append(row)
        print(json.dumps(row), flush=True)
    norm = force(*state)
    slope, intercept = np.polyfit([r["k"] for r in rows],
                                  [r["steady_s"] for r in rows], 1)
    return {"rows": rows, "norm2": norm,
            "fit": {"slope_ms_per_pass": float(slope) * 1e3,
                    "intercept_ms": float(intercept) * 1e3}}


def diag_variants(n: int = 28, iters: int = 8, reps: int = 3) -> list:
    """``fused_diag`` on qft(n)'s largest merged ``DiagOp``: all its terms
    (grouped by lane-bit subset, the kernel's one layout), its row terms
    only (every qubit >= 7), and one constant term."""
    import torch

    from ..circuit import library as lib
    from ..circuit.panelize import DiagOp, compile_window_schedule
    from ..ops import diag_kernels as dk

    dev = setup_platform()
    ops = compile_window_schedule(lib.qft(n), diag_terms_only=True)
    big = max((o for o in ops if isinstance(o, DiagOp)),
              key=lambda o: len(o.terms))
    terms = big.terms
    row = tuple((qs, c) for qs, c in terms if qs and all(q >= 7 for q in qs))
    variants = [
        ("full_grouped", terms),
        ("row_only", row),
        ("const_only", (((), 0.3),)),
    ]
    rows = []
    for tag, ts in variants:
        dterms = dk.DiagTerms.of(ts)
        if dev.type == "cuda":
            dterms.operand(dev)
        state = [torch.full((1 << n,), 0.5, device=dev),
                 torch.full((1 << n,), 0.25, device=dev)]

        def step(dterms=dterms, state=state):
            state[:] = dk.fused_diag(*state, dterms)

        per = device_s(step, iters, reps, dev)
        r = {"variant": tag, "n_terms": len(ts), "s_per_pass": per,
             "GBs": 4 * (1 << n) * 4 / per / 1e9}
        rows.append(r)
        print(json.dumps(r), flush=True)
    return rows


if __name__ == "__main__":
    import sys

    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in ("variants", "wal", "scaling", "diag", "all"):
        raise SystemExit("usage: python -m quantum_simulations_tpu_torch.bench"
                         ".overhead [variants | wal [work_dir [n]] | scaling | "
                         "diag | all]")
    dev = setup_platform()
    warm_grant(dev)
    out = {"device": describe(dev)}
    if which in ("all", "variants"):
        out["nonstab_variants"] = nonstab_variants()
    if which == "wal":
        out["wal_tax"] = wal_tax(
            *map(int, sys.argv[3:4]),
            work_dir=sys.argv[2] if len(sys.argv) > 2 else None)
    if which in ("all", "scaling"):
        out["panel_scaling"] = panel_scaling()
    if which in ("all", "diag"):
        out["diag_variants"] = diag_variants()
    print(json.dumps(out, indent=1))
