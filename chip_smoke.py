#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py            # the whole run (needs one card)
    python3 chip_smoke.py --quick    # build + kernel-vs-twin checks only

Phases (any failure exits non-zero):

1. Environment: torch / CUDA versions, the card's name and power limit,
   then the build of every ``quantum_simulations_tpu_torch/csrc/*.cu``
   (one nvcc per source, started together; ptxas register report).
2. Each kernel against its plain torch twin on the card, on seeded
   unit-norm states: at n = 28 with the W's of nonstab28's schedule
   (positioned pos 11 / 14 / 21, dual with and without its
   pre-straddler, the lane panel on the (2^21, 128) view), and at n = 20
   (positioned pos 7 / 8 / 9, a ragged 64-wide top window, dual in
   (7, 0) order, dual with general complex pre- and post-straddlers).
   Fails on ||diff||_2 > 1e-5.
3. The main path: ``api.simulate(non_stabilizer(28, depth=4, seed=7),
   SimulatorConfig(mode="window"))`` on the card, launch counters
   (dual_panel 2, positioned_panel 3, lane_panel 0, no plain twin),
   |norm2 - 1| <= 1e-5 and ||psi - psi_f64||_2 <= 1e-5 against the
   plain twins in float64 on the card; then a second request,
   ``hadamard_wall(28)`` with ``QST_PANEL_PAIR_FUSE=0``, whose unpaired
   pos-0 panel runs ``lane_panel`` (lane_panel 1, positioned_panel 3;
   every amplitude must equal 2^-14).  The counters are set to 0 just
   before each request and read just after it.
4. Times at n = 28: per kernel the median CUDA-event ms, the plain
   twin's ms, one torch library call computing the same function
   (timed here, never used by the port), and the bound: the larger of
   bytes / 3.35 TB/s and flop / 67 TFLOP/s (H100 SXM data sheet,
   float32 outside the tensor cores), with the flop the function needs
   (6 per complex multiply-add, none for a select straddler).  Then
   the end-to-end time of
   nonstab28 by the two-point estimator (t(2R) - t(R)) / R and
   amplitude-updates/s = 223 * 2^28 / t.

The last lines: the card line as nvidia-smi prints it, one JSON object
``{"kernels": [...]}``, and ``{"ok": true, "device": {...}}``.  The
whole record also goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12        # float32 outside the tensor cores
SEED = 7
SRC = "quantum_simulations_tpu_torch/csrc/panels.cu"
PALLAS = "quantum_simulations_tpu/ops/pallas_kernels.py"
REPLACES = {"lane_panel": f"{PALLAS}:93",
            "positioned_panel": f"{PALLAS}:605",
            "dual_panel": f"{PALLAS}:343"}
# The request whose launches each kernel reports: nonstab28 launches no
# lane panel (its pos-0 panels are all paired), hadamard_wall28 with
# QST_PANEL_PAIR_FUSE=0 does.  Each request has counts of its own.
PATH = {"lane_panel": "hadamard_wall28",
        "positioned_panel": "nonstab28",
        "dual_panel": "nonstab28"}
TOL_L2 = 1e-5

RECORD: dict = {"cases": [], "times": []}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def unit_state(n: int, seed: int, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    re = torch.from_numpy(rng.standard_normal(1 << n, dtype=np.float32)).to(dev)
    im = torch.from_numpy(rng.standard_normal(1 << n, dtype=np.float32)).to(dev)
    norm = math.sqrt(norm2(re, im))
    return (re.double() / norm).float(), (im.double() / norm).float()


def norm2(re, im) -> float:
    """sum |psi|^2 of (re, im) planes, accumulated in float64."""
    return float((re.double() ** 2).sum() + (im.double() ** 2).sum())


def rand_unitary(dim: int, rng):
    import numpy as np

    a = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    q, r = np.linalg.qr(a)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def diff(a, b):
    """(max abs error, ||a - b||_2) of two plane pairs, in float64."""
    import torch

    dr = a[0].double() - b[0].double()
    di = a[1].double() - b[1].double()
    mx = max(float(dr.abs().max()), float(di.abs().max()))
    l2 = float(torch.sqrt((dr * dr).sum() + (di * di).sum()))
    return mx, l2


def cuda_ms(fn, reps: int) -> float:
    """Median device time of one call, by CUDA events around each call,
    after one warm-up call."""
    import torch

    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def straddle_flop(s) -> int:
    """flop per amplitude of a (6, qb) straddler by the reference's term
    plan: a select (CNOT) only moves data; a unit / real / complex term
    costs 2 / 4 / 8 (a general complex U: 32)."""
    import numpy as np

    from quantum_simulations_tpu_torch.ops import panel_kernels as pk

    kinds = pk._straddle_plan(s.qb, s.U, np.float32)[2][2]
    return sum({"select": 0, "unit": 2, "real": 4, "complex": 8}[k]
               for k in kinds)


def bound(N: int, dims: list[int], straddles=()):
    """(bound_ms, bound_by) of the work the function needs.  Bytes: both
    planes read and written once, each W and straddler U read once.
    Operations: a complex contraction of width dim costs 6 * dim flop per
    amplitude by Gauss's three real products (the reference's default,
    ``_cmul_planes`` in pallas_kernels.py), plus 4 adds; a straddler
    costs :func:`straddle_flop`."""
    nbytes = 4 * N * 4 + sum(2 * d * d * 4 for d in dims) + 32 * 4 * len(straddles)
    flop = N * (sum(6 * d + 4 for d in dims)
                + sum(straddle_flop(s) for s in straddles))
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flop / FP32_FLOP_PER_S
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def dual_library(xc, op, cw):
    """One torch call computing a (0, 7) dual pass on the complex state
    ``xc``, straddler included: an einsum of the lane W, the row W and,
    with a pre-straddler on (lane bit 6, row bit qb - 7), its U as
    (2, 2, 2, 2) in (bit 6, qb) order over the (A, 2^(6-dbit), 2,
    2^dbit, 2, 64) view.  The two panels commute (they act on different
    axes); the straddler comes first."""
    import torch

    lane, row = (op.first, op.second) if op.first.pos == 0 else (op.second, op.first)
    Wl, Wr = cw(lane.W), cw(row.W)
    if op.post_straddle is not None:
        raise ValueError("dual_library: no post-straddler on the main path")
    if op.pre_straddle is None:
        xv = xc.view(-1, 128, 128)
        return lambda: torch.einsum("ij,ajm,lm->ail", Wr, xv, Wl)
    _, qb, U = op.pre_straddle
    dbit = qb - 7
    H, L = 1 << (6 - dbit), 1 << dbit
    xv = xc.view(-1, H, 2, L, 2, 64)
    U4 = cw(U).view(2, 2, 2, 2)
    return lambda: torch.einsum("SRsr,ahrosm,lSm,ihRo->ail", U4, xv,
                                Wl.view(128, 2, 64), Wr.view(128, H, 2, L))


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain twin
# ---------------------------------------------------------------------------

def kernel_cases(n: int, ops, rng):
    """(label, kernel name, kernel call, twin call) at size n."""
    from quantum_simulations_tpu_torch.circuit.panelize import (
        DualPanelOp, WindowPanelOp,
    )
    from quantum_simulations_tpu_torch.ops import panel_kernels as pk

    cases = []
    if n == 28:
        for op in ops:
            if isinstance(op, WindowPanelOp):
                cases.append((f"positioned pos{op.pos}", "positioned_panel",
                              lambda x, op=op: pk.positioned_panel(*x, op.W, op.pos),
                              lambda x, op=op: pk.positioned_panel_plain(*x, op.W, op.pos)))
            elif isinstance(op, DualPanelOp):
                tag = "dual" + (" +pre" if op.pre_straddle else "") + (
                    " +post" if op.post_straddle else "")
                args = (op.first.W, op.first.pos, op.second.W, op.second.pos)
                kw = dict(straddle=op.pre_straddle, post_straddle=op.post_straddle)
                cases.append((tag, "dual_panel",
                              lambda x, a=args, k=kw: pk.dual_panel(*x, *a, **k),
                              lambda x, a=args, k=kw: pk.dual_panel_plain(*x, *a, **k)))
        W0 = ops[0].first.W
        cases.append(("lane (2^21, 128)", "lane_panel",
                      lambda x: pk.lane_panel(*x, W0),
                      lambda x: pk.lane_panel_plain(*x, W0)))
        return cases
    for pos in (7, 8, 9):
        W = rand_unitary(128, rng)
        cases.append((f"positioned pos{pos}", "positioned_panel",
                      lambda x, W=W, p=pos: pk.positioned_panel(*x, W, p),
                      lambda x, W=W, p=pos: pk.positioned_panel_plain(*x, W, p)))
    W64 = rand_unitary(64, rng)
    cases.append(("positioned ragged dim64 pos14", "positioned_panel",
                  lambda x: pk.positioned_panel(*x, W64, n - 6),
                  lambda x: pk.positioned_panel_plain(*x, W64, n - 6)))
    Wa, Wb = rand_unitary(128, rng), rand_unitary(128, rng)
    cases.append(("dual (7,0)", "dual_panel",
                  lambda x: pk.dual_panel(*x, Wa, 7, Wb, 0),
                  lambda x: pk.dual_panel_plain(*x, Wa, 7, Wb, 0)))
    pre, post = (6, 10, rand_unitary(4, rng)), (6, 13, rand_unitary(4, rng))
    cases.append(("dual (0,7) complex pre qb10 + post qb13", "dual_panel",
                  lambda x: pk.dual_panel(*x, Wb, 0, Wa, 7, straddle=pre,
                                          post_straddle=post),
                  lambda x: pk.dual_panel_plain(*x, Wb, 0, Wa, 7, straddle=pre,
                                                post_straddle=post)))
    return cases


def check_kernels(dev, nonstab_ops) -> dict:
    import numpy as np
    import torch

    worst: dict = {}
    rng = np.random.default_rng(SEED)
    for n in (20, 28):
        x = unit_state(n, SEED + n, dev)
        for label, name, kern, twin in kernel_cases(n, nonstab_ops, rng):
            got = kern(x)
            torch.cuda.synchronize()
            want = twin(x)
            mx, l2 = diff(got, want)
            ok = l2 <= TOL_L2 and bool(torch.isfinite(got[0]).all())
            log(f"check n={n} {label:<42} max_abs_err={mx:.3e} "
                f"l2_diff={l2:.3e} {'ok' if ok else 'FAIL'}")
            RECORD["cases"].append(dict(n=n, case=label, kernel=name,
                                        max_abs_err=mx, l2_diff=l2))
            if not ok:
                raise AssertionError(f"{name} ({label}, n={n}) disagrees with "
                                     f"its plain twin: ||diff||_2 = {l2:.3e}")
            worst[name] = max(worst.get(name, 0.0), mx)
            del got, want
        del x
        torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def main_path(dev) -> dict:
    import numpy as np
    import torch

    from quantum_simulations_tpu_torch import SimulatorConfig, api
    from quantum_simulations_tpu_torch.circuit import library
    from quantum_simulations_tpu_torch.ops import panel_kernels as pk
    from quantum_simulations_tpu_torch.runtime import simulator

    cd = library.non_stabilizer(28, depth=4, seed=7)
    counts: dict = {}
    pk.reset_counts()
    t0 = time.perf_counter()
    psi = api.simulate(cd, SimulatorConfig(mode="window"), device=dev)
    wall = time.perf_counter() - t0
    counts["nonstab28"] = dict(pk.LAUNCHES)
    log(f"main nonstab28 api.simulate: {wall:.3f} s (first call: schedule, "
        f"W upload, host copy of 2^28 amplitudes) "
        f"launches={counts['nonstab28']} plain_calls={dict(pk.PLAIN_CALLS)}")
    want = {"dual_panel": 2, "positioned_panel": 3, "lane_panel": 0}
    if counts["nonstab28"] != want or any(pk.PLAIN_CALLS.values()):
        raise AssertionError(f"nonstab28 launch counts {counts['nonstab28']} / "
                             f"plain {pk.PLAIN_CALLS}, want {want} and no plain call")

    # Second request: the unpaired-panel schedule, whose pos-0 panel
    # runs lane_panel.  H on every qubit: every amplitude is 2^-14.
    os.environ["QST_PANEL_PAIR_FUSE"] = "0"
    pk.reset_counts()
    try:
        wall_psi = api.simulate(library.hadamard_wall(28),
                                SimulatorConfig(mode="window"), device=dev)
    finally:
        del os.environ["QST_PANEL_PAIR_FUSE"]
    counts["hadamard_wall28"] = dict(pk.LAUNCHES)
    hw_err = float(np.max(np.abs(wall_psi - 2.0 ** -14)))
    log(f"main hadamard_wall28 (QST_PANEL_PAIR_FUSE=0): max |psi - 2^-14| = "
        f"{hw_err:.3e} launches={counts['hadamard_wall28']} "
        f"plain_calls={dict(pk.PLAIN_CALLS)}")
    del wall_psi
    want = {"dual_panel": 0, "positioned_panel": 3, "lane_panel": 1}
    if (counts["hadamard_wall28"] != want or any(pk.PLAIN_CALLS.values())
            or not hw_err <= 1e-6):
        raise AssertionError(f"hadamard_wall28 launch counts "
                             f"{counts['hadamard_wall28']}, want {want}, no plain "
                             f"call and the exact state")

    got = torch.from_numpy(psi).to(dev).to(torch.complex128)
    del psi
    nrm2 = norm2(got.real, got.imag)
    ref = simulator.simulate(cd, dtype="complex128", mode="window",
                             device=dev, plain=True)
    l2 = float(torch.linalg.vector_norm(got - ref))
    mx = float((got - ref).abs().max())
    finite = bool(torch.isfinite(torch.view_as_real(got)).all())
    del got, ref
    torch.cuda.empty_cache()
    log(f"main nonstab28 vs plain float64 twins on the card: norm2={nrm2:.9f} "
        f"|norm2-1|={abs(nrm2 - 1):.3e} ||psi-psi_f64||_2={l2:.3e} "
        f"max_abs={mx:.3e}")
    if not (finite and abs(nrm2 - 1) <= 1e-5 and l2 <= 1e-5):
        raise AssertionError("nonstab28 output is off the float64 reference")
    RECORD["main"] = dict(launches=counts, norm2=nrm2, l2_vs_f64=l2,
                          max_abs_vs_f64=mx, hadamard_wall_max_err=hw_err,
                          first_call_s=wall)
    return counts


# ---------------------------------------------------------------------------
# Phase 4: times
# ---------------------------------------------------------------------------

def times(dev, ops) -> dict:
    import torch

    from quantum_simulations_tpu_torch.circuit import library
    from quantum_simulations_tpu_torch.circuit.panelize import (
        DualPanelOp, WindowPanelOp,
    )
    from quantum_simulations_tpu_torch.ops import dense
    from quantum_simulations_tpu_torch.ops import panel_kernels as pk
    from quantum_simulations_tpu_torch.runtime import simulator

    n, N = 28, 1 << 28
    x = unit_state(n, SEED, dev)
    xc = torch.complex(*x)

    def cw(W):
        return torch.as_tensor(W, dtype=torch.complex64, device=dev)

    rows: dict = {}

    def row(name, label, kern, twin, lib, dims, straddles=()):
        ms = cuda_ms(kern, reps=10)
        plain_ms = cuda_ms(twin, reps=3)
        lib_ms = cuda_ms(lib, reps=5)
        b_ms, b_by = bound(N, dims, straddles)
        log(f"time {label:<26} ms={ms:.3f} plain_ms={plain_ms:.3f} "
            f"library_ms={lib_ms:.3f} bound_ms={b_ms:.3f} ({b_by}) "
            f"bound/ms={b_ms / ms:.3f}")
        rec = dict(kernel=name, case=label, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        RECORD["times"].append(rec)
        rows.setdefault(name, rec)

    for op in ops:
        if isinstance(op, WindowPanelOp):
            wr, wi = pk.w_planes(op.W, dev, torch.float32)
            Wc, C = cw(op.W), 1 << op.pos
            xv = xc.view(-1, 128, C)
            row("positioned_panel", f"positioned pos{op.pos}",
                lambda op=op, w=(wr, wi): pk.positioned_panel(*x, w, op.pos),
                lambda op=op, w=(wr, wi): pk.positioned_panel_plain(*x, w, op.pos),
                lambda Wc=Wc, xv=xv: torch.einsum("ij,ajc->aic", Wc, xv), [128])
    # The dual rows: op 0 (no straddler) first, so it is the JSON row.
    duals = sorted((op for op in ops if isinstance(op, DualPanelOp)),
                   key=lambda o: o.pre_straddle is not None)
    for op in duals:
        w1 = pk.w_planes(op.first.W, dev, torch.float32)
        w2 = pk.w_planes(op.second.W, dev, torch.float32)
        s = pk.Straddle.of(op.pre_straddle)
        row("dual_panel", "dual" + (" +pre" if s else ""),
            lambda w1=w1, w2=w2, op=op, s=s: pk.dual_panel(
                *x, w1, op.first.pos, w2, op.second.pos, straddle=s),
            lambda w1=w1, w2=w2, op=op, s=s: pk.dual_panel_plain(
                *x, w1, op.first.pos, w2, op.second.pos, straddle=s),
            dual_library(xc, op, cw), [128, 128], [s] if s else [])
    w0 = pk.w_planes(ops[0].first.W, dev, torch.float32)
    W0t, xl = cw(ops[0].first.W).T.contiguous(), xc.view(-1, 128)
    row("lane_panel", "lane (2^21, 128)",
        lambda: pk.lane_panel(*x, w0), lambda: pk.lane_panel_plain(*x, w0),
        lambda: xl @ W0t, [128])
    del x, xc
    torch.cuda.empty_cache()

    # End to end, two-point estimator: fixed per-call cost cancels.
    cd = library.non_stabilizer(28, depth=4, seed=7)
    fn = simulator.build_window_circuit_fn(cd, planar_io=True, device=dev)

    def chain(k: int) -> float:
        st = dense.zero_state_planar(n, torch.float32, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            st = fn(*st)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    chain(1)
    R = 3
    t1 = min(chain(R) for _ in range(3))
    t2 = min(chain(2 * R) for _ in range(3))
    dt = (t2 - t1) / R
    rate = len(cd["gates"]) * N / dt
    log(f"e2e nonstab28 window: {dt * 1e3:.3f} ms per run "
        f"(t({R})={t1:.4f} s, t({2 * R})={t2:.4f} s), "
        f"{rate:.4e} amp-updates/s ({len(cd['gates'])} gates x 2^28 / t)")
    RECORD["e2e"] = dict(ms=dt * 1e3, t_R=t1, t_2R=t2, R=R,
                         amp_updates_per_s=rate, gates=len(cd["gates"]))
    return rows


# ---------------------------------------------------------------------------

def main() -> int:
    quick = "--quick" in sys.argv[1:]
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False: chip_smoke.py needs a card")
        return 2
    try:
        from quantum_simulations_tpu_torch.circuit import library
        from quantum_simulations_tpu_torch.circuit.panelize import (
            compile_window_schedule,
        )
        from quantum_simulations_tpu_torch.ops import cuda_build
        from quantum_simulations_tpu_torch.runtime.simulator import pair_panel_diag
    except ImportError as e:
        log(f"FAIL: the port is not beside this script ({e})")
        return 2

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"env python={sys.version.split()[0]} torch={torch.__version__} "
        f"cuda={torch.version.cuda} devices={torch.cuda.device_count()} "
        f"name={torch.cuda.get_device_name(0)}")
    log(f"card (name, power.limit): {card}")
    RECORD.update(card=card, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    libs = cuda_build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"build {[p.name for p in libs]} in {build_s:.1f} s")
    RECORD["build_s"] = build_s

    cd = library.non_stabilizer(28, depth=4, seed=7)
    paired = pair_panel_diag(compile_window_schedule(cd, diag_terms_only=True))
    ops = [op for op, _ in paired]
    log("nonstab28 schedule: " + ", ".join(
        type(o).__name__ + (f"@{o.pos}" if hasattr(o, "pos") else "")
        + (" +pre" if getattr(o, "pre_straddle", None) else "") for o in ops))

    worst = check_kernels(dev, ops)
    if quick:
        log("quick: build and kernel checks passed")
        return 0
    counts = main_path(dev)
    rows = times(dev, ops)

    kernels = []
    for name in ("lane_panel", "positioned_panel", "dual_panel"):
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=SRC, replaces=REPLACES[name],
            launches=counts[PATH[name]][name], path=PATH[name],
            launches_by_path={p: c[name] for p, c in counts.items()},
            max_abs_err=worst[name], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    RECORD["kernels"] = kernels
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        log("FAIL: a phase failed (traceback above)")
        code = 1
    sys.exit(code)
