"""Per-pass table of a window schedule against the card's bound.

For every op of the window schedule: its measured ms on the card beside
the least time the card could take for it (``bench.work``): its bytes
(both float32 planes read and written once, 16 bytes an amplitude, plus
its operands) at 3.35 TB/s, or its operations at the rate of their type
(the dim-128 panels and both contractions of a dual panel on the tensor
cores in split TF32, 495 TFLOP/s; narrower panels, straddlers and diag
epilogues in float32, 67 TFLOP/s), whichever is larger.  Each row's
``binding`` is ``bandwidth``, ``tensor cores (split TF32)`` or
``float32`` by the larger of the two, or ``overhead/slack`` when the
pass takes more than 1.35 times its bound.

Method: two-point prefix differencing.  Timing one op repeated on its
own output is wrong for the transposing window kernels (the real chain
relabels for free what a repeat must move), so ops[0..k) run as one
chain for k = 0..P, R and 2R times, each from |0> and closed by a norm
fetched to the host; prefix k costs (t(2R) - t(R)) / R per rep, with the
min over ``samples`` runs of each (contention only ever adds time), so
the fixed cost of a run (the start, the norm and its fetch) cancels.
The per-rep curve is clamped to be monotone and its deltas are each
pass's cost in context.  A delta below 97% of its own bound (a boundary
spill between adjacent passes) is merged with its neighbour to a
fixpoint; a group's bound is the sum of its members', so no row can
overstate its share and rows read at most ~103% of their bound.  The
TOTAL is exact either way, and the raw per-prefix wall times ship in
the output.

    python -m quantum_simulations_tpu_torch.bench.passes [--config nonstab28]
        [--reps 12] [--samples 5]
"""
from __future__ import annotations

import argparse
import json
import time

from . import (
    FP32_FLOP_PER_S, HBM_BYTES_PER_S, TF32_FLOP_PER_S, describe, force,
    setup_platform, warm_grant, work,
)

TC = "tensor cores (split TF32)"


def _op_work(op, dterms, n: int) -> dict:
    """The pass's plane bytes and its bound in both parts (ms): bytes at
    the card's rate, operations at their type's rate."""
    from ..circuit.panelize import DiagOp, DualPanelOp, WindowPanelOp
    from ..ops import panel_kernels as pk

    N = 1 << n
    dims, straddles, diag, tc = [], [], dterms, False
    if isinstance(op, DualPanelOp):
        dims = [op.first.W[0].shape[-1], op.second.W[0].shape[-1]]
        straddles = [pk.Straddle.of(s) for s in (op.pre_straddle,
                                                 op.post_straddle) if s]
        tc = True
    elif isinstance(op, WindowPanelOp):
        dims = [op.W[0].shape[-1]]
        tc = dims[0] == pk.LANES
    elif isinstance(op, DiagOp):
        diag = op.terms
    nbytes, t_ops = work(N, dims, straddles, diag, tc)
    return {"plane_bytes": 16 * N,
            "bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "ops_ms": 1e3 * t_ops,
            "ops_unit": TC if tc else "float32"}


def _binding(ms: float, g: dict) -> str:
    if g["floor"] > 0 and ms > 1.35 * g["floor"]:
        return "overhead/slack"
    if g["bytes_ms"] >= g["ops_ms"]:
        return "bandwidth"
    return g["ops_unit"]


def _op_detail(op) -> str:
    kind = type(op).__name__
    if kind == "DualPanelOp":
        return (f"pos={op.first.pos}+{op.second.pos} "
                f"fused={op.first.n_fused}+{op.second.n_fused}")
    if hasattr(op, "pos"):
        return f"pos={op.pos} fused={getattr(op, 'n_fused', '?')}"
    if hasattr(op, "qubits"):
        return f"q={op.qubits}"
    if hasattr(op, "pairs"):
        return f"pairs={op.pairs}"
    return ""


def _build_circuit(config: str):
    from ..circuit import library as lib

    if config.startswith("nonstab"):
        return lib.non_stabilizer(int(config[7:] or 28), depth=4, seed=7)
    if config == "sycamore26_d8":
        return lib.sycamore_like(26, depth=8, seed=11)
    if config == "qaoa26_p2":
        return lib.qaoa_maxcut(26, p=2)
    if config == "qft26":
        return lib.qft(26)
    raise SystemExit(f"unknown --config {config}")


def _merge(a: dict, b: dict) -> dict:
    out = {k: a[k] + b[k] for k in ("ops", "kinds", "details", "ms",
                                    "plane_bytes", "bytes_ms", "ops_ms",
                                    "diag_terms", "floor")}
    # the unit of the larger operation part names the group's
    out["ops_unit"] = a["ops_unit"] if a["ops_ms"] >= b["ops_ms"] else b["ops_unit"]
    out["merged"] = True
    return out


def run(config: str = "nonstab28", reps: int = 12, samples: int = 5) -> dict:
    import torch

    from ..circuit.panelize import compile_window_schedule
    from ..ops import dense
    from ..runtime import simulator

    dev = setup_platform()
    warm_grant(dev)
    cd = _build_circuit(config)
    n = cd["number_of_qubits"]
    paired = simulator.pair_panel_diag(
        compile_window_schedule(cd, diag_terms_only=True))
    ops = simulator.prepare_schedule(paired, dev, torch.float32)

    def chain_s(k: int, r: int) -> float:
        re, im = dense.zero_state_planar(n, torch.float32, dev)
        force(re, im)
        t0 = time.perf_counter()
        for _ in range(r):
            for op, dterms in ops[:k]:
                re, im = simulator.apply_window_op(re, im, op, dterms)
        force(re, im)
        return (time.perf_counter() - t0) * 1e3

    def timed(k: int, r: int) -> list[float]:
        chain_s(k, r)  # warm
        return [chain_s(k, r) for _ in range(samples)]

    per_rep, curve = [], []
    for k in range(len(ops) + 1):
        t1, t2 = timed(k, reps), timed(k, 2 * reps)
        per_rep.append((min(t2) - min(t1)) / reps)
        curve.append({"k": k, f"t{reps}_ms": [round(x, 4) for x in t1],
                      f"t{2 * reps}_ms": [round(x, 4) for x in t2]})
    rtt = per_rep[0]  # the empty chain's per-rep cost (~0 by construction)
    # A longer prefix cannot be cheaper than a shorter one: clamp the
    # residual noise so that every delta is >= 0.
    cum = [per_rep[0]]
    for v in per_rep[1:]:
        cum.append(max(v, cum[-1]))

    raw = []
    for idx, (op, dterms) in enumerate(ops):
        w = _op_work(op, dterms, n)
        raw.append({"ops": [idx], "kinds": [type(op).__name__],
                    "details": [_op_detail(op)], "ms": cum[idx + 1] - cum[idx],
                    "diag_terms": len(dterms.terms) if dterms else 0,
                    "floor": max(w["bytes_ms"], w["ops_ms"]),
                    **{k: w[k] for k in ("plane_bytes", "bytes_ms", "ops_ms",
                                         "ops_unit")}})

    # Attribution-spill repair: a pass cannot beat its own bound, so a
    # delta below 97% of it shifted work into a neighbour.  Merge such a
    # row with its predecessor (successor for the first) to a fixpoint.
    groups = [dict(r) for r in raw]
    changed = True
    while changed and len(groups) > 1:
        changed = False
        for i, g in enumerate(groups):
            if g["ms"] < 0.97 * g["floor"]:
                j = i - 1 if i > 0 else i + 1
                lo, hi = min(i, j), max(i, j)
                groups[lo:hi + 1] = [_merge(groups[lo], groups[hi])]
                changed = True
                break

    rows = []
    for g in groups:
        row = {
            "passes": g["ops"],
            "kind": "+".join(g["kinds"]),
            "detail": "; ".join(d for d in g["details"] if d),
            "measured_ms": round(g["ms"], 4),
            "plane_bytes": g["plane_bytes"],
            "bytes_floor_ms": round(g["bytes_ms"], 4),
            "ops_floor_ms": round(g["ops_ms"], 4),
            "floor_ms": round(g["floor"], 4),
            "pct_of_bound": (round(100 * g["floor"] / g["ms"], 1)
                             if g["ms"] > 0 else None),
            "binding": _binding(g["ms"], g),
        }
        if g["diag_terms"]:
            row["diag_epilogue_terms"] = g["diag_terms"]
        if g.get("merged"):
            row["note"] = ("attribution group: a constituent delta fell "
                           "below its own bound (boundary spill); "
                           "combined measure vs summed member bounds")
        rows.append(row)
        print(json.dumps(row), flush=True)

    total = cum[-1] - rtt
    floor = sum(r["floor"] for r in raw)
    out = {"circuit": config, "n": n, "device": describe(dev),
           "gates": len(cd["gates"]), "passes": len(ops),
           "method": "two-point prefix differencing: per-rep cost = "
                     f"(t({2 * reps}) - t({reps})) / {reps} per prefix, "
                     f"min of {samples} runs each, every run from |0> and "
                     "closed by a norm fetched to the host, so the fixed "
                     f"cost cancels; empty-chain residual {rtt:.4f} ms; "
                     "deltas below 97% of their own bound merged into "
                     "attribution groups to a fixpoint",
           "total_ms": round(total, 4),
           "bytes_floor_total_ms": round(sum(r["bytes_ms"] for r in raw), 4),
           "floor_total_ms": round(floor, 4),
           "pct_of_bound_total": (round(100 * floor / total, 1)
                                  if total > 0 else None),
           "hbm_bytes_per_s": HBM_BYTES_PER_S,
           "tf32_flop_per_s": TF32_FLOP_PER_S,
           "fp32_flop_per_s": FP32_FLOP_PER_S,
           "per_pass": [{"pass": r["ops"][0], "kind": r["kinds"][0],
                         "detail": r["details"][0],
                         "ms": round(r["ms"], 4),
                         "plane_bytes": r["plane_bytes"],
                         "floor_ms": round(r["floor"], 4)} for r in raw],
           "per_rep_prefix_ms": [round(v, 4) for v in per_rep],
           "raw_prefix_wall_ms": curve,
           "rows": rows}
    print(json.dumps(out), flush=True)  # the last line: the whole result
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m quantum_simulations_tpu_torch.bench.passes")
    ap.add_argument("--config", default="nonstab28")
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--samples", type=int, default=5)
    a = ap.parse_args(argv)
    run(config=a.config, reps=a.reps, samples=a.samples)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
