"""Per-op profile of a real window schedule on the card.

``kernel_bw`` measures synthetic op classes; this module times the ops
of a compiled circuit schedule (panels, merged diag runs, bit
permutations, straddling two-qubit gates), one representative of each
class, so an end-to-end time can be attributed pass by pass.  Each op
runs through the production dispatcher, ``runtime/simulator
.apply_window_op``, on the schedule of the JAX package's profile,
``compile_window_schedule(cd, diag_terms_only=True)`` (diag runs not
yet paired with a panel).  It also races the straddler policies: a
two-qubit gate through the plain torch gate (``ops/dense.py``) or the
complex torch path against the pair kernels.

Each time is :func:`bench.device_s`: CUDA events around ``iters`` chained
calls, the median of ``reps`` runs after one warm call.

Run: ``python -m quantum_simulations_tpu_torch.bench.opprof``.
"""
from __future__ import annotations

import json
import os

from . import describe, device_s, setup_platform, warm_grant


def _class_key(op) -> str:
    from ..circuit import gates as G
    from ..circuit.panelize import (
        BitPermGridOp, BitPermOp, DiagOp, DualPanelOp, MultiSwapOp,
        PhysGateOp, TransposeCrossOp, WindowPanelOp,
    )

    if isinstance(op, DualPanelOp):
        return f"dualpanel@{op.first.pos}+{op.second.pos}"
    if isinstance(op, WindowPanelOp):
        return f"panel@{op.pos}"
    if isinstance(op, MultiSwapOp):
        return f"multiswap{len(op.pairs)}"
    if isinstance(op, BitPermGridOp):
        return f"bitperm_grid{len(op.pairs)}"
    if isinstance(op, TransposeCrossOp):
        return "transpose_cross"
    if isinstance(op, BitPermOp):
        return f"bitperm_mid{len(op.mid_pairs)}"
    if isinstance(op, DiagOp):
        return f"diag{len(op.qubits)}"
    if not isinstance(op, PhysGateOp):
        raise TypeError(f"no window op {type(op).__name__}")
    if G.is_diagonal(op.U):
        return f"diag{len(op.qubits)}"
    if len(op.qubits) == 2:
        kind = op.name if op.name in ("SWAP", "CNOT") else "2q"
        return f"{kind}@lo{min(op.qubits)}"
    return f"generic{len(op.qubits)}"


def _planes(n: int, dev):
    import torch

    return (torch.full((1 << n,), 0.5, device=dev),
            torch.full((1 << n,), 0.25, device=dev))


def _per_pass(fn, n: int, dev, iters: int, reps: int) -> float:
    """Seconds of one ``fn(re, im) -> (re, im)`` pass, chained."""
    state = list(_planes(n, dev))

    def step():
        state[:] = fn(*state)

    return device_s(step, iters, reps, dev)


def _row(per: float, n: int) -> dict:
    # both planes read and written once
    return {"s_per_pass": per, "GBs": 4 * (1 << n) * 4 / per / 1e9}


def profile_schedule(circuit_dict: dict, *, iters: int = 8,
                     reps: int = 3) -> dict:
    """Time every op class of the window schedule of ``circuit_dict``:
    per class its count, ``s_per_pass``, ``GBs`` (both planes read and
    written) and ``est_total_s`` (count x s_per_pass)."""
    import torch

    from ..circuit.panelize import compile_window_schedule
    from ..runtime import simulator

    dev = setup_platform()
    cd = circuit_dict
    n = cd["number_of_qubits"]
    terms_only = n >= 10 and os.environ.get("QST_DIAG_TERMS_ONLY", "1") == "1"
    ops = compile_window_schedule(cd, diag_terms_only=terms_only)

    classes: dict[str, dict] = {}
    for op in ops:
        e = classes.setdefault(_class_key(op), {"count": 0, "rep": op})
        e["count"] += 1

    out = {}
    est_total = 0.0
    for k, e in sorted(classes.items()):
        (op, _), = simulator.prepare_schedule([(e["rep"], None)], dev,
                                              torch.float32)
        per = _per_pass(lambda re, im, op=op: simulator.apply_window_op(
            re, im, op), n, dev, iters, reps)
        out[k] = {"count": e["count"], **_row(per, n),
                  "est_total_s": per * e["count"]}
        est_total += per * e["count"]
    return {"n": n, "ops": len(ops), "classes": out, "est_total_s": est_total}


def _complex_gate(re, im, qubits, U):
    """The plain complex path: the planes joined into one complex tensor,
    the gate as a complex ``tensordot`` over its qubits' axes, split back
    into planes."""
    import torch

    from ..ops import panel_kernels as pk

    psi = pk.from_planar(re, im)
    n = psi.numel().bit_length() - 1
    k = len(qubits)
    axes = [n - 1 - q for q in qubits]  # bit q is axis n - 1 - q
    u = torch.as_tensor(U, dtype=psi.dtype, device=psi.device)
    y = torch.tensordot(u.reshape((2,) * (2 * k)), psi.view((2,) * n),
                        dims=(list(range(k, 2 * k)), axes))
    return pk.to_planar(torch.movedim(y, list(range(k)), axes).reshape(-1))


def straddler_policies(n: int = 26, *, iters: int = 8, reps: int = 3) -> dict:
    """Race straddler implementations: the plain torch gate and the
    complex torch path against the pair kernels."""
    import numpy as np
    import torch

    from ..circuit import gates as G
    from ..ops import dense
    from ..ops import pair_kernels as pq

    dev = setup_platform()
    hi, lo_col, lo_row = n - 2, 8, max(13, n - 9)
    SW, CX = G.SWAP(), G.CNOT()
    U4 = np.linalg.qr(np.random.default_rng(7).normal(size=(4, 4))
                      + 1j * np.random.default_rng(8).normal(size=(4, 4)))[0]
    cases = {}
    for tag, U in (("swap", SW), ("cnot", CX), ("dense2q", U4)):
        plain = "transpose" if tag == "swap" else "flip" if tag == "cnot" else "gate"
        cases[f"{tag}_torch_{plain}"] = (
            lambda re, im, U=U: dense.apply_gate_planar(re, im, (hi, lo_col), U))
        cases[f"{tag}_pair_col"] = (
            lambda re, im, U=U: pq.pair_update(re, im, hi, lo_col, U))
        cases[f"{tag}_pair_row"] = (
            lambda re, im, U=U: pq.pair_update(re, im, hi, lo_row, U))
    cases.update({
        # (lane, high) pairs: the plain complex path against the kernel
        "swapmixed_torch": lambda re, im: _complex_gate(re, im, (hi, 3), SW),
        "swapmixed_kernel": lambda re, im: pq.mixed_pair(re, im, hi, 3, SW),
        "cnotmixed_torch": lambda re, im: _complex_gate(re, im, (3, hi), CX),
        "cnotmixed_kernel": lambda re, im: pq.mixed_pair(re, im, 3, hi, CX),
    })

    # two disjoint SWAPs, (n-1, 8) and (n-2, 9), as ONE torch permute
    shape = (2, 2, 1 << (n - 12), 2, 2, 1 << 8)
    perm = (3, 4, 2, 0, 1, 5)

    def multi_swap(re, im):
        return tuple(torch.permute(x.view(shape), perm).contiguous().view(-1)
                     for x in (re, im))

    cases["two_swaps_one_transpose"] = multi_swap
    out = {name: _row(_per_pass(fn, n, dev, iters, reps), n)
           for name, fn in cases.items()}
    return {"n": n, "cases": out}


def run(n: int = 26, *, iters: int = 8, reps: int = 3) -> dict:
    """qft(n)'s and non_stabilizer(n + 2)'s schedules by op class, and
    the straddler race at n."""
    from ..circuit import library as L

    dev = setup_platform()
    warm_grant(dev)
    return {
        "device": describe(dev),
        "qft": profile_schedule(L.qft(n), iters=iters, reps=reps),
        "nonstab": profile_schedule(
            L.non_stabilizer(n + 2), iters=iters, reps=reps),
        "policies": straddler_policies(n, iters=iters, reps=reps),
    }


if __name__ == "__main__":
    print(json.dumps(run(), indent=1))
