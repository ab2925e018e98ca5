"""Single-device dense simulator, window mode, on (re, im) planes.

Port of the window half of ``quantum_simulations_tpu/runtime/simulator.py``:
the circuit compiles to a fixed-window schedule
(``circuit/panelize.compile_window_schedule``) and each op runs as one
pass of a panel kernel (``ops/panel_kernels.py``).  The state is split
once into two float planes and stays planar for the whole run.

Execution is out of place: each pass writes fresh planes, so the card
holds input and output of one pass (4 planes, 16 GiB in float32 at
n = 30).  Compiled schedules, with their W planes already on the device,
are cached by circuit hash, dtype, device and the ``QST_*`` switches.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..circuit.contract import circuit_hash, validate_circuit_dict
from ..circuit.panelize import (
    DiagOp, DualPanelOp, WindowPanelOp, compile_window_schedule,
)
from ..ops import dense
from ..ops import panel_kernels as pk
from ..utils.device import complex_dtype, float_dtype, resolve_device

_COMPILE_CACHE: dict = {}

# The reference kernel (quantum_simulations_tpu/ops/pallas_kernels.py or
# its XLA path) that each op type without a port waits for.
_WAITS_FOR = {
    "PhysGateOp": "pair_update_planar / mixed_pair_planar / midpair_planar"
                  " / mixed_low_pair_planar (or dense.apply_gate_planar)",
    "DiagOp": "fused_diag_planar",
    "MultiSwapOp": "apply_multiswap_planar (pair_update_planar in place)",
    "BitPermOp": "bitperm_cross_planar",
    "BitPermGridOp": "bitperm_swap_planar",
    "TransposeCrossOp": "bitperm_transpose_planar",
}


def _unported(op) -> NotImplementedError:
    name = type(op).__name__
    return NotImplementedError(
        f"{name} has no kernel in the port yet: it waits for the port of "
        f"{_WAITS_FOR.get(name, 'its reference kernel')}")


def _no_epilogue(op) -> NotImplementedError:
    return NotImplementedError(
        f"{type(op).__name__} with a fused diag epilogue: waits for the "
        f"port of _theta_matmul / fused_diag_planar (ops/diag_plan.py)")


def apply_window_op(re, im, op, diag_terms=None, *, plain: bool = False):
    """Dispatch ONE window-schedule op on (re, im) planes.

    Panels at pos 0 go to ``lane_panel``, at pos >= 7 to
    ``positioned_panel``, (0, 7) pairs to ``dual_panel``.  Every other op
    type, and a fused diag epilogue, raises ``NotImplementedError``.
    ``plain=True`` runs the plain torch twins on any device.
    """
    if diag_terms is not None:
        raise _no_epilogue(op)
    if isinstance(op, DualPanelOp):
        return pk.dual_panel(
            re, im, op.first.W, op.first.pos, op.second.W, op.second.pos,
            straddle=op.pre_straddle, post_straddle=op.post_straddle,
            plain=plain)
    if isinstance(op, WindowPanelOp):
        if op.pos == 0:
            return pk.lane_panel(re, im, op.W, plain=plain)
        return pk.positioned_panel(re, im, op.W, op.pos, plain=plain)
    raise _unported(op)


def pair_panel_diag(ops, enabled: bool | None = None):
    """Peephole over a window schedule: [(op, fused_diag_terms), ...].

    A WindowPanelOp or DualPanelOp immediately followed by a terms-only
    DiagOp of at least ``QST_PANEL_DIAG_FUSE_MIN`` (48) terms becomes one
    pass with the diag as an epilogue, as in the reference.
    ``QST_PANEL_DIAG_FUSE=0`` disables it.
    """
    if enabled is None:
        enabled = os.environ.get("QST_PANEL_DIAG_FUSE", "1") != "0"
    min_terms = int(os.environ.get("QST_PANEL_DIAG_FUSE_MIN", "48"))
    out = []
    i = 0
    while i < len(ops):
        op = ops[i]
        nxt = ops[i + 1] if i + 1 < len(ops) else None
        if (enabled and isinstance(op, (WindowPanelOp, DualPanelOp))
                and isinstance(nxt, DiagOp) and nxt.terms is not None
                and len(nxt.terms) >= min_terms):
            out.append((op, nxt.terms))
            i += 2
        else:
            out.append((op, None))
            i += 1
    return out


def _prepare(op, device, fdtype):
    """The op with its W planes (and straddler operands) on the device."""
    if isinstance(op, WindowPanelOp):
        return dataclasses.replace(op, W=pk.w_planes(op.W, device, fdtype))
    if isinstance(op, DualPanelOp):
        pre = pk.Straddle.of(op.pre_straddle)
        post = pk.Straddle.of(op.post_straddle)
        for s in (pre, post):
            if s is not None and device.type == "cuda":
                s.operand(device)
        return dataclasses.replace(
            op, first=_prepare(op.first, device, fdtype),
            second=_prepare(op.second, device, fdtype),
            pre_straddle=pre, post_straddle=post)
    raise _unported(op)


def _switches() -> tuple:
    env = os.environ.get
    return tuple(env(k, "") for k in (
        "QST_DIAG_TERMS_ONLY", "QST_PANEL_DIAG_FUSE", "QST_PANEL_DIAG_FUSE_MIN",
        "QST_BITPERM_DECOMP", "QST_PANEL_PAIR_FUSE", "QST_STRADDLE_FOLD",
        "QST_PANEL_GLOBAL_COALESCE"))


def build_window_circuit_fn(
    circuit_dict: dict,
    *,
    dtype="complex64",
    window: int = 7,
    inplace: bool | None = None,
    planar_io: bool = False,
    device="cuda",
    plain: bool = False,
):
    """``fn(psi) -> psi`` (or ``fn(re, im) -> (re, im)`` with
    ``planar_io``) running the circuit's window schedule.

    ``inplace=True`` (the reference's capacity tier) raises
    ``NotImplementedError`` until the capacity slice; ``None`` means
    False.  Execution is out of place, so the caller's planes are never
    written (the reference's ``donate`` has nothing to do here).
    ``plain=True`` runs every op through the plain torch twins (the
    float64 reference on the card).
    """
    if inplace:
        raise NotImplementedError(
            "inplace=True (capacity tier) waits for the in-place kernels")
    dev = resolve_device(device)
    cdtype = complex_dtype(dtype)
    fdtype = float_dtype(cdtype)
    cd = validate_circuit_dict(circuit_dict)
    n = cd["number_of_qubits"]
    terms_only = n >= 10 and os.environ.get("QST_DIAG_TERMS_ONLY", "1") == "1"
    key = ("window", circuit_hash(cd), str(cdtype), window, planar_io,
           str(dev), plain, _switches())
    cached = _COMPILE_CACHE.get(key)
    if cached is not None:
        return cached

    ops = compile_window_schedule(cd, window=window,
                                  diag_terms_only=terms_only)
    paired = pair_panel_diag(ops)
    for op, dterms in paired:  # raise before any pass runs
        if dterms is not None:
            raise _no_epilogue(op)
    prepared = [_prepare(op, dev, fdtype) for op, _ in paired]

    def body(re, im):
        for op in prepared:
            re, im = apply_window_op(re, im, op, plain=plain)
        return re, im

    if planar_io:
        fn = body
    else:
        def fn(psi):
            re, im = body(*pk.to_planar(psi))
            return pk.from_planar(re, im)

    _COMPILE_CACHE[key] = fn
    return fn


def _as_state(initial_state, n: int, cdtype, dev) -> torch.Tensor:
    if initial_state is None:
        return dense.zero_state(n, cdtype, dev)
    if isinstance(initial_state, torch.Tensor):
        return initial_state.to(device=dev, dtype=cdtype)
    return torch.as_tensor(np.asarray(initial_state), device=dev).to(cdtype)


def simulate(
    circuit_dict: dict,
    *,
    dtype="complex64",
    use_fusion: bool = True,
    panel_width: int | None = 7,
    mode: str = "fused",
    initial_state=None,
    segment_gates: int | None = None,
    donate_input: bool = False,
    device="cuda",
    plain: bool = False,
) -> torch.Tensor:
    """Run a circuit on one device, return the final statevector (a
    complex tensor on ``device``).

    ``mode='window'`` runs the fixed-window kernel schedule; ``'auto'``
    resolves as in the reference and runs when it resolves to window.
    The reference's other modes raise ``NotImplementedError``.

    ``segment_gates``: run the circuit as several sub-circuits of at
    most ~``segment_gates`` gates, cut at the lowest-qubit-locality
    boundaries (``circuit.dag.partition``, the reference's
    ``strategy='locality'``).  As in
    the reference, the recursive call does not pass ``segment_gates``
    on, so each part runs as one schedule.  ``donate_input`` keeps the
    reference's meaning (the caller will not touch ``initial_state``
    again); out-of-place execution never writes it.
    """
    cd = validate_circuit_dict(circuit_dict)
    n = cd["number_of_qubits"]
    dev = resolve_device(device)
    cdtype = complex_dtype(dtype)
    if segment_gates is not None and len(cd["gates"]) > segment_gates:
        from ..circuit.dag import partition

        n_seg = -(-len(cd["gates"]) // segment_gates)
        parts = partition(cd, n_seg)
        psi = _as_state(initial_state, n, cdtype, dev)
        first = True
        for part in parts:
            if not part:
                continue
            sub = {"number_of_qubits": n,
                   "gates": [cd["gates"][i] for i in part]}
            psi = simulate(sub, dtype=dtype, use_fusion=use_fusion,
                           panel_width=panel_width, mode=mode,
                           initial_state=psi,
                           donate_input=(donate_input or not first
                                         or initial_state is None),
                           device=dev, plain=plain)
            first = False
        return psi
    if mode == "auto":
        from ..circuit.panelize import window_stats

        st = window_stats(cd)
        dense_enough = st["hbm_passes"] <= max(4, len(cd["gates"]) // 2)
        mode = "window" if (n >= 14 and dense_enough) else "fused"
    if mode != "window":
        raise NotImplementedError(
            f"mode={mode!r}: the port runs window mode only so far")
    fn = build_window_circuit_fn(cd, dtype=cdtype, planar_io=True,
                                 device=dev, plain=plain)
    if initial_state is None:
        re, im = dense.zero_state_planar(n, float_dtype(cdtype), dev)
    else:
        re, im = pk.to_planar(_as_state(initial_state, n, cdtype, dev))
    return pk.from_planar(*fn(re, im))
