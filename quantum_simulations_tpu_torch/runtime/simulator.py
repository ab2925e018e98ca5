"""Single-device dense simulator on (re, im) planes: window, panel and
fused modes.

Port of ``quantum_simulations_tpu/runtime/simulator.py``.  Each mode
compiles the circuit to a schedule and runs each op as one pass of a
kernel, or, for a gate no kernel takes, through the reference's XLA
paths in plain torch (``ops/dense.py``):

* ``mode="window"``: the fixed-window schedule
  (``circuit/panelize.compile_window_schedule``): panels
  (``ops/panel_kernels.py``, with the merged diag run that follows one
  as its epilogue), merged diag runs (``ops/diag_kernels.py``),
  two-qubit gates (``ops/pair_kernels.py``) and bit permutations
  (``ops/bitperm_kernels.py``).
* ``mode="panel"``: the rotating-panel schedule
  (``compile_panel_schedule``): lane panels, bit rotations
  (``tiled_transpose``, one pass per rotation step) and generic gates; a
  128-wide panel directly followed by a rotation by 7 is one lane panel
  with the transposed store.
* ``mode="fused"`` (the default): the step compiler's ops
  (``circuit/fusion.compile_steps``): packed low panels (``lane_panel``)
  and single gates.

The state is split once into two float planes and stays planar for the
whole run.  Execution is out of place (each pass writes fresh planes and
the previous ones are released, so the card holds input and output of
one pass: 4 planes, 16 GiB in float32 at n = 30) or, in window mode with
``inplace`` (the reference's capacity tier), in place: every pass
updates the two planes through a kernel's aliasing instance, routed as
the reference routes its capacity tier, and no op holds a full-plane
temporary.  On an 80 GB card that is what lets n = 33 run at all (two
planes of 32 GiB; an out-of-place pass would need 128 GiB).  Compiled
schedules, with their W planes and diag operands already on the device,
are cached by mode, circuit hash, dtype, device and the ``QST_*``
switches.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..circuit.contract import circuit_hash, validate_circuit_dict
from ..circuit.fusion import LowPanelOp, compile_steps
from ..circuit.gates import is_diagonal
from ..circuit.panelize import (
    PANEL_W, BitPermGridOp, BitPermOp, DiagOp, DualPanelOp, MultiSwapOp,
    PanelOp, PhysGateOp, RotateOp, TransposeCrossOp, WindowPanelOp,
    compile_panel_schedule, compile_window_schedule, diag_phase_terms,
)
from ..ops import bitperm_kernels as bk
from ..ops import dense
from ..ops import diag_kernels as dk
from ..ops import pair_kernels as pq
from ..ops import panel_kernels as pk
from ..ops.cuda_build import store
from ..utils import timing
from ..utils.device import complex_dtype, float_dtype, resolve_device

_COMPILE_CACHE: dict = {}
# One per lookup of ``_COMPILE_CACHE`` by a ``build_*_fn``: a hit finds
# the compiled schedule, a miss compiles it (``qst.compile``).
SCHEDULE_CACHE_HITS = 0
SCHEDULE_CACHE_MISSES = 0


def reset_counts() -> None:
    global SCHEDULE_CACHE_HITS, SCHEDULE_CACHE_MISSES
    SCHEDULE_CACHE_HITS = SCHEDULE_CACHE_MISSES = 0


def _cached(key):
    """The compiled ``fn`` under ``key``, else None; counts the hit or
    miss."""
    global SCHEDULE_CACHE_HITS, SCHEDULE_CACHE_MISSES
    fn = _COMPILE_CACHE.get(key)
    if fn is None:
        SCHEDULE_CACHE_MISSES += 1
    else:
        SCHEDULE_CACHE_HITS += 1
    return fn


def _diag_terms(op):
    if op.terms is None:
        raise ValueError("a DiagOp runs from its Möbius terms; this one has "
                         "only its phase vector d")
    return op.terms


def apply_window_op(re, im, op, diag_terms=None, *, inplace: bool = False,
                    plain: bool = False):
    """Dispatch ONE window-schedule op on (re, im) planes.

    As the reference dispatches (its ``apply_window_op``): panels at pos
    0 go to ``lane_panel``, at pos >= 7 to ``positioned_panel``, (0, 7)
    pairs to ``dual_panel``, each with ``diag_terms`` (the merged diag
    run paired with it) as its epilogue.  A ``DiagOp`` goes to
    ``fused_diag`` with its Möbius terms: the scheduler gives every
    ``DiagOp`` its terms, with or without the phase vector ``d``, and
    the terms make the same phase as ``d``.  ``BitPermGridOp`` goes to
    ``bitperm_swap``, ``TransposeCrossOp`` to ``bitperm_transpose``.  A
    ``PhysGateOp`` goes to :func:`apply_gate`.  A ``MultiSwapOp`` (disjoint
    pairs of bits >= 7, n >= 11 by construction) is one ``bitperm_swap``
    pass, where the reference runs a multi-axis XLA transpose
    (``apply_multiswap_planar``); a ``BitPermOp`` runs its middle pairs
    so, then ``bitperm_cross``.

    ``inplace=True`` (the capacity tier) updates the given planes and
    returns them, every op through a kernel's in-place form: the
    ``BitPermGridOp`` as at most two ``bitperm_involution`` passes (the
    reference's ``split_planes`` holds a third plane), a ``MultiSwapOp``
    pair by pair as the reference routes it (simulator.py:225-251).
    ``plain=True`` runs the plain torch twins on any device.
    """
    kw = dict(inplace=inplace, plain=plain)
    if isinstance(op, DualPanelOp):
        return pk.dual_panel(
            re, im, op.first.W, op.first.pos, op.second.W, op.second.pos,
            straddle=op.pre_straddle, post_straddle=op.post_straddle,
            diag_terms=diag_terms, **kw)
    if isinstance(op, WindowPanelOp):
        if op.pos == 0:
            return pk.lane_panel(re, im, op.W, diag_terms=diag_terms, **kw)
        return pk.positioned_panel(re, im, op.W, op.pos,
                                   diag_terms=diag_terms, **kw)
    if diag_terms is not None:
        raise ValueError(f"a diag epilogue rides a panel, not a "
                         f"{type(op).__name__}")
    if isinstance(op, DiagOp):
        return dk.fused_diag(re, im, _diag_terms(op), **kw)
    if isinstance(op, BitPermGridOp):
        return bk.bitperm_swap(re, im, op.pairs, dict(op.grid_map), **kw)
    if isinstance(op, TransposeCrossOp):
        return bk.bitperm_transpose(re, im, **kw)
    if isinstance(op, PhysGateOp):
        return apply_gate(re, im, op.qubits, op.U, name=op.name, **kw)
    if isinstance(op, MultiSwapOp):
        if inplace:
            return _multiswap_inplace(re, im, op.pairs, plain)
        return bk.bitperm_swap(re, im, op.pairs, {}, plain=plain)
    if isinstance(op, BitPermOp):
        if op.mid_pairs:
            re, im = apply_window_op(re, im, MultiSwapOp(op.mid_pairs), **kw)
        return bk.bitperm_cross(re, im, op.cross, **kw)
    raise TypeError(f"no window op {type(op).__name__}")


def _multiswap_inplace(re, im, pairs, plain: bool):
    """The capacity tier's MultiSwapOp, one in-place pass per SWAP as the
    reference routes it: ``pair_update`` with both bits >= 10,
    ``midpair`` for (7..9, >= 10), else (span < 7, as (8, 9) or
    (10, 12)) a one-gate positioned panel."""
    for qa, qb in pairs:
        if pq.pair_update_supported(qa, qb) and min(qa, qb) >= 10:
            pq.pair_update(re, im, qa, qb, dense._SWAP4, inplace=True,
                           plain=plain)
        elif pq.midpair_supported(qa, qb):
            pq.midpair(re, im, qa, qb, dense._SWAP4, plain=plain)
        else:
            _panel_gate(re, im, (qa, qb), dense._SWAP4, plain)
    return re, im


def _panel_gate(re, im, qubits, U, plain: bool):
    """One gate on a window of at most 7 bits as a one-gate panel, in
    place: the lane panel when every bit is < 7, else a positioned panel
    at the lowest bit."""
    lo, hi = min(qubits), max(qubits)
    if hi < dense.LANE:
        W = dense.compose_low_panel([(tuple(qubits), U)], hi + 1)
        return pk.lane_panel(re, im, W, inplace=True, plain=plain)
    W = dense.compose_low_panel([(tuple(q - lo for q in qubits), U)],
                                hi - lo + 1)
    return pk.positioned_panel(re, im, W, lo, inplace=True, plain=plain)


def gate_route(qubits, U, n: int, inplace: bool = False) -> str:
    """The wrapper a gate runs through, by the reference's predicates:
    "fused_diag", "pair_update", "midpair", "mixed_pair",
    "mixed_low_pair", "bitperm_swap", "panel" or "dense"
    (``ops/dense.py``).

    Out of place (the standard tier, simulator.py:293-345): a
    non-diagonal 2q gate that is not a SWAP to ``pair_update`` when
    ``pair_update_supported``; any non-diagonal 2q gate with a lane bit
    to ``mixed_pair`` (other bit >= 10) or, from n = 10, to
    ``mixed_low_pair`` (other bit 7..9); a SWAP of two bits >= 7 to
    ``bitperm_swap`` with one pair from n = 10 (the reference's XLA
    swapaxes).  In place (the capacity tier, :281-324): every diagonal
    gate to ``fused_diag`` from its Möbius terms, SWAPs too to
    ``pair_update`` but only with both bits >= 10, (7..9, >= 10) to
    ``midpair``, then the mixed kernels; no ``bitperm_swap``.  What the
    reference then runs as an in-place XLA lincomb (a 1q gate, a 2q gate
    on two close bits >= 7) goes to a one-gate panel ("panel"): in plain
    torch it would hold full-plane temporaries, which an n = 33 state
    leaves no room for.
    """
    qubits = tuple(qubits)
    if inplace and is_diagonal(U):
        return "fused_diag"
    if len(qubits) == 2 and not is_diagonal(U):
        qa, qb = qubits
        swap = np.array_equal(np.asarray(U, np.complex128), dense._SWAP4)
        if ((not swap or inplace) and pq.pair_update_supported(qa, qb)
                and (not inplace or min(qa, qb) >= 10)):
            return "pair_update"
        if inplace and pq.midpair_supported(qa, qb):
            return "midpair"
        if pq.mixed_pair_supported(qa, qb):
            return "mixed_pair"
        if pq.mixed_low_pair_supported(qa, qb) and n >= 10:
            return "mixed_low_pair"
        if swap and min(qa, qb) >= 7 and n >= 10 and not inplace:
            return "bitperm_swap"
    if inplace and dense.planar_kind(qubits, U, n) == "lincomb":
        return "panel"
    return "dense"


def _capacity_guard_min() -> int:
    """State size (amplitudes) from which the capacity tier refuses the
    dense contraction (the reference's complex fallback) instead of
    risking an allocation failure: 2^27, ``QST_CAPACITY_GUARD_MIN``
    overrides (the reference's rule and default)."""
    return int(os.environ.get("QST_CAPACITY_GUARD_MIN", str(1 << 27)))


def capacity_guard(qubits, U, n: int, name=None) -> None:
    """Raise the reference's ``ValueError`` for a gate that the capacity
    tier would run through the dense contraction at 2^n >=
    ``_capacity_guard_min()``: it holds a full copy of the state."""
    qubits = tuple(qubits)
    if (1 << n) < _capacity_guard_min() or (
            dense.planar_kind(qubits, U, n) != "contract"):
        return
    name = (name if name not in (None, "?") else None) or f"{len(qubits)}q unitary"
    raise ValueError(
        f"capacity mode: gate {name} on qubits {qubits} has "
        f"no in-place planar kernel (non-diagonal {len(qubits)}-qubit "
        f"gate straddling the lane window). Decompose it into 1q/2q "
        f"gates (e.g. CCX -> H/T/CNOT) or run below n=29 where the "
        f"complex fallback fits."
    )


def apply_gate(re, im, qubits, U, *, inplace: bool = False,
               plain: bool = False, name=None):
    """One gate, routed by :func:`gate_route`; everything no kernel takes
    runs the plain torch gate paths of ``ops/dense.py`` (in place: their
    result copied back, after :func:`capacity_guard`)."""
    qubits = tuple(qubits)
    U = np.asarray(U)
    n = re.numel().bit_length() - 1
    route = gate_route(qubits, U, n, inplace)
    if route == "fused_diag":
        terms = tuple(diag_phase_terms(qubits, np.diag(U)).items())
        return dk.fused_diag(re, im, terms, inplace=True, plain=plain)
    if route == "midpair":
        return pq.midpair(re, im, *qubits, U, plain=plain)
    if route in ("pair_update", "mixed_pair", "mixed_low_pair"):
        return getattr(pq, route)(re, im, *qubits, U, inplace=inplace,
                                  plain=plain)
    if route == "bitperm_swap":
        return bk.bitperm_swap(re, im, (qubits,), {}, plain=plain)
    if route == "panel":
        return _panel_gate(re, im, qubits, U, plain)
    if not inplace:
        return dense.apply_gate_planar(re, im, qubits, U)
    capacity_guard(qubits, U, n, name)
    return store(re, im, dense.apply_gate_planar(re, im, qubits, U))


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
    """The op with its W planes (and straddler and diag operands) on the
    device."""
    if isinstance(op, DiagOp):
        return dataclasses.replace(
            op, terms=_prepare_terms(_diag_terms(op), device))
    if isinstance(op, BitPermOp):
        tables = bk.CrossTables.of(op.cross)
        if device.type == "cuda":
            tables.operand(device)
        return dataclasses.replace(op, cross=tables)
    if isinstance(op, (BitPermGridOp, TransposeCrossOp, MultiSwapOp,
                       PhysGateOp)):
        return op
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
    raise TypeError(f"no window op {type(op).__name__}")


def _prepare_terms(terms, device):
    """A merged diag run packed (and, on the card, uploaded) once."""
    dterms = dk.DiagTerms.of(terms)
    if dterms is not None and device.type == "cuda":
        dterms.operand(device)
    return dterms


def schedule(cd: dict, window: int = 7, inplace: bool = False) -> list:
    """The circuit's window schedule as ``[(op, diag_terms | None)]``:
    ``compile_window_schedule`` (terms-only diag merges in place and from
    n = 10, unless ``QST_DIAG_TERMS_ONLY=0`` out of place), then
    ``pair_panel_diag``."""
    n = cd["number_of_qubits"]
    terms_only = inplace or (
        n >= 10 and os.environ.get("QST_DIAG_TERMS_ONLY", "1") == "1")
    return pair_panel_diag(compile_window_schedule(
        cd, window=window, diag_terms_only=terms_only))


def prepare_schedule(paired, device, fdtype) -> list:
    """``[(op, DiagTerms | None)]`` with every operand on ``device``."""
    return [(_prepare(op, device, fdtype), _prepare_terms(dterms, device))
            for op, dterms in paired]


def _switches() -> tuple:
    env = os.environ.get
    return tuple(env(k, "") for k in (
        "QST_DIAG_TERMS_ONLY", "QST_PANEL_DIAG_FUSE", "QST_PANEL_DIAG_FUSE_MIN",
        "QST_BITPERM_DECOMP", "QST_PANEL_PAIR_FUSE", "QST_STRADDLE_FOLD",
        "QST_PANEL_GLOBAL_COALESCE", "QST_CAPACITY_GUARD_MIN"))


def _planar_fn(body, planar_io: bool):
    """The public ``fn`` of a compiled ``body(state)``, which runs on the
    planes of the list ``state = [re, im]`` and empties it: then the
    planes handed over are released after the first out-of-place pass,
    and the card holds the input and output of one pass and no more.
    ``fn(re, im)`` with ``planar_io`` (the caller's references stay
    the caller's), else ``fn(psi)``; ``fn.consume`` is ``body``."""
    if planar_io:
        def fn(re, im):
            return body([re, im])
    else:
        def fn(psi):
            return pk.from_planar(*body(list(pk.to_planar(psi))))
    fn.consume = body
    return fn


def resolve_inplace(inplace, n: int, device, fdtype=torch.float32) -> bool:
    """``inplace=None``: in place when the card cannot hold the four planes
    of an out-of-place pass with 2 GiB to spare (on an 80 GB H100, from
    n = 33); on the CPU the reference's rule, n >= 29 (a 16 GiB chip's)."""
    if inplace is not None:
        return bool(inplace)
    dev = torch.device(device)
    if dev.type != "cuda":
        return n >= 29
    total = torch.cuda.mem_get_info(dev)[1]
    itemsize = torch.empty((), dtype=fdtype).element_size()
    return 4 * (1 << n) * itemsize + (2 << 30) > total


def plain_route(plain: bool, fdtype: torch.dtype) -> bool:
    """Whether a schedule runs on the plain torch twins: when asked, and
    always for float64 planes.  The kernels take float32 planes only (the
    TPU kernels never ran float64 either), so complex128 runs every op
    through the twins, on the card too, as the reference runs its XLA
    modes in any dtype.  A choice made by dtype, not a fallback: a
    float64 plane handed to a kernel wrapper still raises."""
    return plain or fdtype == torch.float64


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

    ``inplace=True`` (the reference's capacity tier) runs every pass in
    place: with ``planar_io`` the planes given to ``fn`` are updated and
    returned (the reference donates them).  Before anything runs, a gate
    that would need the dense contraction on a state of at least
    ``QST_CAPACITY_GUARD_MIN`` amplitudes raises the reference's
    ``ValueError`` (:func:`capacity_guard`).  ``inplace=None`` resolves by
    :func:`resolve_inplace`.  Out of place, the caller's planes are never
    written.  ``plain=True`` runs every op through the plain torch twins
    (the float64 reference on the card).
    """
    dev = resolve_device(device)
    cdtype = complex_dtype(dtype)
    fdtype = float_dtype(cdtype)
    plain = plain_route(plain, fdtype)
    cd = validate_circuit_dict(circuit_dict)
    n = cd["number_of_qubits"]
    inplace = resolve_inplace(inplace, n, dev, fdtype)
    key = ("window", circuit_hash(cd), str(cdtype), window, planar_io,
           str(dev), plain, inplace, _switches())
    cached = _cached(key)
    if cached is not None:
        return cached

    with timing.span("qst.compile"):
        with timing.span("qst.compile.schedule"):
            paired = schedule(cd, window, inplace)
            if inplace:
                for op, _ in paired:
                    if (isinstance(op, PhysGateOp) and gate_route(
                            op.qubits, op.U, n, True) == "dense"):
                        capacity_guard(op.qubits, op.U, n, op.name)
        with timing.span("qst.compile.prepare"):
            prepared = prepare_schedule(paired, dev, fdtype)

    def body(state):
        re, im = state
        state.clear()
        for op, dterms in prepared:
            re, im = apply_window_op(re, im, op, dterms, inplace=inplace,
                                     plain=plain)
        return re, im

    fn = _COMPILE_CACHE[key] = _planar_fn(body, planar_io)
    return fn


# ---------------------------------------------------------------------------
# Panel mode: the rotating-panel schedule
# ---------------------------------------------------------------------------

def pair_panel_rotate(ops, enabled: bool = True) -> list:
    """Peephole over a panel schedule: ``[(op, rotated), ...]``.

    A 128-wide ``PanelOp`` directly followed by ``RotateOp(7)`` becomes
    one ``lane_panel`` pass with the transposed store (``rotated``), the
    pass the reference's ``panel_apply_planar(rotate=True)`` builds for
    this transition; every other op stays as it is (a rotation by
    another r and a panel before a gate are never swallowed).
    ``enabled=False`` keeps the two ops apart, as the reference's
    executor runs them (``chip_smoke.py`` times both forms).
    """
    out = []
    i = 0
    while i < len(ops):
        op = ops[i]
        nxt = ops[i + 1] if i + 1 < len(ops) else None
        if (enabled and isinstance(op, PanelOp) and op.W.shape[0] == pk.LANES
                and isinstance(nxt, RotateOp) and nxt.r == PANEL_W):
            out.append((op, True))
            i += 2
        else:
            out.append((op, False))
            i += 1
    return out


def panel_schedule(cd: dict, window: int = PANEL_W,
                   fuse_rotate: bool = True) -> list:
    """The circuit's panel schedule as ``[(op, rotated)]``, one pass an
    entry: ``compile_panel_schedule`` through :func:`pair_panel_rotate`
    (``fuse_rotate``), then the final un-rotation (kept apart, as the
    reference runs it), each rotation split into its
    ``dense._rotation_steps`` (a ``RotateOp`` per transpose)."""
    n = validate_circuit_dict(cd)["number_of_qubits"]
    ops, shift = compile_panel_schedule(cd, window=window)
    items = pair_panel_rotate(ops, fuse_rotate)
    if shift % n:
        items.append((RotateOp((n - shift) % n), False))
    out = []
    for op, rotated in items:
        if isinstance(op, RotateOp):
            out.extend((RotateOp(s), False)
                       for s in dense._rotation_steps(op.r, n))
        else:
            out.append((op, rotated))
    return out


def apply_panel_op(re, im, op, rotated: bool = False, *, plain: bool = False):
    """Dispatch ONE pass of a panel schedule on (re, im) planes: a
    ``PanelOp`` (or a ``LowPanelOp`` of the fused steps) to ``lane_panel``
    (``rotated``: its transposed store), a ``RotateOp`` of one rotation
    step r to ``tiled_transpose`` of the (2^(n - r), 2^r) view, a gate
    (``PhysGateOp`` / ``GateOp``) to :func:`apply_gate`."""
    if isinstance(op, (PanelOp, LowPanelOp)):
        return pk.lane_panel(re, im, op.W, rotate=rotated, plain=plain)
    if rotated:
        raise ValueError(f"only a panel stores rotated, not a {type(op).__name__}")
    if isinstance(op, RotateOp):
        n = re.numel().bit_length() - 1
        return bk.tiled_transpose(re, im, 1 << (n - op.r), 1 << op.r,
                                  plain=plain)
    return apply_gate(re, im, op.qubits, op.U, name=op.name, plain=plain)


def prepare_passes(items, device, fdtype) -> list:
    """``[(op, flag)]`` with each panel's W planes on ``device``."""
    return [(dataclasses.replace(op, W=pk.w_planes(op.W, device, fdtype))
             if isinstance(op, (PanelOp, LowPanelOp)) else op, flag)
            for op, flag in items]


def run_passes(prepared, plain: bool = False):
    """The body of the panel and fused modes over ``prepared`` passes
    ``[(op, rotated)]`` (:func:`prepare_passes`): each pass out of place,
    the previous planes released as the next ones are bound."""
    def body(state):
        re, im = state
        state.clear()
        for op, rotated in prepared:
            re, im = apply_panel_op(re, im, op, rotated, plain=plain)
        return re, im

    return body


def build_panel_circuit_fn(
    circuit_dict: dict,
    *,
    dtype="complex64",
    window: int = PANEL_W,
    planar_io: bool = False,
    device="cuda",
    plain: bool = False,
):
    """``fn(psi) -> psi`` (or ``fn(re, im) -> (re, im)`` with
    ``planar_io``) running the circuit's rotating-panel schedule
    (:func:`panel_schedule`), out of place; the state comes back in
    logical bit order.  ``plain=True`` runs the plain torch twins."""
    dev = resolve_device(device)
    cdtype = complex_dtype(dtype)
    plain = plain_route(plain, float_dtype(cdtype))
    cd = validate_circuit_dict(circuit_dict)
    key = ("panel", circuit_hash(cd), str(cdtype), window, planar_io,
           str(dev), plain, _switches())
    cached = _cached(key)
    if cached is not None:
        return cached
    with timing.span("qst.compile"):
        with timing.span("qst.compile.schedule"):
            items = panel_schedule(cd, window)
        with timing.span("qst.compile.prepare"):
            prepared = prepare_passes(items, dev, float_dtype(cdtype))
    fn = _COMPILE_CACHE[key] = _planar_fn(run_passes(prepared, plain),
                                          planar_io)
    return fn


# ---------------------------------------------------------------------------
# Fused mode: the step compiler's ops
# ---------------------------------------------------------------------------

def fused_ops(cd: dict, *, use_fusion: bool = True,
              panel_width: int | None = PANEL_W) -> list:
    """The fused mode's ops, one pass each: ``compile_steps`` with k = n
    (every gate local on one device), each step's local then non-local
    ops, as the reference's ``build_circuit_fn`` runs them."""
    n = validate_circuit_dict(cd)["number_of_qubits"]
    steps = compile_steps(cd, k=n, use_fusion=use_fusion,
                          panel_width=panel_width)
    return [op for s in steps for op in (s.local_ops + s.nonlocal_ops)]


def build_circuit_fn(
    circuit_dict: dict,
    *,
    dtype="complex64",
    use_fusion: bool = True,
    panel_width: int | None = PANEL_W,
    planar_io: bool = False,
    device="cuda",
    plain: bool = False,
):
    """``fn(psi) -> psi`` (or ``fn(re, im) -> (re, im)`` with
    ``planar_io``) running the fused mode's ops (:func:`fused_ops`), out
    of place: a ``LowPanelOp`` is one ``lane_panel`` pass (on the card a
    panel up to 128 wide, ``panel_width`` <= 7), a ``GateOp`` goes to
    :func:`apply_gate`.  ``plain=True`` runs the plain torch twins."""
    dev = resolve_device(device)
    cdtype = complex_dtype(dtype)
    plain = plain_route(plain, float_dtype(cdtype))
    cd = validate_circuit_dict(circuit_dict)
    key = ("fused", circuit_hash(cd), str(cdtype), use_fusion, panel_width,
           planar_io, str(dev), plain, _switches())
    cached = _cached(key)
    if cached is not None:
        return cached
    with timing.span("qst.compile"):
        with timing.span("qst.compile.schedule"):
            ops = fused_ops(cd, use_fusion=use_fusion, panel_width=panel_width)
        with timing.span("qst.compile.prepare"):
            prepared = prepare_passes([(op, False) for op in ops], dev,
                                      float_dtype(cdtype))
    fn = _COMPILE_CACHE[key] = _planar_fn(run_passes(prepared, plain),
                                          planar_io)
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

    ``mode='fused'`` (the default; any mode not named below, as in the
    reference): the step compiler's packed low panels and single gates,
    honouring ``use_fusion`` and ``panel_width``.  ``'panel'``: the
    rotating-panel schedule.  ``'window'``: the fixed-window schedule.
    ``'auto'``: window from n = 14 when most gates pack into panels,
    else fused (the reference's rule).

    ``segment_gates``: run the circuit as several sub-circuits of at
    most ~``segment_gates`` gates, cut at the lowest-qubit-locality
    boundaries (``circuit.dag.partition``, the reference's
    ``strategy='locality'``).  As in
    the reference, the recursive call does not pass ``segment_gates``
    on, so each part runs as one schedule.  ``donate_input`` keeps the
    reference's meaning (the caller will not touch ``initial_state``
    again): torch has no donation, so the call drops its reference to the
    input as soon as the planes are built, and a tensor the caller holds
    no name of is freed there (a c128 input at n = 31 is 32 GiB of the
    card's 80).  Out-of-place execution never writes it.
    """
    # The span opens here, not in a decorator: a wrapper's frame would
    # hold ``initial_state`` for the whole call, past ``donate_input``.
    with timing.span("qst.simulate"):
        cd = validate_circuit_dict(circuit_dict)
        n = cd["number_of_qubits"]
        dev = resolve_device(device)
        cdtype = complex_dtype(dtype)
        if segment_gates is not None and len(cd["gates"]) > segment_gates:
            from ..circuit.dag import partition

            n_seg = -(-len(cd["gates"]) // segment_gates)
            parts = partition(cd, n_seg)
            owned = donate_input or initial_state is None
            # The state lives only in ``box`` between parts, so each part's
            # call holds the last reference to its input and can drop it.
            box = [_as_state(initial_state, n, cdtype, dev)]
            if donate_input:
                del initial_state
            for part in parts:
                if not part:
                    continue
                sub = {"number_of_qubits": n,
                       "gates": [cd["gates"][i] for i in part]}
                box.append(simulate(
                    sub, dtype=dtype, use_fusion=use_fusion,
                    panel_width=panel_width, mode=mode,
                    initial_state=box.pop(), donate_input=owned,
                    device=dev, plain=plain))
                owned = True  # each later part's input is the previous output
            return box.pop()
        if mode == "auto":
            from ..circuit.panelize import window_stats

            st = window_stats(cd)
            dense_enough = st["hbm_passes"] <= max(4, len(cd["gates"]) // 2)
            mode = "window" if (n >= 14 and dense_enough) else "fused"
        kw = dict(dtype=cdtype, planar_io=True, device=dev, plain=plain)
        if mode == "window":
            fn = build_window_circuit_fn(cd, **kw)
        elif mode == "panel":
            fn = build_panel_circuit_fn(cd, **kw)
        else:
            fn = build_circuit_fn(cd, use_fusion=use_fusion,
                                  panel_width=panel_width, **kw)
        if initial_state is None:
            state = list(dense.zero_state_planar(n, float_dtype(cdtype), dev))
        else:
            state = list(pk.to_planar(
                _as_state(initial_state, n, cdtype, dev)))
            if donate_input:
                del initial_state
        with timing.span("qst.passes"):
            re, im = fn.consume(state)
        with timing.span("qst.from_planar"):
            return pk.from_planar(re, im)


def simulate_np(circuit_dict: dict, **kw) -> np.ndarray:
    """Like :func:`simulate` (``device`` too) but returns host numpy."""
    return simulate(circuit_dict, **kw).cpu().numpy()
