"""Panel schedulers (the JAX package's
``quantum_simulations_tpu/circuit/panelize.py``, copied and kept
numpy-only: the port imports nothing of the JAX package).

``compile_window_schedule`` turns a circuit into a short list of ops:
panels on fixed bit windows ``[pos, pos+w)`` with ``pos == 0`` or
``pos >= 7`` (:class:`WindowPanelOp`), pairs of them fused into one pass
(:class:`DualPanelOp`), merged diagonal runs, SWAP networks and generic
gates.  The passes that shape the list read the same ``QST_*`` switches
as the reference, so both packages emit the same op list for the same
circuit and each kernel can be checked op against op.

``compile_panel_schedule`` is the rotating-panel schedule of
``mode="panel"``: panels on the low window (:class:`PanelOp`), bit
rotations that slide the next qubits into it (:class:`RotateOp`) and
generic gates, with the residual rotation to undo at the end.

Every rate and time quoted in the comments below is the JAX package's,
measured on a TPU v5e: it explains why the schedule has the shape it
has, which the port keeps, and says nothing of the port's speed on a
GPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import gates as G
from .contract import validate_circuit_dict
from .fusion import GateOp

PANEL_W = 7  # lane window width (128 = 2^7 lanes)


@dataclass(frozen=True)
class PanelOp:
    """Fused 2^w x 2^w unitary on the current low window."""
    W: np.ndarray
    n_fused: int


@dataclass(frozen=True)
class RotateOp:
    """Rotate index-bit positions down by r (one transpose)."""
    r: int


@dataclass(frozen=True)
class PhysGateOp:
    """A gate applied at explicit physical bit positions (generic path)."""
    qubits: tuple[int, ...]
    U: np.ndarray
    name: str = "?"


@dataclass(frozen=True)
class DiagOp:
    """A diagonal operator held as its 2^m phase VECTOR.

    Merged diagonal runs reach m=13; the full matrix would be a 67M-
    entry literal scanned by every trace-time structure check — the
    vector form keeps scheduling, tracing, and the broadcast-multiply
    executor all O(2^m).
    """
    qubits: tuple[int, ...]
    d: np.ndarray
    name: str = "fused-diag"
    #: Möbius phase decomposition: tuple of ((qubit subset), coeff)
    #: with angle(d[pattern]) == sum of coeff over set subsets.  The
    #: capacity tier's fused Pallas diag kernel consumes these (it
    #: computes theta from index bits in-kernel — no 2^m gather).
    terms: tuple = None


def diag_phase_terms(qubits: tuple, d) -> dict:
    """Möbius decomposition of a diagonal's phase into bit-product terms.

    Returns {qubit-subset-tuple: coeff} with
    ``angle(d[pattern]) == sum(coeff * prod(bits in subset))`` — an
    exact linear identity (any 2*pi branch choice in ``np.angle``
    cancels through cos/sin).  The () key is the global-phase term.
    """
    d = np.asarray(d)
    if d.ndim == 2:
        d = np.diag(d)
    a = len(qubits)
    theta = np.angle(d)
    terms: dict = {}
    for S in range(1 << a):
        c, T = 0.0, S
        while True:
            c += (-1.0) ** bin(S ^ T).count("1") * theta[T]
            if T == 0:
                break
            T = (T - 1) & S
        if abs(c) > 1e-12:
            qs = tuple(qubits[j] for j in range(a) if (S >> (a - 1 - j)) & 1)
            terms[qs] = terms.get(qs, 0.0) + c
    return terms


def compile_panel_schedule(
    circuit_dict: dict,
    *,
    window: int = PANEL_W,
    max_phases_without_progress: int | None = None,
) -> tuple[list, int]:
    """Compile a circuit into [PanelOp | RotateOp | PhysGateOp] ops.

    Returns ``(ops, final_shift)``: after executing ``ops``, logical
    qubit q sits at physical bit (q - final_shift) mod n; undo with
    ``RotateOp(n - final_shift % n)`` or equivalently
    ``rotate_bits_right(psi, (n - final_shift) % n)``.
    """
    from ..ops.dense import compose_low_panel

    cd = validate_circuit_dict(circuit_dict)
    n = cd["number_of_qubits"]
    gates = cd["gates"]
    w = min(window, n)

    if n <= w:
        # Whole state fits the window: a single fused panel.
        ops_ = [(tuple(g["qubits"]), G.gate_matrix(g["gate"], g["params"]))
                for g in gates]
        if not ops_:
            return [], 0
        return [PanelOp(compose_low_panel(ops_, w), len(ops_))], 0

    # DAG readiness bookkeeping.
    per_qubit: dict[int, list[int]] = {}
    for i, g in enumerate(gates):
        for q in g["qubits"]:
            per_qubit.setdefault(q, []).append(i)
    head = {q: 0 for q in per_qubit}
    pending = list(range(len(gates)))
    shift = 0  # logical qubit q sits at physical (q - shift) mod n

    def phys(q: int) -> int:
        return (q - shift) % n

    def is_ready(i: int) -> bool:
        return all(per_qubit[q][head[q]] == i for q in gates[i]["qubits"])

    def mark(i: int) -> None:
        for q in gates[i]["qubits"]:
            head[q] += 1

    def never_fits(g: dict) -> bool:
        qs = g["qubits"]
        if len(qs) == 1:
            return False
        span = max(
            min((qa - qb) % n, (qb - qa) % n)
            for qa in qs for qb in qs if qa != qb
        )
        return span >= w

    out: list = []

    def emit_rotation(r: int) -> None:
        nonlocal shift
        r %= n
        if r:
            out.append(RotateOp(r))
            shift = (shift + r) % n

    stall_limit = max_phases_without_progress or (2 * ((n + w - 1) // w) + 4)
    stalls = 0
    while pending:
        # Phase body: sweep pending in order, building panel runs and
        # emitting never-fits gates generically; blocked qubits gate
        # later gates exactly like the staging scheduler.
        panel_run: list[tuple[tuple[int, ...], np.ndarray]] = []
        progress = False
        blocked: set[int] = set()

        def flush_panel() -> None:
            nonlocal panel_run
            if panel_run:
                out.append(PanelOp(compose_low_panel(panel_run, w), len(panel_run)))
                panel_run = []

        changed = True
        while changed:
            changed = False
            still: list[int] = []
            for i in pending:
                g = gates[i]
                if set(g["qubits"]) & blocked or not is_ready(i):
                    still.append(i)
                    blocked.update(g["qubits"])
                    continue
                pq = [phys(q) for q in g["qubits"]]
                U = G.gate_matrix(g["gate"], g["params"])
                if all(p < w for p in pq):
                    panel_run.append((tuple(pq), U))
                    mark(i)
                    progress = changed = True
                elif never_fits(g):
                    flush_panel()
                    out.append(PhysGateOp(tuple(pq), U, g["gate"]))
                    mark(i)
                    progress = changed = True
                else:
                    still.append(i)
                    blocked.update(g["qubits"])
            pending = still
        flush_panel()

        if not pending:
            break
        if progress:
            stalls = 0
            emit_rotation(w)
        else:
            stalls += 1
            if stalls <= stall_limit:
                # Default slide failed to expose the head gate (e.g. a
                # pair straddling the window at this residue): rotate so
                # the head gate's lowest physical qubit lands on 0.
                head_gate = gates[pending[0]]
                r = min(phys(q) for q in head_gate["qubits"])
                emit_rotation(r if r else w)
            else:
                # Absolute fallback: run the head gate generically.
                g = gates[pending[0]]
                out.append(PhysGateOp(
                    tuple(phys(q) for q in g["qubits"]),
                    G.gate_matrix(g["gate"], g["params"]), g["gate"],
                ))
                mark(pending[0])
                pending = pending[1:]
                stalls = 0

    return out, shift


@dataclass(frozen=True)
class WindowPanelOp:
    """Fused 2^w x 2^w unitary on the FIXED bit window [pos, pos+w).

    ``run`` keeps the constituent (window-relative qubits, small U)
    pairs so executors can compose the panel in-graph from tiny
    literals instead of baking the expanded W (program-size economy).
    """
    pos: int
    W: np.ndarray
    n_fused: int
    run: tuple = ()


def _fit_start(qubits: list[int], n: int, w: int) -> int | None:
    """A valid panel start s covering `qubits`.

    Valid starts are s == 0 (lane window) or s >= 7 (positioned window,
    possibly ragged at the top: effective width min(w, n-s)).  Gates
    straddling the 1..6 start gap (e.g. a pair on qubits 6 and 7) fit
    no window and run through the generic path.

    Starts are clamped to n - w when that keeps s >= 7: a ragged top
    window (dim < 128) measured 44-59 GB/s on v5e (MXU pads the
    contraction to 128 and A collapses to 1) vs ~500+ GB/s full width.
    """
    lo, hi = min(qubits), max(qubits)
    if hi - lo >= w:
        return None
    if hi < w:
        return 0
    if lo < 7:
        return None  # straddles the forbidden start zone
    top = n - w if n - w >= 7 else None
    # Canonical aligned start for bucket reuse, else the smallest valid.
    cand = max(7, w * (lo // w))
    if top is not None:
        cand = min(cand, top)
    if cand <= lo and hi < cand + w:
        return cand
    s = max(7, hi - w + 1)
    return s if s <= lo else None


def compile_window_schedule(
    circuit_dict: dict, *, window: int = PANEL_W,
    layout_safe_diag: bool = False,
    diag_terms_only: bool = False,
) -> list:
    """Fixed-window panel schedule: NO rotations.

    Positioned panels (``ops/pallas_kernels.positioned_panel_planar``)
    can apply a fused 2^w block at any bit window [s, s+w) with s = 0
    or s >= 7, so instead of sliding qubits through the lane window
    with transposes, each phase simply emits one panel per active
    window.  Gates that fit no valid window (spans >= w, or pairs
    straddling position 7's forbidden zone) go through the generic
    layout-aware path.

    Returns a list of WindowPanelOp | PhysGateOp.
    """
    cd = validate_circuit_dict(circuit_dict)
    gate_list = [
        (tuple(g["qubits"]), G.gate_matrix(g["gate"], g["params"]), g["gate"])
        for g in cd["gates"]
    ]
    return compile_window_ops(gate_list, cd["number_of_qubits"],
                              window=window,
                              layout_safe_diag=layout_safe_diag,
                              diag_terms_only=diag_terms_only)


def compile_window_ops(
    gate_list: list, n: int, *, window: int = PANEL_W,
    layout_safe_diag: bool = False,
    diag_terms_only: bool = False,
) -> list:
    """Window-schedule a list of ``(qubits, U, name)`` ops directly.

    Same algorithm as :func:`compile_window_schedule` but over
    already-bound unitaries — the sharded executor uses this to run a
    step's *local* ops through the planar Pallas panels inside
    ``shard_map`` (n = the shard width k there).
    """
    w = min(window, n)
    if n <= w:
        from ..ops.dense import compose_low_panel
        ops_ = [(qs, U) for qs, U, _ in gate_list]
        if not ops_:
            return []
        return [WindowPanelOp(0, compose_low_panel(ops_, w), len(ops_))]

    per_qubit: dict[int, list[int]] = {}
    for i, (qs, _, _) in enumerate(gate_list):
        for q in qs:
            per_qubit.setdefault(q, []).append(i)
    head = {q: 0 for q in per_qubit}

    # Terminal standalone SWAPs (last gate on BOTH qubits, never fits
    # a window) commute past everything after them — defer them all to
    # the end, where a disjoint set is one bit permutation.  QFT's
    # bit-reversal tail collapses from ~12 pair-kernel passes to one
    # BitPermOp when the pairs fit the (lanes | middle | top) kernel
    # classes (see :class:`BitPermOp`).
    deferred: list[int] = []
    if n >= 15:
        from ..ops.dense import _SWAP4
        for i, (qs, U, _) in enumerate(gate_list):
            if (
                len(qs) == 2
                and all(per_qubit[q][-1] == i for q in qs)
                and _fit_start(list(qs), n, w) is None
                and np.asarray(U).shape == (4, 4)
                and np.array_equal(np.asarray(U, np.complex128), _SWAP4)
            ):
                deferred.append(i)

    pending = [i for i in range(len(gate_list)) if i not in set(deferred)]

    def is_ready(i: int) -> bool:
        return all(per_qubit[q][head[q]] == i for q in gate_list[i][0])

    def mark(i: int) -> None:
        for q in gate_list[i][0]:
            head[q] += 1

    from ..ops.dense import compose_low_panel

    out: list = []
    while pending:
        buckets: dict[int, list] = {}
        generics: list[PhysGateOp] = []
        blocked: set[int] = set()
        # Ordering between phase groups: panels (sorted by start) are
        # emitted before generics, and bucket-internal order is kept.
        # A gate may only join a group if every qubit it shares with an
        # already-scheduled gate of this phase is owned by a group that
        # is emitted no later than its own:
        #   same panel bucket  -> ok;   panel -> generic -> ok;
        #   different panel bucket or generic -> panel -> defer.
        owner: dict[int, object] = {}
        progress = False
        changed = True
        while changed:
            changed = False
            still: list[int] = []
            for i in pending:
                qubits_i, U, gname = gate_list[i]
                if set(qubits_i) & blocked or not is_ready(i):
                    still.append(i)
                    blocked.update(qubits_i)
                    continue
                s = _fit_start(qubits_i, n, w)
                # Diagonal gates ride along in a panel their window
                # already has (free in the matmul); otherwise they take
                # the broadcast-multiply path (460-580 GB/s, merged into
                # combined-phase ops) rather than spawning a new panel.
                if (
                    s is not None
                    and G.is_diagonal(U)
                    and s not in buckets
                ):
                    s = None
                key = "generic" if s is None else ("panel", s)
                ok = True
                for q in qubits_i:
                    own = owner.get(q)
                    if own is None or own == key:
                        continue
                    if key == "generic" and isinstance(own, tuple):
                        continue  # panel -> generic is emission-ordered
                    ok = False
                    break
                if not ok:
                    still.append(i)
                    blocked.update(qubits_i)
                    continue
                if s is None:
                    generics.append(PhysGateOp(tuple(qubits_i), U, gname))
                else:
                    rel = tuple(q - s for q in qubits_i)
                    buckets.setdefault(s, []).append((rel, U))
                for q in qubits_i:
                    owner[q] = key
                mark(i)
                progress = changed = True
            pending = still
        # Coalesce buckets: a bucket whose gates all fit another
        # bucket's window merges into it (buckets of one phase own
        # DISJOINT qubit sets — the owner map — so they commute).
        # QFT's tail SWAP folds otherwise fragment into panels
        # @7/@8/@9 when one @9 panel covers all three.
        merged = True
        while merged and len(buckets) > 1:
            merged = False
            for s1 in sorted(buckets):
                for s2 in sorted(buckets):
                    if s1 == s2:
                        continue
                    w2 = min(w, n - s2)
                    if all(s2 <= min(r) + s1 and max(r) + s1 < s2 + w2
                           for r, _ in buckets[s1]):
                        buckets[s2].extend(
                            (tuple(q + s1 - s2 for q in r), U)
                            for r, U in buckets[s1])
                        del buckets[s1]
                        merged = True
                        break
                if merged:
                    break
        # Ascending emission keeps (0,7) adjacent for the dual-panel
        # fuse.  (An order ending phases in the lane panel to chain
        # cross-phase (0,7) pairs was tried and LOST: diag/generic ops
        # sit at phase boundaries and break the adjacency, while the
        # within-phase pairs disappear.)
        for s in sorted(buckets):
            # Full-width panels always (8.3 ms/pass measured): narrow
            # panels had pathological kernel grids and converting small
            # buckets to the elementwise path cost 20-31 ms per gate
            # (XLA reverse ops defeat fusion).
            run = buckets[s]
            w_eff = min(w, n - s)
            out.append(WindowPanelOp(
                s, compose_low_panel(run, w_eff), len(run),
                run=tuple(run)))
        out.extend(generics)
        if not progress and pending:
            raise AssertionError("window scheduler stalled")  # unreachable

    if deferred:
        pairs = [tuple(sorted(gate_list[i][0])) for i in deferred]
        cross_p = [p for p in pairs if p[0] < 7 and p[1] >= n - 7]
        mid_p = [p for p in pairs if p[0] >= 7 and p[1] < n - 7]
        cross = None
        if cross_p:
            lanes = sorted(p[0] for p in cross_p)
            tops = sorted(p[1] for p in cross_p)
            if lanes == list(range(7)) and tops == list(range(n - 7, n)):
                cross = [0] * 7
                for lo, hi in cross_p:
                    cross[lo] = hi
                cross = tuple(cross)
        legal = (
            cross is not None
            and len(cross_p) + len(mid_p) == len(pairs)
        )
        if legal:
            out.append(BitPermOp(tuple(mid_p), cross))
        else:
            # Mid-only or unclassifiable sets keep the existing paths
            # (multiswap transpose / pair kernels); deferral to the
            # tail is still valid and lets _merge_swap_runs fuse them.
            from ..ops.dense import _SWAP4
            out.extend(PhysGateOp(p, _SWAP4, "SWAP") for p in pairs)

    return _fold_straddlers(_fuse_panel_pairs(_decompose_terminal_bitperm(
        _merge_swap_runs(_coalesce_panels_global(
            _merge_diag_runs(out, layout_safe=layout_safe_diag,
                             terms_only=diag_terms_only), n)), n)))


def _op_support(op) -> set[int] | None:
    """Qubit support of an op, or None for reorder barriers.

    A WindowPanelOp acts as identity on window qubits its gates never
    touch, so its support is the union of its run's qubits — tighter
    than the whole window, which is what lets panels from different
    scheduler phases slide past each other.
    """
    if isinstance(op, WindowPanelOp):
        if op.run:
            return {op.pos + q for rel, _U in op.run for q in rel}
        w_used = int(np.log2(op.W.shape[0]))
        return set(range(op.pos, op.pos + w_used))
    if isinstance(op, (PhysGateOp, DiagOp)):
        return set(op.qubits)
    return None


def _coalesce_panels_global(ops: list, n: int) -> list:
    """Cross-phase panel coalescing: merge window panels separated by
    commuting ops.

    The phase-by-phase scheduler emits one panel per (phase, window)
    bucket; dependency chains fragment late gates into many 1-2 gate
    panels (nonstab28: 9 of 14 HBM passes carried ~31 of 223 gates).
    Panels whose supports are disjoint commute exactly, so a later
    panel may bubble left past disjoint-support ops and compose into
    an earlier panel when the union of their gates still fits one
    valid window — same legality rule as the within-phase bucket
    coalescer, applied globally.  ``QST_PANEL_GLOBAL_COALESCE=0``
    reverts.
    """
    import os as _os

    if _os.environ.get("QST_PANEL_GLOBAL_COALESCE", "1") == "0":
        return ops
    from ..ops.dense import compose_low_panel

    ops = list(ops)
    changed = True
    while changed:
        changed = False
        for j in range(len(ops)):
            b = ops[j]
            if not isinstance(b, WindowPanelOp) or not b.run:
                continue
            sup_b = _op_support(b)
            i = j - 1
            while i >= 0:
                a = ops[i]
                sup_a = _op_support(a)
                if sup_a is None:
                    break  # barrier (bit perms etc.)
                if isinstance(a, WindowPanelOp) and a.run:
                    union = sorted(sup_a | sup_b)
                    s = _fit_start(union, n, PANEL_W)
                    if s is not None:
                        w_eff = min(PANEL_W, n - s)
                        run = tuple(
                            (tuple(q + a.pos - s for q in rel), U)
                            for rel, U in a.run
                        ) + tuple(
                            (tuple(q + b.pos - s for q in rel), U)
                            for rel, U in b.run
                        )
                        ops[i] = WindowPanelOp(
                            s, compose_low_panel(list(run), w_eff),
                            a.n_fused + b.n_fused, run=run)
                        del ops[j]
                        changed = True
                        break
                if sup_a & sup_b:
                    break  # non-commuting: cannot bubble further left
                i -= 1
            if changed:
                break
    return ops


def _fuse_panel_pairs(ops: list) -> list:
    """Fuse consecutive panels at positions (0,7)/(0,8)/(7,8) into one
    pass (:class:`DualPanelOp`).  ``QST_PANEL_PAIR_FUSE=0`` reverts."""
    import os as _os

    from ..ops.panel_kernels import dual_panel_supported

    if _os.environ.get("QST_PANEL_PAIR_FUSE", "1") == "0":
        return ops
    out: list = []
    i = 0
    while i < len(ops):
        a = ops[i]
        b = ops[i + 1] if i + 1 < len(ops) else None
        if (isinstance(a, WindowPanelOp) and isinstance(b, WindowPanelOp)
                and not isinstance(a.W, tuple)
                and not isinstance(b.W, tuple)
                and a.W.shape[0] == 128 and b.W.shape[0] == 128
                and a.pos != b.pos
                and dual_panel_supported(a.pos, b.pos)):
            out.append(DualPanelOp(a, b))
            i += 2
        else:
            out.append(a)
            i += 1
    return out


_STRADDLE_PERM = (0, 2, 1, 3)  # basis swap for reversed qubit order


def _fold_straddlers(ops: list) -> list:
    """Fold a PhysGateOp on (6, qb in 7..13) that immediately precedes
    a (0,7) DualPanelOp into that panel pass as a VPU prologue.

    The (6, 7..13) pairs straddle the forbidden window-start zone
    (``_fit_start``: no valid window contains both bits), so they
    otherwise cost a dedicated full-state pass through the mixed
    low/lane pair kernel.  Inside the dual panel's (BA, 128, 128)
    block BOTH bits are VMEM-resident, so the gate rides the panel's
    read for free.  ``QST_STRADDLE_FOLD=0`` reverts.
    """
    import dataclasses
    import os as _os

    if _os.environ.get("QST_STRADDLE_FOLD", "1") == "0":
        return ops

    def foldable(a) -> tuple | None:
        if (isinstance(a, PhysGateOp) and len(a.qubits) == 2
                and min(a.qubits) == 6 and 7 <= max(a.qubits) <= 13):
            U = np.asarray(a.U)
            if a.qubits[0] != 6:  # normalize to (6, qb) qubit order
                U = U[np.ix_(_STRADDLE_PERM, _STRADDLE_PERM)]
            return (6, max(a.qubits), U)
        return None

    def is_dual07(b) -> bool:
        return (isinstance(b, DualPanelOp)
                and {b.first.pos, b.second.pos} == {0, 7})

    # Pass 1 — prologue: [straddler, dual] -> dual(pre_straddle).
    out: list = []
    i = 0
    while i < len(ops):
        a = ops[i]
        b = ops[i + 1] if i + 1 < len(ops) else None
        s = foldable(a)
        if s is not None and is_dual07(b) and b.pre_straddle is None:
            out.append(dataclasses.replace(b, pre_straddle=s))
            i += 2
        else:
            out.append(a)
            i += 1
    # Pass 2 — epilogue: [dual, straddler] -> dual(post_straddle).
    ops, out = out, []
    for a in ops:
        s = foldable(a)
        if (s is not None and out and is_dual07(out[-1])
                and out[-1].post_straddle is None):
            out[-1] = dataclasses.replace(out[-1], post_straddle=s)
        else:
            out.append(a)
    return out


def _decompose_terminal_bitperm(ops: list, n: int) -> list:
    """Factor a terminal BitPermOp as  mid+A_top (free)  then  pure T.

    Any crossing sigma (lane l <-> top cross[l]) equals A ∘ T with
    T the in-order field transpose and A within-field bit
    permutations: A's top part is FREE (index maps of the combined
    BitPermGridOp pass), and A's lane part folds into the last pos-0
    panel's W as a row permutation (diagonal ops in between are
    relabeled q -> pi[q]; ops on bits >= 7 commute).  The crossing
    pass then runs on Mosaic's native transpose (768 GB/s measured)
    instead of two permutation matmuls (333 GB/s) —
    ``QST_BITPERM_DECOMP=0`` reverts to the matmul crossing kernel.
    """
    import os as _os

    # n >= 17 keeps the whole top field at bits >= 10 (index-mappable);
    # smaller n stays on the matmul crossing kernel.
    if (not ops or not isinstance(ops[-1], BitPermOp) or n < 17
            or _os.environ.get("QST_BITPERM_DECOMP", "1") == "0"):
        return ops
    op = ops[-1]
    pi = [op.cross[el] - (n - 7) for el in range(7)]
    pi_inv = [0] * 7
    for el in range(7):
        pi_inv[pi[el]] = el
    grid_map = tuple((n - 7 + m, n - 7 + pi_inv[m])
                     for m in range(7) if pi_inv[m] != m)

    new_ops = list(ops[:-1])
    if pi != list(range(7)):
        # Fold the lane-bit permutation into the last pos-0 panel.
        idx = None
        for i in range(len(new_ops) - 1, -1, -1):
            o = new_ops[i]
            if (isinstance(o, WindowPanelOp) and o.pos == 0
                    and not isinstance(o.W, tuple)):
                idx = i
                break
            if isinstance(o, WindowPanelOp) and o.pos >= 7:
                continue
            if isinstance(o, MultiSwapOp):
                continue
            if isinstance(o, DiagOp):
                continue  # relabeled below
            if isinstance(o, PhysGateOp) and min(o.qubits) >= 7:
                continue
            idx = None
            break
        if idx is None:
            return ops  # no absorber: keep the matmul crossing path
        lane_map = np.zeros(128, dtype=np.int64)
        for lam in range(128):
            v = 0
            for el in range(7):
                v |= ((lam >> pi[el]) & 1) << el
            lane_map[lam] = v
        p0 = new_ops[idx]
        new_ops[idx] = WindowPanelOp(
            0, np.ascontiguousarray(np.asarray(p0.W)[lane_map, :]),
            p0.n_fused, run=p0.run)
        for i in range(idx + 1, len(new_ops)):
            o = new_ops[i]
            if isinstance(o, DiagOp) and any(q < 7 for q in o.qubits):
                def rl(q):
                    return pi[q] if q < 7 else q
                new_ops[i] = DiagOp(
                    tuple(rl(q) for q in o.qubits), o.d, name=o.name,
                    terms=None if o.terms is None else tuple(
                        (tuple(sorted(rl(q) for q in qs)), c)
                        for qs, c in o.terms))

    if op.mid_pairs or grid_map:
        new_ops.append(BitPermGridOp(op.mid_pairs, grid_map))
    new_ops.append(TransposeCrossOp())
    return new_ops


# 13 high-qubit axes keep the phase literal at 2^13 c128 = 128 KB and
# halve QFT-26's diag pass count vs the earlier cap of 11 (18 passes of
# 2.3 ms measured); beyond ~13 the broadcast-view rank and literal size
# grow without saving meaningful passes.
DIAG_MERGE_MAX_QUBITS = 13


def _merge_diag_runs(ops: list, max_qubits: int = DIAG_MERGE_MAX_QUBITS,
                     *, layout_safe: bool = False,
                     terms_only: bool = False) -> list:
    """Fuse consecutive diagonal PhysGateOps into combined-phase ops.

    Diagonal gates commute, so a run of them composes into one diagonal
    over the union of their qubits (capped at ``max_qubits`` so the
    combined phase vector stays a small literal).  QFT-26's 229
    window-spanning CRs collapse to ~30 ops — the per-op count was
    what broke the remote compiler.

    ``layout_safe`` (capacity tier, n >= 29): merged runs must stay
    within one of ``ops/dense.apply_diag_planar_shear``'s layout-safe
    view classes — all-row (>= 7) or all-low (< 10).  Lane+high mixes
    stay singletons (the 2q split path handles those).  The default
    tier merges freely: the direct broadcast takes any mix, and wider
    unions mean fewer HBM passes.

    ``terms_only`` (capacity tier with the fused Pallas diag kernel):
    merge WITHOUT any qubit cap and carry only the Möbius ``terms`` —
    the kernel computes phases from index bits, so no 2^m vector is
    ever needed and a run of 13 capped DiagOps becomes ONE pass (the
    per-element term math grows, but it amortizes over rows while the
    saved HBM sweeps do not).  ``d`` is None on such ops.
    """
    out: list = []
    run: list[PhysGateOp] = []

    def _mergeable(union: set) -> bool:
        if terms_only:
            return True
        if not layout_safe:
            return True
        # Shear-safe classes (ops/dense.apply_diag_planar_shear):
        # <= 1 lane bit (row gather, optionally lane-masked) or
        # <= 1 high bit (low broadcast tables, optionally row-masked).
        return (sum(q < 7 for q in union) <= 1
                or sum(q >= 10 for q in union) <= 1)

    def flush() -> None:
        nonlocal run
        while run:
            group = [run.pop(0)]
            union = set(group[0].qubits)
            while run:
                cand = set(run[0].qubits) | union
                if ((not terms_only and len(cand) > max_qubits)
                        or not _mergeable(cand)):
                    break
                union = cand
                group.append(run.pop(0))
            if len(group) == 1:
                out.append(group[0])
                continue
            qubits = tuple(sorted(union))
            terms: dict = {}
            for g in group:
                for qs, c in diag_phase_terms(g.qubits, np.diag(g.U)).items():
                    k = tuple(sorted(qs))
                    terms[k] = terms.get(k, 0.0) + c
            if terms_only:
                out.append(DiagOp(qubits, None, terms=tuple(
                    (qs, c) for qs, c in terms.items() if abs(c) > 1e-12)))
                continue
            m = len(qubits)
            pos_of = {q: j for j, q in enumerate(qubits)}
            d = np.ones(1 << m, dtype=np.complex128)
            idx = np.arange(1 << m)
            for g in group:
                sub = np.zeros(1 << m, dtype=np.int64)
                mg = len(g.qubits)
                for j, q in enumerate(g.qubits):
                    bit = (idx >> (m - 1 - pos_of[q])) & 1
                    sub |= bit << (mg - 1 - j)
                d *= np.diag(g.U)[sub]
            # Keep the 2^m VECTOR, never the 2^m x 2^m matrix: at the
            # m=13 merge cap np.diag(d) is a 67M-entry (1 GiB) literal
            # that every trace-time structure check then re-scans —
            # measured 14 MINUTES of lowering for QFT-26 (and the
            # arity-13 ops additionally fell past apply_gate_planar's
            # m<=12 diag branch into the complex fallback).
            out.append(DiagOp(qubits, d, terms=tuple(
                (qs, c) for qs, c in terms.items() if abs(c) > 1e-12)))

    for op in ops:
        if (
            isinstance(op, PhysGateOp)
            and len(op.qubits) <= 3
            and G.is_diagonal(op.U)
        ):
            run.append(op)
        else:
            flush()
            out.append(op)
    flush()
    return out


@dataclass(frozen=True)
class BitPermOp:
    """A terminal SWAP network as one bit permutation.

    QFT's bit reversal is the canonical case: its wide SWAP pairs never
    fit a panel window and each costs a full HBM pass on the pair /
    mixed-pair kernels.  When every such SWAP is *terminal* (the last
    gate on both its qubits) the set is one index-bit permutation:
    the 7 lane<->top transpositions run as ONE aliased pass
    (``ops/pallas_kernels.bitperm_cross_planar``) and the middle
    transpositions ride the multiswap / pair-kernel paths.  TPU
    analogue of the reference's bit-permutation redistribution
    (``mpi_redistributer.hpp:20-33``).

    ``mid_pairs``: transpositions within bits [7, n-7).
    ``cross``: 7-tuple (lane l <-> top bit cross[l], a complete
    bijection onto the top 7 bits).
    """
    mid_pairs: tuple[tuple[int, int], ...]
    cross: tuple


@dataclass(frozen=True)
class MultiSwapOp:
    """Disjoint high-bit SWAPs fused into ONE multi-axis transpose pass.

    Two SWAPs per transpose measured 421 GB/s on v5e vs ~295 GB/s for
    one-at-a-time swapaxes — QFT's bit-reversal network is the use
    case.  All bits must be >= 7 so the trailing view dim keeps full
    lanes.
    """
    pairs: tuple[tuple[int, int], ...]


@dataclass(frozen=True)
class DualPanelOp:
    """Two consecutive window panels fused into ONE HBM pass.

    Supported position pairs (0,7), (0,8), (7,8): the combined span
    reaches down to the lanes so the (A, D, 128) view trails in
    exactly 128 lanes and both contractions stay Mosaic-clean
    (``ops/pallas_kernels.dual_panel_planar``).  Panels are
    near-bandwidth-bound: the second contraction rides the same
    read+write.

    ``pre_straddle`` / ``post_straddle``: an optional forbidden-zone
    straddler gate ``(6, qb, U4)`` with qb in 7..13, circuit-order
    immediately BEFORE / AFTER the panels, folded in by
    :func:`_fold_straddlers` — it runs as a VPU prologue / epilogue
    inside the dual-panel kernel, deleting its standalone full-state
    HBM pass (the round-4 audit's weakest pass: 66% of floor at n=28).
    """
    first: "WindowPanelOp"
    second: "WindowPanelOp"
    pre_straddle: tuple = None
    post_straddle: tuple = None


@dataclass(frozen=True)
class BitPermGridOp:
    """One out-of-place pass applying a bit permutation on bits >= 7.

    Transposition ``pairs`` touching sublane bits [7, 10) exchange
    in-VMEM; everything >= 10 (including the arbitrary ``grid_map``
    bijection) rides the block index maps for free
    (``ops/pallas_kernels.bitperm_swap_planar``).
    """
    pairs: tuple[tuple[int, int], ...]
    grid_map: tuple  # ((out_bit, in_bit), ...)


@dataclass(frozen=True)
class TransposeCrossOp:
    """Pure in-order lane<->top exchange (lane l <-> bit n-7+l).

    Mosaic's native tile transpose: 768 GB/s measured vs 333 for the
    permutation-matmul crossing kernel; aliasing-safe (identity block
    maps), so the capacity tier runs it in place.
    """


MULTISWAP_MAX_PAIRS = 4


def _merge_swap_runs(ops: list, *, min_bit: int = 7,
                     max_pairs: int = MULTISWAP_MAX_PAIRS) -> list:
    """Fuse runs of consecutive disjoint high-bit SWAPs."""
    import numpy as _np
    from ..ops.dense import _SWAP4

    def is_high_swap(op) -> bool:
        return (
            isinstance(op, PhysGateOp)
            and len(op.qubits) == 2
            and min(op.qubits) >= min_bit
            and op.U.shape == (4, 4)
            and _np.array_equal(_np.asarray(op.U, _np.complex128), _SWAP4)
        )

    out: list = []
    run: list[PhysGateOp] = []

    def flush() -> None:
        nonlocal run
        while run:
            group = [run.pop(0)]
            used = set(group[0].qubits)
            while run and len(group) < max_pairs:
                cand = set(run[0].qubits)
                if cand & used:
                    break
                used |= cand
                group.append(run.pop(0))
            if len(group) == 1:
                out.append(group[0])
            else:
                out.append(MultiSwapOp(tuple(tuple(g.qubits) for g in group)))

    for op in ops:
        if is_high_swap(op):
            run.append(op)
        else:
            flush()
            out.append(op)
    flush()
    return out


def window_stats(circuit_dict: dict, *, window: int = PANEL_W,
                 diag_terms_only: bool = False) -> dict:
    ops = compile_window_schedule(circuit_dict, window=window,
                                  diag_terms_only=diag_terms_only)
    return {
        "panels": sum(1 for o in ops if isinstance(o, WindowPanelOp)),
        "generic_gates": sum(1 for o in ops if isinstance(o, PhysGateOp)),
        "diag_ops": sum(1 for o in ops if isinstance(o, DiagOp)),
        "multiswaps": sum(1 for o in ops if isinstance(o, MultiSwapOp)),
        "bitperms": sum(1 for o in ops if isinstance(o, BitPermOp)),
        "gates": len(circuit_dict["gates"]),
        "hbm_passes": len(ops),
    }


def panel_stats(circuit_dict: dict, *, window: int = PANEL_W) -> dict:
    ops, shift = compile_panel_schedule(circuit_dict, window=window)
    return {
        "panels": sum(1 for o in ops if isinstance(o, PanelOp)),
        "rotations": sum(1 for o in ops if isinstance(o, RotateOp)),
        "generic_gates": sum(1 for o in ops if isinstance(o, PhysGateOp)),
        "gates": len(circuit_dict["gates"]),
        "final_shift": shift,
        "hbm_passes": len(ops) + (1 if shift else 0),
    }
