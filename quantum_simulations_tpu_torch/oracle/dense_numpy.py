"""In-memory numpy reference simulator — the correctness oracle (a copy
of ``quantum_simulations_tpu/oracle/dense_numpy.py``: the port imports
nothing of the JAX package).

complex128, little-endian, applies gates one-by-one to the full 2^n
statevector, on the host.  Practical to n ~ 24; the port's tiers are
tested against it, and :func:`simulate_trajectory` is the trajectory
tier's twin (``runtime/trajectory.py``).

Role mirrors the reference's oracle (``wenbo_engine/kernel/ref_dense.py``);
the implementation is an independent little-endian bit-arithmetic
simulator supporting gates of any arity.
"""
from __future__ import annotations

import numpy as np

from ..circuit import gates as G
from ..circuit.contract import validate_circuit_dict


def apply_gate(psi: np.ndarray, qubits: list[int], U: np.ndarray) -> np.ndarray:
    """Apply an m-qubit unitary to ``psi`` (returns a new array).

    ``U`` is 2^m x 2^m in big-endian subspace order: subspace index
    bit (m-1-j) carries qubits[j] — i.e. qubits[0] is the MSB.
    """
    n_amps = psi.size
    m = len(qubits)
    dim = 1 << m
    if U.shape != (dim, dim):
        raise ValueError(f"matrix shape {U.shape} does not match {m} qubits")

    # Enumerate base indices: all amplitudes with every gate-qubit bit = 0.
    idx = np.arange(n_amps)
    mask = np.ones(n_amps, dtype=bool)
    for q in qubits:
        mask &= ((idx >> q) & 1) == 0
    base = idx[mask]

    # offsets[s] adds the gate-qubit bits for subspace index s.
    offsets = np.zeros(dim, dtype=np.int64)
    for s in range(dim):
        off = 0
        for j, q in enumerate(qubits):
            if (s >> (m - 1 - j)) & 1:
                off |= 1 << q
        offsets[s] = off

    gathered = np.stack([psi[base + offsets[s]] for s in range(dim)])  # (dim, M)
    result = U @ gathered
    out = psi.copy()
    for s in range(dim):
        out[base + offsets[s]] = result[s]
    return out


def apply_gate_lean(psi: np.ndarray, qubits: list[int], U: np.ndarray,
                    block_amps: int = 1 << 22) -> None:
    """In-place, blocked gate application for 1-3 qubit gates.

    Same math and subspace convention as :func:`apply_gate`, but O(MB)
    temporaries instead of O(state): the state is viewed as a strided
    reshape exposing each gate qubit as its own axis (zero-copy), and
    the 2^m subspace planes are updated block-by-block.  This is what
    makes full-dimension c128 segment differentials feasible at
    n = 29..31 on a 125 GB host (``bench/corpus.py``), where
    :func:`apply_gate`'s index/gather temporaries alone exceed RAM.
    The blocked loop mirrors the native engine's strided in-place
    kernels (``native/host_engine.cpp``) in numpy.
    """
    n_amps = psi.size
    m = len(qubits)
    dim = 1 << m
    if U.shape != (dim, dim):
        raise ValueError(f"matrix shape {U.shape} does not match {m} qubits")
    if m > 3:
        raise ValueError("apply_gate_lean supports 1-3 qubit gates")
    if not psi.flags.c_contiguous:
        # The strided reshape below must be a VIEW: on a non-contiguous
        # input numpy silently returns a copy and every in-place write
        # is discarded (the call becomes a no-op).  Fail loudly instead
        # (ADVICE r4 #1).
        raise ValueError("apply_gate_lean requires a C-contiguous state "
                         "(in-place strided views)")
    U = np.ascontiguousarray(U, dtype=np.complex128)
    # Sort qubits ascending for the reshape; track where each gate
    # qubit landed so subspace index bit (m-1-j) still carries
    # qubits[j] (apply_gate's convention: qubits[0] = MSB).
    order = sorted(range(m), key=lambda j: qubits[j])
    qs = [qubits[j] for j in order]
    # view axes (C order, little-endian bits): innermost = low bits.
    #   (outer, 2, gap2, 2, gap1, 2, inner)  for m = 3 with qs asc.
    shape = []
    prev = -1
    for q in qs:
        shape.append(1 << (q - prev - 1))  # gap below this qubit
        shape.append(2)
        prev = q
    shape.append(n_amps >> (prev + 1))
    shape.reverse()  # C order: outermost axis = highest bits
    view = psi.reshape(shape)
    # Axis index (in `view`) of ascending gate qubit i, and of each
    # ORIGINAL gate qubit j (qubits[j] = MSB of the subspace index).
    axes = [len(shape) - 2 - 2 * i for i in range(m)]
    axis_of_j = [axes[order.index(j)] for j in range(m)]
    gate_axes = set(axis_of_j)
    # Subspace index s (big-endian over qubits[]) -> index tuple.
    sel = []
    for s in range(dim):
        ix: list = [slice(None)] * len(shape)
        for j in range(m):
            ix[axis_of_j[j]] = (s >> (m - 1 - j)) & 1
        sel.append(tuple(ix))
    # Block over the largest NON-gate axis (there is always one:
    # the non-gate volume is n_amps/dim spread over <= m+1 axes), so
    # temporaries stay ~block_amps regardless of which qubits the
    # gate touches.
    baxis = max((ax for ax in range(len(shape)) if ax not in gate_axes),
                key=lambda ax: shape[ax])
    per_unit = max(1, n_amps // shape[baxis])  # amps per index of baxis
    step = max(1, block_amps // per_unit)

    def plane(s, bs):
        ix = list(sel[s])
        ix[baxis] = bs
        return view[tuple(ix)]

    nz = np.abs(U) > 0
    if not np.any(nz & ~np.eye(dim, dtype=bool)):
        # Diagonal gate (P/RZ/CR/T/RZZ...): scalar multiply the
        # touched planes in place — 1 read + 1 write, no copies.
        for i0 in range(0, shape[baxis], step):
            bs = slice(i0, i0 + step)
            for s in range(dim):
                if U[s, s] != 1.0:
                    plane(s, bs)[...] *= U[s, s]
        return None
    if (nz.sum(0) == 1).all() and (nz.sum(1) == 1).all():
        # Monomial/permutation gate (X/CNOT/CCX/CSWAP, phased perms):
        # out plane s = U[s, src[s]] * in plane src[s]; walk each
        # cycle with ONE plane-block temp.
        src = [int(np.nonzero(nz[s])[0][0]) for s in range(dim)]
        for i0 in range(0, shape[baxis], step):
            bs = slice(i0, i0 + step)
            seen: set = set()
            for s0 in range(dim):
                if s0 in seen:
                    continue
                cyc = [s0]  # src[cyc[j]] == cyc[j+1] by construction
                while src[cyc[-1]] != s0:
                    cyc.append(src[cyc[-1]])
                seen.update(cyc)
                if len(cyc) > 1:
                    tmp = plane(cyc[0], bs).copy()
                    for j in range(len(cyc) - 1):
                        plane(cyc[j], bs)[...] = plane(cyc[j + 1], bs)
                    plane(cyc[-1], bs)[...] = tmp
                    del tmp
                for s in cyc:
                    if U[s, src[s]] != 1.0:
                        plane(s, bs)[...] *= U[s, src[s]]
        return None
    for i0 in range(0, shape[baxis], step):
        bs = slice(i0, i0 + step)
        # .copy(), not ascontiguousarray: a contiguous slice would
        # ALIAS the state and the s=0 write would corrupt it.
        planes = [plane(t, bs).copy() for t in range(dim)]
        for s in range(dim):
            acc = U[s, 0] * planes[0]
            for t in range(1, dim):
                acc += U[s, t] * planes[t]
            plane(s, bs)[...] = acc
    return None


def simulate_lean(circuit_dict: dict, *,
                  initial_state: np.ndarray | None = None) -> np.ndarray:
    """Like :func:`simulate` but in place with O(MB) temporaries.

    Mutates and returns ``initial_state`` when given (no copy — the
    point is the memory profile); gates of arity > 3 raise.
    """
    cd = validate_circuit_dict(circuit_dict)
    n = cd["number_of_qubits"]
    psi = zero_state(n) if initial_state is None else initial_state
    if psi.size != (1 << n):
        raise ValueError("initial_state size mismatch")
    if psi.dtype != np.complex128 or not psi.flags.c_contiguous:
        raise ValueError("simulate_lean needs a contiguous c128 buffer")
    for g in cd["gates"]:
        U = G.gate_matrix(g["gate"], g["params"])
        apply_gate_lean(psi, g["qubits"], U)
    return psi


def zero_state(n: int, dtype=np.complex128) -> np.ndarray:
    psi = np.zeros(1 << n, dtype=dtype)
    psi[0] = 1.0
    return psi


def simulate(circuit_dict: dict, *, initial_state: np.ndarray | None = None) -> np.ndarray:
    """Run a circuit, return the final statevector (complex128)."""
    cd = validate_circuit_dict(circuit_dict)
    n = cd["number_of_qubits"]
    psi = zero_state(n) if initial_state is None else np.array(
        initial_state, dtype=np.complex128, copy=True
    )
    if psi.size != (1 << n):
        raise ValueError("initial_state size mismatch")
    for g in cd["gates"]:
        U = G.gate_matrix(g["gate"], g["params"])
        psi = apply_gate(psi, g["qubits"], U)
    return psi


def probabilities(psi: np.ndarray) -> np.ndarray:
    return (psi.real**2 + psi.imag**2).astype(np.float64)


def _p1(psi: np.ndarray, q: int) -> float:
    n = int(np.log2(psi.size))
    x = probabilities(psi).reshape(1 << (n - q - 1), 2, 1 << q)
    return float(x[:, 1, :].sum())


def _collapse(psi: np.ndarray, q: int, outcome: int,
              flip_to_zero: bool = False) -> np.ndarray:
    """Project qubit q onto |outcome>, renormalize; optionally map the
    kept plane back to |0> (RESET semantics)."""
    n = int(np.log2(psi.size))
    x = psi.reshape(1 << (n - q - 1), 2, 1 << q)
    keep = x[:, outcome, :]
    out = np.zeros_like(x)
    dest = 0 if flip_to_zero else outcome
    out[:, dest, :] = keep
    out = out.reshape(psi.size)
    nrm = np.sqrt(probabilities(out).sum())
    if nrm == 0.0:
        raise FloatingPointError(
            f"collapse of qubit {q} onto |{outcome}> has zero probability")
    return out / nrm


def simulate_trajectory(circuit_dict: dict, *, seed: int = 0,
                        initial_state: np.ndarray | None = None):
    """Oracle for the trajectory tier: RESET / MEASURE / conditional
    gates with seeded measurement outcomes.

    One uniform draw is consumed per RESET/MEASURE in gate order
    (outcome 1 iff ``u < P(1)``), so an engine sharing the seed and
    draw order follows the identical trajectory.  Returns
    ``(psi, cregs, outcomes)`` where ``cregs`` maps register name ->
    integer value and ``outcomes`` is the per-measurement bit list.

    Semantics the reference lacks: its QASM driver drops ``reset``
    (``qasm_assembler_standalone.py:525``) and cannot parse ``if``.
    """
    from ..circuit.contract import validate_circuit_dict as _v

    cd = _v(circuit_dict, allow_nonunitary=True)
    n = cd["number_of_qubits"]
    psi = zero_state(n) if initial_state is None else np.array(
        initial_state, dtype=np.complex128, copy=True)
    rng = np.random.default_rng(seed)
    cregs: dict[str, int] = {}
    outcomes: list[int] = []
    for g in cd["gates"]:
        name = g["gate"]
        if name in ("RESET", "MEASURE"):
            q = g["qubits"][0]
            u = float(rng.random())
            outcome = int(u < _p1(psi, q))
            outcomes.append(outcome)
            psi = _collapse(psi, q, outcome, flip_to_zero=(name == "RESET"))
            if name == "MEASURE":
                p = g["params"]
                val = cregs.get(p["creg"], 0)
                bit = 1 << p["cbit"]
                cregs[p["creg"]] = (val & ~bit) | (bit if outcome else 0)
            continue
        cond = g.get("cond")
        if cond is not None and cregs.get(cond["creg"], 0) != cond["value"]:
            continue
        U = G.gate_matrix(name, g["params"])
        if len(g["qubits"]) <= 3:
            # In-place blocked path (identical math, fuzz-tested equal):
            # the gather formulation's temporaries dominate wall time
            # and RAM for the n >= 26 corpus trajectory twins.
            apply_gate_lean(psi, g["qubits"], U)
        else:
            psi = apply_gate(psi, g["qubits"], U)
    return psi, cregs, outcomes


def fidelity_overlap(a: np.ndarray, b: np.ndarray) -> float:
    """|<a|b>| — phase-invariant state comparison (dual-oracle metric)."""
    return float(abs(np.vdot(a, b)))
