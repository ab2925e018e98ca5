"""Dense helpers of the window path: numpy panel composition, plain torch
state construction and the gate paths that run outside the kernels.

The counterparts of ``quantum_simulations_tpu/ops/dense.py``'s
``expand_to_low_block``, ``compose_low_panel``, ``_SWAP4``,
``_rotation_steps``, ``rotate_bits_right`` (the plain twin of the panel
schedule's rotations), ``zero_state``, ``zero_state_planar`` and
``apply_gate_planar`` with the reference's complex ``apply_gate``
fallback behind it.  Those gate paths
are XLA code in the reference, not Pallas kernels, so plain torch is
their port: every call of :func:`apply_gate_planar` adds one to
``GATE_CALLS``.  The reference's diagonal-run helpers have no copy here:
every ``DiagOp`` carries its Möbius terms, so
``ops/diag_kernels.fused_diag`` serves it.

Endianness: little — qubit 0 is bit 0 of the flat index.
Gate matrices are big-endian in the gate subspace (qubits[0] = MSB).
"""
from __future__ import annotations

import numpy as np
import torch

_SWAP4 = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                   [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex128)

LANE = 7
GATE_CALLS = 0


def expand_to_low_block(qubits: tuple[int, ...], U: np.ndarray, width: int) -> np.ndarray:
    """Expand an m-qubit gate to a 2^width x 2^width matrix over bits 0..width-1.

    The result W is little-endian over the low `width` bits and satisfies
    (psi.reshape(-1, 2^width) @ W.T) == gate applied.  All gate qubits
    must be < width.
    """
    m = len(qubits)
    assert all(q < width for q in qubits)
    dim = 1 << width
    idx = np.arange(dim)
    # gate subspace index of each low-block index (big-endian gate order)
    sub = np.zeros(dim, dtype=np.int64)
    for j, q in enumerate(qubits):
        sub |= ((idx >> q) & 1) << (m - 1 - j)
    other_mask = (dim - 1) ^ sum(1 << q for q in qubits)
    other = idx & other_mask
    W = np.zeros((dim, dim), dtype=np.complex128)
    same = other[:, None] == other[None, :]
    W[same] = np.asarray(U, dtype=np.complex128)[sub[:, None], sub[None, :]][same]
    return W


def compose_low_panel(ops: list[tuple[tuple[int, ...], np.ndarray]], width: int) -> np.ndarray:
    """Fuse a sequence of gates (applied first-to-last) on low qubits into one W."""
    W = np.eye(1 << width, dtype=np.complex128)
    for qubits, U in ops:
        W = expand_to_low_block(tuple(qubits), U, width) @ W
    return W


def _rotation_steps(r: int, n: int) -> list[int]:
    """Decompose a bit rotation into steps whose transpose dims are all
    >= 128 (r_i in [7, n-7]); below n = 16 one step of any r (the
    reference's rule: its TPU transpose padded a tiny dim 16x)."""
    r %= n
    if r == 0:
        return []
    if n < 16:
        return [r]
    if 7 <= r <= n - 7:
        return [r]
    for a in range(7, n - 6):
        b = (r - a) % n
        if 0 < b and 7 <= b <= n - 7:
            return [a, b]
    return [r]  # unreachable for n >= 14


def rotate_bits_right(x: torch.Tensor, r: int) -> torch.Tensor:
    """Cyclically rotate index-bit positions of the flat ``x`` down by r:
    new bit j = old bit (j + r) mod n, the low r bits move to the top.
    The plain twin of a rotation: each step of :func:`_rotation_steps`
    is a (2^(n - r_i), 2^r_i) transpose."""
    n = x.numel().bit_length() - 1
    for step in _rotation_steps(r, n):
        x = x.reshape(1 << (n - step), 1 << step).t().contiguous().reshape(-1)
    return x


def zero_state(m: int, dtype=torch.complex64, device="cpu") -> torch.Tensor:
    psi = torch.zeros(1 << m, dtype=dtype, device=device)
    psi[0] = 1.0
    return psi


def zero_state_planar(m: int, fdtype=torch.float32, device="cpu"):
    """|0...0> as (re, im) planes — no complex materialisation."""
    re = torch.zeros(1 << m, dtype=fdtype, device=device)
    re[0] = 1.0
    return re, torch.zeros(1 << m, dtype=fdtype, device=device)


# ---------------------------------------------------------------------------
# Gate paths on (re, im) planes
# ---------------------------------------------------------------------------

def _gate_view(n: int, qubits) -> tuple[list[int], list[int]]:
    """(shape, axes): a factored view of the flat index (bit n-1 first)
    with one axis of 2 per gate qubit and one axis per run of other
    bits, and the axis of each ``qubits[j]``.  At most 2m + 1 axes: a
    copy of a (2,) * n view of 28 axes would pass the limit on dims of
    a strided CUDA copy."""
    shape, axis_of, run = [], {}, 0
    for b in range(n - 1, -1, -1):
        if b in qubits:
            if run:
                shape.append(1 << run)
                run = 0
            axis_of[b] = len(shape)
            shape.append(2)
        else:
            run += 1
    if run:
        shape.append(1 << run)
    return shape, [axis_of[q] for q in qubits]


def _gate_table(v, shape, axes, like: torch.Tensor):
    """(real, imag | None): a 2^m table over the gate bits (big-endian,
    qubits[0] = MSB) as tensors of ``like``'s dtype and device that
    broadcast on the view ``shape``."""
    m = len(axes)
    bshape = [1] * len(shape)
    for a in axes:
        bshape[a] = 2
    order = sorted(range(m), key=lambda j: axes[j])
    t = np.asarray(v, np.complex128).reshape((2,) * m).transpose(order)
    t = t.reshape(bshape)

    def part(x):
        return torch.as_tensor(np.ascontiguousarray(x),
                               device=like.device).to(like.dtype)

    return part(t.real), (part(t.imag) if t.imag.any() else None)


def diag_planar(re, im, qubits, d):
    """The diagonal ``d`` (2^m phases) on the gate bits as one broadcast
    multiply (the reference's dense.py:677-685)."""
    n = re.numel().bit_length() - 1
    shape, axes = _gate_view(n, tuple(qubits))
    pr, pi = _gate_table(d, shape, axes, re)
    xr, xi = re.reshape(shape), im.reshape(shape)
    if pi is None:
        return (xr * pr).reshape(-1), (xi * pr).reshape(-1)
    return (xr * pr - xi * pi).reshape(-1), (xr * pi + xi * pr).reshape(-1)


def lincomb_planar(re, im, qubits, U):
    """A 1- or 2-qubit U as the reference's strided-plane lincomb
    (dense.py:687-753): on the (A, 2, B, 2, C) view
    ``out = sum_f C_f * flip_f(x)`` over the flip patterns f of the gate
    bits, with ``C_f[s] = U[s, s ^ f]`` and zero parts elided, so a
    permutation gate only moves floats.  Uncounted: it is also the twin
    of the pair kernels."""
    qubits = tuple(qubits)
    n, m = re.numel().bit_length() - 1, len(qubits)
    U = np.asarray(U, dtype=np.complex128)
    shape, axes = _gate_view(n, qubits)
    xr, xi = re.reshape(shape), im.reshape(shape)
    s = np.arange(1 << m)
    ar = ai = None

    def add(acc, t):
        return t if acc is None else acc + t

    for f in range(1 << m):
        cf = U[s, s ^ f]
        if not cf.any():
            continue
        dims = [axes[j] for j in range(m) if (f >> (m - 1 - j)) & 1]
        tr, ti = (xr.flip(dims), xi.flip(dims)) if dims else (xr, xi)
        cr, ci = _gate_table(cf, shape, axes, re)
        if cf.real.any():
            ar, ai = add(ar, tr * cr), add(ai, ti * cr)
        if ci is not None:
            ar, ai = add(ar, -(ti * ci)), add(ai, tr * ci)
    if ar is None:
        return torch.zeros_like(re), torch.zeros_like(im)
    return ar.reshape(-1), ai.reshape(-1)


def contract_planar(re, im, qubits, U):
    """Any m-qubit U as one dense contraction over the gate axes of the
    factored view: the port of the reference's complex ``apply_gate``
    fallback (simulator.py:344), for what the planar forms do not take
    (a 3-qubit Toffoli, a 2q gate across the lane boundary)."""
    qubits = tuple(qubits)
    n, m = re.numel().bit_length() - 1, len(qubits)
    U = np.asarray(U, dtype=np.complex128)
    shape, axes = _gate_view(n, qubits)
    front = list(range(m))
    ur = torch.as_tensor(U.real, device=re.device).to(re.dtype)
    ui = torch.as_tensor(U.imag, device=re.device).to(re.dtype)
    xr = torch.movedim(re.reshape(shape), axes, front)
    xi = torch.movedim(im.reshape(shape), axes, front)
    moved = xr.shape
    xr, xi = xr.reshape(1 << m, -1), xi.reshape(1 << m, -1)

    def back(y):
        return torch.movedim(y.reshape(moved), front, axes).reshape(-1)

    return back(ur @ xr - ui @ xi), back(ur @ xi + ui @ xr)


def planar_kind(qubits, U, n: int) -> str:
    """Which plain path :func:`apply_gate_planar` takes: "diag", "lincomb"
    or "contract" (the reference's complex fallback, where its
    ``apply_gate_planar`` returns None)."""
    qubits = tuple(qubits)
    m = len(qubits)
    U = np.asarray(U, dtype=np.complex128)
    if m <= 12 and not (U - np.diag(np.diag(U))).any():
        return "diag"
    if m == 1 or (m == 2 and min(qubits) >= min(LANE, n)):
        return "lincomb"
    return "contract"


def apply_gate_planar(re: torch.Tensor, im: torch.Tensor,
                      qubits: tuple[int, ...], U: np.ndarray):
    """Any gate on (re, im) planes in plain torch, dispatched as the
    reference's ``apply_gate_planar`` and its complex fallback: a
    diagonal gate of <= 12 qubits is a broadcast multiply, a 1q gate or
    a 2q gate on bits >= 7 a strided lincomb (a SWAP only moves floats),
    anything else one dense contraction.  Adds one to ``GATE_CALLS``."""
    global GATE_CALLS
    GATE_CALLS += 1
    qubits = tuple(qubits)
    U = np.asarray(U, dtype=np.complex128)
    kind = planar_kind(qubits, U, re.numel().bit_length() - 1)
    if kind == "diag":
        return diag_planar(re, im, qubits, np.diag(U))
    if kind == "lincomb":
        return lincomb_planar(re, im, qubits, U)
    return contract_planar(re, im, qubits, U)
