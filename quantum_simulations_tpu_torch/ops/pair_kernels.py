"""Two-qubit gates on (re, im) planes: one CUDA kernel, ``pair_gate``, for
the card and its plain torch twin, behind three wrappers named after the
TPU entries they replace.

Counterparts of ``quantum_simulations_tpu/ops/pallas_kernels.py``:

===================  ======================================================
``pair_update``      ``pair_update_planar``: both bits >= 7 (column body
                     for lo <= 12, row body above; in place, as the
                     reference's ``_pair_row_inplace_kernel``, for
                     lo >= 10 only)
``mixed_pair``       ``mixed_pair_planar``: a lane bit (< 7) and a bit
                     >= 10
``mixed_low_pair``   ``mixed_low_pair_planar``: a lane bit and a bit in
                     7..9 (matmul body and lane-diagonal body)
``midpair``          ``midpair_planar``: a bit in 7..9 and a bit >= 10,
                     in place only (the reference calls it so)
===================  ======================================================

The four compute one function, a 4x4 unitary on index bits (lo, hi):
``out[i | ho 2^hi | l' 2^lo] = sum C[ho, l', h, l] in[i | h 2^hi | l 2^lo]``
with ``C = pair_coeffs(U, qa, qb)`` (U big-endian, qa its MSB, as in the
reference).  The TPU entries differ only in how they fit the (8, 128)
tiling and the 128x128 MXU; on the card one kernel (``csrc/pair.cu``)
serves every 0 <= lo < hi < n, out of place or (its aliasing instance)
in place.  Each wrapper checks its reference predicate and keeps its own
``LAUNCHES`` / ``PLAIN_CALLS`` key, with ``" inplace"`` appended for an
in-place call of the first three (``midpair`` is in place by nature).

A wrapper runs the kernel on a CUDA tensor and the twin on a CPU tensor,
and nothing else; ``plain=True`` asks for the twin on any device.  The
twin is the strided (A, 2, B, 2, C) lincomb of the reference's
``dense.apply_gate_planar`` (``ops/dense.lincomb_planar``), copied back
into the given planes in place.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_build import check_aligned, launch, on_card, outputs, store
from .dense import lincomb_planar

LANE = 7

_KEYS = ("pair_update", "mixed_pair", "mixed_low_pair", "pair_update inplace",
         "mixed_pair inplace", "mixed_low_pair inplace", "midpair")
LAUNCHES = dict.fromkeys(_KEYS, 0)
PLAIN_CALLS = dict.fromkeys(_KEYS, 0)


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# The reference's predicates and coefficients (jax-free copies)
# ---------------------------------------------------------------------------

def pair_update_supported(qa: int, qb: int, lane: int = LANE) -> bool:
    hi, lo = max(qa, qb), min(qa, qb)
    if lo < lane:
        return False
    return lo >= 13 or hi >= lo + 4  # column kernel needs B >= 8


def mixed_pair_supported(qa: int, qb: int, lane: int = LANE) -> bool:
    hi, lo = max(qa, qb), min(qa, qb)
    return lo < lane and hi >= 10


def mixed_low_pair_supported(qa: int, qb: int, lane: int = LANE) -> bool:
    hi, lo = max(qa, qb), min(qa, qb)
    return lo < lane and lane <= hi <= 9


def midpair_supported(qa: int, qb: int) -> bool:
    hi, lo = max(qa, qb), min(qa, qb)
    return 7 <= lo <= 9 and hi >= 10


def pair_coeffs(U, qa: int, qb: int) -> np.ndarray:
    """C[ho, lo_, h, l] = <out plane (ho, lo_)| U |in plane (h, l)>, with
    (h, l) the values of the high / low bit positions and U big-endian
    in gate-qubit order (qa = MSB)."""
    hi = max(qa, qb)

    def sub(h: int, l: int) -> int:
        return (h << 1) | l if qa == hi else (l << 1) | h

    u = np.asarray(U, dtype=np.complex128)
    idx = [sub(h, l) for h in (0, 1) for l in (0, 1)]
    return u[np.ix_(idx, idx)].reshape(2, 2, 2, 2)


@functools.lru_cache(maxsize=4096)
def _packed(qa: int, qb: int, u_bytes: bytes):
    """The kernel's coefficient argument, 16 real parts then 16
    imaginary parts in (ho, lo_, h, l) order, packed once per gate."""
    U = np.frombuffer(u_bytes, dtype=np.complex128).reshape(4, 4)
    C = pair_coeffs(U, qa, qb).reshape(-1)
    return (ctypes.c_float * 32)(*C.real.tolist(), *C.imag.tolist())


# ---------------------------------------------------------------------------
# Plain torch twin
# ---------------------------------------------------------------------------

def pair_gate_plain(re, im, qa: int, qb: int, U):
    """The twin's arithmetic, uncounted: the (A, 2, B, 2, C) lincomb."""
    return lincomb_planar(re, im, (qa, qb), U)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "qst_error_string": (ctypes.c_char_p, [_I]),
    "qst_pair_gate": (_I, [_P, _P, _P, _P, _LL, _I, _I,
                           ctypes.POINTER(ctypes.c_float), _I, _P]),
}


def _pair_gate(name: str, re, im, qa: int, qb: int, U, plain: bool,
               inplace: bool = False):
    n = re.numel().bit_length() - 1
    if qa == qb or not (0 <= min(qa, qb) and max(qa, qb) < n):
        raise ValueError(f"{name}: qubits ({qa}, {qb}) on a {n}-qubit state")
    key = name + " inplace" if inplace and name != "midpair" else name
    if plain or not on_card(name, re, im):
        PLAIN_CALLS[key] += 1
        out = pair_gate_plain(re, im, qa, qb, U)
        return store(re, im, out) if inplace else out
    check_aligned(name, re, im)
    u = np.ascontiguousarray(np.asarray(U, dtype=np.complex128))
    if u.shape != (4, 4):
        raise ValueError(f"{name}: U must be 4x4, got {u.shape}")
    ore, oim = outputs(re, im, inplace)
    launch("pair", _SIGNATURES, "qst_pair_gate", re.device,
           re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
           re.numel(), min(qa, qb), max(qa, qb),
           _packed(int(qa), int(qb), u.tobytes()))
    LAUNCHES[key] += 1
    return ore, oim


def pair_update(re, im, qa: int, qb: int, U, *, inplace: bool = False,
                plain: bool = False):
    """A 4x4 U on two bits >= 7 (``pair_update_supported``); in place
    only with both bits >= 10, as the reference asserts."""
    if not pair_update_supported(qa, qb):
        raise ValueError(f"pair_update: ({qa}, {qb}) fails pair_update_supported")
    if inplace and min(qa, qb) < 10:
        raise ValueError(f"pair_update: in place needs both bits >= 10, not "
                         f"{(qa, qb)} (midpair takes 7..9)")
    return _pair_gate("pair_update", re, im, qa, qb, U, plain, inplace)


def mixed_pair(re, im, qa: int, qb: int, U, *, inplace: bool = False,
               plain: bool = False):
    """A 4x4 U on a lane bit and a bit >= 10 (``mixed_pair_supported``)."""
    if not mixed_pair_supported(qa, qb):
        raise ValueError(f"mixed_pair: ({qa}, {qb}) fails mixed_pair_supported")
    return _pair_gate("mixed_pair", re, im, qa, qb, U, plain, inplace)


def mixed_low_pair(re, im, qa: int, qb: int, U, *, inplace: bool = False,
                   plain: bool = False):
    """A 4x4 U on a lane bit and a bit in 7..9
    (``mixed_low_pair_supported``)."""
    if not mixed_low_pair_supported(qa, qb):
        raise ValueError(f"mixed_low_pair: ({qa}, {qb}) fails "
                         f"mixed_low_pair_supported")
    return _pair_gate("mixed_low_pair", re, im, qa, qb, U, plain, inplace)


def midpair(re, im, qa: int, qb: int, U, *, plain: bool = False):
    """A 4x4 U on a bit in 7..9 and a bit >= 10 (``midpair_supported``),
    in place: the capacity tier's route for such gates and SWAPs
    (the reference's ``midpair_planar(..., inplace=True)``)."""
    if not midpair_supported(qa, qb):
        raise ValueError(f"midpair: ({qa}, {qb}) fails midpair_supported")
    return _pair_gate("midpair", re, im, qa, qb, U, plain, inplace=True)
