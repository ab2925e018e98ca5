"""Merged diagonal runs on (re, im) planes: the ``fused_diag`` CUDA kernel
for the card and its plain torch twin.

Counterpart of ``fused_diag_planar`` in
``quantum_simulations_tpu/ops/pallas_kernels.py``: a run of diagonal
gates, given as its Möbius phase terms ``((qubits...), coeff)``, applied
in one pass as ``psi[i] *= exp(i theta(i))`` with
``theta(i) = sum of coeff over the terms whose qubits are all set in i``.

:class:`DiagTerms` packs a term tuple once into the kernel operand
(``csrc/phase.cuh``: a lane table, groups of row-side terms by lane-bit
subset, angles as 32-bit fixed-point turns) and caches it per device.  The
panel kernels' diag epilogue (``ops/panel_kernels.py``) takes the same
operand.

``fused_diag`` runs the kernel (``csrc/diag.cu``) on a CUDA tensor and the
twin on a CPU tensor, and nothing else; ``plain=True`` asks for the twin
on any device, ``inplace=True`` writes into the given planes (the
kernel's aliasing instance; the twin copies its result back).  Every
launch adds one to ``LAUNCHES["fused_diag"]`` (``"fused_diag inplace"``
in place), every twin call one to ``PLAIN_CALLS`` under the same key.
The twin sums theta in float64 (exact next to the kernel's fixed point)
and rotates in the plane dtype.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .cuda_build import launch, on_card, outputs, store

LANES = 128
LANE_BITS = 7

LAUNCHES = {"fused_diag": 0, "fused_diag inplace": 0}
PLAIN_CALLS = dict(LAUNCHES)


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _turns_u32(coeff: float) -> int:
    """coeff (rad) as 32-bit fixed-point turns, rounded, mod 2^32."""
    return int(round(coeff / (2 * math.pi) * 2.0 ** 32)) % (1 << 32)


def _mask(qubits) -> int:
    m = 0
    for q in qubits:
        m |= 1 << q
    return m


@dataclass(frozen=True)
class DiagTerms:
    """A merged diagonal run's Möbius terms with their kernel operand.

    ``words`` is the packed operand of ``csrc/phase.cuh`` (uint32):
    the 128-entry lane table of the terms without row bits, then, for
    ``G`` groups of terms that share one lane-bit subset L, ``lmask[G]``,
    ``start[G + 1]`` and the ``T`` terms' ``rmask[T]`` (row bits q - 7)
    and ``coeff[T]``.  ``operand(device)`` uploads it once per device.
    """
    terms: tuple
    words: np.ndarray = field(compare=False, repr=False)
    G: int = field(compare=False)
    T: int = field(compare=False)
    packed: dict = field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def of(cls, terms) -> "DiagTerms | None":
        if terms is None or isinstance(terms, DiagTerms):
            return terms
        terms = tuple((tuple(int(q) for q in qs), float(c)) for qs, c in terms)
        lane = np.zeros(LANES, np.uint64)
        lanes = np.arange(LANES)
        groups: dict[int, list] = {}
        for qs, c in terms:
            lmask = _mask(q for q in qs if q < LANE_BITS)
            rmask = _mask(q - LANE_BITS for q in qs if q >= LANE_BITS)
            if rmask >= 1 << 32:
                raise ValueError("DiagTerms: row bits beyond 32 (n > 39)")
            u = _turns_u32(c)
            if rmask == 0:
                lane[(lanes & lmask) == lmask] += u
            else:
                groups.setdefault(lmask, []).append((rmask, u))
        lmasks = list(groups)
        start = [0]
        rm, co = [], []
        for lm in lmasks:
            for r, u in groups[lm]:
                rm.append(r)
                co.append(u)
            start.append(len(rm))
        words = np.concatenate([
            lane % (1 << 32), np.array(lmasks, np.uint64),
            np.array(start, np.uint64), np.array(rm, np.uint64),
            np.array(co, np.uint64)]).astype(np.uint32)
        return cls(terms, words, len(lmasks), len(rm))

    def operand(self, device) -> torch.Tensor:
        """The packed words as an int32 tensor (same bits) on ``device``."""
        key = str(device)
        if key not in self.packed:
            self.packed[key] = torch.from_numpy(
                self.words.view(np.int32).copy()).to(device)
        return self.packed[key]


# ---------------------------------------------------------------------------
# Plain torch twin
# ---------------------------------------------------------------------------

def terms_theta(N: int, terms, dtype, device) -> torch.Tensor:
    """theta(i) = sum of coeff over the terms all set in i, for i < N,
    summed in ``dtype``."""
    idx = torch.arange(N, dtype=torch.int64, device=device)
    theta = torch.zeros(N, dtype=dtype, device=device)
    for qs, c in terms:
        m = _mask(qs)
        theta += ((idx & m) == m).to(dtype) * c
    return theta


def rotate_plain(re, im, theta):
    """(re, im) * exp(i theta), with cos / sin cast to the plane dtype."""
    c, s = torch.cos(theta).to(re.dtype), torch.sin(theta).to(re.dtype)
    return re * c - im * s, im * c + re * s


def apply_diag_plain(re, im, terms):
    """The twin's arithmetic, uncounted (the panel twins' epilogue too):
    theta summed in float64, the rotation in the plane dtype."""
    terms = DiagTerms.of(terms).terms
    return rotate_plain(re, im, terms_theta(re.numel(), terms, torch.float64,
                                            re.device))


def _key(inplace: bool) -> str:
    return "fused_diag inplace" if inplace else "fused_diag"


def fused_diag_plain(re, im, terms, inplace=False):
    """The plain twin of ``fused_diag``."""
    PLAIN_CALLS[_key(inplace)] += 1
    out = apply_diag_plain(re, im, terms)
    return store(re, im, out) if inplace else out


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "qst_error_string": (ctypes.c_char_p, [_I]),
    "qst_fused_diag": (_I, [_P, _P, _P, _P, _LL, _P, _I, _I, _I, _P]),
}


def phase_args(dterms: "DiagTerms | None", device) -> tuple:
    """(pointer, G, T) of a packed operand for a kernel entry; null if none."""
    if dterms is None:
        return (None, 0, 0)
    return (dterms.operand(device).data_ptr(), dterms.G, dterms.T)


def fused_diag(re, im, terms, *, inplace: bool = False, plain: bool = False):
    """psi *= exp(i theta) for a merged run's Möbius ``terms`` (a tuple
    or a :class:`DiagTerms`), in one pass, in place with ``inplace``."""
    dterms = DiagTerms.of(terms)
    if plain or not on_card("fused_diag", re, im):
        return fused_diag_plain(re, im, dterms, inplace)
    ore, oim = outputs(re, im, inplace)
    launch("diag", _SIGNATURES, "qst_fused_diag", re.device, re.data_ptr(),
           im.data_ptr(), ore.data_ptr(), oim.data_ptr(), re.numel(),
           *phase_args(dterms, re.device))
    LAUNCHES[_key(inplace)] += 1
    return ore, oim
