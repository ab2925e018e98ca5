"""The window path's panel kernels on (re, im) planes: CUDA for the card,
a plain torch twin of each for the CPU and for checking.

Counterpart of the three panel entries of
``quantum_simulations_tpu/ops/pallas_kernels.py``:

=====================  ====================================================
``lane_panel``         ``panel_apply_planar`` (pos 0), with its ``rotate``
                       option: the transposed store, so the pass also
                       rotates the index bits right by log2(dim)
``positioned_panel``   ``positioned_panel_planar`` (pos >= 7, ragged too)
``dual_panel``         ``dual_panel_planar`` with its straddler gates
=====================  ====================================================

Each takes the reference's ``diag_terms``: the merged diagonal run that
follows the panel (``runtime/simulator.pair_panel_diag``), applied to the
panel's output in the same pass (the kernel's diag epilogue,
``csrc/phase.cuh``).  A panel whose tile rows are not whole state rows
(width below 128, or a positioned panel below pos 7) runs the reference's
two passes instead: the panel kernel, then ``fused_diag``.

Each wrapper runs its CUDA kernel (``csrc/panels.cu``) on a CUDA tensor
and its plain twin on a CPU tensor, and nothing else: on the card it
launches or raises, with no fallback.  ``plain=True`` asks for the twin
on any device (the float64 reference run on the card).  ``inplace=True``
(the reference's ``inplace``, the capacity tier) writes the result into
the given planes and returns them: on the card the kernel's aliasing
instance, in the twin an out-of-place result copied back.  Every launch
adds one to ``LAUNCHES[name]``, ``name + "+diag"`` with an epilogue,
``"lane_panel+rotate"`` for a rotated lane panel, and ``" inplace"``
after any of them in place; every twin call adds one to
``PLAIN_CALLS`` under the same key.  A twin with ``diag_terms`` runs the
panel and then the diag twin's arithmetic
(``ops/diag_kernels.apply_diag_plain``).

The kernels take float32 planes only (the TPU kernels never ran float64
on the chip); the twins take any float type.  At dim 128 the lane and
positioned kernels and both contractions of ``dual_panel`` run on the
tensor cores in split TF32 (three TF32 products a real product:
float32-class accuracy; ``csrc/panels.cu``), narrower panels and the
dual's straddlers on the float32 SIMT units.  A W is a
numpy complex matrix or a ``(wr, wi)`` pair of planes from
:func:`w_planes`.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from .cuda_build import launch, load, on_card, outputs, store
from .diag_kernels import DiagTerms, apply_diag_plain, fused_diag, phase_args

# The reference holds panels to full float32 precision (HIGHEST); a
# single-pass TF32 product loses 13 mantissa bits.  The twins' matmuls
# and the timed library calls must not use it either.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LANES = 128
TILE_ELEMS = LANES * LANES

_KEYS = tuple(k + mode for mode in ("", " inplace") for k in (
    "lane_panel", "lane_panel+diag", "positioned_panel",
    "positioned_panel+diag", "dual_panel", "dual_panel+diag")) + (
    "lane_panel+rotate",)
LAUNCHES = dict.fromkeys(_KEYS, 0)
PLAIN_CALLS = dict.fromkeys(_KEYS, 0)


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# Planes and operands
# ---------------------------------------------------------------------------

def to_planar(psi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return psi.real.contiguous(), psi.imag.contiguous()


def from_planar(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.complex(re, im)


def w_planes(W, device, fdtype) -> tuple[torch.Tensor, torch.Tensor]:
    """A panel as contiguous (wr, wi) planes of ``fdtype`` on ``device``."""
    if isinstance(W, tuple):
        wr, wi = W
        return (wr.to(device=device, dtype=fdtype).contiguous(),
                wi.to(device=device, dtype=fdtype).contiguous())
    Wn = np.asarray(W, dtype=np.complex128)
    return (torch.as_tensor(np.ascontiguousarray(Wn.real), device=device).to(fdtype),
            torch.as_tensor(np.ascontiguousarray(Wn.imag), device=device).to(fdtype))


def _straddle_plan(qb: int, U, npdt):
    """Static plan for a (6, qb in 7..13) straddler (the reference's).

    ``out[p] = sum_k C_k[p] * x[p ^ flips_k]`` over the <= 4 flip
    patterns of the two bits (k bit 0: row bit ``qb - 7``; k bit 1:
    lane bit 6), with (128, 128) coefficient planes
    ``C_k[p] = U[b(p), b(p)^k]`` (b = 2*x_lane6 + x_dbit).  Zero terms
    are elided; a permutation-like gate (CNOT) becomes one select.
    Returns ``(creal, cimag | None, meta)`` with
    ``meta = (qb, ks, kinds, has_imag)``.
    """
    dbit = qb - 7
    d0 = (np.arange(128) >> dbit) & 1          # row -> d-bit value
    l6 = (np.arange(128) >> 6) & 1             # lane -> bit-6 value
    b = 2 * l6[None, :] + d0[:, None]          # (128, 128) block ids
    Un = np.asarray(U, np.complex128)
    ks, kinds, crs, cis = [], [], [], []
    has_imag = False
    planes = {}
    for k in range(4):
        C = Un[b, b ^ k]
        if not C.any():
            continue
        planes[k] = C
        ks.append(k)
        if np.allclose(C.imag, 0.0):
            kinds.append("unit" if np.allclose(C.real, 1.0) else "real")
        else:
            kinds.append("complex")
            has_imag = True
        crs.append(C.real.astype(npdt))
        cis.append(C.imag.astype(npdt))
    if (len(ks) == 2 and ks[0] == 0
            and all(np.allclose(planes[k].imag, 0) for k in ks)
            and all(np.isin(planes[k].real, (0.0, 1.0)).all() for k in ks)
            and np.allclose(planes[ks[0]].real + planes[ks[1]].real, 1.0)):
        mask = planes[ks[1]].real.astype(npdt)  # 1 -> take flipped term
        return mask[None], None, (qb, (ks[1],), ("select",), False)
    creal = np.stack(crs)
    cimag = np.stack(cis) if has_imag else None
    return creal, cimag, (qb, tuple(ks), tuple(kinds), has_imag)


@dataclass(frozen=True)
class Straddle:
    """A (6, qb) straddler gate, U normalised to (6, qb) order, with its
    kernel operand (Re U, Im U as 32 floats) cached per device."""
    qb: int
    U: np.ndarray
    packed: dict = field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def of(cls, s) -> "Straddle | None":
        """From the scheduler's ``(6, qb, U4)`` tuple (or a Straddle)."""
        if s is None or isinstance(s, Straddle):
            return s
        qa, qb, U = s
        if qa != 6 or not 7 <= qb <= 13:
            raise ValueError(f"a straddler acts on (6, qb in 7..13), not {s[:2]}")
        return cls(int(qb), np.asarray(U, np.complex128))

    def operand(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self.packed:
            u = np.concatenate([self.U.real.ravel(), self.U.imag.ravel()])
            self.packed[key] = torch.as_tensor(u, dtype=torch.float32,
                                               device=device)
        return self.packed[key]


def dual_panel_supported(p1: int, p2: int) -> bool:
    # Only (0, 7): both contractions of the (A, 128, 128) view are plain
    # 128-wide products, so the pair shares one pass of traffic.
    return {p1, p2} == {0, 7}


# ---------------------------------------------------------------------------
# Plain torch twins
# ---------------------------------------------------------------------------

def _cmm(ar, ai, br, bi):
    """(ar + i ai) @ (br + i bi) as planes."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _key(name: str, diag_terms, inplace: bool = False) -> str:
    return (name + ("" if diag_terms is None else "+diag")
            + (" inplace" if inplace else ""))


def _epilogue_plain(re, im, out, diag_terms, inplace):
    """The twin's diag run on ``out``, then the in-place copy into
    ``(re, im)``."""
    if diag_terms is not None:
        out = apply_diag_plain(*out, diag_terms)
    return store(re, im, out) if inplace else out


def lane_panel_plain(re, im, W, diag_terms=None, inplace=False,
                     rotate=False):
    """out[r, i] = sum_k W[i, k] x[r, k] over the view (R, dim) (with
    ``rotate``: out[i, r], the index bits rotated right by log2(dim)),
    then the diag run ``diag_terms`` if given."""
    _check_rotate(rotate, inplace)
    PLAIN_CALLS["lane_panel+rotate" if rotate
                else _key("lane_panel", diag_terms, inplace)] += 1
    wr, wi = w_planes(W, re.device, re.dtype)
    dim = wr.shape[0]
    o_re, o_im = _cmm(re.reshape(-1, dim), im.reshape(-1, dim), wr.T, wi.T)
    if rotate:
        o_re, o_im = o_re.t().contiguous(), o_im.t().contiguous()
    return _epilogue_plain(re, im, (o_re.reshape(-1), o_im.reshape(-1)),
                           diag_terms, inplace)


def _check_rotate(rotate: bool, inplace: bool) -> None:
    if rotate and inplace:
        raise ValueError("lane_panel: an in-place panel cannot rotate (the "
                         "transposed store would overwrite rows other "
                         "blocks still read)")


def positioned_panel_plain(re, im, W, pos: int, diag_terms=None,
                           inplace=False):
    """out[a, i, c] = sum_k W[i, k] x[a, k, c] over the view (A, dim, 2^pos),
    then the diag run ``diag_terms`` if given."""
    PLAIN_CALLS[_key("positioned_panel", diag_terms, inplace)] += 1
    wr, wi = w_planes(W, re.device, re.dtype)
    dim = wr.shape[0]
    shape = (-1, dim, 1 << pos)
    o_re, o_im = _cmm(wr, wi, re.reshape(shape), im.reshape(shape))
    return _epilogue_plain(re, im, (o_re.reshape(-1), o_im.reshape(-1)),
                           diag_terms, inplace)


def _straddle_plain(xr, xi, s: Straddle):
    """The reference's ``_straddle_prologue`` on (A, 128, 128) planes."""
    creal, cimag, (qb, ks, kinds, _) = _straddle_plan(
        s.qb, s.U, np.dtype(str(xr.dtype).removeprefix("torch.")))
    creal = torch.as_tensor(creal, device=xr.device)
    cimag = None if cimag is None else torch.as_tensor(cimag, device=xr.device)
    dbit = qb - 7
    A = xr.shape[0]

    def flip_d(x):  # XOR of row bit dbit
        v = x.reshape(A, 128 >> (dbit + 1), 2, 1 << dbit, 128)
        return torch.flip(v, dims=[2]).reshape(x.shape)

    def term(k):  # k bit 0: row-bit flip, bit 1: lane-6 flip (XOR 64)
        tr, ti = xr, xi
        if k & 2:
            tr, ti = torch.roll(tr, 64, dims=-1), torch.roll(ti, 64, dims=-1)
        if k & 1:
            tr, ti = flip_d(tr), flip_d(ti)
        return tr, ti

    if kinds == ("select",):
        sel = creal[0] > 0.5
        tr, ti = term(ks[0])
        return torch.where(sel, tr, xr), torch.where(sel, ti, xi)
    acc_r = acc_i = None
    for t, (k, kind) in enumerate(zip(ks, kinds)):
        tr, ti = term(k)
        if kind == "unit":
            pr, pi = tr, ti
        elif kind == "real":
            pr, pi = tr * creal[t], ti * creal[t]
        else:
            pr = tr * creal[t] - ti * cimag[t]
            pi = ti * creal[t] + tr * cimag[t]
        acc_r = pr if acc_r is None else acc_r + pr
        acc_i = pi if acc_i is None else acc_i + pi
    return acc_r, acc_i


def dual_panel_plain(re, im, W1, p1, W2, p2, straddle=None,
                     post_straddle=None, diag_terms=None, inplace=False):
    """[pre] W1@p1, W2@p2 [post] [diag] on the (A, 128, 128) view, in op
    order.

    Mode "lane" (pos 0): out[a, d, l] = sum_m W[l, m] x[a, d, m];
    mode "full" (pos 7): out[a, i, k] = sum_j W[i, j] x[a, j, k].
    """
    PLAIN_CALLS[_key("dual_panel", diag_terms, inplace)] += 1
    xr = re.reshape(-1, LANES, LANES)
    xi = im.reshape(-1, LANES, LANES)
    if straddle is not None:
        xr, xi = _straddle_plain(xr, xi, Straddle.of(straddle))
    for W, p in ((W1, p1), (W2, p2)):
        wr, wi = w_planes(W, re.device, re.dtype)
        if p == 0:
            xr, xi = _cmm(xr, xi, wr.T, wi.T)
        else:
            xr, xi = _cmm(wr, wi, xr, xi)
    if post_straddle is not None:
        xr, xi = _straddle_plain(xr, xi, Straddle.of(post_straddle))
    return _epilogue_plain(re, im, (xr.reshape(-1), xi.reshape(-1)),
                           diag_terms, inplace)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PHASE = [_P, _I, _I]  # the packed DiagTerms operand (or null), G, T
_SIGNATURES = {
    "qst_error_string": (ctypes.c_char_p, [_I]),
    "qst_lane_panel": (_I, [_P, _P, _P, _P, _P, _P, _LL, _I, _I, *_PHASE,
                            _I, _P]),
    "qst_positioned_panel": (_I, [_P, _P, _P, _P, _P, _P, _LL, _I, _LL,
                                  *_PHASE, _I, _P]),
    "qst_dual_panel": (_I, [_P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P,
                            _I, _P, _P, _LL, *_PHASE, _I, _P]),
}


def variant_library(defines: tuple) -> ctypes.CDLL:
    """``csrc/panels.cu`` built with the ``-D`` macros ``defines`` (its
    measurement variants, ``panel_variants.py``), entries typed as the
    wrappers' own."""
    return load("panels", _SIGNATURES, defines)


def _check_dim(name: str, dim: int, N: int, view: int) -> None:
    if dim & (dim - 1) or not 1 <= dim <= LANES or N % view:
        raise ValueError(f"{name}: W of width {dim} does not fit 2^n = {N}")


def lane_panel(re, im, W, *, diag_terms=None, inplace: bool = False,
               rotate: bool = False, plain: bool = False):
    """W on the low bits: out[r, i] = sum_k W[i, k] x[r, k], view (R, dim),
    then the merged diag run ``diag_terms`` if given.

    ``rotate`` (the reference's ``rotate=True``): the tile is stored
    transposed, out[i, r] of the (dim, R) view, so the result's index
    bits are rotated right by log2(dim), as ``dense.rotate_bits_right``
    after the panel.  Out of place only; with ``diag_terms`` the diag
    run is a second pass on the rotated result (``fused_diag``), as the
    reference runs it."""
    _check_rotate(rotate, inplace)
    diag_terms = DiagTerms.of(diag_terms)
    if plain or not on_card("lane_panel", re, im):
        return lane_panel_plain(re, im, W, diag_terms, inplace, rotate)
    wr, wi = w_planes(W, re.device, re.dtype)
    dim, N = wr.shape[0], re.numel()
    _check_dim("lane_panel", dim, N, dim)
    fuse = diag_terms if dim == LANES and not rotate else None
    ore, oim = outputs(re, im, inplace)
    launch("panels", _SIGNATURES, "qst_lane_panel", re.device,
           re.data_ptr(), im.data_ptr(), wr.data_ptr(), wi.data_ptr(),
           ore.data_ptr(), oim.data_ptr(), N // dim, dim, int(rotate),
           *phase_args(fuse, re.device))
    LAUNCHES["lane_panel+rotate" if rotate
             else _key("lane_panel", fuse, inplace)] += 1
    if diag_terms is not None and fuse is None:
        return fused_diag(ore, oim, diag_terms, inplace=inplace)
    return ore, oim


def positioned_panel(re, im, W, pos: int, *, diag_terms=None,
                     inplace: bool = False, plain: bool = False):
    """W on the bit window [pos, pos + w): view (A, dim, C = 2^pos), then
    the merged diag run ``diag_terms`` if given."""
    diag_terms = DiagTerms.of(diag_terms)
    if plain or not on_card("positioned_panel", re, im):
        return positioned_panel_plain(re, im, W, pos, diag_terms, inplace)
    wr, wi = w_planes(W, re.device, re.dtype)
    dim, N, C = wr.shape[0], re.numel(), 1 << pos
    _check_dim("positioned_panel", dim, N, dim * C)
    fuse = diag_terms if dim == LANES and C >= LANES else None
    ore, oim = outputs(re, im, inplace)
    launch("panels", _SIGNATURES, "qst_positioned_panel", re.device,
           re.data_ptr(), im.data_ptr(), wr.data_ptr(), wi.data_ptr(),
           ore.data_ptr(), oim.data_ptr(), N // (dim * C), dim, C,
           *phase_args(fuse, re.device))
    LAUNCHES[_key("positioned_panel", fuse, inplace)] += 1
    if diag_terms is not None and fuse is None:
        return fused_diag(ore, oim, diag_terms, inplace=inplace)
    return ore, oim


def dual_panel(re, im, W1, p1: int, W2, p2: int, *, straddle=None,
               post_straddle=None, diag_terms=None, inplace: bool = False,
               plain: bool = False):
    """W1@p1 then W2@p2 ((p1, p2) a permutation of (0, 7)) in one pass,
    with an optional (6, qb) straddler gate before and after, then the
    merged diag run ``diag_terms`` if given."""
    if not dual_panel_supported(p1, p2):
        raise ValueError(f"dual_panel takes positions (0, 7), not {(p1, p2)}")
    straddle, post_straddle = Straddle.of(straddle), Straddle.of(post_straddle)
    diag_terms = DiagTerms.of(diag_terms)
    if re.numel() < TILE_ELEMS:
        return _dual_small(re, im, W1, p1, W2, p2, straddle, post_straddle,
                           diag_terms, inplace, plain)
    if plain or not on_card("dual_panel", re, im):
        return dual_panel_plain(re, im, W1, p1, W2, p2, straddle,
                                post_straddle, diag_terms, inplace)
    dev = re.device
    w1r, w1i = w_planes(W1, dev, re.dtype)
    w2r, w2i = w_planes(W2, dev, re.dtype)
    if w1r.shape[0] != LANES or w2r.shape[0] != LANES:
        raise ValueError("dual_panel needs two 128-wide panels")

    def strad(s):
        return (None, 0) if s is None else (s.operand(dev).data_ptr(), s.qb)

    pre, post = strad(straddle), strad(post_straddle)
    ore, oim = outputs(re, im, inplace)
    launch("panels", _SIGNATURES, "qst_dual_panel", dev,
           re.data_ptr(), im.data_ptr(),
           w1r.data_ptr(), w1i.data_ptr(), int(p1 != 0),
           w2r.data_ptr(), w2i.data_ptr(), int(p2 != 0),
           pre[0], pre[1], post[0], post[1],
           ore.data_ptr(), oim.data_ptr(), re.numel() // TILE_ELEMS,
           *phase_args(diag_terms, dev))
    LAUNCHES[_key("dual_panel", diag_terms, inplace)] += 1
    return ore, oim


def _dual_small(re, im, W1, p1, W2, p2, straddle, post_straddle, diag_terms,
                inplace, plain):
    """States below one (128, 128) tile (n < 14): the reference's
    two-pass branch, panels through their own wrappers (the second one
    with the diag run, unless a post-straddler follows it) and the
    straddlers in plain torch."""
    from . import dense

    def strad(re, im, s):
        out = dense.apply_gate_planar(re, im, (6, s.qb), s.U)
        return store(re, im, out) if inplace else out

    def one(re, im, W, p, dt=None):
        if p == 0:
            return lane_panel(re, im, W, diag_terms=dt, inplace=inplace,
                              plain=plain)
        return positioned_panel(re, im, W, p, diag_terms=dt, inplace=inplace,
                                plain=plain)

    if straddle is not None:
        re, im = strad(re, im, straddle)
    re, im = one(re, im, W1, p1)
    if post_straddle is None:
        return one(re, im, W2, p2, diag_terms)
    re, im = one(re, im, W2, p2)
    re, im = strad(re, im, post_straddle)
    if diag_terms is not None:
        re, im = fused_diag(re, im, diag_terms, inplace=inplace, plain=plain)
    return re, im
