"""Bit permutations of the state index on (re, im) planes: QFT's terminal
bit reversal.  CUDA kernels for the card, a plain torch twin of each.

=====================  ====================================================
``bitperm_swap``       ``bitperm_swap_planar``: a permutation of the bits
                       >= 7 (disjoint pairs plus a ``grid_map`` bijection
                       on the bits >= 10), out of place
``bitperm_transpose``  ``bitperm_transpose_planar``: lane bit l <-> bit
                       n - 7 + l, out[x, m, y] = in[y, m, x] on the
                       (128, M, 128) view, out of place
=====================  ====================================================

Each wrapper runs its CUDA kernel (``csrc/bitperm.cu``) on a CUDA tensor
and its plain twin on a CPU tensor, and nothing else; ``plain=True`` asks
for the twin on any device.  Every launch adds one to ``LAUNCHES[name]``,
every twin call one to ``PLAIN_CALLS[name]``.  Both only move floats, so
kernel and twin agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import launch, on_card

LANE_BITS = 7
LANES = 1 << LANE_BITS

LAUNCHES = {"bitperm_swap": 0, "bitperm_transpose": 0}
PLAIN_CALLS = {"bitperm_swap": 0, "bitperm_transpose": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _n_of(re: torch.Tensor) -> int:
    return re.numel().bit_length() - 1


def bit_sources(n: int, pairs, grid_map) -> list[int]:
    """src[b] for every index bit b < n: the output index bit that input
    bit b is read from, so ``out[i] = in[sigma(i)]`` with bit b of
    sigma(i) equal to bit src[b] of i.  A pair swaps its two bits;
    ``grid_map`` is {b: src[b]} on bits >= 10.  Checked as the reference
    checks it (``bitperm_swap_planar``)."""
    pairs = tuple(tuple(sorted(p)) for p in pairs)
    grid_map = dict(grid_map or {})
    flat = [b for p in pairs for b in p]
    if n < 10:
        raise ValueError("bitperm_swap needs n >= 10")
    if len(set(flat)) != len(flat):
        raise ValueError(f"bitperm_swap: pairs {pairs} are not disjoint")
    if not all(LANE_BITS <= lo and hi < n for lo, hi in pairs):
        raise ValueError(f"bitperm_swap: pairs {pairs} leave bits [7, {n})")
    if sorted(grid_map) != sorted(grid_map.values()):
        raise ValueError(f"bitperm_swap: grid_map {grid_map} is not a bijection")
    if not all(10 <= b < n and 10 <= s < n for b, s in grid_map.items()):
        raise ValueError(f"bitperm_swap: grid_map {grid_map} leaves bits [10, {n})")
    if set(flat) & (set(grid_map) | set(grid_map.values())):
        raise ValueError("bitperm_swap: pairs and grid_map share bits")
    src = list(range(n))
    for lo, hi in pairs:
        src[lo], src[hi] = hi, lo
    for b, s in grid_map.items():
        src[b] = s
    return src


# ---------------------------------------------------------------------------
# Plain torch twins
# ---------------------------------------------------------------------------

def permute_view(n: int, src: list[int]):
    """(shape, dims): a factored view of the flat index (bit n-1 first)
    with one axis of 2 per moved bit and one axis per run of fixed bits,
    and the axis order with ``x.view(shape).permute(dims)`` = the
    permuted state."""
    shape, axis_of = [], {}
    run = 0
    for b in range(n - 1, -1, -1):
        if src[b] != b:
            if run:
                shape.append(1 << run)
                run = 0
            axis_of[b] = len(shape)
            shape.append(2)
        else:
            run += 1
    if run:
        shape.append(1 << run)
    dims = list(range(len(shape)))
    for b, ax in axis_of.items():
        # out bit src[b] reads in bit b: the out axis of bit src[b] is
        # the in axis of bit b
        dims[axis_of[src[b]]] = ax
    return shape, dims


def bitperm_swap_plain(re, im, pairs, grid_map=None):
    """``permute(...).contiguous()`` of the factored view of each plane."""
    PLAIN_CALLS["bitperm_swap"] += 1
    n = _n_of(re)
    shape, dims = permute_view(n, bit_sources(n, pairs, grid_map))
    return tuple(x.reshape(shape).permute(dims).contiguous().reshape(-1)
                 for x in (re, im))


def bitperm_transpose_plain(re, im):
    """``view(128, M, 128).transpose(0, 2)`` of each plane."""
    PLAIN_CALLS["bitperm_transpose"] += 1
    n = _n_of(re)
    if n < 2 * LANE_BITS:
        raise ValueError("bitperm_transpose needs the (128, M, 128) view: n >= 14")
    return tuple(x.reshape(LANES, -1, LANES).transpose(0, 2).contiguous()
                 .reshape(-1) for x in (re, im))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "qst_error_string": (ctypes.c_char_p, [_I]),
    "qst_bitperm_swap": (_I, [_P, _P, _P, _P, _LL, ctypes.POINTER(_I), _I,
                              _I, _P]),
    "qst_bitperm_transpose": (_I, [_P, _P, _P, _P, _LL, _I, _P]),
}


def check_aligned(name: str, *planes) -> None:
    """Raise unless every plane starts on a 16-byte boundary: the kernel
    moves float4s, and a misaligned one would end in a sticky CUDA error
    that spoils the context instead of an exception."""
    for x in planes:
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: planes must start on a 16-byte "
                             f"boundary (a view at an odd offset?)")


def bitperm_swap(re, im, pairs, grid_map=None, *, plain: bool = False):
    """out[i] = in[sigma(i)] for the permutation of the bits >= 7 that
    ``pairs`` and ``grid_map`` make (:func:`bit_sources`): one row
    gather of the (2^n / 128, 128) view, out of place."""
    if plain or not on_card("bitperm_swap", re, im):
        return bitperm_swap_plain(re, im, pairs, grid_map)
    n = _n_of(re)
    src = bit_sources(n, pairs, grid_map)
    rows = [s - LANE_BITS for s in src[LANE_BITS:]]
    check_aligned("bitperm_swap", re, im)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    launch("bitperm", _SIGNATURES, "qst_bitperm_swap", re.device,
           re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
           re.numel() // LANES, (_I * len(rows))(*rows), len(rows))
    LAUNCHES["bitperm_swap"] += 1
    return ore, oim


def bitperm_transpose(re, im, *, plain: bool = False):
    """Lane bit l <-> bit n - 7 + l: out[x, m, y] = in[y, m, x] on the
    (128, M, 128) view, 128 x 128 tile transposes, out of place."""
    if plain or not on_card("bitperm_transpose", re, im):
        return bitperm_transpose_plain(re, im)
    n = _n_of(re)
    if n < 2 * LANE_BITS:
        raise ValueError("bitperm_transpose needs the (128, M, 128) view: n >= 14")
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    launch("bitperm", _SIGNATURES, "qst_bitperm_transpose", re.device,
           re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
           re.numel() >> (2 * LANE_BITS))
    LAUNCHES["bitperm_transpose"] += 1
    return ore, oim
