"""Bit permutations of the state index on (re, im) planes: QFT's terminal
bit reversal and SWAP networks.  CUDA kernels for the card, a plain torch
twin of each.

======================  ===================================================
``bitperm_swap``        ``bitperm_swap_planar``: a permutation of the bits
                        >= 7 (disjoint pairs plus a ``grid_map`` bijection
                        on the bits >= 10), out of place as one row
                        gather; in place (instead of the reference's
                        ``split_planes``) as at most two
                        ``bitperm_involution`` passes
``bitperm_involution``  the in-place pass: rows r <-> P(r) of an
                        involution P of the bits >= 7
``bitperm_transpose``   ``bitperm_transpose_planar``: lane bit l <-> bit
                        n - 7 + l, out[x, m, y] = in[y, m, x] on the
                        (128, M, 128) view
``bitperm_cross``       ``bitperm_cross_planar``: the 7 transpositions lane
                        l <-> top bit cross[l], out[x, m, y] = in[f(y), m,
                        g(x)] on the (128, M, 128) view
``tiled_transpose``     ``tiled_transpose``: (rows, cols) -> (cols, rows)
                        of both planes, the panel schedule's bit rotation
                        (one step of ``dense.rotate_bits_right``), out of
                        place
======================  ===================================================

Each wrapper runs its CUDA kernel (``csrc/bitperm.cu``) on a CUDA tensor
and its plain twin on a CPU tensor, and nothing else; ``plain=True`` asks
for the twin on any device.  ``inplace=True`` writes into the given
planes (the transposes' aliasing instances; the twins copy their result
back).  Every launch adds one to ``LAUNCHES[name]`` (``name + " inplace"``
for an in-place transpose or crossing), every twin call one to
``PLAIN_CALLS`` under the same key.  All only move floats, so kernel and
twin agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from .cuda_build import check_aligned, launch, on_card, outputs, store

LANE_BITS = 7
LANES = 1 << LANE_BITS

_KEYS = ("bitperm_swap", "bitperm_transpose", "bitperm_cross",
         "bitperm_involution", "bitperm_transpose inplace",
         "bitperm_cross inplace", "tiled_transpose")
LAUNCHES = dict.fromkeys(_KEYS, 0)
PLAIN_CALLS = dict.fromkeys(_KEYS, 0)


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


@dataclass(frozen=True)
class CrossTables:
    """The lane <-> top crossing ``cross`` (lane l <-> bit cross[l], a
    bijection onto the top 7 bits of an n = max(cross) + 1 bit index)
    with its tables, built once on the host as the reference builds them
    (pallas_kernels.py:1922-1932): bit pi(l) of f(v) is bit l of v, bit l
    of g(v) is bit pi(l) of v, pi(l) = cross[l] - (n - 7).  ``words`` is
    f then g (uint8); ``operand(device)`` uploads it once per device."""
    cross: tuple
    words: np.ndarray = field(compare=False, repr=False)
    packed: dict = field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def of(cls, cross) -> "CrossTables":
        if isinstance(cross, CrossTables):
            return cross
        cross = tuple(int(c) for c in cross)
        n = max(cross) + 1
        if len(cross) != LANE_BITS or sorted(cross) != list(range(n - 7, n)):
            raise ValueError(f"bitperm_cross: cross {cross} is not a bijection "
                             f"onto the top 7 bits")
        v = np.arange(LANES)
        f, g = np.zeros(LANES, np.uint8), np.zeros(LANES, np.uint8)
        for el, c in enumerate(cross):
            pi = c - (n - 7)
            f |= (((v >> el) & 1) << pi).astype(np.uint8)
            g |= (((v >> pi) & 1) << el).astype(np.uint8)
        return cls(cross, np.concatenate([f, g]))

    @property
    def n(self) -> int:
        return max(self.cross) + 1

    def operand(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self.packed:
            self.packed[key] = torch.from_numpy(self.words.copy()).to(device)
        return self.packed[key]


def involution_factors(src) -> list[list[int]]:
    """Involutions ``[t1, t2]`` of the bits with ``src[x] = t2[t1[x]]``,
    identity factors left out (none for the identity, one for an
    involution).

    A bitperm pass with map ``t`` computes ``out[i] = in[S_t(i)]``, bit b
    of ``S_t(i)`` bit ``t[b]`` of i, so a pass with ``t1`` then one with
    ``t2`` computes the pass with ``src``.  Each cycle (c_0 ... c_{k-1})
    of ``src`` (``src[c_i] = c_{i+1}``) is the product of two
    reflections, ``t1: c_i -> c_{-i}`` then ``t2: c_j -> c_{1-j}``
    (indices mod k); a reflection is its own inverse.
    """
    src = list(src)
    n = len(src)
    t1, t2 = list(range(n)), list(range(n))
    seen = [False] * n
    for b in range(n):
        if seen[b]:
            continue
        cyc = [b]
        seen[b] = True
        while src[cyc[-1]] != b:
            cyc.append(src[cyc[-1]])
            seen[cyc[-1]] = True
        k = len(cyc)
        for i, c in enumerate(cyc):
            t1[c] = cyc[-i % k]
            t2[c] = cyc[(1 - i) % k]
    return [t for t in (t1, t2) if t != list(range(n))]


TILE_BITS = 6  # row bits of an involution tile: 64 rows, one block's round


@dataclass(frozen=True)
class InvolutionPlan:
    """The pair enumeration of ``bitperm_involution`` for an involution P
    of the ``nbits`` row bits (a product of disjoint transpositions).

    The row bits split into a tile set T (at most 6 bits, closed under P:
    the lowest bits with their images) and the outer bits.  A unit is an
    orbit of P on the outer part g of a row: a fixed g (one tile, whose
    2-cycles are the pairs (q, tperm[q]) for q in ``fix_lo``, q <
    tperm[q]) or a 2-cycle g < P(g) (two tiles, row (g, q) <-> (P(g),
    tperm[q]) for every q).  So the rows a unit touches are runs of
    contiguous rows on both sides of each pair.

    Units are numbered by ranges: range 0 holds the fixed outer g, range
    j + 1 the g whose highest differing outer transposition (``pairs``
    sorted by c) is j, with (b_j, c_j) = (1, 0).  Unit u of range k is
    ``g = setbits[k] | deposit(u - start[k], dep[k])``, then bit c_i set
    to bit b_i for i >= dup_from[k] (the transpositions whose two bits
    are equal in g).  Row index = outer bits of g | the tile bits of q
    (``tile_bits``, bit k of q to row bit tile_bits[k])."""
    nbits: int
    tile_bits: tuple
    tperm: tuple
    fix_lo: tuple
    pairs: tuple                      # outer transpositions (b, c), by c
    ranges: tuple                     # (start, dep, setbits, dup_from)
    units: int

    @classmethod
    def of(cls, rowperm) -> "InvolutionPlan":
        p = [int(x) for x in rowperm]
        nbits = len(p)
        tile: list[int] = []
        for b in range(nbits):
            add = {b, p[b]} - set(tile)
            if len(tile) + len(add) <= TILE_BITS:
                tile += sorted(add)
            if len(tile) == TILE_BITS:
                break
        tile = sorted(tile)
        tpos = {b: k for k, b in enumerate(tile)}
        tperm = []
        for q in range(1 << len(tile)):
            tperm.append(sum(((q >> k) & 1) << tpos[p[b]]
                             for k, b in enumerate(tile)))
        fix_lo = tuple(q for q in range(1 << len(tile)) if q < tperm[q])
        outer = [b for b in range(nbits) if b not in tpos]
        pairs = sorted(((b, p[b]) for b in outer if p[b] > b),
                       key=lambda bc: bc[1])
        free = sum(1 << b for b in outer if p[b] == b)
        ranges, start = [], 0

        def add_range(dep, setbits, dup_from):
            nonlocal start
            ranges.append((start, dep, setbits, dup_from))
            start += 1 << bin(dep).count("1")

        add_range(free | sum(1 << b for b, _ in pairs), 0, 0)
        for j, (bj, _) in enumerate(pairs):
            dep = (free | sum((1 << b) | (1 << c) for b, c in pairs[:j])
                   | sum(1 << b for b, _ in pairs[j + 1:]))
            add_range(dep, 1 << bj, j + 1)
        return cls(nbits, tuple(tile), tuple(tperm), fix_lo, tuple(pairs),
                   tuple(ranges), start)

    def unit_rows(self, u: int) -> tuple[int, int, bool]:
        """(g, P(g), fixed) of unit u: the kernel's decode."""
        k = max(i for i, r in enumerate(self.ranges) if r[0] <= u)
        start, dep, g, dup_from = self.ranges[k]
        v = u - start
        for b in range(self.nbits):
            if dep >> b & 1:
                g |= (v & 1) << b
                v >>= 1
        for b, c in self.pairs[dup_from:]:
            g |= (g >> b & 1) << c
        pg = g
        for b, c in self.pairs:
            if (g >> b ^ g >> c) & 1:
                pg ^= (1 << b) | (1 << c)
        return g, pg, k == 0

    def tile_offset(self, q: int) -> int:
        return sum(((q >> k) & 1) << b for k, b in enumerate(self.tile_bits))

    def row_pairs(self):
        """Every (a, b) row pair the kernel swaps, unit by unit."""
        for u in range(self.units):
            g, pg, fixed = self.unit_rows(u)
            for q in (self.fix_lo if fixed else range(len(self.tperm))):
                yield g | self.tile_offset(q), pg | self.tile_offset(self.tperm[q])

    def operands(self):
        """The C entry's arrays: ranges (start, dep, setbits, dup_from) as
        int64, then the int32 words pairs (b, c), tile_bits, tperm,
        fix_lo."""
        r = (ctypes.c_longlong * (4 * len(self.ranges)))(
            *[x for rg in self.ranges for x in rg])
        words = ([x for bc in self.pairs for x in bc] + list(self.tile_bits)
                 + list(self.tperm) + list(self.fix_lo))
        return r, (ctypes.c_int * len(words))(*words)


def cross_sources(n: int, cross) -> list[int]:
    """src[b] (as :func:`bit_sources`) of the transpositions lane l <->
    bit cross[l]."""
    src = list(range(n))
    for el, c in enumerate(cross):
        src[el], src[c] = c, el
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


def _permuted(re, im, src):
    """out[i] = in[S(i)] of each plane, bit b of S(i) bit src[b] of i."""
    shape, dims = permute_view(_n_of(re), src)
    return tuple(x.reshape(shape).permute(dims).contiguous().reshape(-1)
                 for x in (re, im))


def bitperm_swap_plain(re, im, pairs, grid_map=None):
    """``permute(...).contiguous()`` of the factored view of each plane."""
    PLAIN_CALLS["bitperm_swap"] += 1
    return _permuted(re, im, bit_sources(_n_of(re), pairs, grid_map))


def bitperm_involution_plain(re, im, src):
    """The involution ``src`` out of place, copied back into the planes."""
    PLAIN_CALLS["bitperm_involution"] += 1
    return store(re, im, _permuted(re, im, src))


def _key(name: str, inplace: bool) -> str:
    return name + " inplace" if inplace else name


def bitperm_transpose_plain(re, im, inplace=False):
    """``view(128, M, 128).transpose(0, 2)`` of each plane."""
    PLAIN_CALLS[_key("bitperm_transpose", inplace)] += 1
    n = _n_of(re)
    if n < 2 * LANE_BITS:
        raise ValueError("bitperm_transpose needs the (128, M, 128) view: n >= 14")
    out = tuple(x.reshape(LANES, -1, LANES).transpose(0, 2).contiguous()
                .reshape(-1) for x in (re, im))
    return store(re, im, out) if inplace else out


def bitperm_cross_plain(re, im, cross, inplace=False):
    """``permute(...).contiguous()`` of the factored view of each plane,
    the 7 transpositions lane l <-> bit cross[l]."""
    PLAIN_CALLS[_key("bitperm_cross", inplace)] += 1
    tables = CrossTables.of(cross)
    n = _check_cross(re, tables)
    out = _permuted(re, im, cross_sources(n, tables.cross))
    return store(re, im, out) if inplace else out


def tiled_transpose_plain(re, im, rows: int, cols: int):
    """``view(rows, cols).t().contiguous()`` of each plane."""
    PLAIN_CALLS["tiled_transpose"] += 1
    return tuple(x.reshape(rows, cols).t().contiguous().reshape(-1)
                 for x in (re, im))


def _check_cross(re, tables: CrossTables) -> int:
    n = _n_of(re)
    if n < 2 * LANE_BITS:
        raise ValueError("bitperm_cross needs the (128, M, 128) view: n >= 14")
    if tables.n != n:
        raise ValueError(f"bitperm_cross: cross {tables.cross} is not onto "
                         f"the top 7 bits of a {n}-qubit state")
    return n


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "qst_error_string": (ctypes.c_char_p, [_I]),
    "qst_bitperm_swap": (_I, [_P, _P, _P, _P, _LL, ctypes.POINTER(_I), _I,
                              _I, _P]),
    "qst_bitperm_involution": (_I, [_P, _P, _LL, _I,
                                    ctypes.POINTER(_LL), _I,
                                    ctypes.POINTER(_I), _I, _I, _I, _LL,
                                    _I, _P]),
    "qst_bitperm_transpose": (_I, [_P, _P, _P, _P, _LL, _I, _P]),
    "qst_bitperm_cross": (_I, [_P, _P, _P, _P, _LL, _P, _I, _P]),
    "qst_tiled_transpose": (_I, [_P, _P, _P, _P, _LL, _LL, _I, _P]),
}


def _row_map(src) -> ctypes.Array:
    """The kernels' row-bit map of a bit map that fixes the lane bits."""
    rows = [s - LANE_BITS for s in src[LANE_BITS:]]
    return (_I * len(rows))(*rows)


def bitperm_swap(re, im, pairs, grid_map=None, *, inplace: bool = False,
                 plain: bool = False):
    """out[i] = in[sigma(i)] for the permutation of the bits >= 7 that
    ``pairs`` and ``grid_map`` make (:func:`bit_sources`): one row
    gather of the (2^n / 128, 128) view, out of place.  In place: the
    :func:`involution_factors` of sigma, each one
    :func:`bitperm_involution` pass (at most two, no temporary plane)."""
    n = _n_of(re)
    src = bit_sources(n, pairs, grid_map)
    if inplace:
        for t in involution_factors(src):
            bitperm_involution(re, im, t, plain=plain)
        return re, im
    if plain or not on_card("bitperm_swap", re, im):
        return bitperm_swap_plain(re, im, pairs, grid_map)
    check_aligned("bitperm_swap", re, im)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    launch("bitperm", _SIGNATURES, "qst_bitperm_swap", re.device,
           re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
           re.numel() // LANES, _row_map(src), n - LANE_BITS)
    LAUNCHES["bitperm_swap"] += 1
    return ore, oim


def bitperm_involution(re, im, src, *, plain: bool = False):
    """In place: rows r <-> P(r) of the (2^n / 128, 128) view, P the
    involution ``src`` of the bits >= 7 (``src[src[b]] == b``, the lane
    bits fixed): out[i] = in[S(i)], bit b of S(i) bit src[b] of i.  The
    kernel walks the 2-cycles of P by :class:`InvolutionPlan`."""
    n = _n_of(re)
    src = [int(s) for s in src]
    if (len(src) != n or src[:LANE_BITS] != list(range(LANE_BITS))
            or any(src[s] != b for b, s in enumerate(src))):
        raise ValueError(f"bitperm_involution: {src} is not an involution of "
                         f"the bits [7, {n})")
    if plain or not on_card("bitperm_involution", re, im):
        return bitperm_involution_plain(re, im, src)
    check_aligned("bitperm_involution", re, im)
    plan, ranges, words = _involution_operands(
        tuple(s - LANE_BITS for s in src[LANE_BITS:]))
    launch("bitperm", _SIGNATURES, "qst_bitperm_involution", re.device,
           re.data_ptr(), im.data_ptr(), re.numel() // LANES, plan.nbits,
           ranges, len(plan.ranges), words, len(plan.pairs),
           len(plan.tile_bits), len(plan.fix_lo), plan.units)
    LAUNCHES["bitperm_involution"] += 1
    return re, im


@functools.lru_cache(maxsize=64)
def _involution_operands(rowperm: tuple):
    plan = InvolutionPlan.of(rowperm)
    return (plan, *plan.operands())


def bitperm_transpose(re, im, *, inplace: bool = False, plain: bool = False):
    """Lane bit l <-> bit n - 7 + l: out[x, m, y] = in[y, m, x] on the
    (128, M, 128) view, 128 x 128 tile transposes."""
    if plain or not on_card("bitperm_transpose", re, im):
        return bitperm_transpose_plain(re, im, inplace)
    n = _n_of(re)
    if n < 2 * LANE_BITS:
        raise ValueError("bitperm_transpose needs the (128, M, 128) view: n >= 14")
    ore, oim = outputs(re, im, inplace)
    launch("bitperm", _SIGNATURES, "qst_bitperm_transpose", re.device,
           re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
           re.numel() >> (2 * LANE_BITS))
    LAUNCHES[_key("bitperm_transpose", inplace)] += 1
    return ore, oim


def bitperm_cross(re, im, cross, *, inplace: bool = False,
                  plain: bool = False):
    """Lane bit l <-> bit cross[l] (``cross`` a tuple or
    :class:`CrossTables`): out[x, m, y] = in[f(y), m, g(x)] on the
    (128, M, 128) view, 128 x 128 tiles through shared memory."""
    tables = CrossTables.of(cross)
    if plain or not on_card("bitperm_cross", re, im):
        return bitperm_cross_plain(re, im, tables, inplace)
    _check_cross(re, tables)
    check_aligned("bitperm_cross", re, im)
    ore, oim = outputs(re, im, inplace)
    launch("bitperm", _SIGNATURES, "qst_bitperm_cross", re.device,
           re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
           re.numel() >> (2 * LANE_BITS), tables.operand(re.device).data_ptr())
    LAUNCHES[_key("bitperm_cross", inplace)] += 1
    return ore, oim


def tiled_transpose(re, im, rows: int, cols: int, *, plain: bool = False):
    """Each plane, read as ``(rows, cols)`` row-major, transposed to
    ``(cols, rows)``: a rotation of the index bits right by log2(cols).
    Out of place, 128 x 128 tiles through shared memory."""
    rows, cols = int(rows), int(cols)
    if rows < 1 or cols < 1 or rows * cols != re.numel():
        raise ValueError(f"tiled_transpose: ({rows}, {cols}) is not a view of "
                         f"{re.numel()} amplitudes")
    if plain or not on_card("tiled_transpose", re, im):
        return tiled_transpose_plain(re, im, rows, cols)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    launch("bitperm", _SIGNATURES, "qst_tiled_transpose", re.device,
           re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
           rows, cols)
    LAUNCHES["tiled_transpose"] += 1
    return ore, oim
