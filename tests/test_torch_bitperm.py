"""The bit-permutation twins against the JAX package's Pallas entries.

The JAX side runs as its own tests run it (CPU, ``interpret=True``,
float64 planes); the port's wrappers get CPU tensors, so they run their
plain twins.  Both only move floats, so they must agree exactly.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from quantum_simulations_tpu.ops import pallas_kernels as rk
from quantum_simulations_tpu_torch.ops import bitperm_kernels as bk


def _state(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)


def _ref(fn, psi, *args, **kw):
    re, im = fn(jnp.asarray(psi.real), jnp.asarray(psi.imag), *args,
                interpret=True, **kw)
    return np.asarray(re), np.asarray(im)


def _port(fn, psi, *args, **kw):
    re, im = fn(torch.from_numpy(psi.real.copy()),
                torch.from_numpy(psi.imag.copy()), *args, **kw)
    return re.numpy(), im.numpy()


def _exact(got, want):
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


SWAPS = {
    # qft28's pass at n = 20 scale: sub-pairs on bits 7..9, a grid pair,
    # and a grid_map with a 3-cycle (not an involution: pins its direction)
    "pairs_and_cycle": (20, ((7, 19), (8, 18), (9, 17), (10, 16)),
                        {11: 13, 13: 15, 15: 11, 12: 14, 14: 12}),
    "qft18_grid_only": (18, (), {11: 17, 12: 16, 13: 15, 15: 13, 16: 12,
                                 17: 11}),
    "sub_pairs_only": (14, ((7, 9), (8, 13)), {}),
    "identity": (12, (), {}),
}


@pytest.mark.parametrize("case", list(SWAPS), ids=list(SWAPS))
def test_bitperm_swap_matches_reference(case):
    n, pairs, grid_map = SWAPS[case]
    psi = _state(n, n)
    bk.reset_counts()
    got = _port(bk.bitperm_swap, psi, pairs, grid_map)
    assert bk.PLAIN_CALLS["bitperm_swap"] == 1
    _exact(got, _ref(rk.bitperm_swap_planar, psi, pairs, grid_map=grid_map))


@pytest.mark.parametrize("n", [14, 18])
def test_bitperm_transpose_matches_reference(n):
    psi = _state(n, n)
    bk.reset_counts()
    got = _port(bk.bitperm_transpose, psi)
    assert bk.PLAIN_CALLS["bitperm_transpose"] == 1
    _exact(got, _ref(rk.bitperm_transpose_planar, psi))


def test_bit_sources_compose_pairs_and_grid_map():
    src = bk.bit_sources(16, ((7, 12),), {10: 11, 11: 13, 13: 10})
    assert src[:7] == list(range(7))
    assert (src[7], src[12]) == (12, 7)
    assert (src[10], src[11], src[13]) == (11, 13, 10)
    assert src[14:] == [14, 15]


@pytest.mark.parametrize("pairs,grid_map,match", [
    (((7, 12), (12, 13)), {}, "disjoint"),
    (((5, 12),), {}, "leave bits"),
    ((), {10: 11, 11: 11}, "bijection"),
    ((), {9: 11, 11: 9}, "leaves bits"),
    (((10, 12),), {10: 11, 11: 10}, "share bits"),
])
def test_bitperm_swap_rejects_what_the_reference_rejects(pairs, grid_map, match):
    with pytest.raises(ValueError, match=match):
        bk.bit_sources(16, pairs, grid_map)


def test_bitperm_transpose_needs_n14():
    x = torch.zeros(1 << 13, dtype=torch.float64)
    with pytest.raises(ValueError, match="n >= 14"):
        bk.bitperm_transpose(x, x)


def test_bitperm_swap_checks_16_byte_alignment():
    """The kernel moves float4s: a plane that is a view at an odd offset
    is refused with a ValueError before any launch."""
    base = torch.zeros((1 << 10) + 4, dtype=torch.float32)
    good, odd = base[:1 << 10], base[1:(1 << 10) + 1]
    assert good.data_ptr() % 16 == 0 and odd.is_contiguous()
    bk.check_aligned("bitperm_swap", good, good)
    with pytest.raises(ValueError, match="16-byte boundary"):
        bk.check_aligned("bitperm_swap", good, odd)


CROSSES = {
    "identity14": (14, tuple(range(7, 14))),
    "reversal14": (14, tuple(range(13, 6, -1))),
    "identity16": (16, tuple(range(9, 16))),
    "shuffle16": (16, (12, 15, 9, 14, 10, 13, 11)),
}


@pytest.mark.parametrize("case", list(CROSSES), ids=list(CROSSES))
def test_bitperm_cross_matches_reference(case):
    n, cross = CROSSES[case]
    psi = _state(n, n + 1)
    bk.reset_counts()
    got = _port(bk.bitperm_cross, psi, cross)
    assert bk.PLAIN_CALLS["bitperm_cross"] == 1
    _exact(got, _ref(rk.bitperm_cross_planar, psi, cross))


def test_cross_tables_are_the_references():
    """f and g as bitperm_cross_planar builds them (its 0/1 matrices
    PF[y, f(y)] = PG[x, g(x)] = 1)."""
    cross = (12, 15, 9, 14, 10, 13, 11)
    t = bk.CrossTables.of(cross)
    f, g = t.words[:128], t.words[128:]
    n = 16
    pi = [c - (n - 7) for c in cross]
    for v in range(128):
        assert f[v] == sum(((v >> el) & 1) << pi[el] for el in range(7))
        assert g[v] == sum(((v >> pi[el]) & 1) << el for el in range(7))
    assert bk.CrossTables.of(t) is t and t.n == n


@pytest.mark.parametrize("n,cross,match", [
    (13, tuple(range(6, 13)), "n >= 14"),
    (16, tuple(range(8, 15)), "top 7 bits of a 16-qubit"),
    (16, (9, 10, 11, 12, 13, 14, 14), "bijection"),
    (16, (9, 10, 11, 12, 13, 15), "bijection"),
])
def test_bitperm_cross_rejects_what_the_reference_rejects(n, cross, match):
    x = torch.zeros(1 << n, dtype=torch.float64)
    with pytest.raises(ValueError, match=match):
        bk.bitperm_cross(x, x, cross)


def _random_involution(nbits, rng):
    """A random involution of ``nbits`` row bits: k disjoint
    transpositions (k from 0 to nbits // 2)."""
    bits = [int(b) for b in rng.permutation(nbits)]
    p = list(range(nbits))
    for i in range(int(rng.integers(0, nbits // 2 + 1))):
        a, b = bits[2 * i], bits[2 * i + 1]
        p[a], p[b] = b, a
    return p


@pytest.mark.parametrize("n", range(8, 21))
def test_involution_plan_covers_each_2_cycle_once(n):
    """bitperm_involution's pair enumeration (InvolutionPlan, the
    kernel's decode): on random involutions of the row bits, every
    2-cycle of P appears once, by its lower row, and no fixed row does."""
    rng = np.random.default_rng(n)
    nbits = n - bk.LANE_BITS
    for _ in range(4):
        p = _random_involution(nbits, rng)
        perm = np.zeros(1 << nbits, np.int64)
        rows = np.arange(1 << nbits)
        for b in range(nbits):
            perm |= ((rows >> b) & 1) << p[b]
        plan = bk.InvolutionPlan.of(p)
        pairs = np.array(list(plan.row_pairs()), np.int64).reshape(-1, 2)
        assert (perm[pairs[:, 0]] == pairs[:, 1]).all()
        lower = np.sort(np.minimum(pairs[:, 0], pairs[:, 1]))
        np.testing.assert_array_equal(lower, rows[perm > rows])
        assert {p[b] for b in plan.tile_bits} == set(plan.tile_bits)


def test_involution_plan_of_qft28():
    """qft28's grid permutation: the tile holds the three lowest row bits
    and their images, so a unit's rows are runs of 8 rows on both sides."""
    src = bk.bit_sources(28, ((7, 20), (8, 19), (9, 18), (10, 17)),
                         {21: 27, 22: 26, 23: 25, 25: 23, 26: 22, 27: 21})
    t, = bk.involution_factors(src)
    plan = bk.InvolutionPlan.of([s - bk.LANE_BITS for s in t[bk.LANE_BITS:]])
    assert plan.tile_bits == (0, 1, 2, 11, 12, 13)
    moved = (1 << 21) - (1 << 14)
    fixed_units = plan.ranges[1][0]
    assert fixed_units * len(plan.fix_lo) + (plan.units - fixed_units) * 64 == moved // 2


def test_bitperm_involution_twin_is_the_gather():
    """In place on the CPU: the twin, equal to the out-of-place gather."""
    n, pairs = 16, ((7, 15), (9, 12))
    psi = _state(n, 3)
    src = bk.bit_sources(n, pairs, {})
    re, im = torch.from_numpy(psi.real.copy()), torch.from_numpy(psi.imag.copy())
    bk.reset_counts()
    got = bk.bitperm_involution(re, im, src)
    assert got[0] is re and bk.PLAIN_CALLS["bitperm_involution"] == 1
    _exact((re.numpy(), im.numpy()), _port(bk.bitperm_swap, psi, pairs, {}))
