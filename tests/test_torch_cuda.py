"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips without a card (decided inside the
fixture, never at import).  On a machine with a card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Float32 kernels against float32 twins (cuBLAS products, TF32 off): the
two sum 128 terms in different orders, so they differ by float32
round-off, ~1e-7 in ||diff||_2 for a unit-norm state; the bound is 1e-5.
"""
import numpy as np
import pytest
import torch

from quantum_simulations_tpu_torch.circuit import library
from quantum_simulations_tpu_torch.ops import bitperm_kernels as bk
from quantum_simulations_tpu_torch.ops import diag_kernels as dk
from quantum_simulations_tpu_torch.ops import pair_kernels as pq
from quantum_simulations_tpu_torch.ops import panel_kernels as pk

pytestmark = pytest.mark.cuda
TOL_L2 = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _state(n, seed, dev):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi /= np.linalg.norm(psi)
    return (torch.as_tensor(psi.real, dtype=torch.float32, device=dev),
            torch.as_tensor(psi.imag, dtype=torch.float32, device=dev))


def _unitary(dim, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim))
                        + 1j * rng.standard_normal((dim, dim)))
    return q


def _l2(a, b):
    return float(torch.sqrt(((a[0] - b[0]).double() ** 2).sum()
                            + ((a[1] - b[1]).double() ** 2).sum()))


@pytest.mark.parametrize("n,w", [(14, 7), (13, 6), (9, 3), (3, 3)])
def test_lane_panel(dev, n, w):
    x, W = _state(n, n, dev), _unitary(1 << w, w)
    before = pk.LAUNCHES["lane_panel"]
    got = pk.lane_panel(*x, W)
    assert pk.LAUNCHES["lane_panel"] == before + 1
    assert _l2(got, pk.lane_panel_plain(*x, W)) < TOL_L2


@pytest.mark.parametrize("n,pos,w", [(16, 7, 7), (17, 10, 7), (16, 9, 7),
                                     (12, 7, 5), (10, 8, 2), (9, 2, 4)])
def test_positioned_panel(dev, n, pos, w):
    x, W = _state(n, pos, dev), _unitary(1 << w, pos + w)
    got = pk.positioned_panel(*x, W, pos)
    assert _l2(got, pk.positioned_panel_plain(*x, W, pos)) < TOL_L2


@pytest.mark.parametrize("order", [(0, 7), (7, 0)])
@pytest.mark.parametrize("qb", [7, 10, 13])
def test_dual_panel_straddlers(dev, order, qb):
    x = _state(15, qb, dev)
    W1, W2 = _unitary(128, 1), _unitary(128, 2)
    pre, post = (6, qb, _unitary(4, qb)), (6, 20 - qb, _unitary(4, 3))
    got = pk.dual_panel(*x, W1, order[0], W2, order[1], straddle=pre,
                        post_straddle=post)
    want = pk.dual_panel_plain(*x, W1, order[0], W2, order[1], straddle=pre,
                               post_straddle=post)
    assert _l2(got, want) < TOL_L2


def test_float64_planes_raise(dev):
    x = torch.zeros(1 << 14, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError, match="float32"):
        pk.lane_panel(x, x, np.eye(128))


def test_simulate_on_card_matches_float64_twins(dev):
    from quantum_simulations_tpu_torch.runtime import simulator

    cd = library.non_stabilizer(18)
    pk.reset_counts()
    got = simulator.simulate(cd, mode="window", device=dev)
    assert pk.LAUNCHES["dual_panel"] == 2 and not any(pk.PLAIN_CALLS.values())
    want = simulator.simulate(cd, mode="window", dtype="complex128",
                              device=dev, plain=True)
    assert float(torch.linalg.vector_norm(got.to(torch.complex128) - want)) < TOL_L2


def _terms(n, count, seed, scale=5.0):
    """Random Möbius terms of order <= 3 on n qubits (the global term
    too), sum |coeff| about count * scale / 2."""
    rng = np.random.default_rng(seed)
    terms = {(): float(rng.uniform(-scale, scale))}
    while len(terms) < count:
        qs = tuple(sorted(rng.choice(n, rng.integers(1, 4), replace=False)))
        terms[tuple(int(q) for q in qs)] = float(rng.uniform(-scale, scale))
    return tuple(terms.items())


@pytest.mark.parametrize("n,count", [(20, 43), (20, 120), (9, 20), (3, 6)])
def test_fused_diag(dev, n, count):
    x, terms = _state(n, n, dev), _terms(n, count, n + count)
    before = dk.LAUNCHES["fused_diag"]
    got = dk.fused_diag(*x, terms)
    assert dk.LAUNCHES["fused_diag"] == before + 1
    assert _l2(got, dk.fused_diag_plain(*x, terms)) < TOL_L2


@pytest.mark.parametrize("n,pos", [(20, 7), (20, 13), (16, 9)])
def test_positioned_panel_diag_epilogue(dev, n, pos):
    x, W, terms = _state(n, pos, dev), _unitary(128, pos), _terms(n, 60, pos)
    before = pk.LAUNCHES["positioned_panel+diag"]
    got = pk.positioned_panel(*x, W, pos, diag_terms=terms)
    assert pk.LAUNCHES["positioned_panel+diag"] == before + 1
    want = pk.positioned_panel_plain(*x, W, pos, diag_terms=terms)
    assert _l2(got, want) < TOL_L2


@pytest.mark.parametrize("n", [20, 13])
def test_lane_panel_diag_epilogue(dev, n):
    x, W, terms = _state(n, n, dev), _unitary(128, 5), _terms(n, 50, n)
    got = pk.lane_panel(*x, W, diag_terms=terms)
    assert _l2(got, pk.lane_panel_plain(*x, W, diag_terms=terms)) < TOL_L2


def test_dual_panel_diag_epilogue(dev):
    x, terms = _state(20, 1, dev), _terms(20, 70, 2)
    W1, W2 = _unitary(128, 1), _unitary(128, 2)
    kw = dict(straddle=(6, 9, _unitary(4, 9)),
              post_straddle=(6, 12, _unitary(4, 12)), diag_terms=terms)
    got = pk.dual_panel(*x, W1, 0, W2, 7, **kw)
    assert _l2(got, pk.dual_panel_plain(*x, W1, 0, W2, 7, **kw)) < TOL_L2


def test_ragged_panel_diag_runs_two_kernels(dev):
    x, W, terms = _state(16, 3, dev), _unitary(32, 3), _terms(16, 50, 3)
    pk.reset_counts()
    dk.reset_counts()
    got = pk.positioned_panel(*x, W, 11, diag_terms=terms)
    assert pk.LAUNCHES["positioned_panel"] == 1
    assert dk.LAUNCHES["fused_diag"] == 1
    want = pk.positioned_panel_plain(*x, W, 11, diag_terms=terms)
    assert _l2(got, want) < TOL_L2


@pytest.mark.parametrize("n,pairs,grid_map", [
    (20, ((7, 19), (8, 18), (9, 17), (10, 16)),
     {11: 13, 13: 15, 15: 11, 12: 14, 14: 12}),
    (28, ((7, 20), (8, 19), (9, 18), (10, 17)),
     {21: 27, 22: 26, 23: 25, 25: 23, 26: 22, 27: 21}),
    (12, (), {10: 11, 11: 10}),
])
def test_bitperm_swap_exact(dev, n, pairs, grid_map):
    x = _state(n, n, dev)
    got = bk.bitperm_swap(*x, pairs, grid_map)
    want = bk.bitperm_swap_plain(*x, pairs, grid_map)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_bitperm_swap_refuses_a_misaligned_plane(dev):
    """A view at an odd offset raises before the launch, and the context
    stays usable."""
    n = 12
    x = _state(n, n, dev)
    base = torch.zeros((1 << n) + 4, device=dev)
    base[1:(1 << n) + 1] = x[0]
    with pytest.raises(ValueError, match="16-byte boundary"):
        bk.bitperm_swap(base[1:(1 << n) + 1], x[1], (), {10: 11, 11: 10})
    got = bk.bitperm_swap(*x, (), {10: 11, 11: 10})
    torch.cuda.synchronize()
    assert torch.equal(got[0], bk.bitperm_swap_plain(*x, (), {10: 11, 11: 10})[0])


@pytest.mark.parametrize("n", [14, 20])
def test_bitperm_transpose_exact(dev, n):
    x = _state(n, n, dev)
    got = bk.bitperm_transpose(*x)
    want = bk.bitperm_transpose_plain(*x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", ["qft", "qaoa_maxcut", "qpe", "deutsch_jozsa"])
def test_qft_qaoa_on_card_match_float64_twins(dev, name):
    from quantum_simulations_tpu_torch.runtime import simulator

    n = 20
    cd = library.qpe(n - 1) if name == "qpe" else getattr(library, name)(n)
    rng = np.random.default_rng(n)
    psi0 = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi0 = torch.as_tensor(psi0 / np.linalg.norm(psi0), device=dev)
    for m in (pk, dk, bk, pq):
        m.reset_counts()
    got = simulator.simulate(cd, mode="window", device=dev, initial_state=psi0)
    assert not any({**pk.PLAIN_CALLS, **dk.PLAIN_CALLS, **bk.PLAIN_CALLS,
                    **pq.PLAIN_CALLS}.values())
    want = simulator.simulate(cd, mode="window", dtype="complex128",
                              device=dev, plain=True, initial_state=psi0)
    assert float(torch.linalg.vector_norm(got.to(torch.complex128) - want)) < TOL_L2


# (qa, qb) at n = 20 for lo in {0, 1, 2, 6, 7, 12, 13}, both orders, each
# pair wrapper and body class; lo < 2 is the kernel's float4 edge.
PAIR_CLASSES = [(0, 7), (9, 1), (2, 8), (6, 7), (7, 6), (0, 19), (12, 1),
                (2, 10), (6, 15), (7, 11), (19, 7), (12, 16), (13, 14),
                (17, 13)]


@pytest.mark.parametrize("qa,qb", PAIR_CLASSES)
def test_pair_gate_through_each_wrapper(dev, qa, qb):
    x, U = _state(20, qa + 20 * qb, dev), _unitary(4, qa * 7 + qb)
    if pq.pair_update_supported(qa, qb):
        name = "pair_update"
    elif pq.mixed_pair_supported(qa, qb):
        name = "mixed_pair"
    else:
        name = "mixed_low_pair"
    before = pq.LAUNCHES[name]
    got = getattr(pq, name)(*x, qa, qb, U)
    assert pq.LAUNCHES[name] == before + 1
    assert _l2(got, pq.pair_gate_plain(*x, qa, qb, U)) < TOL_L2


@pytest.mark.parametrize("qa,qb", [(0, 1), (1, 0), (1, 2), (0, 3), (2, 3)])
def test_pair_gate_low_bits(dev, qa, qb):
    """Bits the wrappers never pass (hi < 7): one float4 holds a whole
    quad (0, 1), or half of two (lo < 2 <= hi)."""
    x, U = _state(12, qa + qb, dev), _unitary(4, 5 + qa)
    got = pq._pair_gate("mixed_low_pair", *x, qa, qb, U, False)
    assert _l2(got, pq.pair_gate_plain(*x, qa, qb, U)) < TOL_L2


def test_pair_gate_moves_a_permutation_exactly(dev):
    from quantum_simulations_tpu_torch.ops import dense

    x = _state(20, 3, dev)
    for qa, qb in ((13, 19), (3, 15), (6, 8)):
        got = pq._pair_gate("pair_update", *x, qa, qb, dense._SWAP4, False)
        want = pq.pair_gate_plain(*x, qa, qb, dense._SWAP4)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,cross", [(14, tuple(range(13, 6, -1))),
                                     (20, (19, 13, 17, 14, 18, 16, 15))])
def test_bitperm_cross_exact(dev, n, cross):
    x = _state(n, n, dev)
    before = bk.LAUNCHES["bitperm_cross"]
    got = bk.bitperm_cross(*x, cross)
    assert bk.LAUNCHES["bitperm_cross"] == before + 1
    want = bk.bitperm_cross_plain(*x, cross)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# In place (the capacity tier): each kernel's aliasing instance against its
# out-of-place instance (bit for bit) and its plain twin
# ---------------------------------------------------------------------------

def _inplace_check(fn, x, key, mod, twin=None, exact=False):
    """``fn(re, im, inplace=...)`` in place on copies of ``x``: the result
    is the given planes, equal bit for bit to the out-of-place run, one
    launch under ``key``, and within TOL_L2 of ``twin(x)`` (or equal)."""
    out = fn(*x, inplace=False)
    re, im = x[0].clone(), x[1].clone()
    before = mod.LAUNCHES[key]
    got = fn(re, im, inplace=True)
    assert got[0] is re and got[1] is im
    assert mod.LAUNCHES[key] == before + 1
    assert torch.equal(re, out[0]) and torch.equal(im, out[1])
    if twin is not None:
        want = twin(x)
        if exact:
            assert torch.equal(re, want[0]) and torch.equal(im, want[1])
        else:
            assert _l2((re, im), want) < TOL_L2


@pytest.mark.parametrize("n,w,diag", [(14, 7, False), (9, 3, False),
                                      (20, 7, True)])
def test_lane_panel_inplace(dev, n, w, diag):
    x, W = _state(n, n, dev), _unitary(1 << w, w)
    dt = _terms(n, 40, n) if diag else None
    key = "lane_panel+diag inplace" if diag else "lane_panel inplace"
    _inplace_check(lambda re, im, inplace: pk.lane_panel(
        re, im, W, diag_terms=dt, inplace=inplace), x, key, pk,
        lambda x: pk.lane_panel_plain(*x, W, diag_terms=dt))


@pytest.mark.parametrize("n,pos,w,diag", [(16, 7, 7, False), (17, 10, 7, True),
                                          (12, 7, 5, False), (10, 8, 2, False),
                                          (20, 13, 7, True)])
def test_positioned_panel_inplace(dev, n, pos, w, diag):
    x, W = _state(n, pos, dev), _unitary(1 << w, pos + w)
    dt = _terms(n, 40, pos) if diag else None
    key = "positioned_panel+diag inplace" if diag else "positioned_panel inplace"
    _inplace_check(lambda re, im, inplace: pk.positioned_panel(
        re, im, W, pos, diag_terms=dt, inplace=inplace), x, key, pk,
        lambda x: pk.positioned_panel_plain(*x, W, pos, diag_terms=dt))


@pytest.mark.parametrize("order", [(0, 7), (7, 0)])
@pytest.mark.parametrize("diag", [False, True])
def test_dual_panel_inplace(dev, order, diag):
    x = _state(16, 5, dev)
    W1, W2 = _unitary(128, 1), _unitary(128, 2)
    kw = dict(straddle=(6, 9, _unitary(4, 9)),
              post_straddle=(6, 12, _unitary(4, 12)),
              diag_terms=_terms(16, 50, 2) if diag else None)
    key = "dual_panel+diag inplace" if diag else "dual_panel inplace"
    _inplace_check(lambda re, im, inplace: pk.dual_panel(
        re, im, W1, order[0], W2, order[1], inplace=inplace, **kw), x, key, pk,
        lambda x: pk.dual_panel_plain(*x, W1, order[0], W2, order[1], **kw))


@pytest.mark.parametrize("n,count", [(20, 43), (9, 20)])
def test_fused_diag_inplace(dev, n, count):
    x, terms = _state(n, n, dev), _terms(n, count, n + count)
    _inplace_check(lambda re, im, inplace: dk.fused_diag(
        re, im, terms, inplace=inplace), x, "fused_diag inplace", dk,
        lambda x: dk.fused_diag_plain(*x, terms))


@pytest.mark.parametrize("name,qa,qb", [
    ("pair_update", 12, 16), ("pair_update", 16, 12), ("pair_update", 13, 19),
    ("mixed_pair", 0, 19), ("mixed_pair", 15, 1), ("mixed_low_pair", 6, 7),
    ("mixed_low_pair", 9, 2)])
def test_pair_wrappers_inplace(dev, name, qa, qb):
    x, U = _state(20, qa + 20 * qb, dev), _unitary(4, qa * 7 + qb)
    _inplace_check(lambda re, im, inplace: getattr(pq, name)(
        re, im, qa, qb, U, inplace=inplace), x, name + " inplace", pq,
        lambda x: pq.pair_gate_plain(*x, qa, qb, U))


@pytest.mark.parametrize("qa,qb", [(7, 11), (11, 7), (8, 14), (14, 8),
                                   (9, 19), (19, 9)])
def test_midpair(dev, qa, qb):
    """lo 7, 8, 9 in both qubit orders: in place, equal bit for bit to the
    pair kernel out of place, and to its twin within TOL_L2."""
    from quantum_simulations_tpu_torch.ops import dense

    for U in (_unitary(4, qa * qb), dense._SWAP4):
        x = _state(20, qa + qb, dev)
        out = pq._pair_gate("midpair", *x, qa, qb, U, False)
        re, im = x[0].clone(), x[1].clone()
        before = pq.LAUNCHES["midpair"]
        got = pq.midpair(re, im, qa, qb, U)
        assert got[0] is re and got[1] is im
        assert pq.LAUNCHES["midpair"] == before + 1
        assert torch.equal(re, out[0]) and torch.equal(im, out[1])
        assert _l2((re, im), pq.pair_gate_plain(*x, qa, qb, U)) < TOL_L2


@pytest.mark.parametrize("n", [14, 20])
def test_bitperm_transpose_inplace(dev, n):
    _inplace_check(lambda re, im, inplace: bk.bitperm_transpose(
        re, im, inplace=inplace), _state(n, n, dev),
        "bitperm_transpose inplace", bk,
        lambda x: bk.bitperm_transpose_plain(*x), exact=True)


def test_bitperm_cross_inplace(dev):
    cross = (19, 13, 17, 14, 18, 16, 15)
    _inplace_check(lambda re, im, inplace: bk.bitperm_cross(
        re, im, cross, inplace=inplace), _state(20, 4, dev),
        "bitperm_cross inplace", bk,
        lambda x: bk.bitperm_cross_plain(*x, cross), exact=True)


@pytest.mark.parametrize("seed", range(4))
def test_bitperm_swap_inplace_random_permutations(dev, seed):
    """A random permutation of the bits >= 7 as pairs plus a grid_map: at
    most two bitperm_involution passes, equal bit for bit to the
    out-of-place gather."""
    rng = np.random.default_rng(seed)
    n = 20
    perm = [int(b) for b in rng.permutation(np.arange(10, n))]
    grid_map = {10 + i: perm[i] for i in range(n - 10)}
    pairs = (((7, 9),), ((8, 9),))[seed % 2]
    x = _state(n, seed, dev)
    want = bk.bitperm_swap(*x, pairs, grid_map)
    re, im = x[0].clone(), x[1].clone()
    before = bk.LAUNCHES["bitperm_involution"]
    got = bk.bitperm_swap(re, im, pairs, grid_map, inplace=True)
    assert got[0] is re and got[1] is im
    src = bk.bit_sources(n, pairs, grid_map)
    assert (bk.LAUNCHES["bitperm_involution"] - before
            == len(bk.involution_factors(src)))
    assert torch.equal(re, want[0]) and torch.equal(im, want[1])


@pytest.mark.parametrize("name", ["qft", "qpe", "non_stabilizer", "ghz"])
def test_simulate_capacity_on_card_matches_window(dev, name):
    """The capacity tier in place on the card: only in-place launches, and
    the state of the out-of-place window run within TOL_L2."""
    from quantum_simulations_tpu_torch.runtime import capacity, simulator

    n = 20
    cd = library.qpe(n - 1) if name == "qpe" else getattr(library, name)(n)
    for m in (pk, dk, bk, pq):
        m.reset_counts()
    res = capacity.simulate_capacity(cd, device=dev)
    counts = {k: v for m in (pk, dk, bk, pq) for k, v in m.LAUNCHES.items() if v}
    assert counts and all(k.endswith(" inplace")
                          or k in ("midpair", "bitperm_involution")
                          for k in counts), counts
    assert not any({**pk.PLAIN_CALLS, **dk.PLAIN_CALLS, **bk.PLAIN_CALLS,
                    **pq.PLAIN_CALLS}.values())
    want = simulator.simulate(cd, mode="window", device=dev)
    assert _l2((res.re, res.im), (want.real.contiguous(),
                                  want.imag.contiguous())) < TOL_L2
    assert abs(res.norm2() - 1) < 1e-5


# ---------------------------------------------------------------------------
# Panel mode's kernels: tiled_transpose and the lane panel's rotated store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rb,cb", [(17, 7), (7, 17), (12, 12), (9, 1), (1, 9),
                                   (3, 7), (7, 3), (0, 10), (10, 0), (5, 5)])
def test_tiled_transpose_exact(dev, rb, cb):
    """(2^rb, 2^cb) -> (2^cb, 2^rb) of both planes, ragged tiles too: bit
    for bit the twin's ``.t().contiguous()``."""
    x = _state(rb + cb, rb + 3 * cb, dev)
    before = bk.LAUNCHES["tiled_transpose"]
    got = bk.tiled_transpose(*x, 1 << rb, 1 << cb)
    assert bk.LAUNCHES["tiled_transpose"] == before + 1
    want = bk.tiled_transpose_plain(*x, 1 << rb, 1 << cb)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,w", [(20, 7), (14, 7), (10, 7), (8, 7), (9, 3),
                                 (3, 3)])
def test_lane_panel_rotate(dev, n, w):
    """The rotated store against the twin (the panel, then the (R, dim)
    transpose), R below and above one 128-row tile."""
    from quantum_simulations_tpu_torch.ops import dense

    x, W = _state(n, n + w, dev), _unitary(1 << w, w + 1)
    before = pk.LAUNCHES["lane_panel+rotate"]
    got = pk.lane_panel(*x, W, rotate=True)
    assert pk.LAUNCHES["lane_panel+rotate"] == before + 1
    want = pk.lane_panel_plain(*x, W, rotate=True)
    assert _l2(got, want) < TOL_L2
    flat = pk.lane_panel_plain(*x, W)
    assert _l2(got, tuple(dense.rotate_bits_right(p, w) for p in flat)) < TOL_L2


def test_lane_panel_rotate_refuses_in_place(dev):
    x = _state(14, 1, dev)
    with pytest.raises(ValueError, match="cannot rotate"):
        pk.lane_panel(*x, _unitary(128, 1), rotate=True, inplace=True)


@pytest.mark.parametrize("mode", ["panel", "fused"])
@pytest.mark.parametrize("name", ["non_stabilizer", "qft", "ghz"])
def test_panel_and_fused_modes_on_card(dev, mode, name):
    """simulate(mode=...) on the card: no plain twin called, and the float64
    twins of the same schedule within TOL_L2, from a random state."""
    from quantum_simulations_tpu_torch.runtime import simulator

    n = 18
    cd = getattr(library, name)(n)
    rng = np.random.default_rng(n)
    psi0 = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi0 = torch.as_tensor(psi0 / np.linalg.norm(psi0), device=dev)
    for m in (pk, dk, bk, pq):
        m.reset_counts()
    got = simulator.simulate(cd, mode=mode, device=dev, initial_state=psi0)
    assert not any({**pk.PLAIN_CALLS, **dk.PLAIN_CALLS, **bk.PLAIN_CALLS,
                    **pq.PLAIN_CALLS}.values())
    if mode == "panel":
        assert pk.LAUNCHES["lane_panel+rotate"] and bk.LAUNCHES["tiled_transpose"]
    want = simulator.simulate(cd, mode=mode, dtype="complex128", device=dev,
                              plain=True, initial_state=psi0)
    assert float(torch.linalg.vector_norm(got.to(torch.complex128) - want)) < TOL_L2


# ---------------------------------------------------------------------------
# Dim 128 on the tensor cores (split TF32): lane and positioned layouts
# ---------------------------------------------------------------------------

def _f64(x):
    return x[0].double(), x[1].double()


@pytest.mark.parametrize("variant", ["plain", "diag", "inplace"])
@pytest.mark.parametrize("pos", [7, 8, 9, 11, 14, 21])
def test_positioned_panel_tensor_cores(dev, pos, variant):
    """The positioned layout (k, c) at the chip's positions: the kernel
    within TOL_L2 of its float32 twin and of the float64 twin, with the
    diag epilogue and in place."""
    n = max(pos + 7, 16)
    x, W = _state(n, pos, dev), _unitary(128, pos + 1)
    dt = _terms(n, 40, pos) if variant == "diag" else None
    key = "positioned_panel" + ("+diag" if dt else "") + (
        " inplace" if variant == "inplace" else "")
    before = pk.LAUNCHES[key]
    want = pk.positioned_panel_plain(*x, W, pos, diag_terms=dt)
    want64 = pk.positioned_panel_plain(*_f64(x), W, pos, diag_terms=dt)
    if variant == "inplace":
        got = pk.positioned_panel(*x, W, pos, inplace=True)
        assert got[0] is x[0]
    else:
        got = pk.positioned_panel(*x, W, pos, diag_terms=dt)
    assert pk.LAUNCHES[key] == before + 1
    assert _l2(got, want) < TOL_L2 and _l2(got, want64) < TOL_L2


@pytest.mark.parametrize("variant", ["plain", "diag", "rotate", "inplace"])
@pytest.mark.parametrize("n", [7, 10, 13, 14, 21])
def test_lane_panel_tensor_cores(dev, n, variant):
    """The lane layout (r, k), R = 2^(n - 7) rows below and above one
    128-row tile: kernel against both twins, with the diag epilogue, the
    rotated store and in place."""
    x, W = _state(n, n + 1, dev), _unitary(128, n)
    dt = _terms(n, 40, n) if variant == "diag" else None
    rot = variant == "rotate"
    want = pk.lane_panel_plain(*x, W, diag_terms=dt, rotate=rot)
    want64 = pk.lane_panel_plain(*_f64(x), W, diag_terms=dt, rotate=rot)
    got = pk.lane_panel(*x, W, diag_terms=dt, rotate=rot,
                        inplace=variant == "inplace")
    assert _l2(got, want) < TOL_L2 and _l2(got, want64) < TOL_L2


def test_positioned_panel_ragged_view(dev):
    """Dim 128 below pos 7: C = 4 columns a tile, the element-wise load."""
    x, W = _state(10, 3, dev), _unitary(128, 3)
    got = pk.positioned_panel(*x, W, 2)
    assert _l2(got, pk.positioned_panel_plain(*x, W, 2)) < TOL_L2


def _misaligned(x):
    """The planes one float off a 16-byte boundary (copies)."""
    out = []
    for p in x:
        buf = torch.empty(p.numel() + 1, dtype=p.dtype, device=p.device)
        buf[1:].copy_(p)
        out.append(buf[1:])
    return tuple(out)


# The precision rule of the dim-128 panels: float32 class, at most twice
# the mma.sync kernel's worst reading (1.4e-7) from the float64 twin.
TOL_TC_F64 = 2.8e-7

_TC_CASES = {
    # label: (n, kernel call, twin call); every panel_tc_kernel instance
    "lane": (16, lambda x, W, **k: pk.lane_panel(*x, W, **k),
             lambda x, W, **k: pk.lane_panel_plain(*x, W, **k)),
    "lane rotate": (16, lambda x, W: pk.lane_panel(*x, W, rotate=True),
                    lambda x, W: pk.lane_panel_plain(*x, W, rotate=True)),
    "lane inplace": (16, lambda x, W: pk.lane_panel(x[0].clone(), x[1].clone(), W,
                                                    inplace=True),
                     lambda x, W: pk.lane_panel_plain(*x, W)),
    "lane +diag": (16, lambda x, W: pk.lane_panel(*x, W, diag_terms=_terms(16, 40, 4)),
                   lambda x, W: pk.lane_panel_plain(*x, W, diag_terms=_terms(16, 40, 4))),
    "lane ragged (R = 64)": (13, lambda x, W: pk.lane_panel(*x, W),
                             lambda x, W: pk.lane_panel_plain(*x, W)),
    "lane misaligned": (16, lambda x, W: pk.lane_panel(*_misaligned(x), W),
                        lambda x, W: pk.lane_panel_plain(*x, W)),
    **{f"positioned pos{p}": (max(p + 7, 16),
                              lambda x, W, p=p: pk.positioned_panel(*x, W, p),
                              lambda x, W, p=p: pk.positioned_panel_plain(*x, W, p))
       for p in (7, 11, 14, 21)},
    "positioned inplace": (18, lambda x, W: pk.positioned_panel(
        x[0].clone(), x[1].clone(), W, 11, inplace=True),
        lambda x, W: pk.positioned_panel_plain(*x, W, 11)),
    "positioned +diag": (18, lambda x, W: pk.positioned_panel(
        *x, W, 9, diag_terms=_terms(18, 40, 9)),
        lambda x, W: pk.positioned_panel_plain(*x, W, 9, diag_terms=_terms(18, 40, 9))),
    "positioned misaligned": (16, lambda x, W: pk.positioned_panel(*_misaligned(x), W, 7),
                              lambda x, W: pk.positioned_panel_plain(*x, W, 7)),
}


@pytest.mark.parametrize("label", list(_TC_CASES))
def test_panel_tc_instances_against_float64(dev, label):
    """Each instance of panel_tc_kernel (lane, rotated, positioned, in
    place, with the diag epilogue; a ragged and a misaligned view) within
    the precision rule of the float64 twin, and within TOL_L2 of the
    float32 one."""
    n, kern, twin = _TC_CASES[label]
    x, W = _state(n, n + 40, dev), _unitary(128, n + 41)
    got = kern(x, W)
    assert _l2(got, twin(_f64(x), W)) <= TOL_TC_F64
    assert _l2(got, twin(x, W)) < TOL_L2


def test_panel_chain_drift_against_float64(dev):
    """24 positioned passes (as nonstab33 and its inverse run) stay within
    1e-5 of the float64 twins."""
    x = _state(18, 9, dev)
    x64 = _f64(x)
    for p in range(24):
        W, pos = _unitary(128, 300 + p), (7, 9, 11)[p % 3]
        x = pk.positioned_panel(*x, W, pos)
        x64 = pk.positioned_panel_plain(*x64, W, pos)
    assert _l2(x, x64) < TOL_L2


# ---------------------------------------------------------------------------
# complex128 on the card: every mode through the plain twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fused", "panel", "window", "capacity"])
@pytest.mark.parametrize("name", ["ghz", "qft"])
def test_complex128_runs_on_card(dev, mode, name):
    """dtype complex128 runs every op through the plain twins (the kernels
    take float32 planes): no kernel launches, the float64 twins run
    directly agree within 1e-10, and so does the closed form (GHZ: 2^-1/2
    at 0 and 2^12 - 1; the QFT of |0>: 2^-6 everywhere), which holds the
    numbers and not only the route."""
    from quantum_simulations_tpu_torch import SimulatorConfig, api
    from quantum_simulations_tpu_torch.runtime import simulator

    cd = getattr(library, name)(12)
    for m in (pk, dk, bk, pq):
        m.reset_counts()
    res = api.simulate(cd, SimulatorConfig(dtype="complex128", mode=mode),
                       device=dev)
    got = res.to_array() if mode == "capacity" else res
    assert got.dtype == np.complex128
    assert not any({**pk.LAUNCHES, **dk.LAUNCHES, **bk.LAUNCHES,
                    **pq.LAUNCHES}.values())
    want = simulator.simulate(cd, dtype="complex128", device=dev, plain=True,
                              mode="window" if mode == "capacity" else mode)
    assert np.linalg.norm(got - want.cpu().numpy()) < 1e-10
    exact = np.zeros(1 << 12, np.complex128)
    if name == "ghz":
        exact[[0, -1]] = 2 ** -0.5
    else:
        exact[:] = 2.0 ** -6
    assert np.linalg.norm(got - exact) < 1e-10


def test_cli_complex128_on_card(dev, tmp_path):
    import json
    import subprocess
    import sys

    path = tmp_path / "ghz12.json"
    path.write_text(json.dumps(library.ghz(12)))
    proc = subprocess.run([sys.executable, "-m", "quantum_simulations_tpu_torch",
                           "run", str(path), "--dtype", "complex128", "--top", "2"],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout)
    assert sorted(i for i, _ in res["top"]) == ["0x0", "0xfff"]
    assert all(abs(p - 0.5) < 1e-12 for _, p in res["top"])


# ---------------------------------------------------------------------------
# dual_panel on the tensor cores; bitperm_involution by its pair plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "straddlers", "diag", "inplace"])
@pytest.mark.parametrize("order", [(0, 7), (7, 0)])
def test_dual_panel_tensor_cores(dev, order, variant):
    """The split-TF32 dual against its float32 and float64 twins, with
    general complex pre- and post-straddlers, a diag epilogue, in place
    (all three at once)."""
    n = 18
    x, W1, W2 = _state(n, 11, dev), _unitary(128, 21), _unitary(128, 22)
    kw = {}
    if variant in ("straddlers", "inplace"):
        kw.update(straddle=(6, 9, _unitary(4, 5)), post_straddle=(6, 13, _unitary(4, 6)))
    if variant in ("diag", "inplace"):
        kw["diag_terms"] = _terms(n, 60, 7)
    key = "dual_panel" + ("+diag" if "diag_terms" in kw else "") + (
        " inplace" if variant == "inplace" else "")
    want = pk.dual_panel_plain(*x, W1, order[0], W2, order[1], **kw)
    want64 = pk.dual_panel_plain(*_f64(x), W1, order[0], W2, order[1], **kw)
    before = pk.LAUNCHES[key]
    if variant == "inplace":
        re, im = x[0].clone(), x[1].clone()
        got = pk.dual_panel(re, im, W1, order[0], W2, order[1], inplace=True, **kw)
        assert got[0] is re and got[1] is im
    else:
        got = pk.dual_panel(*x, W1, order[0], W2, order[1], **kw)
    assert pk.LAUNCHES[key] == before + 1
    assert _l2(got, want) < TOL_L2 and _l2(got, want64) < TOL_L2


def _tc_sass(kernel: str) -> dict:
    """{template arguments: {"HGMMA": count, "HMMA": count}} over the
    instances of ``kernel`` in the built library of csrc/panels.cu
    (cuobjdump -sass): HGMMA the warpgroup MMA, HMMA mma.sync."""
    import re
    import subprocess
    from pathlib import Path

    from quantum_simulations_tpu_torch.ops import cuda_build

    lib = next(p for p in cuda_build.build_all()
               if p.name.startswith("libpanels-"))
    tool = Path(cuda_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            d = re.search(kernel + r"((?:ILb\d)(?:ELb\d)*)E", m.group(1))
            fn = d.group(1) if d else None
            if fn is not None:
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn is not None:
            for op in counts[fn]:
                counts[fn][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def test_dual_panel_runs_hmma(dev):
    """Both instances of the dual kernel (out of place, in place) hold
    tensor-core instructions (cuobjdump -sass of the built library)."""
    counts = _tc_sass("dual_tc_kernel")
    assert set(counts) == {"ILb0", "ILb1"}, counts
    assert all(c["HMMA"] for c in counts.values()), counts


def test_panel_tc_runs_hgmma(dev):
    """Every instance of the lane / positioned kernel (lane, in place,
    rotated; positioned, in place) runs on the warpgroup MMA: HGMMA, and
    no mma.sync (HMMA); the dual's two still run mma.sync."""
    counts = _tc_sass("panel_tc_kernel")
    assert set(counts) == {"ILb0ELb0ELb0", "ILb0ELb1ELb0", "ILb0ELb0ELb1",
                           "ILb1ELb0ELb0", "ILb1ELb1ELb0"}, counts
    assert all(c["HGMMA"] and not c["HMMA"] for c in counts.values()), counts
    assert all(c["HMMA"] for c in _tc_sass("dual_tc_kernel").values())


def _random_involution_src(n, rng):
    bits = [int(b) for b in rng.permutation(np.arange(7, n))]
    k = int(rng.integers(1, (n - 7) // 2 + 1))
    pairs = tuple((bits[2 * i], bits[2 * i + 1]) for i in range(k))
    return pairs, bk.bit_sources(n, pairs, {})


@pytest.mark.parametrize("seed", range(4))
def test_bitperm_involution_random_exact(dev, seed):
    """In place, bit for bit equal to the plain twin, one launch."""
    pairs, src = _random_involution_src(20, np.random.default_rng(seed))
    x = _state(20, 30 + seed, dev)
    re, im = x[0].clone(), x[1].clone()
    before = bk.LAUNCHES["bitperm_involution"]
    got = bk.bitperm_involution(re, im, src)
    assert got[0] is re and bk.LAUNCHES["bitperm_involution"] == before + 1
    want = bk.bitperm_swap_plain(*x, pairs, {})
    assert torch.equal(re, want[0]) and torch.equal(im, want[1])


def test_bitperm_involution_qft28_exact(dev):
    """qft28's grid permutation (one involution) at n = 28."""
    from quantum_simulations_tpu_torch.runtime.simulator import schedule

    op = next(op for op, _ in schedule(library.qft(28))
              if type(op).__name__ == "BitPermGridOp")
    t, = bk.involution_factors(bk.bit_sources(28, op.pairs, dict(op.grid_map)))
    x = _state(28, 2, dev)
    re, im = x[0].clone(), x[1].clone()
    bk.bitperm_involution(re, im, t)
    want = bk.bitperm_involution(*x, t, plain=True)
    assert torch.equal(re, want[0]) and torch.equal(im, want[1])


# ---------------------------------------------------------------------------
# The sparse COO tier and the trajectory tier on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n", [("ghz", 62), ("w_state", 40), ("qft", 9),
                                    ("random_circuit", 10)])
def test_sparse_coo_on_card_equals_cpu(dev, name, n):
    """The COO tier on the card: the same index set as its CPU run, in the
    same (ascending) order, amplitudes within 1e-12."""
    from quantum_simulations_tpu_torch.sparse.engine import simulate_sparse

    cd = (library.random_circuit(n, 80, seed=2) if name == "random_circuit"
          else getattr(library, name)(n))
    h, hc = [], []
    got = simulate_sparse(cd, nnz_history=h, device=dev)
    want = simulate_sparse(cd, nnz_history=hc, device="cpu")
    assert h == hc
    assert [i for i, _ in got.items()] == [i for i, _ in want.items()]
    assert max(abs(a - want.amplitude(i)) for i, a in got.items()) <= 1e-12


def test_sparse_coo_ghz63_on_card(dev):
    from quantum_simulations_tpu_torch.sparse.engine import simulate_sparse

    st = simulate_sparse(library.ghz(63), force_tier="numpy", device=dev)
    assert [i for i, _ in st.items()] == [0, (1 << 63) - 1]
    assert all(abs(a - 2 ** -0.5) <= 1e-12 for _, a in st.items())


def test_trajectory_mixed_on_card(dev):
    """MIXED (tests/test_trajectory.py) in complex64 on the card: the
    oracle's outcomes and registers, the state within 1e-5."""
    from quantum_simulations_tpu_torch import oracle
    from quantum_simulations_tpu_torch.circuit.import_qasm import qasm_to_dict
    from quantum_simulations_tpu_torch.runtime.trajectory import simulate_trajectory

    src = ("OPENQASM 2.0;\nqreg q[4];\ncreg c[2];\nh q[0];\ncx q[0],q[1];\n"
           "measure q[0] -> c[0];\nif(c==1) x q[2];\nreset q[1];\nh q[1];\n"
           "rz(pi/3) q[2];\nmeasure q[1] -> c[1];\nif(c==3) z q[3];\n"
           "h q[3];\ncp(pi/4) q[2],q[3];\n")
    cd = qasm_to_dict(src, nonunitary="trajectory")
    for seed in range(8):
        psi, cregs, outs = simulate_trajectory(cd, seed=seed, device=dev)
        psi_o, cregs_o, outs_o = oracle.simulate_trajectory(cd, seed=seed)
        assert psi.device.type == "cuda" and psi.dtype == torch.complex64
        assert outs == outs_o and cregs == cregs_o
        assert np.linalg.norm(psi.cpu().numpy() - psi_o) <= TOL_L2


# ---------------------------------------------------------------------------
# The out-of-core spill tier on the card
# ---------------------------------------------------------------------------

def _fused_in_hbm(cd, dev):
    from quantum_simulations_tpu_torch.runtime import simulator

    return simulator.simulate(cd, device=dev).cpu().numpy()


def _l2_np(a, b):
    return float(np.linalg.norm(a.astype(np.complex128) - b))


@pytest.mark.parametrize("pipeline", [True, False])
def test_spill_host_n20_against_fused(dev, pipeline):
    """nonstab20 through host stripes of 2^14 (groups up to 2^20): within
    1e-5 of fused mode in HBM, kernels launched, the host buffer pinned;
    pipelined and synchronous bit for bit, and ``transfer='f32'`` too."""
    from quantum_simulations_tpu_torch.runtime import spill

    cd = library.non_stabilizer(20, 4, 7)
    want = _fused_in_hbm(cd, dev)
    before = pk.LAUNCHES["lane_panel"], pq.LAUNCHES["pair_update"]
    st = {}
    got = spill.run_out_of_core(cd, stripe_qubits=14, pipeline=pipeline,
                                device=dev, stats=st)
    assert pk.LAUNCHES["lane_panel"] > before[0]
    assert pq.LAUNCHES["pair_update"] > before[1]
    assert st["pinned"] and st["bytes_up"] == st["bytes_down"] == (
        st["steps"] * 8 << 20)
    assert _l2_np(got, want) < TOL_L2
    other = spill.run_out_of_core(cd, stripe_qubits=14,
                                  pipeline=not pipeline, device=dev)
    np.testing.assert_array_equal(got, other)
    f32 = spill.run_out_of_core(cd, stripe_qubits=14, transfer="f32",
                                device=dev)
    np.testing.assert_array_equal(got, f32)


def test_spill_staged_and_single_copy_on_card(dev):
    from quantum_simulations_tpu_torch.runtime import spill

    cd = library.non_stabilizer(20, 4, 7)
    want = _fused_in_hbm(cd, dev)
    got = spill.run_out_of_core(cd, stripe_qubits=15, use_staging=True,
                                single_copy=True, device=dev)
    assert _l2_np(got, want) < TOL_L2
    psi0 = np.zeros(1 << 20, np.complex64)
    psi0[0] = 1
    adopted = spill.run_out_of_core(cd, stripe_qubits=14, initial_state=psi0,
                                    single_copy=True, device=dev)
    assert adopted is psi0 and _l2_np(adopted, want) < TOL_L2


def test_spill_disk_crash_and_resume_on_card(dev, tmp_path):
    import json
    import os
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    from quantum_simulations_tpu_torch.runtime import spill

    cd = library.non_stabilizer(16, 4, 7)
    steps = spill.compile_steps(cd, k=12, panel_width=7)
    group = next(i for i, s in enumerate(steps) if spill._group_bits(s, 12))
    crash = group * 16 + 3  # the 4th write of the first group step
    root = Path(__file__).resolve().parent.parent
    script = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(root)!r})
        from quantum_simulations_tpu_torch.runtime import spill
        spill.run_out_of_core(json.loads('''{json.dumps(cd)}'''),
                              stripe_qubits=12, backend="disk",
                              work_dir={str(tmp_path)!r}, device="cuda")
    """)
    env = dict(os.environ, **{spill.CRASH_ENV: str(crash)})
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 1, res.stderr
    done = json.loads((tmp_path / "wal.json").read_text())["done_steps"]
    assert done == group < len(steps)
    env.pop(spill.CRASH_ENV)
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert _l2_np(spill.collect_state(tmp_path), _fused_in_hbm(cd, dev)) < TOL_L2


def test_spill_pinned_route(dev):
    """The host buffer is page-locked (``is_pinned`` on its tensor view),
    the slot copies run on their own streams, and the API routes there."""
    from quantum_simulations_tpu_torch import SimulatorConfig, api
    from quantum_simulations_tpu_torch.runtime.chunk_store import HostBuffer

    buf = HostBuffer(16, 12, device=dev)
    assert buf.pinned and torch.from_numpy(buf.data).is_pinned()
    assert buf.data[0] == 1 and not buf.data[1:].any()
    cd = library.ghz(16)
    got = api.simulate(cd, SimulatorConfig(stripe_qubits=12), device=dev)
    assert abs(got[0] - 2 ** -0.5) < 1e-6 and abs(got[-1] - 2 ** -0.5) < 1e-6
    bits = api.sample(cd, 8, config=SimulatorConfig(stripe_qubits=12),
                      device=dev)
    assert bits.shape == (8, 16) and set(bits.sum(axis=1).tolist()) <= {0, 16}


# ---------------------------------------------------------------------------
# The sharded tier and the runner on the card (positions sharing cuda:0)
# ---------------------------------------------------------------------------

def _mesh_on(dev, positions):
    from quantum_simulations_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=[dev] * positions)


def _sharded_l2(st, re, im):
    k = st.k
    return float(sum(
        ((a.double() - re[s << k:(s + 1) << k].double()) ** 2).sum()
        + ((b.double() - im[s << k:(s + 1) << k].double()) ** 2).sum()
        for s, (a, b) in st.shards.items())) ** 0.5


@pytest.mark.parametrize("mode", ["fused", "window"])
@pytest.mark.parametrize("positions", [2, 8])
def test_sharded_on_card_matches_one_device(dev, mode, positions):
    """non_stabilizer(18) over positions on the card: each shard's kernels
    launched, within 1e-5 of the one-device run of the same mode."""
    from quantum_simulations_tpu_torch.ops import pair_kernels
    from quantum_simulations_tpu_torch.parallel import executor as E
    from quantum_simulations_tpu_torch.runtime import simulator

    cd = library.non_stabilizer(18, 4, 7)
    for m in (pk, dk, bk, pair_kernels):
        m.reset_counts()
    st = E.simulate_sharded(_mesh_on(dev, positions), cd, mode=mode)
    torch.cuda.synchronize()
    assert sum(pk.LAUNCHES.values()) > 0
    assert not any(m.PLAIN_CALLS[k] for m in (pk, dk, bk, pair_kernels)
                   for k in m.PLAIN_CALLS)
    ref = simulator.simulate(cd, mode=mode, device=dev)
    assert _sharded_l2(st, ref.real, ref.imag) < TOL_L2


def test_sharded_capacity_on_card(dev):
    from quantum_simulations_tpu_torch.parallel import executor as E
    from quantum_simulations_tpu_torch.parallel import mesh as M
    from quantum_simulations_tpu_torch.runtime.capacity import simulate_capacity

    cd = library.qft(16)
    mesh = _mesh_on(dev, 4)
    _, fn = E.build_circuit_fns(mesh, cd, mode="window", inplace=True)
    st = fn(M.zero_state_planar_sharded(mesh, 16))
    ref = simulate_capacity(cd, device=dev)
    assert _sharded_l2(st, ref.re, ref.im) < TOL_L2


def test_runner_on_card_crash_free_resume(dev, tmp_path):
    """The runner on 2 positions of the card, then a no-op rerun; the
    committed state is the one-device window state."""
    from quantum_simulations_tpu_torch.runtime import runner, simulator

    cd = library.non_stabilizer(16, 4, 7)
    st = {}
    runner.run(cd, tmp_path, mesh=_mesh_on(dev, 2), mode="window",
               max_levels_per_step=2, stats=st)
    assert st["checkpoints"] == st["steps"] > 1
    got = runner.collect_state(tmp_path)
    ref = simulator.simulate(cd, mode="window", device=dev).cpu().numpy()
    assert np.linalg.norm(got - ref) < TOL_L2
    runner.run(cd, tmp_path, mesh=_mesh_on(dev, 2), mode="window",
               max_levels_per_step=2, stats=st)
    assert st["checkpoints"] == 0


@pytest.mark.parametrize("positions,backend", [(2, "host"), (4, "host"),
                                               (4, "disk")])
def test_spill_across_mesh_on_card(dev, positions, backend, tmp_path):
    """nonstab20 in stripes of 2^16, each group sharded over positions of
    the card: kernels launched, no plain twin, every stripe once up and
    once down a step (through pinned buffers on the host backend), within
    1e-5 of the in-HBM run of fused mode."""
    from quantum_simulations_tpu_torch.ops import pair_kernels
    from quantum_simulations_tpu_torch.runtime import spill

    cd = library.non_stabilizer(20, 4, 7)
    want = _fused_in_hbm(cd, dev)
    for m in (pk, dk, bk, pair_kernels):
        m.reset_counts()
    st = {}
    got = spill.run_out_of_core(cd, stripe_qubits=16, backend=backend,
                                work_dir=tmp_path, mesh=_mesh_on(dev, positions),
                                device=dev, stats=st)
    if backend == "disk":
        got = spill.collect_state(got)
    assert sum(pk.LAUNCHES.values()) > 0
    assert not any(m.PLAIN_CALLS[k] for m in (pk, dk, bk, pair_kernels)
                   for k in m.PLAIN_CALLS)
    assert st["pinned"] == (backend == "host")
    assert st["bytes_up"] == st["bytes_down"] == st["steps"] * 8 << 20
    assert _l2_np(got, want) < TOL_L2


def test_make_mesh_refuses_more_cards_than_present(dev):
    from quantum_simulations_tpu_torch.parallel.mesh import MeshError, make_mesh

    count = torch.cuda.device_count()
    with pytest.raises(MeshError, match=f"need {2 * count} devices, have {count}"):
        make_mesh(2 * count)


@pytest.mark.parametrize("mode", ["panel", "window", "fused"])
def test_every_family_at_small_n_on_card(dev, mode, monkeypatch):
    """The suite bench's shapes on the card (n = 6, 10, 14: 2^6 is below
    one 128-wide lane row) in each mode: every library family through the
    kernels within 1e-4 of the numpy oracle."""
    from quantum_simulations_tpu_torch.bench import suite

    monkeypatch.delenv("QST_BENCH_PLATFORM", raising=False)
    out = suite.run(mode=mode)
    assert out["n_mismatch"] == 0, [r for r in out["rows"]
                                    if r.get("status") == "MISMATCH"]
    assert sum(r["status"] == "ok" for r in out["rows"]) > 60


@pytest.mark.parametrize("name,mode", [("non_stabilizer", "fused"), ("qft", "window")])
def test_c128_blocked_passes_hold_two_states(dev, name, mode, monkeypatch):
    """complex128 at n = 28 (the plain twins on the card, above
    ``dense.PLAIN_BLOCK``): the run peaks at <= 2 states + 2 GiB of
    ``max_memory_allocated`` (10 GiB) and is within 1e-10 of the same run
    with every pass on whole planes."""
    from quantum_simulations_tpu_torch.ops import dense
    from quantum_simulations_tpu_torch.runtime import simulator

    n = 28
    cd = getattr(library, name)(n)
    state = 16 << n
    torch.zeros(1, device=dev)  # the allocator's statistics exist from here on
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    got = simulator.simulate(cd, dtype="complex128", mode=mode, device=dev)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    assert peak <= 2 * state + (2 << 30), peak / 2**30
    monkeypatch.setattr(dense, "PLAIN_BLOCK", 1 << 40)
    want = simulator.simulate(cd, dtype="complex128", mode=mode, device=dev)
    assert float((got - want).abs().max()) < 1e-10
