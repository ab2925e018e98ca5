"""The plain passes run block by block above ``dense.PLAIN_BLOCK``
amplitudes (``dense.blocked``), held to their whole-plane selves and to
the JAX package.

``PLAIN_BLOCK`` is lowered to 2^4-2^6 amplitudes so that states of n =
10-12 run in many blocks, strided ones too where an op touches the top
bits.  The JAX side runs as its own tests run it: the Pallas entries on
the CPU with ``interpret=True``, float64 planes (x64 is on through
``tests/conftest.py``), the XLA gate paths and ``simulate`` in
complex128.  Both sides see the same seeded numpy state and operators;
tolerance 1e-10 (float64 round-off of these sums is ~1e-15).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from quantum_simulations_tpu.circuit import library as rlib
from quantum_simulations_tpu.ops import dense as rdense
from quantum_simulations_tpu.ops import pallas_kernels as rk
from quantum_simulations_tpu.runtime import simulator as rsim
from quantum_simulations_tpu_torch.circuit import library
from quantum_simulations_tpu_torch.ops import bitperm_kernels as bk
from quantum_simulations_tpu_torch.ops import dense
from quantum_simulations_tpu_torch.ops import diag_kernels as dk
from quantum_simulations_tpu_torch.ops import pair_kernels as pq
from quantum_simulations_tpu_torch.ops import panel_kernels as pk
from quantum_simulations_tpu_torch.runtime import simulator

ATOL = 1e-10
BLOCKS = [1 << 4, 1 << 6]


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """One thread per xdist worker (as tests/test_torch_kernels.py)."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _state(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return psi / np.linalg.norm(psi)


def _unitary(dim, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim))
                        + 1j * rng.standard_normal((dim, dim)))
    return q


def _terms(n, count, seed):
    """Random Möbius terms of order <= 3 on n qubits, the global one too."""
    rng = np.random.default_rng(seed)
    terms = {(): float(rng.uniform(-5, 5))}
    while len(terms) < count:
        qs = sorted(rng.choice(n, rng.integers(1, 4), replace=False))
        terms[tuple(int(q) for q in qs)] = float(rng.uniform(-5, 5))
    return tuple(terms.items())


def _port(fn, psi, *args, **kw):
    re, im = fn(torch.from_numpy(psi.real.copy()),
                torch.from_numpy(psi.imag.copy()), *args, **kw)
    return re.numpy() + 1j * im.numpy()


def _ref(fn, psi, *args, **kw):
    re, im = fn(jnp.asarray(psi.real), jnp.asarray(psi.imag), *args, **kw)
    return np.asarray(re) + 1j * np.asarray(im)


def _gate_ref(psi, qubits, U):
    """The JAX package's planar gate path, its complex fallback where it
    returns None (a gate across the lane boundary)."""
    out = rdense.apply_gate_planar(jnp.asarray(psi.real), jnp.asarray(psi.imag),
                                   tuple(qubits), U)
    if out is None:
        return np.asarray(rdense.apply_gate(jnp.asarray(psi), tuple(qubits), U))
    return np.asarray(out[0]) + 1j * np.asarray(out[1])


N = 12
_T = _terms(N, 40, 3)
_DIAG4 = np.diag(np.exp(1j * np.array([0.3, -1.1, 2.0, 0.7])))
_CCX = np.eye(8, dtype=np.complex128)[[0, 1, 2, 3, 4, 5, 7, 6]]

# name -> (n, port call, JAX call): each a function of the state
CASES = {
    "lane_panel_plain": (N, lambda p: _port(pk.lane_panel_plain, p, _unitary(128, 1)),
                         lambda p: _ref(rk.panel_apply_planar, p, _unitary(128, 1),
                                        interpret=True)),
    "lane_panel_plain+diag": (
        N, lambda p: _port(pk.lane_panel_plain, p, _unitary(128, 2), _T),
        lambda p: _ref(rk.panel_apply_planar, p, _unitary(128, 2), diag_terms=_T,
                       interpret=True)),
    "lane_panel_plain rotate": (
        N, lambda p: _port(pk.lane_panel_plain, p, _unitary(128, 3), rotate=True),
        lambda p: _ref(rk.panel_apply_planar, p, _unitary(128, 3), rotate=True,
                       interpret=True)),
    "positioned_panel_plain top": (
        N, lambda p: _port(pk.positioned_panel_plain, p, _unitary(32, 4), 7),
        lambda p: _ref(rk.positioned_panel_planar, p, _unitary(32, 4), 7,
                       interpret=True)),
    "positioned_panel_plain+diag": (
        N, lambda p: _port(pk.positioned_panel_plain, p, _unitary(16, 5), 7, _T),
        lambda p: _ref(rk.positioned_panel_planar, p, _unitary(16, 5), 7,
                       diag_terms=_T, interpret=True)),
    "dual_panel_plain": (
        15, lambda p: _port(pk.dual_panel_plain, p, _unitary(128, 6), 0,
                            _unitary(128, 7), 7, (6, 9, _unitary(4, 8))),
        lambda p: _ref(rk.dual_panel_planar, p, _unitary(128, 6), 0,
                       _unitary(128, 7), 7, straddle=(6, 9, _unitary(4, 8)),
                       interpret=True)),
    "pair_gate_plain (7, top)": (
        N, lambda p: _port(pq.pair_gate_plain, p, 7, N - 1, _unitary(4, 9)),
        lambda p: _ref(rk.pair_update_planar, p, 7, N - 1, _unitary(4, 9),
                       interpret=True)),
    "pair_gate_plain (top, 2)": (
        N, lambda p: _port(pq.pair_gate_plain, p, N - 1, 2, _unitary(4, 10)),
        lambda p: _ref(rk.mixed_pair_planar, p, N - 1, 2, _unitary(4, 10),
                       interpret=True)),
    "diag_planar": (N, lambda p: _port(dense.diag_planar, p, (N - 1, 4), np.diag(_DIAG4)),
                    lambda p: _gate_ref(p, (N - 1, 4), _DIAG4)),
    "lincomb_planar 1q": (N, lambda p: _port(dense.lincomb_planar, p, (N - 1,),
                                             _unitary(2, 11)),
                          lambda p: _gate_ref(p, (N - 1,), _unitary(2, 11))),
    "lincomb_planar 2q": (N, lambda p: _port(dense.lincomb_planar, p, (8, N - 1),
                                             _unitary(4, 12)),
                          lambda p: _gate_ref(p, (8, N - 1), _unitary(4, 12))),
    "contract_planar Toffoli": (
        N, lambda p: _port(dense.contract_planar, p, (5, 6, N - 1), _CCX),
        lambda p: _gate_ref(p, (5, 6, N - 1), _CCX)),
    "bitperm_swap_plain": (
        N, lambda p: _port(bk.bitperm_swap_plain, p, ((7, N - 1), (8, 10))),
        lambda p: _ref(rk.bitperm_swap_planar, p, ((7, N - 1), (8, 10)),
                       interpret=True)),
    "fused_diag_plain": (N, lambda p: _port(dk.fused_diag_plain, p, _T),
                         lambda p: _ref(rk.fused_diag_planar, p, _T, interpret=True)),
}


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_blocked_pass_matches_whole_and_reference(case, block, monkeypatch):
    """Each plain pass in blocks of ``block`` amplitudes: equal to its
    whole-plane self and to the JAX function; every blocking in it
    (``dense.block_bits``) fixes at least one bit."""
    n, port, ref = CASES[case]
    psi = _state(n, n + len(case))
    whole = port(psi)
    fixed = []
    real = dense.block_bits

    def spy(n, touched, dtype=torch.float64):
        fixed.append(len(real(n, touched, dtype)))
        return real(n, touched, dtype)

    monkeypatch.setattr(dense, "PLAIN_BLOCK", block)
    monkeypatch.setattr(dense, "block_bits", spy)
    got = port(psi)
    assert fixed and all(k > 0 for k in fixed), fixed
    assert float(np.max(np.abs(got - whole))) < ATOL
    assert float(np.max(np.abs(got - ref(psi)))) < ATOL


@pytest.mark.parametrize("base", [0, 48, 1 << 10])
def test_terms_theta_with_a_base_offset(base):
    """theta of a block from its base index is the whole plane's theta
    over that block's indices."""
    n, size = 11, 1 << 6
    whole = dk.terms_theta(1 << n, _terms(n, 30, 7), torch.float64, "cpu")
    got = dk.terms_theta(size, _terms(n, 30, 7), torch.float64, "cpu", base)
    assert torch.equal(got, whole[base:base + size])


def test_blocks_hold_whole_orbits():
    """A block never splits an orbit: with fewer untouched bits than the
    cut needs, every untouched bit is fixed and the block is larger."""
    saved = dense.PLAIN_BLOCK
    try:
        dense.PLAIN_BLOCK = 1 << 4
        assert dense.block_bits(12, set(range(7))) == [11, 10, 9, 8, 7]
        assert dense.block_bits(12, {11, 3}) == [10, 9, 8, 7, 6, 5, 4, 2]
        assert dense.block_bits(4, set()) == []
        assert dense.block_bits(12, {1}, torch.float32) == []
        dense.PLAIN_BLOCK = 1 << 20
        assert dense.block_bits(12, {1}) == []
    finally:
        dense.PLAIN_BLOCK = saved


@pytest.mark.parametrize("donate", [False, True])
def test_blocked_output_planes(donate):
    """Out of place the input planes stay as they were; with ``donate``
    the result lands in them."""
    saved = dense.PLAIN_BLOCK
    try:
        dense.PLAIN_BLOCK = 1 << 4
        psi = _state(8, 1)
        re, im = torch.from_numpy(psi.real.copy()), torch.from_numpy(psi.imag.copy())
        out = dk.apply_diag_plain(re, im, _terms(8, 10, 2), donate=donate)
        assert (out[0].data_ptr() == re.data_ptr()) == donate
        assert np.array_equal(re.numpy(), psi.real) != donate
    finally:
        dense.PLAIN_BLOCK = saved


_CIRCUITS = {
    "qft11": lambda lib: lib.qft(11),
    "nonstab11": lambda lib: lib.non_stabilizer(11, depth=3),
    "qpe10": lambda lib: lib.qpe(9),
}


@pytest.mark.parametrize("segment_gates", [None, 4])
@pytest.mark.parametrize("mode", ["fused", "window", "panel"])
@pytest.mark.parametrize("circ", list(_CIRCUITS))
def test_simulate_c128_blocked_matches_reference(circ, mode, segment_gates,
                                                 monkeypatch):
    """``simulate(dtype="complex128")`` with every plain pass in blocks of
    2^5 amplitudes, from a random state, against the JAX ``simulate``."""
    monkeypatch.setattr(dense, "PLAIN_BLOCK", 1 << 5)
    cd = _CIRCUITS[circ](library)
    n = cd["number_of_qubits"]
    psi0 = _state(n, 17)
    got = simulator.simulate(cd, dtype="complex128", mode=mode,
                             initial_state=torch.from_numpy(psi0),
                             segment_gates=segment_gates, device="cpu")
    want = rsim.simulate(_CIRCUITS[circ](rlib), dtype=jnp.complex128, mode=mode,
                         initial_state=jnp.asarray(psi0),
                         segment_gates=segment_gates)
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < ATOL
