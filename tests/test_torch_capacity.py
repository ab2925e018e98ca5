"""The port's capacity tier against the JAX package's, on the CPU.

In-place wrappers (their plain twins here: out of place, copied back into
the caller's planes) against the JAX entries with ``inplace=True`` in
interpret mode, the two-involution factorisation of a bit permutation,
``simulate_capacity`` against the JAX ``simulate_capacity``, the planar
readout against the JAX planar functions, samples held statistically
(4.5 sigma, as tests/test_trajectory_stats.py), the capacity guard, the
api routes, and a host-only dry run of the n = 33 requests' dispatch
with the launch counts that ``chip_smoke.py`` asserts.  float64 planes
(complex128) throughout; tolerance 1e-10 unless a case says otherwise.
"""
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_simulations_tpu.circuit import library as rlib
from quantum_simulations_tpu.ops import pallas_kernels as rk
from quantum_simulations_tpu.ops import sampling as rsampling
from quantum_simulations_tpu.runtime import capacity as rcap
from quantum_simulations_tpu_torch import SimulatorConfig, api, library
from quantum_simulations_tpu_torch.ops import bitperm_kernels as bk
from quantum_simulations_tpu_torch.ops import dense
from quantum_simulations_tpu_torch.ops import diag_kernels as dk
from quantum_simulations_tpu_torch.ops import pair_kernels as pq
from quantum_simulations_tpu_torch.ops import panel_kernels as pk
from quantum_simulations_tpu_torch.ops import sampling
from quantum_simulations_tpu_torch.runtime import capacity
from quantum_simulations_tpu_torch.runtime import simulator as PS

CPU = "cpu"
CAP = SimulatorConfig(mode="capacity", dtype="complex128")
ROOT = Path(__file__).resolve().parent.parent
MODS = (pk, dk, bk, pq)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """One thread per xdist worker (as tests/test_torch_simulate.py)."""
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
    q, r = np.linalg.qr(rng.standard_normal((dim, dim))
                        + 1j * rng.standard_normal((dim, dim)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _terms(n, count, seed):
    rng = np.random.default_rng(seed)
    return cs.rand_terms(n, count, rng)


def _ref(fn, psi, *args, **kw):
    re, im = fn(jnp.asarray(psi.real), jnp.asarray(psi.imag), *args,
                interpret=True, **kw)
    return np.asarray(re) + 1j * np.asarray(im)


def _inplace(fn, psi, *args, **kw):
    """Run a port wrapper in place; the result must be the caller's
    planes (same storage), updated."""
    re, im = torch.from_numpy(psi.real.copy()), torch.from_numpy(psi.imag.copy())
    ptrs = (re.data_ptr(), im.data_ptr())
    ore, oim = fn(re, im, *args, **kw)
    assert (ore.data_ptr(), oim.data_ptr()) == ptrs
    assert ore is re and oim is im
    return re.numpy() + 1j * im.numpy()


def _close(got, want, tol=1e-10):
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# In-place wrappers against the JAX entries with inplace=True
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("diag", [False, True], ids=["panel", "panel+diag"])
def test_lane_panel_inplace(diag):
    n = 15
    psi, W = _state(n, 1), _unitary(128, 2)
    dt = _terms(n, 30, 3) if diag else None
    pk.reset_counts()
    got = _inplace(pk.lane_panel, psi, W, diag_terms=dt, inplace=True)
    key = "lane_panel+diag inplace" if diag else "lane_panel inplace"
    assert pk.PLAIN_CALLS[key] == 1
    _close(got, _ref(rk.panel_apply_planar, psi, W, inplace=True, diag_terms=dt))


@pytest.mark.parametrize("pos,w,diag", [(8, 7, False), (7, 7, True),
                                        (9, 3, False), (10, 5, True)])
def test_positioned_panel_inplace(pos, w, diag):
    n = 16
    psi, W = _state(n, pos), _unitary(1 << w, pos + w)
    dt = _terms(n, 25, pos) if diag else None
    got = _inplace(pk.positioned_panel, psi, W, pos, diag_terms=dt,
                   inplace=True)
    _close(got, _ref(rk.positioned_panel_planar, psi, W, pos, inplace=True,
                     diag_terms=dt))


@pytest.mark.parametrize("n", [14, 15])
def test_dual_panel_inplace(n):
    """Both straddlers and the diag epilogue."""
    psi = _state(n, n)
    W1, W2 = _unitary(128, 1), _unitary(128, 2)
    kw = dict(straddle=(6, 9, _unitary(4, 9)),
              post_straddle=(6, 11, _unitary(4, 11)),
              diag_terms=_terms(n, 20, n))
    got = _inplace(pk.dual_panel, psi, W1, 0, W2, 7, inplace=True, **kw)
    _close(got, _ref(rk.dual_panel_planar, psi, W1, 0, W2, 7, inplace=True,
                     **kw))


def test_fused_diag_inplace():
    n = 14
    psi, terms = _state(n, 4), _terms(n, 40, 4)
    dk.reset_counts()
    got = _inplace(dk.fused_diag, psi, terms, inplace=True)
    assert dk.PLAIN_CALLS == {"fused_diag": 0, "fused_diag inplace": 1}
    _close(got, _ref(rk.fused_diag_planar, psi, terms, inplace=True))


PAIRS_INPLACE = [("pair_update", 12, 16), ("pair_update", 16, 12),
                 ("pair_update", 13, 16), ("mixed_pair", 0, 10),
                 ("mixed_pair", 15, 3), ("mixed_low_pair", 6, 7),
                 ("mixed_low_pair", 9, 2)]


@pytest.mark.parametrize("gate", ["random", "SWAP"])
@pytest.mark.parametrize("name,qa,qb", PAIRS_INPLACE,
                         ids=[f"{a}-{b}-{c}" for a, b, c in PAIRS_INPLACE])
def test_pair_wrappers_inplace(name, qa, qb, gate):
    n = 17
    psi = _state(n, qa * 19 + qb)
    U = _unitary(4, qa + qb) if gate == "random" else dense._SWAP4
    pq.reset_counts()
    got = _inplace(getattr(pq, name), psi, qa, qb, U, inplace=True)
    assert pq.PLAIN_CALLS[name + " inplace"] == 1
    _close(got, _ref(getattr(rk, name + "_planar"), psi, qa, qb, U,
                     inplace=True))


def test_pair_update_inplace_needs_bits_from_10():
    x = torch.zeros(1 << 16, dtype=torch.float64)
    with pytest.raises(ValueError, match="midpair"):
        pq.pair_update(x, x.clone(), 8, 15, dense._SWAP4, inplace=True)


MIDPAIRS = [(7, 11), (11, 7), (8, 14), (14, 8), (9, 16), (16, 9)]


@pytest.mark.parametrize("gate", ["random", "SWAP", "CNOT"])
@pytest.mark.parametrize("qa,qb", MIDPAIRS)
def test_midpair_matches_reference(qa, qb, gate):
    """lo 7, 8 and 9, both qubit orders, against ``midpair_planar``."""
    from quantum_simulations_tpu.circuit import gates as RG

    n = 17
    psi = _state(n, qa * 23 + qb)
    U = {"random": _unitary(4, qa * qb), "SWAP": dense._SWAP4,
         "CNOT": RG.CNOT()}[gate]
    pq.reset_counts()
    got = _inplace(pq.midpair, psi, qa, qb, U)
    assert pq.PLAIN_CALLS["midpair"] == 1
    _close(got, _ref(rk.midpair_planar, psi, qa, qb, U, inplace=True))
    assert pq.midpair_supported(qa, qb) == rk.midpair_supported(qa, qb)


def test_midpair_predicate_matches_reference():
    for qa in range(20):
        for qb in range(20):
            if qa != qb:
                assert pq.midpair_supported(qa, qb) == rk.midpair_supported(qa, qb)


@pytest.mark.parametrize("n", [14, 16])
def test_bitperm_transpose_inplace(n):
    psi = _state(n, n)
    got = _inplace(bk.bitperm_transpose, psi, inplace=True)
    _close(got, _ref(rk.bitperm_transpose_planar, psi, inplace=True), 0)


def test_bitperm_cross_inplace():
    n = 16
    psi, cross = _state(n, 2), (12, 15, 9, 13, 14, 10, 11)
    got = _inplace(bk.bitperm_cross, psi, cross, inplace=True)
    _close(got, _ref(rk.bitperm_cross_planar, psi, cross, inplace=True), 0)


SPLIT_CASES = [
    (((7, 11),), {12: 15, 15: 13, 13: 12}),
    (((7, 19), (8, 18), (9, 17), (10, 16)), {11: 13, 13: 15, 15: 11}),
    ((), {10: 11, 11: 10}),
    (((8, 9),), {}),
]


@pytest.mark.parametrize("pairs,grid_map", SPLIT_CASES)
def test_bitperm_swap_inplace_matches_split_planes(pairs, grid_map):
    """In place as at most two involution passes, against the reference's
    ``split_planes`` form."""
    n = 20
    psi = _state(n, len(pairs))
    src = bk.bit_sources(n, pairs, grid_map)
    bk.reset_counts()
    got = _inplace(bk.bitperm_swap, psi, pairs, grid_map, inplace=True)
    assert bk.PLAIN_CALLS["bitperm_involution"] == len(bk.involution_factors(src))
    assert bk.PLAIN_CALLS["bitperm_swap"] == 0
    _close(got, _ref(rk.bitperm_swap_planar, psi, pairs, grid_map=grid_map,
                     split_planes=True), 0)


@pytest.mark.parametrize("seed", range(6))
def test_involution_factors_of_random_permutations(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 40))
    src = [int(b) for b in rng.permutation(n)]
    factors = bk.involution_factors(src)
    assert len(factors) <= 2
    for t in factors:
        assert all(t[t[b]] == b for b in range(n))   # an involution
    comp = list(range(n))
    for t in factors:                                # t1 first, then t2
        comp = [t[c] for c in comp]
    assert comp == src                               # src[x] = t2[t1[x]]


def test_involution_factors_of_involutions_and_identity():
    assert bk.involution_factors(list(range(9))) == []
    inv = [0, 1, 2, 3, 4, 5, 6, 9, 8, 7, 12, 11, 10]
    assert bk.involution_factors(inv) == [inv]
    assert cs.moved_rows(13, inv) == (1 << 6) - (1 << 4)


def test_bitperm_involution_refuses_a_non_involution():
    x = torch.zeros(1 << 12, dtype=torch.float64)
    src = list(range(7)) + [8, 9, 7, 10, 11]
    with pytest.raises(ValueError, match="not an involution"):
        bk.bitperm_involution(x, x.clone(), src)


# ---------------------------------------------------------------------------
# simulate_capacity against the JAX simulate_capacity
# ---------------------------------------------------------------------------

def _swapnet17():
    """A multiswap of three (7..9, >= 10) SWAPs and a (16, 8) CNOT: the
    capacity tier's midpair, pair by pair and as a PhysGateOp."""
    g = [{"qubits": [q], "gate": "H"} for q in range(17)]
    g += [{"qubits": [q], "gate": "T"} for q in (3, 8, 12, 16)]
    g += [{"qubits": list(p), "gate": "SWAP"} for p in ((7, 14), (8, 15), (9, 16))]
    g += [{"qubits": [16, 8], "gate": "CNOT"}]
    g += [{"qubits": [q], "gate": "H"} for q in (7, 9, 14)]
    return {"number_of_qubits": 17, "gates": g}


CIRCUITS = [("qft8", lambda: rlib.qft(8)),
            ("nonstab10", lambda: rlib.non_stabilizer(10, depth=3)),
            ("ghz12", lambda: rlib.ghz(12)),
            ("sycamore10", lambda: rlib.sycamore_like(10, depth=3)),
            ("qpe12", lambda: rlib.qpe(12)),
            ("swapnet17", _swapnet17),
            ("qft14", lambda: rlib.qft(14)),
            ("qft16", lambda: rlib.qft(16)),
            ("qft18", lambda: rlib.qft(18))]


def _ref_capacity(cd, psi0=None):
    n = cd["number_of_qubits"]
    if psi0 is None:
        psi0 = np.zeros(1 << n, complex)
        psi0[0] = 1
    res = rcap.simulate_capacity(cd, dtype=jnp.complex128, initial_planes=(
        jnp.asarray(psi0.real), jnp.asarray(psi0.imag)))
    return np.asarray(res.re) + 1j * np.asarray(res.im)


@pytest.mark.parametrize("tag,make", CIRCUITS, ids=[c[0] for c in CIRCUITS])
def test_simulate_capacity_matches_reference(tag, make):
    """qpe(12)'s and qft14's SWAPs run on the mixed kernels, swapnet17
    reaches midpair (a multiswap and a CNOT), qft16 the in-place crossing
    (a BitPermOp) and qft18 the in-place BitPermGridOp (one involution
    pass) and transpose; from |0> and from a random state."""
    cd = make()
    n = cd["number_of_qubits"]
    res = capacity.simulate_capacity(cd, dtype="complex128", device=CPU)
    assert isinstance(res, capacity.CapacityResult) and res.n == n
    _close(res.to_array(), _ref_capacity(cd))
    psi0 = _state(n, 3)
    re = torch.from_numpy(psi0.real.copy())
    im = torch.from_numpy(psi0.imag.copy())
    res = capacity.simulate_capacity(cd, dtype="complex128", device=CPU,
                                     initial_planes=(re, im))
    assert res.re is re and res.im is im              # updated in place
    _close(res.to_array(), _ref_capacity(cd, psi0))


def test_capacity_routes_multiswap_and_bitperm_grid_in_place():
    """swapnet17's multiswap goes pair by pair to midpair, and its CNOT
    too; qft18's BitPermGridOp as one involution pass; no bitperm_swap,
    no plain gate path."""
    for m in MODS:
        m.reset_counts()
    dense.GATE_CALLS = 0
    capacity.simulate_capacity(_swapnet17(), dtype="complex128", device=CPU)
    assert pq.PLAIN_CALLS["midpair"] == 4
    capacity.simulate_capacity(rlib.qft(18), dtype="complex128", device=CPU)
    assert bk.PLAIN_CALLS["bitperm_involution"] == 1
    assert bk.PLAIN_CALLS["bitperm_transpose inplace"] == 1
    calls = {k: v for m in MODS for k, v in m.PLAIN_CALLS.items() if v}
    assert all(k.endswith(" inplace") or k in ("midpair", "bitperm_involution")
               for k in calls), calls
    assert dense.GATE_CALLS == 0


def test_window_fn_inplace_matches_out_of_place():
    n = 14
    cd = library.qpe(n - 1)
    psi0 = _state(n, 5)
    fn = PS.build_window_circuit_fn(cd, dtype="complex128", planar_io=True,
                                    device=CPU, inplace=True)
    re = torch.from_numpy(psi0.real.copy())
    im = torch.from_numpy(psi0.imag.copy())
    ore, oim = fn(re, im)
    assert ore is re and oim is im
    want = PS.simulate(cd, dtype="complex128", mode="window", device=CPU,
                       initial_state=psi0)
    _close(re.numpy() + 1j * im.numpy(), want.numpy())


@pytest.mark.parametrize("qubits", [(0,), (3,), (9,), (13,), (8, 9),
                                    (12, 10)])
def test_capacity_gate_on_a_panel_matches_reference(qubits):
    """A gate the reference runs as an in-place XLA lincomb (a 1q gate, or
    a 2q gate on two close bits >= 7) runs as a one-gate panel in place:
    no plain gate path, and the reference's PhysGateOp result."""
    from quantum_simulations_tpu.circuit.panelize import PhysGateOp as RPhys
    from quantum_simulations_tpu.runtime import simulator as RS

    n = 14
    psi = _state(n, sum(qubits))
    U = _unitary(1 << len(qubits), len(qubits) * 5 + qubits[0])
    for m in MODS:
        m.reset_counts()
    dense.GATE_CALLS = 0
    got = _inplace(lambda re, im: PS.apply_gate(re, im, qubits, U,
                                                 inplace=True), psi)
    assert dense.GATE_CALLS == 0
    key = "lane_panel inplace" if max(qubits) < 7 else "positioned_panel inplace"
    assert pk.PLAIN_CALLS[key] == 1
    op = RPhys(qubits=tuple(qubits), U=U, name="U")
    re, im = RS.apply_window_op(jnp.asarray(psi.real), jnp.asarray(psi.imag),
                                op, jnp.float64, True, True)
    _close(got, np.asarray(re) + 1j * np.asarray(im))


def test_inplace_none_resolves_as_the_reference_on_the_cpu():
    assert PS.resolve_inplace(None, 28, CPU) is False
    assert PS.resolve_inplace(None, 29, CPU) is True
    assert PS.resolve_inplace(False, 33, CPU) is False


# ---------------------------------------------------------------------------
# Planar readout against the JAX planar functions
# ---------------------------------------------------------------------------

@pytest.fixture(params=[28, 8], ids=["one_chunk", "chunked"])
def chunk_bits(request, monkeypatch):
    monkeypatch.setattr(sampling, "CHUNK_BITS", request.param)
    return request.param


def _planes(psi):
    return torch.from_numpy(psi.real.copy()), torch.from_numpy(psi.imag.copy())


def _jplanes(psi):
    return jnp.asarray(psi.real), jnp.asarray(psi.imag)


def test_norm2_and_qubit_probability(chunk_bits):
    n = 13
    psi = _state(n, 8) * 1.1
    re, im = _planes(psi)
    _close(sampling.norm2_planar(re, im),
           float(rsampling.norm2_planar(*_jplanes(psi))))
    for q in (0, 3, 5, 6, 7, 12):
        _close(sampling.qubit_probability_planar(re, im, q),
               float(rsampling.qubit_probability_planar(*_jplanes(psi), q)))


@pytest.mark.parametrize("qubits", [[0], [1, 4], [0, 6, 7, 12], [2, 9, 11]])
def test_expectation_z(chunk_bits, qubits):
    n = 13
    psi = _state(n, sum(qubits))
    got = sampling.expectation_z_planar(*_planes(psi), qubits)
    _close(got, float(rsampling.expectation_z_planar(*_jplanes(psi), qubits)))


@pytest.mark.parametrize("k", [1, 5, 8])
def test_top_amplitudes_exact(chunk_bits, k):
    n = 14
    psi = _state(n, k)
    idx, probs, ar, ai = sampling.top_amplitudes_planar(*_planes(psi), k)
    assert idx.dtype == torch.int64
    ridx, rprobs, rar, rai = rsampling.top_amplitudes_planar(*_jplanes(psi), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    _close(probs.numpy(), np.asarray(rprobs))
    _close(ar.numpy() + 1j * ai.numpy(), psi[np.asarray(ridx)])


def test_capacity_result_readout_matches_reference():
    cd = rlib.qft(8)
    res = api.simulate(cd, CAP, device=CPU)
    psi = res.to_array()
    want = _ref_capacity(cd)
    _close(psi, want)
    mask = (1 << 1) | (1 << 4)
    signs = np.array([(-1) ** bin(i & mask).count("1") for i in range(psi.size)])
    _close(res.expectation_z([1, 4]), float((np.abs(want) ** 2 * signs).sum()))
    _close(res.norm2(), 1.0)
    summary = res.summary(4)
    assert summary["mode"] == "capacity" and len(summary["top"]) == 4


def test_expectation_pauli_matches_reference():
    from quantum_simulations_tpu.ops import observables as robs
    from quantum_simulations_tpu.runtime import simulator as RS

    cd = rlib.qft(8)
    want = float(robs.expectation_pauli(
        jnp.asarray(RS.simulate(cd, dtype="complex128")), "XZIY"))
    _close(api.expectation_pauli(cd, "XZIY", CAP, device=CPU), want)
    _close(api.expectation_pauli(cd, {1: "z", 3: "Y"}, CAP, device=CPU),
           float(robs.expectation_pauli(
               jnp.asarray(RS.simulate(cd, dtype="complex128")), {1: "z", 3: "Y"})))
    with pytest.raises(ValueError, match="unknown Pauli"):
        api.expectation_pauli(cd, "XQ", CAP, device=CPU)


# ---------------------------------------------------------------------------
# Samples, statistically
# ---------------------------------------------------------------------------

def _bound(p: float, shots: int, sigmas: float = 4.5) -> float:
    return sigmas * math.sqrt(p * (1 - p) / shots)


def test_ghz_samples(chunk_bits):
    res = api.simulate(rlib.ghz(12), CAP, device=CPU)
    shots = 4000
    bits = res.sample_bits(shots, seed=3)
    assert bits.shape == (shots, 12) and bits.dtype == np.int8
    rowsum = bits.sum(axis=1)
    assert set(rowsum.tolist()) <= {0, 12}
    assert abs((rowsum == 12).mean() - 0.5) < _bound(0.5, shots)


def test_ry_marginal():
    theta = 1.1
    cd = {"number_of_qubits": 9, "gates": [
        {"qubits": [0], "gate": "RY", "params": {"theta": theta}},
        {"qubits": [5], "gate": "H"}]}
    res = api.simulate(cd, CAP, device=CPU)
    p1 = math.sin(theta / 2) ** 2
    shots = 4000
    bits = res.sample_bits(shots, seed=7)
    assert abs(bits[:, 0].mean() - p1) < _bound(p1, shots)
    assert abs(bits[:, 5].mean() - 0.5) < _bound(0.5, shots)
    _close(res.qubit_probability(0), p1)


def test_random_circuit_marginals(chunk_bits):
    """Every qubit's sampled frequency against its exact probability from
    the JAX state, within 4.5 sigma."""
    cd = rlib.random_circuit(10, 80, seed=11)
    res = api.simulate(cd, CAP, device=CPU)
    want = np.abs(_ref_capacity(cd)) ** 2
    shots = 6000
    bits = res.sample_bits(shots, seed=5)
    idx = np.arange(want.size)
    for q in range(10):
        p1 = float(want[(idx >> q) & 1 == 1].sum())
        assert abs(bits[:, q].mean() - p1) < _bound(p1, shots) + 1e-12, q


def test_samples_are_seeded():
    res = api.simulate(rlib.random_circuit(8, 40, seed=2), CAP, device=CPU)
    a, b = res.sample_bits(300, seed=4), res.sample_bits(300, seed=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, res.sample_bits(300, seed=5))


# ---------------------------------------------------------------------------
# The guard and the api routes
# ---------------------------------------------------------------------------

def test_capacity_guard_raises_cleanly(monkeypatch):
    """A non-diagonal 3q gate straddling the lane window: the reference's
    ValueError, before any pass runs."""
    monkeypatch.setenv("QST_CAPACITY_GUARD_MIN", "256")
    ccx = {"number_of_qubits": 10, "gates": [
        {"qubits": [0], "gate": "H"},
        {"qubits": [0, 8, 9], "gate": "CCX"}]}
    with pytest.raises(ValueError, match="no in-place planar kernel"):
        api.simulate(ccx, CAP, device=CPU)
    with pytest.raises(ValueError, match="no in-place planar kernel"):
        rcap.simulate_capacity(ccx)


def test_capacity_guard_allows_small_states():
    ccx = {"number_of_qubits": 10, "gates": [
        {"qubits": [0], "gate": "H"}, {"qubits": [1], "gate": "H"},
        {"qubits": [0, 1, 9], "gate": "CCX"}]}
    res = api.simulate(ccx, CAP, device=CPU)
    _close(res.to_array(), _ref_capacity(ccx))


def test_api_sample_and_expectation_route_capacity():
    bits = api.sample(rlib.ghz(10), 50, seed=1, config=CAP, device=CPU)
    assert bits.shape == (50, 10) and set(bits.sum(axis=1).tolist()) <= {0, 10}
    cd = rlib.qft(8)
    res = api.simulate(cd, CAP, device=CPU)
    _close(api.expectation_z(cd, [2, 5], CAP, device=CPU),
           res.expectation_z([2, 5]))


@pytest.mark.parametrize("cfg,err", [
    # The dense tier reads out (tests/test_torch_panel_mode.py); beside a
    # spill stripe it is the spill tier, which runs now
    # (tests/test_torch_spill.py) and reads out the reference's state
    # (err None).
    (SimulatorConfig(mode="window", stripe_qubits=8, dtype="complex128"),
     None),
    (SimulatorConfig(mode="capacity", n_devices=2), "sharded"),
    # sparse=True runs and samples (tests/test_torch_sparse.py); the
    # sharded tier's error names it among the tiers that run.
    (SimulatorConfig(mode="window", n_devices=2), "sparse"),
])
def test_api_readout_of_unported_tiers_raises(cfg, err):
    if err is None:
        from quantum_simulations_tpu.api import expectation_z as rexp

        bits = api.sample(rlib.ghz(10), 10, config=cfg, device=CPU)
        assert bits.shape == (10, 10)
        assert set(bits.sum(axis=1).tolist()) <= {0, 10}
        cd = rlib.qft(10)
        _close(api.expectation_z(cd, [0, 9], config=cfg, device=CPU),
               rexp(cd, [0, 9], cfg))
        return
    with pytest.raises(NotImplementedError, match=err):
        api.sample(rlib.ghz(10), 10, config=cfg, device=CPU)
    with pytest.raises(NotImplementedError, match=err):
        api.expectation_z(rlib.ghz(10), [0], config=cfg, device=CPU)


def test_auto_mode_routes_to_capacity_from_29():
    from quantum_simulations_tpu_torch.api import _is_capacity

    auto = SimulatorConfig(mode="auto")
    assert not _is_capacity(auto, 28) and _is_capacity(auto, 29)
    assert _is_capacity(SimulatorConfig(mode="capacity"), 10)
    assert not _is_capacity(SimulatorConfig(mode="capacity"), 10, work_dir="w")


# ---------------------------------------------------------------------------
# Host-only: the n = 33 requests' dispatch, on meta tensors
# ---------------------------------------------------------------------------

def _dry_run(cd):
    """Launch counts of the in-place schedule of ``cd`` as the card would
    make them: the wrappers see meta tensors (shape, no data) as card
    planes and launch nothing."""
    saved = [(m, m.on_card, m.launch) for m in MODS]
    for m in MODS:
        m.on_card = lambda name, re, im: True
        m.launch = lambda *a: None
    try:
        for m in MODS:
            m.reset_counts()
        dense.GATE_CALLS = 0
        n = cd["number_of_qubits"]
        meta = torch.device("meta")
        prepared = PS.prepare_schedule(PS.schedule(cd, inplace=True), meta,
                                       torch.float32)
        re = torch.empty(1 << n, device=meta)
        im = torch.empty(1 << n, device=meta)
        for op, dt in prepared:
            out = PS.apply_window_op(re, im, op, dt, inplace=True)
            assert out[0] is re and out[1] is im
        assert not any(v for m in MODS for v in m.PLAIN_CALLS.values())
        assert dense.GATE_CALLS == 0
        return {k: v for m in MODS for k, v in m.LAUNCHES.items() if v}
    finally:
        for m, on_card, launch in saved:
            m.on_card, m.launch = on_card, launch


@pytest.mark.parametrize("label", list(cs.CAPACITY33))
def test_n33_requests_run_on_kernels_only(label):
    assert _dry_run(cs.circuits33()[label]) == cs.WANT[label]


@pytest.mark.parametrize("label", ["nonstab28", "qft28", "qaoa28", "qpe28",
                                   "qft_adder28", "deutsch_jozsa28", "w_qft28",
                                   "hadamard_wall28", "qft28 nodecomp"])
def test_n28_capacity_requests_launch_counts(label, monkeypatch):
    switches = {"hadamard_wall28": ("QST_PANEL_PAIR_FUSE", "0"),
                "qft28 nodecomp": ("QST_BITPERM_DECOMP", "0")}
    if label in switches:
        monkeypatch.setenv(*switches[label])
    cd = cs.circuits()[label.split()[0]]
    assert _dry_run(cd) == cs.WANT[label + " capacity"]


def test_qpe_answer_index():
    """qpe(k) with theta = 1/8 ends in one basis state: eigenstate bit k
    and counting bit k - 3.  Pinned at small k against the JAX package,
    then the index chip_smoke.py checks at k = 32 (above 2^32)."""
    from quantum_simulations_tpu.runtime import simulator as RS

    for k in (6, 9, 12):
        p = np.abs(np.asarray(RS.simulate(rlib.qpe(k), dtype="complex128"))) ** 2
        assert int(np.argmax(p)) == (1 << k) | (1 << (k - 3))
        assert p.max() > 1 - 1e-10
    assert cs.QPE33_ANSWER == (1 << 32) | (1 << 29)
    res = api.simulate(library.qpe(12), CAP, device=CPU)
    assert res.top_amplitudes(1)[0][0] == (1 << 12) | (1 << 9)


def test_nonstab_inverse_returns_to_zero():
    """chip_smoke.py's nonstab33 check at n = 14: the circuit, then its
    inverse on the same planes, gives back |0>."""
    cd = library.non_stabilizer(14, depth=4, seed=7)
    res = capacity.simulate_capacity(cd, dtype="complex128", device=CPU)
    res = capacity.simulate_capacity(cs.inverse(cd), dtype="complex128",
                                     device=CPU, initial_planes=(res.re, res.im))
    zero = np.zeros(1 << 14)
    zero[0] = 1
    _close(res.to_array(), zero)


def test_qft_exact_amplitude_distance(chunk_bits):
    """chip_smoke.py's qft33 check (chunked ||psi - 2^-n/2||_2) at n = 12."""
    res = api.simulate(rlib.qft(12), CAP, device=CPU)
    assert cs.uniform_distance(res.re, res.im) < 1e-10
    res.re[5] += 1e-3
    assert abs(cs.uniform_distance(res.re, res.im) - 1e-3) < 1e-9

