"""The port's native host engine (``native/``, ``oracle/native.py``)
against the JAX package's, on the CPU.

The cases of ``tests/test_native.py``, each through both packages' C++
engines: the port builds the same ``host_engine.cpp`` into its own
``native/build/``, so results must equal the reference engine's bit for
bit, and both hold to the numpy oracle (1e-12 in complex128 per gate,
1e-10 per circuit, 1e-6 / 2e-5 in complex64).  Skips, as the reference's
tests do, where no C++ toolchain builds the engine.
"""
import numpy as np
import pytest

from quantum_simulations_tpu import native as rnative
from quantum_simulations_tpu.circuit import library as rlib
from quantum_simulations_tpu.oracle import native as rnat
from quantum_simulations_tpu_torch import native
from quantum_simulations_tpu_torch.circuit import gates as G
from quantum_simulations_tpu_torch.oracle import dense_numpy as oracle
from quantum_simulations_tpu_torch.oracle import native as nat


@pytest.fixture(autouse=True)
def _engines():
    if not nat.available():
        pytest.skip(f"native build failed: {native.BUILD_ERROR}")
    assert rnat.available(), rnative.BUILD_ERROR


def _rand(n, seed=0, dtype=np.complex128):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return (psi / np.linalg.norm(psi)).astype(dtype)


def test_same_engine_source():
    from pathlib import Path

    here = Path(native.__file__).parent / "host_engine.cpp"
    ref = Path(rnative.__file__).parent / "host_engine.cpp"
    assert here.read_bytes() == ref.read_bytes()
    assert native._SO.parent == Path(native.__file__).parent / "build"


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("q", [0, 3, 6])
def test_native_1q(dtype, q):
    psi = _rand(7, seed=q, dtype=dtype)
    want = oracle.apply_gate(psi.astype(np.complex128), [q], G.H())
    ref = psi.copy()
    native.apply_1q(psi, q, G.H())
    rnative.apply_1q(ref, q, G.H())
    np.testing.assert_array_equal(psi, ref)
    atol = 1e-6 if dtype == np.complex64 else 1e-12
    np.testing.assert_allclose(psi, want, atol=atol)


@pytest.mark.parametrize("qa,qb", [(0, 1), (1, 0), (2, 6), (6, 2), (5, 3)])
def test_native_2q(qa, qb):
    psi = _rand(7, seed=qa * 8 + qb)
    want = oracle.apply_gate(psi, [qa, qb], G.CNOT())
    ref = psi.copy()
    native.apply_2q(psi, qa, qb, G.CNOT())
    rnative.apply_2q(ref, qa, qb, G.CNOT())
    np.testing.assert_array_equal(psi, ref)
    np.testing.assert_allclose(psi, want, atol=1e-12)


def test_native_diag_and_norm2():
    psi = _rand(6, seed=2)
    U = G.gate_matrix("CR", {"k": 3})
    want = oracle.apply_gate(psi, [4, 1], U)
    ref = psi.copy()
    native.apply_diag(psi, [4, 1], np.diag(U))
    rnative.apply_diag(ref, [4, 1], np.diag(U))
    np.testing.assert_array_equal(psi, ref)
    np.testing.assert_allclose(psi, want, atol=1e-12)
    big = _rand(8, seed=1)
    # An OpenMP reduction: the sum's order follows the thread split.
    assert abs(native.norm2(big) - rnative.norm2(big)) <= 1e-14
    assert abs(native.norm2(big) - 1.0) < 1e-10


CIRCUITS = [
    ("qft8", rlib.qft(8)),
    ("random", rlib.random_circuit(8, 60, seed=3)),
    ("w7", rlib.w_state(7)),
    ("qaoa", rlib.qaoa_maxcut(8, p=2)),
    ("ccx", {"number_of_qubits": 4, "gates": [
        {"qubits": [0], "gate": "H"}, {"qubits": [1], "gate": "X"},
        {"qubits": [0, 1, 2], "gate": "CCX"}]}),
]


@pytest.mark.parametrize("tag,cd", CIRCUITS, ids=[c[0] for c in CIRCUITS])
def test_native_simulator_equals_reference(tag, cd):
    got = nat.simulate(cd)
    np.testing.assert_array_equal(got, rnat.simulate(cd))
    np.testing.assert_allclose(got, oracle.simulate(cd), atol=1e-10)


def test_native_c64_accuracy_and_threads():
    cd = rlib.qft(10)
    got = nat.simulate(cd, dtype=np.complex64)
    np.testing.assert_array_equal(got, rnat.simulate(cd, dtype=np.complex64))
    np.testing.assert_allclose(got, oracle.simulate(cd), atol=2e-5)
    native.set_threads(2)
    cd = rlib.ghz(6)
    np.testing.assert_allclose(nat.simulate(cd), oracle.simulate(cd),
                               atol=1e-12)
    psi0 = _rand(6, seed=7)
    np.testing.assert_allclose(nat.simulate(cd, initial_state=psi0),
                               oracle.simulate(cd, initial_state=psi0),
                               atol=1e-12)


def test_native_measure_ghz_collapses_together():
    base = oracle.simulate(rlib.ghz(6))
    outcomes = set()
    for seed in range(12):
        psi, ref = base.copy(), base.copy()
        out = native.measure(psi, list(range(6)), seed=seed)
        assert out == rnative.measure(ref, list(range(6)), seed=seed)
        np.testing.assert_array_equal(psi, ref)
        assert out in (0, 0b111111)
        outcomes.add(out)
        assert abs(native.norm2(psi) - 1.0) < 1e-10
    assert outcomes == {0, 0b111111}


def test_native_measure_deterministic_and_statistics():
    psi0 = np.zeros(4, dtype=np.complex128)
    psi0[0b10] = 1.0
    for seed in (0, 1, 99):
        psi = psi0.copy()
        assert native.measure(psi, [0, 1], seed=seed) == 0b10
        np.testing.assert_allclose(psi, psi0, atol=1e-12)
    plus = np.full(2, 1 / np.sqrt(2), dtype=np.complex128)
    ones = [native.measure(plus.copy(), [0], seed=s) for s in range(400)]
    assert ones == [rnative.measure(plus.copy(), [0], seed=s)
                    for s in range(400)]
    assert 140 <= sum(ones) <= 260


def test_native_oracle_measurement_helpers():
    psi = oracle.simulate(rlib.ghz(5))
    assert nat.prob_qubit(psi.copy(), 2) == rnat.prob_qubit(psi.copy(), 2)
    a, b = psi.copy(), psi.copy()
    oa, sa = nat.measure_qubit(a, 4, np.random.default_rng(3))
    ob, sb = rnat.measure_qubit(b, 4, np.random.default_rng(3))
    assert oa == ob
    np.testing.assert_array_equal(sa, sb)
    bits = nat.measure_all(psi.copy(), 5, np.random.default_rng(1))
    assert bits == rnat.measure_all(psi.copy(), 5, np.random.default_rng(1))
    assert bits in ("00000", "11111")


@pytest.mark.parametrize("dtype,eps", [(np.complex64, 1e-4),
                                       (np.complex128, 3e-8)])
def test_native_state_equal(dtype, eps):
    a = _rand(8, seed=5, dtype=dtype)
    assert native.state_equal(a, a.copy())
    b = a.copy()
    b[17] += eps
    d = native.state_max_diff(a, b)
    assert d == rnative.state_max_diff(a, b)
    assert abs(d - eps) < eps * 1e-3
    assert not native.state_equal(a, b, tol=eps / 10)
    assert native.state_equal(a, b, tol=eps * 10)


def test_native_state_equal_mismatch_raises():
    a = _rand(4, seed=1)
    with pytest.raises(ValueError):
        native.state_max_diff(a, a.astype(np.complex64))
    with pytest.raises(ValueError):
        native.state_max_diff(a, a[:8].copy())


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_native_alloc_state_runs_circuit(dtype):
    n = 12
    psi = native.alloc_state(1 << n, dtype=dtype)
    assert psi.size == 1 << n and psi.dtype == dtype
    assert not psi.flags.owndata
    np.testing.assert_array_equal(psi, 0)
    psi[0] = 1.0
    native.apply_1q(psi, 0, G.H())
    for q in range(n - 1):
        native.apply_2q(psi, q, q + 1, G.CNOT())
    want = oracle.simulate(rlib.ghz(n)).astype(dtype)
    atol = 1e-6 if dtype == np.complex64 else 1e-12
    np.testing.assert_allclose(psi, want, atol=atol)
    native.free_state(psi)
    with pytest.raises(TypeError):
        native.alloc_state(16, dtype=np.float32)


def test_unavailable_engine_raises(monkeypatch):
    """A failed build leaves ``available()`` False and every call raising
    ``RuntimeError`` naming the build error, as in the reference."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_ERROR", "g++ not found")
    assert not native.available() and not nat.available()
    psi = _rand(3)
    for call in (lambda: native.apply_1q(psi, 0, G.H()),
                 lambda: native.norm2(psi),
                 lambda: native.alloc_state(8)):
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            call()
    with pytest.raises(RuntimeError, match="unavailable"):
        nat.simulate(rlib.ghz(3))
