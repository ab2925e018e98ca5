"""The two-qubit gate wrappers' twins and the plain torch gate paths
against the JAX package.

The JAX side runs as its own tests run it (CPU, ``interpret=True``,
float64 planes through x64); the port's wrappers get CPU tensors, so they
run their plain twin.  Same seeded states and gates, tolerance 1e-10.
A seeded random 4x4 unitary is in every case list: a permutation gate
(CNOT, SWAP) can hide a wrong coefficient or a conjugation.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from quantum_simulations_tpu.circuit import gates as RG
from quantum_simulations_tpu.ops import dense as rdense
from quantum_simulations_tpu.ops import pallas_kernels as rk
from quantum_simulations_tpu_torch.ops import dense
from quantum_simulations_tpu_torch.ops import pair_kernels as pq

N = 18


def _state(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)


def _unitary(dim, seed):
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.standard_normal((dim, dim))
                        + 1j * rng.standard_normal((dim, dim)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _gate(kind, seed):
    if kind == "random":
        return _unitary(4, seed)
    return {"CNOT": RG.CNOT(), "SWAP": RG.SWAP()}[kind]


def _ref(fn, psi, *args):
    re, im = fn(jnp.asarray(psi.real), jnp.asarray(psi.imag), *args,
                interpret=True)
    return np.asarray(re) + 1j * np.asarray(im)


def _port(fn, psi, *args):
    re, im = fn(torch.from_numpy(psi.real.copy()),
                torch.from_numpy(psi.imag.copy()), *args)
    return re.numpy() + 1j * im.numpy()


PAIR_UPDATE = [(7, 11), (11, 7), (9, 14), (14, 9), (12, 16), (16, 12),
               (13, 15), (15, 13), (13, 17), (17, 13)]
MIXED = [(0, 10), (6, 17), (17, 3)]
MIXED_LOW = [(6, 7), (0, 9), (9, 2)]
GATES = ["random", "CNOT", "SWAP"]


@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("qa,qb", PAIR_UPDATE)
def test_pair_update_matches_reference(qa, qb, gate):
    """Column body (lo 7..12) and row body (lo >= 13), both orders."""
    psi, U = _state(N, qa * 31 + qb), _gate(gate, qa + qb)
    pq.reset_counts()
    got = _port(pq.pair_update, psi, qa, qb, U)
    assert pq.PLAIN_CALLS["pair_update"] == 1
    np.testing.assert_allclose(got, _ref(rk.pair_update_planar, psi, qa, qb, U),
                               atol=1e-10)


@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("qa,qb", MIXED)
def test_mixed_pair_matches_reference(qa, qb, gate):
    psi, U = _state(N, qa * 17 + qb), _gate(gate, qa + qb + 1)
    pq.reset_counts()
    got = _port(pq.mixed_pair, psi, qa, qb, U)
    assert pq.PLAIN_CALLS["mixed_pair"] == 1
    np.testing.assert_allclose(got, _ref(rk.mixed_pair_planar, psi, qa, qb, U),
                               atol=1e-10)


def _cu(theta):
    """Controlled phase-rotation on the target: diagonal in the control
    (qa = MSB), so with qa in the lanes every lane operator is diagonal."""
    u = np.array([[np.cos(theta), -np.sin(theta) * 1j],
                  [-np.sin(theta) * 1j, np.cos(theta)]]) * np.exp(0.4j)
    return np.block([[np.eye(2), np.zeros((2, 2))], [np.zeros((2, 2)), u]])


@pytest.mark.parametrize("gate", GATES + ["CU"])
@pytest.mark.parametrize("qa,qb", MIXED_LOW)
def test_mixed_low_pair_matches_reference(qa, qb, gate):
    """The matmul body and, for CNOT / CU with the control in the lanes
    ((6, 7), (0, 9)), the lane-diagonal body."""
    psi = _state(N, qa * 13 + qb)
    U = _cu(0.3) if gate == "CU" else _gate(gate, qa + qb + 2)
    pq.reset_counts()
    got = _port(pq.mixed_low_pair, psi, qa, qb, U)
    assert pq.PLAIN_CALLS["mixed_low_pair"] == 1
    np.testing.assert_allclose(
        got, _ref(rk.mixed_low_pair_planar, psi, qa, qb, U), atol=1e-10)


@pytest.mark.parametrize("qa,qb", [(7, 11), (3, 12), (9, 5), (0, 1)])
def test_pair_coeffs_match_reference(qa, qb):
    U = _unitary(4, qa + 5 * qb)
    assert np.array_equal(pq.pair_coeffs(U, qa, qb), rk._pair_coeffs(U, qa, qb))


@pytest.mark.parametrize("qa,qb", [(q, r) for q in range(0, 20, 3)
                                   for r in range(0, 20, 4) if q != r])
def test_predicates_match_reference(qa, qb):
    assert pq.pair_update_supported(qa, qb) == rk.pair_update_supported(qa, qb)
    assert pq.mixed_pair_supported(qa, qb) == rk.mixed_pair_supported(qa, qb)
    assert (pq.mixed_low_pair_supported(qa, qb)
            == rk.mixed_low_pair_supported(qa, qb))


@pytest.mark.parametrize("wrapper,qa,qb", [
    ("pair_update", 7, 9), ("pair_update", 3, 12), ("mixed_pair", 3, 8),
    ("mixed_pair", 7, 12), ("mixed_low_pair", 3, 10), ("mixed_low_pair", 8, 9),
])
def test_wrappers_refuse_what_their_entry_refuses(wrapper, qa, qb):
    x = torch.zeros(1 << 14, dtype=torch.float64)
    with pytest.raises(ValueError, match=wrapper):
        getattr(pq, wrapper)(x, x, qa, qb, np.eye(4))


def test_wrapper_refuses_a_qubit_past_the_state():
    x = torch.zeros(1 << 12, dtype=torch.float64)
    with pytest.raises(ValueError, match="12-qubit state"):
        pq.pair_update(x, x, 7, 12, np.eye(4))


def test_packed_coefficients_are_c_in_kernel_order():
    U = _unitary(4, 3)
    packed = np.array(pq._packed(13, 8, U.tobytes()))
    C = pq.pair_coeffs(U, 13, 8).reshape(-1)
    np.testing.assert_allclose(packed, np.concatenate([C.real, C.imag]),
                               atol=1e-7)


# ---------------------------------------------------------------------------
# The plain torch gate paths (ops/dense.py) against the reference's
# ---------------------------------------------------------------------------

def _rdense(psi, qubits, U):
    """The reference's planar path, or its complex fallback."""
    re, im = jnp.asarray(psi.real), jnp.asarray(psi.imag)
    out = rdense.apply_gate_planar(re, im, qubits, U)
    if out is None:
        return np.asarray(rdense.apply_gate(jnp.asarray(psi), qubits, U))
    return np.asarray(out[0]) + 1j * np.asarray(out[1])


DENSE_CASES = {
    "diag 1q": ((5,), np.diag([1, np.exp(0.7j)])),
    "diag 3q": ((2, 11, 8), np.diag(np.exp(1j * np.arange(8) * 0.37))),
    "1q lane": ((3,), None),
    "1q high": ((12,), None),
    "2q high": ((13, 9), None),
    "2q SWAP high": ((8, 13), RG.SWAP()),
    "2q mixed (6, 7)": ((6, 7), None),
    "2q lane": ((2, 5), None),
    "3q Toffoli": ((4, 12, 9), RG.CCX()),
    "3q random": ((13, 1, 7), None),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_gate_paths_match_reference(case):
    n = 14
    qubits, U = DENSE_CASES[case]
    if U is None:
        U = _unitary(1 << len(qubits), len(case))
    psi = _state(n, len(case) + 3)
    before = dense.GATE_CALLS
    got = _port(dense.apply_gate_planar, psi, qubits, U)
    assert dense.GATE_CALLS == before + 1
    np.testing.assert_allclose(got, _rdense(psi, qubits, U), atol=1e-10)


def test_gate_view_keeps_few_axes():
    """One axis per gate bit and per run of other bits: a 28-qubit state
    and a 3-qubit gate give 7 axes, not 28."""
    shape, axes = dense._gate_view(28, (20, 3, 11))
    assert shape == [128, 2, 256, 2, 128, 2, 8]
    assert axes == [1, 5, 3]
