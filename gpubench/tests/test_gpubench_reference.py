"""The plain reference against a NumPy brute force: every gate as a full
2^n x 2^n Kronecker matrix, at n <= 8."""
import math

import numpy as np
import pytest
import torch

from gpubench import circuits
from gpubench.reference import statevector as sv

ONE_Q = ["H", "X", "Y", "Z", "S", "SDG", "T", "TDG", "SX"]
ONE_Q_PARAM = {"RX": "theta", "RY": "theta", "RZ": "theta", "P": "phi"}
TWO_Q = ["CNOT", "CZ", "SWAP"]
TWO_Q_PARAM = {"CP": "phi", "RZZ": "theta"}


def full_matrix(n, qubits, U):
    """The 2^n x 2^n matrix of U on ``qubits`` (qubit q = index bit q;
    U's rows big-endian over ``qubits``), entry by entry."""
    N = 1 << n
    M = np.zeros((N, N), dtype=np.complex128)
    k = len(qubits)
    for col in range(N):
        sub_c = 0
        for q in qubits:
            sub_c = 2 * sub_c + ((col >> q) & 1)
        for sub_r in range(1 << k):
            row = col
            for i, q in enumerate(qubits):
                bit = (sub_r >> (k - 1 - i)) & 1
                row = (row & ~(1 << q)) | (bit << q)
            M[row, col] += U[sub_r, sub_c]
    return M


def brute(cd):
    n = cd["number_of_qubits"]
    psi = np.zeros(1 << n, dtype=np.complex128)
    psi[0] = 1
    for g in cd["gates"]:
        psi = full_matrix(n, g["qubits"], sv.gate_matrix(g)) @ psi
    return psi


def random_circuit(n, count, rng):
    gates = []
    for _ in range(count):
        r = rng.random()
        if r < 0.3:
            gates.append({"gate": ONE_Q[rng.integers(len(ONE_Q))],
                          "qubits": [int(rng.integers(n))]})
        elif r < 0.5:
            name = list(ONE_Q_PARAM)[rng.integers(len(ONE_Q_PARAM))]
            gates.append({"gate": name, "qubits": [int(rng.integers(n))],
                          "params": {ONE_Q_PARAM[name]: float(rng.uniform(-4, 4))}})
        elif r < 0.8:
            a, b = (int(x) for x in rng.choice(n, 2, replace=False))
            gates.append({"gate": TWO_Q[rng.integers(len(TWO_Q))],
                          "qubits": [a, b]})
        else:
            a, b = (int(x) for x in rng.choice(n, 2, replace=False))
            name = list(TWO_Q_PARAM)[rng.integers(len(TWO_Q_PARAM))]
            gates.append({"gate": name, "qubits": [a, b],
                          "params": {TWO_Q_PARAM[name]: float(rng.uniform(-4, 4))}})
    return {"number_of_qubits": n, "gates": gates}


@pytest.mark.parametrize("n, seed", [(1, 0), (2, 1), (3, 2), (5, 3), (8, 4)])
def test_simulate_matches_brute_force(n, seed):
    rng = np.random.default_rng(seed)
    if n == 1:
        cd = {"number_of_qubits": 1, "gates": [
            {"gate": g, "qubits": [0]} for g in ONE_Q]}
    else:
        cd = random_circuit(n, 40, rng)
    got = sv.simulate(cd, "cpu").numpy()
    np.testing.assert_allclose(got, brute(cd), atol=1e-12)


@pytest.mark.parametrize("maker", ["non_stabilizer", "qaoa_maxcut"])
def test_config_circuits_match_brute_force(maker):
    cd = circuits.maker(maker)(6)
    np.testing.assert_allclose(sv.simulate(cd, "cpu").numpy(), brute(cd),
                               atol=1e-12)


def test_gate_matrices_are_unitary_and_match_definitions():
    for name in sv.GATES:
        g = {"gate": name, "qubits": [0] if name in ONE_Q or name in ONE_Q_PARAM
             else [0, 1]}
        if name in ONE_Q_PARAM:
            g["params"] = {ONE_Q_PARAM[name]: 0.7}
        if name in TWO_Q_PARAM:
            g["params"] = {TWO_Q_PARAM[name]: 0.7}
        U = sv.gate_matrix(g)
        np.testing.assert_allclose(U @ U.conj().T, np.eye(len(U)), atol=1e-14)
    # CNOT's control is qubits[0]: |c=1, t=0> -> |c=1, t=1>
    cd = {"number_of_qubits": 2, "gates": [
        {"gate": "X", "qubits": [1]}, {"gate": "CNOT", "qubits": [1, 0]}]}
    assert abs(sv.simulate(cd, "cpu")[3]) == pytest.approx(1.0)
    # RZZ(t) = exp(-i t/2 Z Z)
    t = 0.3
    np.testing.assert_allclose(
        sv.gate_matrix({"gate": "RZZ", "qubits": [0, 1], "params": {"theta": t}}),
        np.diag(np.exp(-0.5j * t * np.array([1, -1, -1, 1]))), atol=1e-15)


def test_readouts_match_brute_force():
    n = 7
    cd = random_circuit(n, 50, np.random.default_rng(9))
    psi = brute(cd)
    p = np.abs(psi) ** 2
    probs = sv.probabilities(torch.from_numpy(psi))
    idx = np.arange(1 << n)
    for qs in ([0], [6], [1, 4], [0, 2, 5, 6]):
        par = np.zeros_like(idx)
        for q in qs:
            par ^= (idx >> q) & 1
        want = float(np.sum(p * (1 - 2 * par)))
        assert sv.z_expectation(probs, n, qs) == pytest.approx(want, abs=1e-12)
    edges = [(0, 1), (2, 5), (3, 6)]
    want = sum(0.5 * (1 - sv.z_expectation(probs, n, e)) for e in edges)
    assert sv.maxcut_energy(probs, n, edges) == pytest.approx(want, abs=1e-12)


def test_sample_bits_follow_probabilities():
    n = 4
    psi = torch.zeros(16, dtype=torch.complex128)
    psi[5] = math.sqrt(0.75)
    psi[10] = math.sqrt(0.25)
    gen = torch.Generator().manual_seed(3)
    bits = sv.sample_bits(sv.probabilities(psi), n, 20000, gen)
    idx = (bits.astype(np.int64) << np.arange(n)).sum(axis=1)
    assert set(np.unique(idx)) == {5, 10}
    assert np.mean(idx == 5) == pytest.approx(0.75, abs=0.02)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0],
                     dtype=torch.float32)
    got = sv.round_tf32_(x.clone())
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
    cd = circuits.non_stabilizer(8)
    hi = sv.simulate(cd, "cpu")
    lo = sv.simulate(cd, "cpu", tf32=True)
    err = float((hi - lo.to(torch.complex128)).abs().square().sum().sqrt())
    assert 1e-5 < err < 1e-1
