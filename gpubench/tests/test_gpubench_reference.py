"""The plain reference against a NumPy brute force: every gate as a full
2^n x 2^n Kronecker matrix, at n <= 8; its gate table against the
port's and against the published definitions."""
import cmath
import copy
import math
import time

import numpy as np
import pytest
import torch

from gpubench import check, circuits
from gpubench import run as R
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


# Every entry of the reference's table, with its parameters at one draw.
_W = np.linalg.qr(np.array([[0.3 + 0.8j, -1.1 + 0.2j], [0.5 - 0.4j, 0.7 + 0.9j]]))[0]
PARAMS = {
    **{name: {} for name in ONE_Q + TWO_Q + ["CY"]},
    "RX": {"theta": 0.7}, "RY": {"theta": -1.3}, "RZ": {"theta": 2.9},
    "P": {"phi": 0.7}, "R": {"k": 3}, "G": {"p": 3},
    "U": {"theta": 0.7, "phi": -0.4, "lam": 2.1}, "U2": {"phi": 1.2, "lam": -0.8},
    "CP": {"phi": 0.7}, "RZZ": {"theta": 0.7}, "CR": {"k": 5},
    "CU": {"U": _W, "exponent": 3}, "CRX": {"theta": 0.7},
    "CRY": {"theta": -2.2}, "CRZ": {"theta": 1.6}, "RXX": {"theta": 0.7},
    "RYY": {"theta": -0.9}, "FSIM": {"theta": 0.7, "phi": 0.3},
}
_PX = np.array([[0, 1], [1, 0]])
_PY = np.array([[0, -1j], [1j, 0]])
_PZ = np.diag([1, -1])


def matrix(name, params):
    return sv.gate_matrix({"gate": name, "params": params})


def expm_pauli_pair(theta, p):
    """exp(-i theta/2 P(x)P) by the eigenvectors of the Hermitian P(x)P."""
    w, v = np.linalg.eigh(np.kron(p, p))
    return (v * np.exp(-0.5j * theta * w)) @ v.conj().T


def controlled(u):
    return np.block([[np.eye(2), np.zeros((2, 2))], [np.zeros((2, 2)), u]])


def test_gate_matrices_are_unitary_and_match_definitions():
    assert set(PARAMS) == set(sv.GATES)
    m = {name: matrix(name, p) for name, p in PARAMS.items()}
    for U in m.values():
        assert U.shape in ((2, 2), (4, 4)) and U.dtype == np.complex128
        np.testing.assert_allclose(U @ U.conj().T, np.eye(len(U)), atol=1e-14)
    # CNOT's control is qubits[0]: |c=1, t=0> -> |c=1, t=1>
    cd = {"number_of_qubits": 2, "gates": [
        {"gate": "X", "qubits": [1]}, {"gate": "CNOT", "qubits": [1, 0]}]}
    assert abs(sv.simulate(cd, "cpu")[3]) == pytest.approx(1.0)
    # so is CY's: |c=1, t=0> -> i |c=1, t=1>
    cd["gates"][1]["gate"] = "CY"
    assert complex(sv.simulate(cd, "cpu")[3]) == pytest.approx(1j)
    for name, p in (("RXX", _PX), ("RYY", _PY), ("RZZ", _PZ)):
        t = PARAMS[name]["theta"]
        np.testing.assert_allclose(m[name], expm_pauli_pair(t, p), atol=1e-14)
    for name in ("CRX", "CRY", "CRZ"):
        np.testing.assert_allclose(
            m[name], controlled(matrix(name[1:], PARAMS[name])), atol=0)
    np.testing.assert_allclose(m["CY"], controlled(m["Y"]), atol=0)
    np.testing.assert_allclose(m["CU"], controlled(_W @ _W @ _W), atol=1e-15)
    np.testing.assert_allclose(m["R"], matrix("P", {"phi": math.pi / 4}), atol=1e-15)
    np.testing.assert_allclose(m["CR"], matrix("CP", {"phi": math.pi / 16}),
                               atol=1e-15)
    np.testing.assert_allclose(matrix("G", {"p": 1}), np.eye(2), atol=0)
    np.testing.assert_allclose(matrix("G", {"p": 2}),
                               matrix("RY", {"theta": math.pi / 2}), atol=1e-15)
    u2 = PARAMS["U2"]
    np.testing.assert_allclose(m["U2"], matrix("U", {"theta": math.pi / 2, **u2}),
                               atol=1e-15)
    # u3(theta, -pi/2, pi/2) = RX(theta); u3(theta, 0, 0) = RY(theta)
    np.testing.assert_allclose(
        matrix("U", {"theta": 0.7, "phi": -math.pi / 2, "lam": math.pi / 2}),
        matrix("RX", {"theta": 0.7}), atol=1e-15)
    np.testing.assert_allclose(matrix("U", {"theta": 0.7, "phi": 0, "lam": 0}),
                               matrix("RY", {"theta": 0.7}), atol=0)


def test_fsim_is_rxx_ryy_cp_and_the_published_matrix():
    for theta, phi in ((0.7, 0.3), (-2.1, 1.9), (math.pi / 2, math.pi / 6)):
        got = matrix("FSIM", {"theta": theta, "phi": phi})
        want = (matrix("RXX", {"theta": theta}) @ matrix("RYY", {"theta": theta})
                @ matrix("CP", {"phi": -phi}))
        np.testing.assert_allclose(got, want, atol=1e-15)
    # Sycamore's nominal coupler: fSim(pi/2, pi/6) (Arute et al. 2019)
    published = np.array([[1, 0, 0, 0], [0, 0, -1j, 0], [0, -1j, 0, 0],
                          [0, 0, 0, cmath.exp(-1j * math.pi / 6)]])
    np.testing.assert_allclose(
        matrix("FSIM", {"theta": math.pi / 2, "phi": math.pi / 6}), published,
        atol=1e-16)


def _draw_params(spec, rng):
    """One draw of a gate's parameters by the contract's names."""
    out = {}
    for key in spec:
        if key in ("k", "p"):
            out[key] = int(rng.integers(1, 9))
        elif key == "exponent":
            out[key] = int(rng.integers(-3, 4))
        elif key == "U":
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            out[key] = np.linalg.qr(z)[0]
        else:
            out[key] = float(rng.uniform(-4, 4))
    return out


def test_every_gate_of_the_port_s_contract_is_the_port_s_matrix():
    from quantum_simulations_tpu_torch.circuit import gates

    names = sorted(gates.ALL_1Q | gates.ALL_2Q)
    assert set(sv.GATES) == set(names) | {"FSIM"}
    for name in names:
        for seed in range(3):
            rng = np.random.default_rng([seed, len(name), ord(name[-1])])
            params = _draw_params(gates.PARAM_SPEC.get(name, ()), rng)
            got = sv.gate_matrix({"gate": name, "qubits": [0], "params": params})
            np.testing.assert_allclose(got, gates.gate_matrix(name, params),
                                       atol=1e-12, rtol=0, err_msg=name)


NEW = ["R", "G", "U", "U2", "CY", "CR", "CU", "CRX", "CRY", "CRZ", "RXX",
       "RYY", "FSIM"]


@pytest.mark.parametrize("name", NEW)
def test_new_gates_match_brute_force(name):
    """Each gate on every ordered pair (or every qubit) of a generic state."""
    n = 5
    rng = np.random.default_rng(len(name) * 31 + ord(name[0]))
    gates_ = [{"gate": "U", "qubits": [q],
               "params": _draw_params(("theta", "phi", "lam"), rng)}
              for q in range(n)]
    two = len(matrix(name, PARAMS[name])) == 4
    places = ([[a, b] for a in range(n) for b in range(n) if a != b]
              if two else [[q] for q in range(n)])
    for qs in places:
        params = _draw_params(PARAMS[name], rng)
        gates_.append({"gate": name, "qubits": qs, "params": params})
        gates_.append({"gate": "H", "qubits": [qs[0]]})
    cd = {"number_of_qubits": n, "gates": gates_}
    np.testing.assert_allclose(sv.simulate(cd, "cpu").numpy(), brute(cd),
                               atol=1e-12)


# The reference's table as it stood before FSIM and the rest were added: the
# numbers of the cells that use only these gates may not move by a bit
# (test_the_older_cells_keep_their_numbers).
_R2 = 1.0 / math.sqrt(2.0)
PARENT_GATES = {
    "H": lambda: np.array([[_R2, _R2], [_R2, -_R2]]),
    "X": lambda: np.array([[0, 1], [1, 0]]),
    "Y": lambda: np.array([[0, -1j], [1j, 0]]),
    "Z": lambda: np.diag([1, -1]),
    "S": lambda: np.diag([1, 1j]),
    "SDG": lambda: np.diag([1, -1j]),
    "T": lambda: np.diag([1, cmath.exp(0.25j * math.pi)]),
    "TDG": lambda: np.diag([1, cmath.exp(-0.25j * math.pi)]),
    "SX": lambda: 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]]),
    "RX": lambda theta: np.array(
        [[math.cos(theta / 2), -1j * math.sin(theta / 2)],
         [-1j * math.sin(theta / 2), math.cos(theta / 2)]]),
    "RY": lambda theta: np.array(
        [[math.cos(theta / 2), -math.sin(theta / 2)],
         [math.sin(theta / 2), math.cos(theta / 2)]]),
    "RZ": lambda theta: np.diag([cmath.exp(-0.5j * theta),
                                 cmath.exp(0.5j * theta)]),
    "P": lambda phi: np.diag([1, cmath.exp(1j * phi)]),
    "CNOT": lambda: np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]]),
    "CZ": lambda: np.diag([1, 1, 1, -1]),
    "SWAP": lambda: np.array(
        [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]]),
    "CP": lambda phi: np.diag([1, 1, 1, cmath.exp(1j * phi)]),
    "RZZ": lambda theta: np.diag(
        [cmath.exp(-0.5j * theta), cmath.exp(0.5j * theta),
         cmath.exp(0.5j * theta), cmath.exp(-0.5j * theta)]),
}
SPEC = R.load_json(R.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("workload", [
    "nonstab28.zsweep.window", "qaoa28.energy.window", "nonstab28.zsweep.fused",
    "qaoa28.shots.window", "nonstab33.capacity.zsweep"])
def test_the_older_cells_keep_their_numbers(workload, monkeypatch):
    """Each older cell at n = 10: its check numbers with today's table and
    with the parent's, on the same records, equal to the last bit."""
    cell = copy.deepcopy(R.load_cell(SPEC, workload))
    cell.config["params"]["n"] = 10
    if "edges" in cell.config:
        cell.config["edges"]["params"]["n"] = 10
    if "reference" in cell.config:
        cell.config["reference"]["cut"] = 5
    seen = []
    compare = check.compare

    def spy(*args):
        out = compare(*args)
        seen.append((args, out))
        return out

    monkeypatch.setattr(check, "compare", spy)
    R.run_cell(cell, 2 ** 31 + 5, 0.3, False, "cpu", t_start=time.perf_counter())
    (args, out), = seen
    monkeypatch.setattr(sv, "GATES", PARENT_GATES)
    assert compare(*args) == out
    assert all(math.isfinite(v) for v in out.values())


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
