"""The port's sparse and adaptive tiers against the JAX package's, on the CPU.

The JAX side runs as its own tests run it (``tests/test_sparse_and_sampling.py``,
``test_sparse_merge.py``, ``test_adaptive.py``: numpy COO, complex128
through x64); the port runs its COO tier in torch with ``device="cpu"``.
Same circuits, same seeds: the same index sets, amplitudes within 1e-12,
the same ``nnz_history`` and switch index, and ``sample_bits`` bit for
bit (both draw from ``np.random.default_rng`` over dicts in ascending
index order).
"""
import json
import math

import numpy as np
import pytest
import torch

from quantum_simulations_tpu import api as rapi
from quantum_simulations_tpu.__main__ import main as rmain
from quantum_simulations_tpu.circuit import library as rlib
from quantum_simulations_tpu.sparse import adaptive as RA
from quantum_simulations_tpu.sparse import engine as RE
from quantum_simulations_tpu.sparse import merge as RM
from quantum_simulations_tpu.utils.config import SimulatorConfig as RConfig
from quantum_simulations_tpu_torch import SimulatorConfig, api, library, oracle
from quantum_simulations_tpu_torch.__main__ import main
from quantum_simulations_tpu_torch.sparse import adaptive as PA
from quantum_simulations_tpu_torch.sparse import engine as PE
from quantum_simulations_tpu_torch.sparse.merge import merge_sparse_states

CPU = "cpu"
TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """One thread per xdist worker (as tests/test_torch_simulate.py)."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _same_state(got, want, tol=TOL):
    """The same index set, in the same (ascending) order, amplitudes
    within ``tol``."""
    assert got.n == want.n
    gi = [i for i, _ in got.items()]
    assert gi == [i for i, _ in want.items()]
    for i, a in want.items():
        assert abs(got.amplitude(i) - complex(a)) <= tol, i


CIRCUITS = {
    "bell": library.bell(),
    "ghz6": library.ghz(6),
    "qft5": library.qft(5),
    "w6": library.w_state(6),
    "random": library.random_circuit(6, 40, seed=8),
}


@pytest.mark.parametrize("tier", ["numpy", "bigint"])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_sparse_matches_reference(tier, name):
    cd = CIRCUITS[name]
    h, rh = [], []
    got = PE.simulate_sparse(cd, force_tier=tier, nnz_history=h, device=CPU)
    want = RE.simulate_sparse(cd, force_tier=tier, nnz_history=rh)
    _same_state(got, want)
    assert h == rh
    np.testing.assert_allclose(got.to_dense(), oracle.simulate(cd), atol=1e-10)


def test_ghz63_coo_tier_uses_bit_62():
    """GHZ-63 forced onto the COO tier: index 2^63 - 1 sets bit 62, the
    highest an int64 holds with its sign bit clear."""
    cd = library.ghz(63)
    got = PE.simulate_sparse(cd, force_tier="numpy", device=CPU)
    want = RE.simulate_sparse(cd, force_tier="numpy")
    _same_state(got, want)
    assert [i for i, _ in got.items()] == [0, (1 << 63) - 1]
    for i, _ in got.items():
        assert abs(got.amplitude(i) - 2 ** -0.5) <= TOL


def test_ghz62_auto_tier_is_coo():
    h = []
    got = PE.simulate_sparse(library.ghz(62), nnz_history=h, device=CPU)
    assert len(got) == 2 and max(h) == 2
    assert abs(got.amplitude((1 << 62) - 1) - 2 ** -0.5) <= TOL


@pytest.mark.parametrize("name,n,nnz", [("ghz", 1000, 2), ("w_state", 200, 200)])
def test_bigint_tier_at_large_n(name, n, nnz):
    cd = getattr(library, name)(n)
    got = PE.simulate_sparse(cd, device=CPU)
    _same_state(got, RE.simulate_sparse(getattr(rlib, name)(n)))
    assert len(got) == nnz and abs(got.norm() - 1) < 1e-9


def test_bigint_tier_stays_on_the_host():
    """Above 62 qubits the tier is host Python whatever ``device`` says:
    it needs no card."""
    st = PE.simulate_sparse(library.ghz(100), device="cuda")
    assert len(st) == 2


@pytest.mark.parametrize("threshold", [1e-15, 0.01, 0.02])
@pytest.mark.parametrize("tier", ["numpy", "bigint"])
def test_threshold_prune(threshold, tier):
    for cd in (library.hadamard_wall(10), library.random_circuit(7, 60, seed=3)):
        got = PE.simulate_sparse(cd, threshold=threshold, force_tier=tier,
                                 device=CPU)
        want = RE.simulate_sparse(cd, threshold=threshold, force_tier=tier)
        _same_state(got, want)
    wall = PE.simulate_sparse(library.hadamard_wall(10), device=CPU)
    assert len(wall) == 1024 and abs(wall.norm() - 1) < 1e-9


@pytest.mark.parametrize("name", ["ghz6", "w6", "random", "qft5"])
def test_top_amplitudes(name):
    cd = CIRCUITS[name]
    got = PE.simulate_sparse(cd, device=CPU).top_amplitudes(5)
    want = RE.simulate_sparse(cd).top_amplitudes(5)
    assert [i for i, _ in got] == [i for i, _ in want]
    assert max(abs(a - b) for (_, a), (_, b) in zip(got, want)) <= TOL


@pytest.mark.parametrize("name,n,seed", [
    ("ghz", 12, 0), ("w_state", 9, 3), ("qft", 6, 5),
    ("random_circuit", 7, 11), ("ghz", 62, 2)])
def test_sample_bits_equal_reference(name, n, seed):
    args = (n, 50) if name == "random_circuit" else (n,)
    cd = getattr(library, name)(*args)
    got = PE.simulate_sparse(cd, device=CPU).sample_bits(200, seed=seed)
    want = RE.simulate_sparse(cd).sample_bits(200, seed=seed)
    assert got.dtype == np.int8 and np.array_equal(got, want)


def test_dense_export_guard():
    st = PE.simulate_sparse(library.ghz(40), device=CPU)
    with pytest.raises(ValueError):
        st.to_dense()


# ---------------------------------------------------------------------------
# merge (the cases of tests/test_sparse_merge.py, and the reference's result)
# ---------------------------------------------------------------------------

def _merge_cases():
    s = 1 / math.sqrt(2)
    tail = library.qft(4)["gates"]
    b1 = {"number_of_qubits": 4, "gates": tail}
    b2 = {"number_of_qubits": 4, "gates": [{"qubits": [0], "gate": "X"}] + tail}
    return {
        "sums": ([(2, {0: 0.5, 1: 0.5}), (2, {1: 0.25, 3: 0.25})], {}),
        "branches": ([(4, {i: s * a for i, a in RE.simulate_sparse(b).items()})
                      for b in (b1, b2)], {}),
        "prune": ([(2, {0: 1.0, 1: 1e-20})],
                  dict(threshold=1e-12, renormalize=True)),
    }


@pytest.mark.parametrize("case", ["sums", "branches", "prune"])
def test_merge_matches_reference(case):
    parts, kw = _merge_cases()[case]
    got = merge_sparse_states([PE.SparseState(n, dict(d)) for n, d in parts], **kw)
    want = RM.merge_sparse_states([RE.SparseState(n, dict(d)) for n, d in parts],
                                  **kw)
    _same_state(got, want, tol=0.0)


def test_merge_linearity_vs_oracle():
    """Simulating a superposition == merging branch simulations."""
    s = 1 / math.sqrt(2)
    tail = library.qft(4)["gates"]
    b1 = PE.simulate_sparse({"number_of_qubits": 4, "gates": tail}, device=CPU)
    b2 = PE.simulate_sparse({"number_of_qubits": 4, "gates": [
        {"qubits": [0], "gate": "X"}] + tail}, device=CPU)
    merged = merge_sparse_states([
        PE.SparseState(4, {i: s * a for i, a in b.items()}) for b in (b1, b2)])
    full = {"number_of_qubits": 4,
            "gates": [{"qubits": [0], "gate": "H"}] + tail}
    np.testing.assert_allclose(merged.to_dense(), oracle.simulate(full),
                               atol=1e-10)


def test_merge_mismatch_raises():
    with pytest.raises(ValueError):
        merge_sparse_states([PE.SparseState(2, {}), PE.SparseState(3, {})])
    with pytest.raises(ValueError):
        merge_sparse_states([])


# ---------------------------------------------------------------------------
# adaptive (the cases of tests/test_adaptive.py)
# ---------------------------------------------------------------------------

BIG_N = {"number_of_qubits": 30, "gates": [
    {"gate": "H", "qubits": [q], "params": {}} for q in range(22)]}
ADAPTIVE = {
    "hwall10": (library.hadamard_wall(10), {}),
    "qft9": (library.qft(9), {}),
    "ghz_qft8": (library.ghz_qft(8), {}),
    "ghz40": (library.ghz(40), {}),
    "w30": (library.w_state(30), {}),
    "big_n": (BIG_N, dict(dense_max_qubits=20)),
}


@pytest.mark.parametrize("name,mode", [
    (name, mode) for name in ADAPTIVE for mode in ("fused", "window")
    if name != "big_n" or mode == "fused"])  # big_n never reaches a mode
def test_adaptive_matches_reference(name, mode):
    cd, kw = ADAPTIVE[name]
    got = PA.simulate_adaptive(cd, dtype="complex128", mode=mode, device=CPU,
                               **kw)
    want = RA.simulate_adaptive(cd, dtype="complex128", mode=mode, **kw)
    assert got.switched_at == want.switched_at
    assert got.nnz_history == want.nnz_history
    assert got.is_dense == want.is_dense
    if want.is_dense:
        assert isinstance(got.state, torch.Tensor)
        assert got.state.dtype == torch.complex128
        np.testing.assert_allclose(got.to_dense(), np.asarray(want.state),
                                   atol=1e-10, rtol=0)
        np.testing.assert_allclose(got.to_dense(), oracle.simulate(cd),
                                   atol=1e-10, rtol=0)
    else:
        _same_state(got.state, want.state)


def test_adaptive_switch_rule():
    """The wall switches when nnz first exceeds 2^n / 16: after gate
    n - 4 (nnz 2^(n - 3)), so switched_at = n - 3."""
    res = PA.simulate_adaptive(library.hadamard_wall(12), device=CPU)
    assert res.switched_at == 9
    assert res.nnz_history == [2 ** k for k in range(1, 10)]
    assert res.is_dense and res.state.dtype == torch.complex64
    np.testing.assert_allclose(res.to_dense(), np.full(4096, 2.0 ** -6),
                               atol=1e-6)


def test_adaptive_c64_handoff_dtype():
    """The scattered state is handed on in ``dtype`` (complex64 here) and
    stays complex128 when no gate is left."""
    cd = library.hadamard_wall(8)
    got = PA.simulate_adaptive(cd, dtype="complex64", device=CPU)
    want = RA.simulate_adaptive(cd, dtype="complex64")
    assert got.state.dtype == torch.complex64
    assert np.asarray(want.state).dtype == np.complex64
    np.testing.assert_allclose(got.to_dense(), np.asarray(want.state), atol=1e-6)
    last = {"number_of_qubits": 8, "gates": [
        {"gate": "H", "qubits": [q], "params": {}} for q in range(5)]}
    res = PA.simulate_adaptive(last, dtype="complex64", device=CPU)
    assert res.switched_at == 5 and res.state.dtype == torch.complex128
    assert RA.simulate_adaptive(last).state.dtype == np.complex128


# ---------------------------------------------------------------------------
# api and CLI
# ---------------------------------------------------------------------------

def test_api_sparse_routes():
    cd = library.ghz(40)
    got = api.simulate(cd, SimulatorConfig(sparse=True), device=CPU)
    want = rapi.simulate(rlib.ghz(40), RConfig(sparse=True))
    assert isinstance(got, PE.SparseState)
    _same_state(got, want)
    # sparse=True beats capacity and devices in the reference's order
    got = api.simulate(cd, SimulatorConfig(sparse=True, mode="capacity",
                                           n_devices=4), device=CPU)
    _same_state(got, want)


def test_api_auto_routes():
    out = api.simulate(library.hadamard_wall(8),
                       SimulatorConfig(sparse="auto", dtype="complex64"),
                       device=CPU)
    assert isinstance(out, np.ndarray)
    np.testing.assert_allclose(np.abs(out) ** 2, np.full(256, 1 / 256),
                               atol=1e-6)
    out = api.simulate(library.ghz(35), SimulatorConfig(sparse="auto"),
                       device=CPU)
    assert hasattr(out, "top_amplitudes") and len(out) == 2


@pytest.mark.parametrize("sparse", [True, "auto"])
def test_api_sample_sparse_equals_reference(sparse):
    cfg, rcfg = SimulatorConfig(sparse=sparse), RConfig(sparse=sparse)
    got = api.sample(library.ghz(62), 64, seed=1, config=cfg, device=CPU)
    want = rapi.sample(rlib.ghz(62), 64, seed=1, config=rcfg)
    assert np.array_equal(got, want)
    assert set(got.sum(axis=1).tolist()) <= {0, 62}


def test_api_sample_auto_dense_route():
    bits = api.sample(library.hadamard_wall(6), 32, seed=0,
                      config=SimulatorConfig(sparse="auto"), device=CPU)
    assert bits.shape == (32, 6) and bits.dtype == np.int8


@pytest.fixture
def files(tmp_path):
    out = {}
    for name, cd in (("ghz40", rlib.ghz(40)), ("w12", rlib.w_state(12)),
                     ("hwall8", rlib.hadamard_wall(8))):
        out[name] = tmp_path / f"{name}.json"
        out[name].write_text(json.dumps(cd))
    return out


@pytest.mark.parametrize("name", ["ghz40", "w12"])
@pytest.mark.parametrize("flag", [["--sparse"], ["--sparse", "auto"]],
                         ids=["sparse", "auto"])
def test_cli_sparse_equals_reference(capsys, files, name, flag):
    argv = ["run", str(files[name]), *flag, "--top", "5"]
    assert rmain(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want) == {"nonzero", "norm", "top"}
    assert got["nonzero"] == want["nonzero"]
    assert abs(got["norm"] - want["norm"]) <= TOL
    assert [i for i, _ in got["top"]] == [i for i, _ in want["top"]]
    for (_, a), (_, b) in zip(got["top"], want["top"]):
        assert abs(complex(*a) - complex(*b)) <= TOL


def test_cli_sparse_auto_that_switches(capsys, files):
    """A wall switches to dense: the dense tier's output, uniform."""
    assert main(["run", str(files["hwall8"]), "--sparse", "auto", "--top", "3",
                 "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["n_amplitudes"] == 256 and abs(got["norm2"] - 1) <= 1e-6
    assert [i for i, _ in got["top"]] == ["0x0", "0x1", "0x2"]
