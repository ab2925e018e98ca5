"""The port's sharded tier against the JAX package's, on the CPU.

The cases of ``tests/test_sharded.py``: the JAX tier runs on its virtual
8-device CPU mesh (window mode in interpret mode, complex128 through
x64), the port on a mesh of positions on the CPU (``make_mesh(D,
device="cpu")``, its kernels' plain torch twins).  Tiny shards force
every cross-shard case: 1q gates on every qubit, 2q gates in every split
of local and mesh bits, 3q gates across the boundary.  The single-gate
grid holds the port to the JAX package's numpy oracle (the reference its
own grid uses), the circuits and the window cases to the JAX executor
itself where it runs in about a second, all at 1e-10.  Also: the
exchange's counted bytes against ``exchange_bytes`` / ``reshard_bytes``,
and the cost helpers against the JAX package's.
"""
import numpy as np
import pytest
import torch

from quantum_simulations_tpu.circuit import library as rlib
from quantum_simulations_tpu.circuit.staging import permute_state
from quantum_simulations_tpu.oracle import dense_numpy as roracle
from quantum_simulations_tpu.ops import exchange as rexchange
from quantum_simulations_tpu.parallel import executor as RE
from quantum_simulations_tpu.parallel import mesh as RM
from quantum_simulations_tpu_torch.circuit import gates as G
from quantum_simulations_tpu_torch.circuit import staging as S
from quantum_simulations_tpu_torch.ops import exchange
from quantum_simulations_tpu_torch.parallel import comm
from quantum_simulations_tpu_torch.parallel import executor as E
from quantum_simulations_tpu_torch.parallel import mesh as M
from quantum_simulations_tpu_torch.parallel import reshard

TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """One thread per xdist worker (as tests/test_torch_simulate.py)."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _mesh(d: int) -> M.Mesh:
    return M.make_mesh(d, device="cpu")


def _run(d, cd, **kw):
    return E.collect_state(E.simulate_sharded(_mesh(d), cd,
                                              dtype="complex128", **kw))


def _ref(d, cd, **kw):
    return RE.collect_state(RE.simulate_sharded(RM.make_mesh(d), cd,
                                                dtype="complex128", **kw))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _prep_plus_gate(n, gate_entry):
    """Separable prep (H wall + phases) followed by one gate (the
    reference test's)."""
    gates = [{"qubits": [q], "gate": "H"} for q in range(n)]
    gates += [{"qubits": [q], "gate": "T"} for q in range(0, n, 2)]
    gates += [{"qubits": [q], "gate": "RY", "params": {"theta": 0.3 + q}}
              for q in range(n)]
    gates.append(gate_entry)
    return {"number_of_qubits": n, "gates": gates}


# ---------------------------------------------------------------------------
# Single-gate grid: n=5 on 8 positions => k=2 (qubits 2, 3, 4 on mesh bits)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fused", "window"])
@pytest.mark.parametrize("name", ["H", "X", "Y", "T", "RY"])
def test_1q_every_position(mode, name):
    for q in range(5):
        entry = {"qubits": [q], "gate": name}
        if name == "RY":
            entry["params"] = {"theta": 0.77}
        cd = _prep_plus_gate(5, entry)
        _close(_run(8, cd, mode=mode), roracle.simulate(cd))


_PAIRS = [(0, 1), (0, 3), (3, 0), (1, 4), (4, 1), (2, 3), (4, 2), (3, 4),
          (2, 4)]


@pytest.mark.parametrize("qa,qb", _PAIRS)
@pytest.mark.parametrize("name", ["CNOT", "SWAP", "CZ", "CY", "CR"])
def test_2q_every_split(qa, qb, name):
    entry = {"qubits": [qa, qb], "gate": name}
    if name == "CR":
        entry["params"] = {"k": 2}
    cd = _prep_plus_gate(5, entry)
    want = roracle.simulate(cd)
    for mode in ("fused", "window"):
        _close(_run(8, cd, mode=mode), want)


@pytest.mark.parametrize("mode", ["fused", "window"])
def test_3q_gate_across_boundary(mode):
    for entry in ({"qubits": [0, 2, 4], "gate": "CCX"},
                  {"qubits": [4, 3, 2], "gate": "CSWAP"}):
        cd = _prep_plus_gate(5, entry)
        _close(_run(8, cd, mode=mode), roracle.simulate(cd))


# ---------------------------------------------------------------------------
# Full circuits at every mesh size
# ---------------------------------------------------------------------------

CIRCUITS = [
    ("ghz8", rlib.ghz(8)),
    ("qft7", rlib.qft(7)),
    ("w6", rlib.w_state(6)),
    ("qpe5", rlib.qpe(4)),
    ("random", rlib.random_circuit(7, 70, seed=9)),
    ("qaoa", rlib.qaoa_maxcut(7, p=2)),
    ("sycamore", rlib.sycamore_like(7, depth=5)),
]


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("tag,cd", CIRCUITS, ids=[c[0] for c in CIRCUITS])
def test_circuits_all_mesh_sizes(n_dev, tag, cd):
    want = _ref(8, cd) if n_dev == 8 else roracle.simulate(cd)
    _close(_run(n_dev, cd), want)


@pytest.mark.parametrize("fusion", [True, False])
def test_fusion_flag_sharded(fusion):
    cd = rlib.random_circuit(6, 40, seed=17)
    _close(_run(8, cd, use_fusion=fusion), _ref(8, cd, use_fusion=fusion))


def test_initial_state_sharded():
    rng = np.random.default_rng(0)
    psi0 = rng.normal(size=32) + 1j * rng.normal(size=32)
    psi0 /= np.linalg.norm(psi0)
    cd = rlib.qft(5)
    _close(_run(2, cd, initial_state=psi0),
           _ref(2, cd, initial_state=psi0))


def test_mesh_size_consistency():
    cd = rlib.sycamore_like(6, depth=4, seed=5)
    results = [_run(nd, cd) for nd in (1, 2, 4, 8)]
    for r in results[1:]:
        _close(r, results[0], 1e-12)


def test_state_layout_and_one_position_mesh_moves_nothing():
    """Position s holds amplitudes [s 2^k, (s+1) 2^k) as two planes on
    its device; a one-position mesh runs with no collective."""
    cd = rlib.random_circuit(6, 30, seed=3)
    st = E.simulate_sharded(_mesh(4), cd, dtype="complex128")
    want = roracle.simulate(cd)
    assert st.k == 4 and sorted(st.shards) == [0, 1, 2, 3]
    for s, (re, im) in st.shards.items():
        _close(re.numpy() + 1j * im.numpy(), want[s << 4:(s + 1) << 4])
    comm.reset_counts()
    _close(_run(1, cd), want)
    assert comm.moved_bytes() == 0


# ---------------------------------------------------------------------------
# The exchange planner: costs, and the bytes the exchange really moves
# ---------------------------------------------------------------------------

def _haar(dim, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    q, _ = np.linalg.qr(a)
    return q


COST_CASES = [
    ("Z", (5,)), ("CZ", (4, 6)), ("CR", (3, 7)), ("RZZ", (3, 4)),
    ("CNOT", (5, 1)), ("CY", (4, 0)), ("CNOT", (1, 5)), ("CNOT", (4, 5)),
    ("H", (5,)), ("H", (1,)), ("SWAP", (3, 4)), ("RXX", (3, 4)),
    ("SWAP", (0, 5)), ("SWAP", (1, 5)), ("haar", (3, 4)), ("haar", (1, 5)),
]


def _gate(name):
    if name == "haar":
        return _haar(4, 0)
    params = {"CR": {"k": 2}, "RZZ": {"theta": 1.0},
              "RXX": {"theta": 0.3}}.get(name, {})
    return G.gate_matrix(name, params)


@pytest.mark.parametrize("name,qubits", COST_CASES,
                         ids=[f"{n}{q}" for n, q in COST_CASES])
def test_cost_helpers_match_reference(name, qubits):
    U, k = _gate(name), 3
    for fn in ("nonzero_offsets", "exchange_cost", "offset_traffic",
               "exchange_bytes"):
        assert getattr(exchange, fn)(U, qubits, k) == getattr(
            rexchange, fn)(U, qubits, k), fn


@pytest.mark.parametrize("name,qubits", [
    ("H", (5,)), ("CNOT", (1, 5)), ("CNOT", (4, 5)), ("SWAP", (1, 5)),
    ("SWAP", (3, 4)), ("CY", (4, 0)), ("haar", (1, 5)), ("haar", (3, 4))],
    ids=lambda v: str(v))
def test_exchange_moves_its_modelled_bytes(name, qubits):
    """``apply_nonlocal`` on 8 positions of k = 3 (n = 6), from a random
    state: the oracle's result, and the bytes ``comm`` counts equal
    ``exchange_bytes`` per position (complex128: 16 bytes an amplitude)."""
    U, n, k = _gate(name), 6, 3
    rng = np.random.default_rng(7)
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    mesh = _mesh(8)
    st = M.put_state(mesh, psi, "complex128")
    comm.reset_counts()
    out = exchange.apply_nonlocal(mesh, st.shards, k, qubits, U)
    assert comm.moved_bytes() == 8 * exchange.exchange_bytes(
        U, qubits, k, itemsize=16)
    got = np.concatenate([out[s][0].numpy() + 1j * out[s][1].numpy()
                          for s in range(8)])
    _close(got, roracle.apply_gate(psi, list(qubits), U), 1e-12)


def test_reshard_moves_its_modelled_bytes():
    n, k, pairs = 6, 3, [(0, 3), (1, 4), (2, 5)]
    psi = np.arange(1 << n, dtype=np.complex128)
    mesh = _mesh(8)
    st = M.put_state(mesh, psi, "complex128")
    comm.reset_counts()
    for plane in (0, 1):
        reshard.swap_device_bits(mesh, {s: pl[plane] for s, pl in
                                        st.shards.items()}, k, pairs)
    assert comm.TRAFFIC["all_to_all_bytes"] == 8 * reshard.reshard_bytes(
        k, len(pairs), itemsize=16)["all_to_all_bytes"]


# ---------------------------------------------------------------------------
# Window mode: the window schedule's kernels on each shard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag,cd", [
    ("ghz12", rlib.ghz(12)),
    ("qft10", rlib.qft(10)),
    ("random11", rlib.random_circuit(11, 60, seed=4)),
    ("sycamore10", rlib.sycamore_like(10, depth=4, seed=1)),
])
def test_window_mode_sharded_vs_reference(tag, cd):
    _close(_run(8, cd, mode="window"), _ref(8, cd, mode="window"))


def test_window_mode_merged_diag_k10():
    """k = 13 - 3 = 10 crosses the terms-only diag-merge gate."""
    cd = rlib.qft(13)
    _close(_run(8, cd, mode="window"), roracle.simulate(cd))


def test_window_mode_decomposed_bitperm_k17():
    """k = 20 - 3 = 17 crosses the terminal-bitperm decomposition gate:
    the shard-local QFT bit reversal runs as a BitPermGridOp and the
    native-transpose crossing on each shard."""
    from quantum_simulations_tpu_torch.circuit.contract import (
        validate_circuit_dict)
    from quantum_simulations_tpu_torch.circuit.panelize import (
        TransposeCrossOp, compile_window_ops)

    local = [(tuple(g["qubits"]), G.gate_matrix(g["gate"], g["params"]),
              g["gate"])
             for g in validate_circuit_dict(rlib.qft(17))["gates"]]
    kops = compile_window_ops(local, 17, diag_terms_only=True)
    assert any(isinstance(o, TransposeCrossOp) for o in kops)
    cd = rlib.qft(20)
    _close(_run(8, cd, mode="window"), roracle.simulate(cd))


def test_window_mode_mesh2():
    cd = rlib.qft(9)
    _close(_run(2, cd, mode="window"), _ref(2, cd, mode="window"))


def test_window_mode_staged():
    cd = rlib.random_circuit(10, 80, seed=9)
    staged, log2phys, _ = S.stage_circuit(cd, k=7, method="heuristic")
    got = permute_state(_run(8, staged, mode="window"), log2phys)
    _close(got, roracle.simulate(cd))
