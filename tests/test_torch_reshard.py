"""The port's reshard (all_to_all bit permutation) and XOR-offset exchange
against the JAX package's, on the CPU.

The cases of ``tests/test_reshard.py``: swapping local index bits with
mesh bits must equal the SWAP-gate sequence for every pair and multi-pair
layout (the JAX package's numpy oracle, 1e-12), the subgroups and the
boundary-SWAP plan must be the reference's own, staged circuits must run
their stage transitions as reshards, and the fuzz over random disjoint
pairs, reshards between gate layers and random 2q unitaries in every
boundary split (``apply_nonlocal``, whose single-cell half-plane path
the reference's fuzz caught shipping the wrong half for a SWAP).
"""
import numpy as np
import pytest
import torch

from quantum_simulations_tpu.circuit import library as rlib
from quantum_simulations_tpu.circuit.fusion import GateOp as RGateOp
from quantum_simulations_tpu.oracle import dense_numpy as roracle
from quantum_simulations_tpu.parallel import executor as RE
from quantum_simulations_tpu.parallel import mesh as RM
from quantum_simulations_tpu.parallel import reshard as rreshard
from quantum_simulations_tpu_torch.circuit import gates as G
from quantum_simulations_tpu_torch.circuit.fusion import GateOp, compile_steps
from quantum_simulations_tpu_torch.circuit.staging import (
    permute_state, stage_circuit,
)
from quantum_simulations_tpu_torch.ops import dense, exchange
from quantum_simulations_tpu_torch.parallel import executor as E
from quantum_simulations_tpu_torch.parallel import mesh as M
from quantum_simulations_tpu_torch.parallel import reshard


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """One thread per xdist worker (as tests/test_torch_simulate.py)."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _random_state(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return (psi / np.linalg.norm(psi)).astype(np.complex128)


def _reshard_state(st, k, pairs):
    for plane in (0, 1):
        reshard.swap_device_bits(
            st.mesh, {s: pl[plane] for s, pl in st.shards.items()}, k, pairs)
    return st


def _apply_reshard(n_dev, psi, k, pairs):
    mesh = M.make_mesh(n_dev, device="cpu")
    return E.collect_state(_reshard_state(M.put_state(mesh, psi, "complex128"),
                                          k, pairs))


def _oracle_swaps(psi, n, pairs):
    cd = {"number_of_qubits": n,
          "gates": [{"qubits": list(p), "gate": "SWAP"} for p in pairs]}
    return roracle.simulate(cd, initial_state=psi)


PAIR_CASES = [
    [(0, 3)],
    [(2, 5)],
    [(0, 5), (1, 4)],
    [(0, 3), (1, 4), (2, 5)],
    [(2, 3), (0, 5)],
]


@pytest.mark.parametrize("pairs", PAIR_CASES,
                         ids=["-".join(f"{a}x{b}" for a, b in c)
                              for c in PAIR_CASES])
def test_swap_device_bits_vs_oracle(pairs):
    n, k = 6, 3  # 8 positions -> mesh bits are qubits 3, 4, 5
    psi = _random_state(n, seed=sum(a * 7 + b for a, b in pairs))
    np.testing.assert_allclose(_apply_reshard(8, psi, k, pairs),
                               _oracle_swaps(psi, n, pairs), atol=1e-12)


@pytest.mark.parametrize("bits", [[0, 2], [1], [0, 1, 2], [2, 0]])
def test_axis_groups_structure(bits):
    groups = reshard._axis_groups(8, bits)
    assert groups == rreshard._axis_groups(8, bits)
    assert sorted(x for g in groups for x in g) == list(range(8))
    for g in groups:
        assert len(g) == 1 << len(bits)
        for j, s in enumerate(g):
            for i, b in enumerate(bits):
                assert (s >> b) & 1 == (j >> i) & 1


def _ops(ops, cls):
    swap, h = G.gate_matrix("SWAP", {}), G.gate_matrix("H", {})
    return [cls(q, swap if name == "SWAP" else h, name) for q, name in ops]


@pytest.mark.parametrize("ops", [
    [((0, 4), "SWAP"), ((1, 3), "SWAP"), ((5,), "H"), ((2, 5), "SWAP")],
    [((0, 4), "SWAP"), ((1, 4), "SWAP")],
    [((0, 1), "SWAP")],
], ids=["leading", "overlap", "local"])
def test_plan_boundary_reshard_matches_reference(ops):
    k = 3
    pairs, rest = reshard.plan_boundary_reshard(_ops(ops, GateOp), k)
    rpairs, rrest = rreshard.plan_boundary_reshard(_ops(ops, RGateOp), k)
    assert pairs == rpairs
    assert [(o.qubits, o.name) for o in rest] == [
        (o.qubits, o.name) for o in rrest]


def test_staged_circuit_stage_transitions_collapse():
    """A staged circuit runs its boundary SWAPs as reshards and matches the
    JAX tier end to end."""
    n = 6
    cd = rlib.qft(n)
    staged, log2phys, _ = stage_circuit(cd, k=3, method="heuristic")
    mesh = M.make_mesh(8, device="cpu")
    got = permute_state(E.collect_state(E.simulate_sharded(
        mesh, staged, dtype="complex128")), log2phys)
    want = RE.collect_state(RE.simulate_sharded(
        RM.make_mesh(8), cd, dtype="complex128"))
    np.testing.assert_allclose(got, want, atol=1e-10)
    steps = compile_steps(staged, k=3)
    rounds = residual = 0
    for s in steps:
        pairs, rest = reshard.plan_boundary_reshard(s.nonlocal_ops, 3)
        rounds += bool(pairs)
        residual += sum(1 for o in rest if o.name == "SWAP")
    assert rounds >= 1 and residual == 0


@pytest.mark.parametrize("k,r", [(20, 3), (3, 1), (10, 2)])
def test_reshard_bytes_model(k, r):
    assert reshard.reshard_bytes(k, r) == rreshard.reshard_bytes(k, r)
    shard = (1 << k) * 8
    assert reshard.reshard_bytes(k, r)["all_to_all_bytes"] == shard - (shard >> r)


def test_swap_device_bits_fuzz_random_pairs():
    rng = np.random.default_rng(123)
    for trial in range(40):
        d = int(rng.choice([1, 2, 3]))
        k = int(rng.integers(2, 5))
        n = d + k
        r = int(rng.integers(1, min(k, d) + 1))
        lqs = rng.choice(k, size=r, replace=False)
        dqs = rng.choice(np.arange(k, n), size=r, replace=False)
        pairs = [(int(a), int(b)) for a, b in zip(lqs, dqs)]
        psi = _random_state(n, seed=1000 + trial)
        np.testing.assert_allclose(
            _apply_reshard(1 << d, psi, k, pairs), _oracle_swaps(psi, n, pairs),
            atol=1e-12, err_msg=f"trial={trial} d={d} n={n} pairs={pairs}")


def test_swap_device_bits_fuzz_composed_with_gates():
    """A reshard after a layer of gates, local ones on each shard and
    cross-shard ones by the exchange: the layout bookkeeping composes."""
    rng = np.random.default_rng(7)
    n, k = 6, 3
    mesh = M.make_mesh(8, device="cpu")
    for trial in range(10):
        r = int(rng.integers(1, 4))
        lqs = rng.choice(k, size=r, replace=False)
        dqs = rng.choice(np.arange(k, n), size=r, replace=False)
        pairs = [(int(a), int(b)) for a, b in zip(lqs, dqs)]
        pre = rlib.random_circuit(n, 10, seed=trial)
        psi = _random_state(n, seed=trial)
        st = M.put_state(mesh, psi, "complex128")
        shards = st.shards
        for g in pre["gates"]:
            U = G.gate_matrix(g["gate"], g.get("params") or {})
            qs = tuple(g["qubits"])
            if all(q < k for q in qs):
                shards = {s: dense.apply_gate_planar(*pl, qs, U)
                          for s, pl in shards.items()}
            else:
                shards = exchange.apply_nonlocal(mesh, shards, k, qs, U)
        st.shards = shards
        got = E.collect_state(_reshard_state(st, k, pairs))
        want = _oracle_swaps(roracle.simulate(pre, initial_state=psi), n, pairs)
        np.testing.assert_allclose(got, want, atol=1e-12,
                                   err_msg=f"trial={trial} pairs={pairs}")


def test_apply_nonlocal_fuzz_random_2q_unitaries():
    """``apply_nonlocal`` against the oracle for Haar-random and structured
    2q gates in EVERY boundary split, the asymmetric single-cell case
    (SWAP) included."""
    from scipy.stats import unitary_group

    n, k = 6, 3
    rng = np.random.default_rng(42)
    mesh = M.make_mesh(8, device="cpu")
    mats = [G.SWAP(), G.CNOT(), G.CY()]
    mats += [unitary_group.rvs(4, random_state=7 + i) for i in range(3)]
    splits = [(0, 4), (4, 0), (2, 3), (3, 2), (1, 5), (3, 4), (5, 3)]
    for U in mats:
        for qs in splits:
            psi = _random_state(n, seed=int(rng.integers(1 << 30)))
            st = M.put_state(mesh, psi, "complex128")
            st.shards = exchange.apply_nonlocal(mesh, st.shards, k, qs, U)
            np.testing.assert_allclose(
                E.collect_state(st), roracle.apply_gate(psi, list(qs),
                                                        np.asarray(U)),
                atol=1e-12, err_msg=f"qs={qs} U={np.asarray(U)[:1]}")
