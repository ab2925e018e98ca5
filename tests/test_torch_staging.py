"""The port's staging scheduler and exchange cost helpers against the JAX
package's, on the CPU.

Planning code in numpy on both sides, so every result must be EXACTLY
the reference's: the physical circuits, ``log2phys``, the stats, the
plan costs and the chosen plan (``pulp`` is absent, so ``"ilp"`` runs the
pure-python branch-and-bound ``_stage_bb`` in both).  ``permute_state``
(merged axes) and ``permute_state_inplace`` (block cycles) must return the
reference's array bit for bit.
"""
import numpy as np
import pytest

from quantum_simulations_tpu.circuit import library as rlib
from quantum_simulations_tpu.circuit import staging as R
from quantum_simulations_tpu.ops import exchange as RX
from quantum_simulations_tpu_torch.circuit import gates as G
from quantum_simulations_tpu_torch.circuit import staging as S
from quantum_simulations_tpu_torch.circuit.contract import validate_circuit_dict
from quantum_simulations_tpu_torch.circuit.fusion import compile_steps
from quantum_simulations_tpu_torch.ops import exchange as X
from quantum_simulations_tpu_torch.runtime.spill import _group_bits

CIRCUITS = [
    ("qft7", rlib.qft(7), 4),
    ("random", rlib.random_circuit(7, 60, seed=3), 4),
    ("ghz8", rlib.ghz(8), 5),
    ("sycamore", rlib.sycamore_like(6, depth=4), 3),
    ("w6", rlib.w_state(6), 3),
]
POD2_COSTS = [1.0, 1.0, 20.0]


def _dcn_trap_circuit():
    """tests/test_staging.py's circuit on which cost-aware staging wins."""
    g = [{"qubits": [0], "gate": "H"}, {"qubits": [5], "gate": "H"},
         {"qubits": [0, 1], "gate": "CNOT"},
         {"qubits": [5], "gate": "RY", "params": {"theta": 0.3}},
         {"qubits": [1], "gate": "T"}, {"qubits": [5], "gate": "H"}]
    for _ in range(12):
        g += [{"qubits": [1, 2], "gate": "CNOT"}, {"qubits": [2], "gate": "T"},
              {"qubits": [0, 2], "gate": "CNOT"}]
    g += [{"qubits": [2, 5], "gate": "CNOT"}, {"qubits": [5], "gate": "H"}]
    return {"number_of_qubits": 6, "gates": g}


@pytest.mark.parametrize("method", ["heuristic", "greedy", "ilp"])
@pytest.mark.parametrize("tag,cd,k", CIRCUITS, ids=[c[0] for c in CIRCUITS])
def test_stage_circuit_equals_reference(tag, cd, k, method):
    got = S.stage_circuit(cd, k, method)
    want = R.stage_circuit(cd, k, method)
    assert got == want
    if method == "ilp":
        assert got[2]["method"] in ("ilp-bb", "heuristic")


@pytest.mark.parametrize("bit_costs", [None, POD2_COSTS, [1.0, 20.0, 20.0]])
def test_cost_aware_staging_and_plan_cost_equal_reference(bit_costs):
    cd = _dcn_trap_circuit()
    for method in ("heuristic", "greedy"):
        got = S.stage_circuit(cd, 3, method, bit_costs=bit_costs)
        assert got == R.stage_circuit(cd, 3, method, bit_costs=bit_costs)
        assert S.plan_cost(got[0], 3, bit_costs) == R.plan_cost(
            got[0], 3, bit_costs)
    got = S.choose_staging(cd, 3, bit_costs=bit_costs)
    assert got == R.choose_staging(cd, 3, bit_costs=bit_costs)


@pytest.mark.parametrize("tag,cd,k", CIRCUITS, ids=[c[0] for c in CIRCUITS])
def test_staging_stats_and_choose_equal_reference(tag, cd, k):
    assert S.staging_stats(cd, k) == R.staging_stats(cd, k)
    costs = [1.0] * (cd["number_of_qubits"] - k - 1) + [20.0]
    assert S.staging_stats(cd, k, bit_costs=costs) == R.staging_stats(
        cd, k, bit_costs=costs)
    assert S.choose_staging(cd, k) == R.choose_staging(cd, k)


def test_plan_cost_charges_collapsed_runs_as_reference():
    run2 = {"number_of_qubits": 6, "gates": [
        {"qubits": [0, 3], "gate": "SWAP"}, {"qubits": [1, 5], "gate": "SWAP"},
        {"qubits": [2], "gate": "H"}, {"qubits": [4, 1], "gate": "CNOT"}]}
    for costs in (None, POD2_COSTS):
        assert S.plan_cost(run2, 3, costs) == R.plan_cost(run2, 3, costs)
    # One DCN-priced run of two boundary SWAPs; the H is local and the
    # CNOT's control on a device bit ships nothing.
    assert S.plan_cost(run2, 3, POD2_COSTS) == 20.0 * (64 - 16)


def test_non_insular_and_sets_to_schedule_equal_reference():
    for g in ({"qubits": [3], "gate": "T"}, {"qubits": [3], "gate": "H"},
              {"qubits": [2, 5], "gate": "CNOT"},
              {"qubits": [2, 5], "gate": "CR", "params": {"k": 2}},
              {"qubits": [2, 5], "gate": "SWAP"},
              {"qubits": [0, 1, 2], "gate": "CCX"}):
        assert S.non_insular_qubits(g) == R.non_insular_qubits(g)
    cd = rlib.qft(6)
    assert (S._sets_to_schedule(cd, 3, [[0, 1, 2]])
            == R._sets_to_schedule(cd, 3, [[0, 1, 2]]))
    vcd = validate_circuit_dict(cd)
    assert S._stage_bb(vcd, 3) == R._stage_bb(vcd, 3) is not None


def test_nonstab33_plan_of_the_card_run():
    """The staged plan the card's spill run streams at n = 33, m = 28
    (chip_smoke.py phase 7): the reference's, 7 steps, groups of at most
    2^30 amplitudes (r <= 2), where unstaged the widest is the whole
    state; the un-permute walks 2^14 blocks of 2^19 in place."""
    cd = rlib.non_stabilizer(33, 4, 7)
    got = S.stage_circuit(cd, 28, "heuristic")
    assert got == R.stage_circuit(cd, 28, "heuristic")
    st = S.staging_stats(cd, 28, "heuristic")
    assert st["exchanges_staged"] < st["exchanges_unstaged"]  # 'auto' stages
    steps = compile_steps(got[0], k=28, panel_width=7)
    assert len(steps) == 7
    assert max(len(_group_bits(s, 28)) for s in steps) == 2
    unstaged = compile_steps(cd, k=28, panel_width=7)
    assert max(len(_group_bits(s, 28)) for s in unstaged) == 5
    l2p = got[1]
    assert l2p[:19] == list(range(19)) and l2p[19] != 19
    assert len(S._bit_runs(l2p)) == 11


# ---------------------------------------------------------------------------
# permute_state
# ---------------------------------------------------------------------------

def _layouts(rng):
    yield [2, 0, 3, 1]
    yield [int(x) for x in rng.permutation(20)]  # a random 20-bit layout
    yield list(range(5)) + [5 + int(x) for x in rng.permutation(12)]
    # The n = 33 plan's shape (tests above): low bits fixed, the high
    # ones shuffled, blocks of 2^10 moving in place.
    yield list(range(10)) + [10 + int(x) for x in rng.permutation(10)]
    yield list(range(12)) + [12, 13, 15, 14]
    for n in (1, 2, 3, 7, 9):
        yield [int(x) for x in rng.permutation(n)]


def test_permute_state_equals_reference():
    rng = np.random.default_rng(5)
    for l2p in _layouts(rng):
        n = len(l2p)
        psi = (rng.standard_normal(1 << n)
               + 1j * rng.standard_normal(1 << n)).astype(np.complex64)
        want = R.permute_state(psi, l2p)
        np.testing.assert_array_equal(S.permute_state(psi, l2p), want)
        mine = psi.copy()
        got = S.permute_state_inplace(mine, l2p)
        np.testing.assert_array_equal(got, want)
        f = next((q for q, p in enumerate(l2p) if p != q), n)
        # Blocks of >= 2^10 amplitudes that stay whole move in place (and
        # the identity is a no-op).
        assert (got is mine) == (f == n or (f >= 10 and n - f <= 20))


def test_permute_state_fast_paths():
    psi = np.arange(8, dtype=complex)
    assert S.permute_state(psi, [0, 1, 2]) is psi
    assert S.permute_state_inplace(psi, [0, 1, 2]) is psi
    out = S.permute_state_inplace(psi, [1, 0, 2])  # blocks of 1: a copy
    np.testing.assert_array_equal(out, R.permute_state(psi, [1, 0, 2]))
    assert out is not psi and np.array_equal(psi, np.arange(8))
    assert S._bit_runs([0, 1, 5, 6, 2, 3, 4]) == [(0, 0, 2), (2, 5, 2),
                                                  (4, 2, 3)]


def test_permute_state_inplace_block_limits(monkeypatch):
    """Past ``INPLACE_MAX_BLOCKS`` blocks, or below blocks of
    ``INPLACE_MIN_BLOCK`` amplitudes, the walk gives way to the copy."""
    rng = np.random.default_rng(1)
    psi = rng.standard_normal(1 << 8).astype(complex)
    l2p = [0, 1] + [2 + int(x) for x in rng.permutation(6)]
    want = R.permute_state(psi, l2p)
    monkeypatch.setattr(S, "INPLACE_MIN_BLOCK", 4)
    out = S.permute_state_inplace(psi.copy(), l2p)
    np.testing.assert_array_equal(out, want)
    monkeypatch.setattr(S, "INPLACE_MAX_BLOCKS", 32)
    out = S.permute_state_inplace(psi, l2p)
    assert out is not psi
    np.testing.assert_array_equal(out, want)
    monkeypatch.setattr(S, "INPLACE_MAX_BLOCKS", 64)
    assert S.permute_state_inplace(psi, l2p) is psi


# ---------------------------------------------------------------------------
# Exchange cost helpers
# ---------------------------------------------------------------------------

GATES = [("H", (3,), {}), ("X", (1,), {}), ("T", (4,), {}),
         ("CNOT", (0, 4), {}), ("CNOT", (4, 0), {}), ("CNOT", (3, 4), {}),
         ("CZ", (1, 3), {}), ("SWAP", (0, 3), {}), ("SWAP", (3, 4), {}),
         ("CR", (4, 2), {"k": 3}), ("RY", (4,), {"theta": 0.3}),
         ("CCX", (0, 3, 4), {}), ("CCX", (3, 4, 1), {})]


@pytest.mark.parametrize("k", [2, 3, 5])
def test_exchange_helpers_equal_reference(k):
    for name, qs, params in GATES:
        U = G.gate_matrix(name, params)
        assert X.nonzero_offsets(U, qs, k) == RX.nonzero_offsets(U, qs, k)
        assert X.exchange_cost(U, qs, k) == RX.exchange_cost(U, qs, k)
        assert X.offset_traffic(U, qs, k) == RX.offset_traffic(U, qs, k)
        assert X.exchange_bytes(U, qs, k) == RX.exchange_bytes(U, qs, k)
        costs = [1.0, 20.0, 3.0][:max(1, 5 - k)]
        assert X.weighted_exchange_bytes(U, qs, k, costs) == \
            RX.weighted_exchange_bytes(U, qs, k, costs)
        r = sum(q >= k for q in qs)
        for a in range(1 << r):
            np.testing.assert_array_equal(X.zero_offset_block(U, qs, k, a),
                                          RX.zero_offset_block(U, qs, k, a))
