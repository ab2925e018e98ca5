"""The light-cone reference: <Z_S> from the gates in the backward light
cone of S equals <Z_S> of the whole state, and a check that names it
holds every answer of the window, not only the sampled ones."""
import copy
import time

import numpy as np
import pytest

from gpubench import circuits
from gpubench import run as R
from gpubench.kinds import expectation_z
from gpubench.reference import lightcone as lc
from gpubench.reference import statevector as sv

ONE = {"H": {}, "T": {}, "SX": {}, "RX": {"theta": 0.9},
       "U": {"theta": 0.7, "phi": -0.4, "lam": 2.1}}
TWO = {"CNOT": {}, "CZ": {}, "SWAP": {}, "FSIM": {"theta": 1.1, "phi": 0.5},
       "RXX": {"theta": -0.8}, "CRY": {"theta": 1.3}}


def mixed_circuit(n, count, rng):
    """Layers of 1-qubit gates, then 2-qubit gates on random pairs, either
    way round, so that some cones stay narrow and others fill the circuit."""
    gates = []
    for _ in range(count):
        for q in range(n):
            name = list(ONE)[rng.integers(len(ONE))]
            gates.append({"gate": name, "qubits": [q], "params": ONE[name]})
        for _ in range(n // 3):
            a = int(rng.integers(n))
            b = (a + int(rng.choice([-2, -1, 1, 2]))) % n
            name = list(TWO)[rng.integers(len(TWO))]
            gates.append({"gate": name, "qubits": [a, b], "params": TWO[name]})
    return {"number_of_qubits": n, "gates": gates}


@pytest.mark.parametrize("n, depth, seed", [(2, 1, 0), (6, 2, 1), (9, 3, 2),
                                            (10, 4, 3)])
def test_the_cone_gives_the_whole_state_s_z(n, depth, seed):
    rng = np.random.default_rng(seed)
    for cd in (mixed_circuit(n, depth, rng),
               circuits.non_stabilizer(n, depth, seed)):
        probs = sv.probabilities(sv.simulate(cd, "cpu"))
        for k in range(1, min(n, 4) + 1):
            for _ in range(4):
                qs = sorted(int(q) for q in rng.choice(n, k, replace=False))
                assert lc.z_expectation(cd, qs, "cpu") == pytest.approx(
                    sv.z_expectation(probs, n, qs), abs=1e-12)


def test_the_cone_drops_what_cannot_reach_the_string():
    cd = {"number_of_qubits": 4, "gates": [
        {"gate": "H", "qubits": [0]}, {"gate": "CNOT", "qubits": [0, 1]},
        {"gate": "H", "qubits": [3]}, {"gate": "CNOT", "qubits": [2, 3]},
        {"gate": "X", "qubits": [0]}]}
    # X on qubit 0 comes after the CNOT that brings qubit 0 in: dropped
    order, kept = lc.cone(cd, [1])
    assert order == [0, 1] and kept == cd["gates"][:2]
    order, kept = lc.cone(cd, [3])
    assert order == [2, 3] and kept == cd["gates"][2:4]
    assert lc.cone(cd, [0]) == ([0, 1], [*cd["gates"][:2], cd["gates"][4]])
    # the cell's instances: a string of a few qubits reads a narrow cone
    order, kept = lc.cone(circuits.non_stabilizer(28, 4, 7), [5])
    assert len(order) < 28 and len(kept) < 223


def _fresh(n=10):
    """nonstab28.fresh.window from its files: the cell is held out of
    BENCHMARK.json (its throughput spreads too widely on the card's host)."""
    spec = copy.deepcopy(R.load_json(R.ROOT / "BENCHMARK.json"))
    spec["workloads"].append({"name": "nonstab28.fresh.window",
                              "config": "nonstab28", "traffic": "fresh.window",
                              "chips": 1})
    cell = copy.deepcopy(R.load_cell(spec, "nonstab28.fresh.window"))
    cell.config["params"]["n"] = n
    return cell


def test_every_answer_of_the_window_is_held_to_its_cone(monkeypatch):
    """One answer altered, neither the last nor any the full reference
    runs: the check still finds it."""
    cell = _fresh()
    assert cell.check["answers"] == "light_cone"
    assert cell.check["requests"] == 1
    calls = [0]
    call = expectation_z.call

    def second_off(*args):
        calls[0] += 1
        return call(*args) + (1e-3 if calls[0] == 2 else 0.0)

    res = R.run_cell(cell, 2 ** 31 + 41, 0.3, False, "cpu",
                     t_start=time.perf_counter())
    assert res["correct"] is True, res["checks"]
    monkeypatch.setattr(expectation_z, "call", second_off)
    res = R.run_cell(cell, 2 ** 31 + 41, 0.3, False, "cpu",
                     t_start=time.perf_counter())
    assert calls[0] > 3 and res["attempted"] > 2
    assert res["correct"] is False
    assert res["checks"]["z_err"]["value"] == pytest.approx(1e-3, rel=1e-6)
    assert res["checks"]["state_err"]["value"] < 1e-5
