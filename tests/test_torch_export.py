"""The port's circuit export, DAG and partitions against the JAX package's.

``to_qasm``, ``to_dot``, ``partition`` (all four strategies),
``partition_stats`` and ``CircuitGraph`` are numpy-free copies: on the
same circuits they must give the same strings, lists and dicts; the
CLI's ``export`` the same bytes as the JAX CLI's.  qiskit is installed
nowhere the port runs, so its two entry points raise ``ImportError``.
"""
import json

import pytest

from quantum_simulations_tpu.__main__ import main as rmain
from quantum_simulations_tpu.circuit import dag as RD
from quantum_simulations_tpu.circuit import import_qiskit as RQ
from quantum_simulations_tpu.circuit.export_qasm import to_qasm as rto_qasm
from quantum_simulations_tpu_torch import library
from quantum_simulations_tpu_torch.__main__ import main
from quantum_simulations_tpu_torch.circuit import dag as PD
from quantum_simulations_tpu_torch.circuit import import_qiskit as PQ
from quantum_simulations_tpu_torch.circuit.export_qasm import to_qasm
from quantum_simulations_tpu_torch.circuit.import_qasm import qasm_to_dict

CIRCUITS = {
    "ghz8": lambda: library.ghz(8),
    "w6": lambda: library.w_state(6),
    "qft7": lambda: library.qft(7),
    "qpe5": lambda: library.qpe(5),
    "qaoa8": lambda: library.qaoa_maxcut(8),
    "nonstab9": lambda: library.non_stabilizer(9),
    "grover5": lambda: library.grover(5),
    "qft_adder6": lambda: library.qft_adder(6),
    "sycamore8": lambda: library.sycamore_like(8),
    "vqe6": lambda: library.vqe_ansatz(6),
    "shor15": lambda: library.shor15(),
    "random": lambda: library.random_circuit(7, 60, seed=4),
}
PARTITIONED = ["ghz8", "qft7", "qaoa8", "nonstab9", "shor15", "random"]


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_to_qasm_equals_reference(name):
    cd = CIRCUITS[name]()
    text = to_qasm(cd)
    assert text == rto_qasm(cd)
    # the port's importer reads the text back
    assert qasm_to_dict(text)["number_of_qubits"] == cd["number_of_qubits"]


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_graph_and_dot_equal_reference(name):
    cd = CIRCUITS[name]()
    g, rg = PD.CircuitGraph.from_circuit(cd), RD.CircuitGraph.from_circuit(cd)
    assert g.edges == rg.edges
    assert g.topological_levels() == rg.topological_levels()
    assert g.critical_path_length() == rg.critical_path_length()
    assert g.gate_qubit_counts() == rg.gate_qubit_counts()
    assert g.is_acyclic()
    assert PD.to_dot(cd) == RD.to_dot(cd)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("strategy", ["level_based", "greedy", "balanced",
                                      "locality"])
@pytest.mark.parametrize("name", PARTITIONED)
def test_partition_equals_reference(name, strategy, k):
    cd = CIRCUITS[name]()
    parts = PD.partition(cd, k, strategy)
    assert parts == RD.partition(cd, k, strategy)
    assert PD.partition_stats(cd, parts) == RD.partition_stats(cd, parts)
    assert PD.to_dot(cd, parts) == RD.to_dot(cd, parts)


def test_partition_default_is_locality():
    """``simulate(segment_gates=...)`` calls ``partition(cd, k)``: the
    locality cut, as the reference's simulator asks for by name."""
    cd = library.qft(9)
    assert PD.partition(cd, 4) == RD.partition(cd, 4, "locality")
    with pytest.raises(ValueError, match="unknown strategy"):
        PD.partition(cd, 2, "nope")
    assert PD.partition({"number_of_qubits": 2, "gates": []}, 3) == [[], [], []]


@pytest.fixture
def files(tmp_path):
    out = {"qft8": tmp_path / "qft8.json", "qaoa8": tmp_path / "qaoa8.json"}
    out["qft8"].write_text(json.dumps(library.qft(8)))
    out["qaoa8"].write_text(json.dumps(library.qaoa_maxcut(8)))
    return out


@pytest.mark.parametrize("argv", [
    ["--format", "qasm"], ["--format", "dot"],
    ["--format", "dot", "--partitions", "3"], ["--format", "json"], []],
    ids=["qasm", "dot", "dot-partitions", "json", "default"])
@pytest.mark.parametrize("name", ["qft8", "qaoa8"])
def test_cli_export_equals_reference(capsys, files, name, argv):
    cmd = ["export", str(files[name]), *argv]
    assert rmain(cmd) == 0
    want = capsys.readouterr().out
    assert main(cmd) == 0
    assert capsys.readouterr().out == want


def test_qiskit_entry_points_raise():
    assert PQ.HAVE_QISKIT == RQ.HAVE_QISKIT
    assert PQ.SUPPORTED_BASIS == RQ.SUPPORTED_BASIS
    if PQ.HAVE_QISKIT:
        pytest.skip("qiskit is installed")
    for fn in (lambda: PQ.qiskit_to_dict(None),
               lambda: PQ.dict_to_qiskit(library.ghz(3)),
               lambda: PQ.overlap_with_qiskit(library.ghz(3), None)):
        with pytest.raises(ImportError, match="qiskit is not installed"):
            fn()
