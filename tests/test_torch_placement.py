"""The port's shard-placement report and verifier against the JAX
package's (``tests/test_placement.py``), and the mesh's refusal to put
more positions than cards on ``device="cuda"``.

The JAX report runs on its virtual 8-device CPU mesh, the port's on a
mesh of 8 CPU positions: every field is the same but the device names.
Multi-process meshes are built directly from their (process, device)
positions, as the reference test's ``FakeMesh`` stands in for a pod.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from quantum_simulations_tpu.__main__ import main as rmain
from quantum_simulations_tpu.parallel import placement as rplacement
from quantum_simulations_tpu.parallel.mesh import make_mesh as rmake_mesh
from quantum_simulations_tpu_torch.__main__ import main
from quantum_simulations_tpu_torch.parallel import placement
from quantum_simulations_tpu_torch.parallel.mesh import (
    Mesh, MeshError, ShardedState, make_mesh, zero_state_sharded,
)

CPU = torch.device("cpu")


def _mesh_of(procs) -> Mesh:
    return Mesh(tuple((p, CPU) for p in procs), 0)


class FakeMesh:
    """The reference test's duck-typed mesh (.devices and .size)."""

    def __init__(self, procs):
        self.devices = np.array([SimpleNamespace(process_index=p, id=i)
                                 for i, p in enumerate(procs)], dtype=object)
        self.size = len(procs)


def _without_devices(rep):
    rep = json.loads(json.dumps(rep))
    for row in rep["devices"]:
        row.pop("device")
    return rep


def test_report_on_cpu_mesh_matches_reference():
    rep = placement.placement_report(make_mesh(8, device="cpu"), n=6)
    assert rep["n_devices"] == 8 and rep["local_qubits"] == 3
    assert [r["amp_range"] for r in rep["devices"]] == [
        [s * 8, (s + 1) * 8] for s in range(8)]
    assert [b["qubit"] for b in rep["device_bits"]] == [3, 4, 5]
    assert all(b["link"] == "ICI" for b in rep["device_bits"])
    assert rep["invariants"]["ok"]
    assert _without_devices(rep) == _without_devices(
        rplacement.placement_report(rmake_mesh(8), n=6))


def test_verify_sharded_array_ok_and_violations():
    mesh = make_mesh(8, device="cpu")
    n = 6
    chk = placement.verify_sharded_array(zero_state_sharded(mesh, n), mesh, n)
    assert chk == {"ok": True, "addressable": 8, "violations": []}
    # Shards that each hold the whole vector (the reference's replicated
    # array) break the placement formula.
    full = ShardedState(mesh, n, {s: (torch.zeros(1 << n), torch.zeros(1 << n))
                                  for s in range(8)})
    bad = placement.verify_sharded_array(full, mesh, n)
    assert not bad["ok"] and len(bad["violations"]) == 16
    missing = zero_state_sharded(mesh, n)
    del missing.shards[3]
    bad = placement.verify_sharded_array(missing, mesh, n)
    assert bad["violations"] == ["position 3 has no shard"]
    assert not placement.verify_sharded_array(
        zero_state_sharded(mesh, n), mesh, n + 1)["ok"]


@pytest.mark.parametrize("procs", [
    [0, 0, 1, 1], [0, 1, 0, 1], [0, 0, 0, 1], [0, 0, 0],
    [0, 0, 0, 0, 1, 1, 1, 1]])
def test_invariants_match_reference(procs):
    assert (placement.check_invariants(_mesh_of(procs))
            == rplacement.check_invariants(FakeMesh(procs)))


def test_fake_two_host_mesh_marks_top_bit_dcn():
    procs = [0, 0, 0, 0, 1, 1, 1, 1]
    rep = placement.placement_report(_mesh_of(procs), n=10)
    assert [b["link"] for b in rep["device_bits"]] == ["ICI", "ICI", "DCN"]
    assert rep["n_processes"] == 2 and rep["invariants"]["ok"]
    ref = rplacement.placement_report(FakeMesh(procs), n=10)
    assert rep["device_bits"] == ref["device_bits"]


@pytest.mark.parametrize("argv,code", [
    (["placement", "--devices", "8", "--qubits", "6"], 0),
    (["placement", "--devices", "2"], 0),
    (["placement", "--devices", "4", "--qubits", "1"], None)])
def test_cli_placement_subcommand(capsys, argv, code):
    if code is None:  # a mesh too large for the state: the reference's error
        with pytest.raises(ValueError, match="too large"):
            rmain(argv)
        with pytest.raises(ValueError, match="too large"):
            main(argv + ["--device", "cpu"])
        return
    assert rmain(argv) == code
    want = json.loads(capsys.readouterr().out)
    assert main(argv + ["--device", "cpu"]) == code
    got = json.loads(capsys.readouterr().out)
    assert _without_devices(got) == _without_devices(want)
    assert got["invariants"]["ok"] and got["sharded_array_check"]["ok"]


@pytest.fixture
def one_card(monkeypatch):
    """A machine with one card, as far as the mesh can tell."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA FakeCard 80GB")


def test_mesh_refuses_more_positions_than_cards(one_card):
    with pytest.raises(MeshError, match="need 2 devices, have 1: cuda:0 "
                                       r"\(NVIDIA FakeCard 80GB\)"):
        make_mesh(2)
    # Named explicitly, positions may share the card.
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * 4)
    assert mesh.size == 4 and set(mesh.devices) == {torch.device("cuda", 0)}


def test_cli_devices_beyond_the_cards_exits_1(capsys, one_card, tmp_path):
    path = tmp_path / "ghz4.json"
    path.write_text(json.dumps({"number_of_qubits": 4, "gates": [
        {"qubits": [0], "gate": "H"}, {"qubits": [0, 3], "gate": "CNOT"}]}))
    assert main(["run", str(path), "--devices", "2"]) == 1
    err = capsys.readouterr().err
    assert "need 2 devices, have 1" in err and "FakeCard" in err
    assert main(["placement", "--devices", "2"]) == 1
    assert "FakeCard" in capsys.readouterr().err
