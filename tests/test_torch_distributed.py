"""The port's multi-process tier against the JAX package's, on the CPU
(``tests/test_distributed.py`` and ``tests/test_multiprocess_dcn.py``).

A real two-process cluster: two OS processes, each driving 4 positions
on the CPU, join one gloo process group through a ``file://`` store in
the test's own directory (no port to collide with under xdist), with a
gloo timeout and a wall limit on each process, so a deadlock fails the
test instead of hanging it.  They build the 8-position pod mesh
(processes contiguous: mesh bit 2 crosses processes), run a circuit whose
gates span the process boundary in fused and window mode (exchanges and a
boundary-SWAP reshard across processes), a reshard of a local bit with
the process bit, the sharded readout and the WAL runner on a shared work
dir.  Each process writes its shards; this process holds them to the JAX
tier's result (its 8-device virtual mesh) at 1e-10.  The workers import
only the port.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from quantum_simulations_tpu.circuit import gates as RG
from quantum_simulations_tpu.circuit.staging import staging_stats as rstats
from quantum_simulations_tpu.oracle import dense_numpy as roracle
from quantum_simulations_tpu.ops.exchange import (
    weighted_exchange_bytes as rweighted,
)
from quantum_simulations_tpu.parallel import distributed as RD
from quantum_simulations_tpu.parallel import executor as RE
from quantum_simulations_tpu.parallel import mesh as RM
from quantum_simulations_tpu.runtime import runner as rrunner
from quantum_simulations_tpu_torch.circuit import gates as G
from quantum_simulations_tpu_torch.circuit.staging import staging_stats
from quantum_simulations_tpu_torch.ops.exchange import weighted_exchange_bytes
from quantum_simulations_tpu_torch.parallel import distributed as D
from quantum_simulations_tpu_torch.parallel.mesh import Mesh, make_mesh
from quantum_simulations_tpu_torch.runtime import runner

REPO = Path(__file__).resolve().parent.parent
WALL_S = 240

N = 6  # k = 3 local qubits; qubits 3, 4 in a process, qubit 5 across
GATES = [{"qubits": [q], "gate": "H"} for q in range(N)] + [
    {"qubits": [5], "gate": "T"},                  # process-bit diag: no traffic
    {"qubits": [0, 5], "gate": "CNOT"},            # target on the process bit
    {"qubits": [5, 0], "gate": "CNOT"},            # control on the process bit
    {"qubits": [5], "gate": "H"},                  # 1q butterfly across
    {"qubits": [0, 5], "gate": "SWAP"},            # boundary SWAP -> reshard
    {"qubits": [4, 5], "gate": "SWAP"},            # both qubits mesh bits
    {"qubits": [5, 4], "gate": "CR", "params": {"k": 2}},
    {"qubits": [1], "gate": "T"},
]
CD = {"number_of_qubits": N, "gates": GATES}


def test_init_distributed_noop_without_coordinator(monkeypatch):
    for key in ("QST_COORDINATOR", "MASTER_ADDR", "WORLD_SIZE",
                "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(key, raising=False)
    assert D.init_distributed() is False
    assert RD.init_distributed() is False
    assert not D.is_multihost()


def test_device_bit_costs_single_process():
    assert D.device_bit_costs(make_mesh(8, device="cpu")) == \
        RD.device_bit_costs(RM.make_mesh(8)) == [D.ICI_COST] * 3
    pod = Mesh(tuple((p, torch.device("cpu")) for p in (0,) * 4 + (1,) * 4))
    assert D.device_bit_costs(pod) == [D.ICI_COST, D.ICI_COST, D.DCN_COST]
    assert (D.ICI_COST, D.DCN_COST) == (RD.ICI_COST, RD.DCN_COST)


def test_weighted_staging_stats():
    """A gate on a process-crossing bit costs more than one on a bit
    within a process, and the staging stats weigh it so, as the
    reference's."""
    k = 5
    costs = [1.0, 1.0, 20.0]
    low = weighted_exchange_bytes(G.CNOT(), (0, k + 0), k, costs)
    top = weighted_exchange_bytes(G.CNOT(), (0, k + 2), k, costs)
    assert low > 0 and top == 20.0 * low
    assert (low, top) == (rweighted(RG.CNOT(), (0, k), k, costs),
                          rweighted(RG.CNOT(), (0, k + 2), k, costs))
    cd = {"number_of_qubits": 8, "gates": [
        {"gate": "CNOT", "qubits": [0, 7], "params": {}},
        {"gate": "H", "qubits": [6], "params": {}}]}
    st = staging_stats(cd, k, bit_costs=costs)
    assert st == rstats(cd, k, bit_costs=costs)
    assert st["weighted_bytes_staged"] <= st["weighted_bytes_unstaged"]


_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch

    from quantum_simulations_tpu_torch.ops import sampling
    from quantum_simulations_tpu_torch.parallel import comm
    from quantum_simulations_tpu_torch.parallel import distributed as D
    from quantum_simulations_tpu_torch.parallel import executor as E
    from quantum_simulations_tpu_torch.parallel import mesh as M
    from quantum_simulations_tpu_torch.parallel.reshard import swap_device_bits
    from quantum_simulations_tpu_torch.runtime import runner

    pid, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    assert D.init_distributed({store!r}, world, pid, backend="gloo",
                              timeout_s=60)
    assert D.init_distributed()  # idempotent
    mesh = D.make_pod_mesh({devices}, device="cpu")
    assert mesh.size == {devices} and mesh.rank == pid
    assert D.is_multihost() == (world > 1)
    cd = json.loads({cd!r})

    def save(tag, state):
        for s, (re, im) in state.shards.items():
            np.save(f"{{out}}/{{tag}}_{{s}}.npy", re.numpy() + 1j * im.numpy())

    rec = {{"costs": D.device_bit_costs(mesh), "local": mesh.local}}
    comm.reset_counts()
    for mode in ("fused", "window"):
        st = E.simulate_sharded(mesh, cd, dtype="complex128", mode=mode)
        save(mode, st)
    rec["remote_bytes"] = comm.TRAFFIC["remote_bytes"]
    rec["z"] = sampling.expectation_z_sharded(st, [0, 5])
    rec["p5"] = sampling.qubit_probability_sharded(st, 5)
    rec["bits"] = sampling.sample_bits_sharded(st, 64, seed=3).tolist()
    outcome, post = sampling.measure_qubit_sharded(
        st, 5, torch.Generator().manual_seed(1))
    rec["outcome"] = outcome
    save("measured", post)
    for plane in (0, 1):
        swap_device_bits(mesh, {{s: pl[plane] for s, pl in st.shards.items()}},
                         M.shard_width(mesh, cd["number_of_qubits"]), [(0, 5)])
    save("resharded", st)
    runner.run(cd, f"{{out}}/wd", mesh=mesh, dtype="complex128",
               use_fusion=False)
    print(json.dumps(rec), flush=True)
""")


def _cluster(tmp_path, world, devices):
    """Run the worker in ``world`` processes; their records by rank."""
    code = _WORKER.format(repo=str(REPO), store=f"file://{tmp_path}/store",
                          devices=devices, cd=json.dumps(CD))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("QST_", "MASTER_", "WORLD_SIZE", "RANK"))}
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(i), str(world), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(world)]
    recs = []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=WALL_S)
            assert p.returncode == 0, f"process {i} failed:\n{out}\n{err}"
            recs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return recs


def _assemble(tmp_path, tag, devices):
    return np.concatenate([np.load(tmp_path / f"{tag}_{s}.npy")
                           for s in range(devices)])


def test_two_process_pod_rehearsal(tmp_path):
    recs = _cluster(tmp_path, 2, 8)
    want = RE.collect_state(RE.simulate_sharded(RM.make_mesh(8), CD,
                                                dtype="complex128"))
    np.testing.assert_allclose(want, roracle.simulate(CD), atol=1e-10)
    for mode in ("fused", "window"):
        np.testing.assert_allclose(_assemble(tmp_path, mode, 8), want,
                                   atol=1e-10, err_msg=mode)
    assert [r["local"] for r in recs] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    for r in recs:
        assert r["costs"] == [D.ICI_COST, D.ICI_COST, D.DCN_COST]
        assert r["remote_bytes"] > 0
    # The readout: the same on both ranks, and the reference's values.
    probs = np.abs(want) ** 2
    idx = np.arange(1 << N)
    z = float(np.sum(probs * (1 - 2 * (((idx >> 0) ^ (idx >> 5)) & 1))))
    p5 = float(probs[(idx >> 5) & 1 == 1].sum())
    for r in recs:
        assert abs(r["z"] - z) < 1e-10 and abs(r["p5"] - p5) < 1e-10
    assert recs[0]["bits"] == recs[1]["bits"]
    assert recs[0]["outcome"] == recs[1]["outcome"]
    support = {int(i) for i in np.nonzero(probs > 1e-12)[0]}
    for row in recs[0]["bits"]:
        assert sum(b << q for q, b in enumerate(row)) in support
    keep = (idx >> 5) & 1 == recs[0]["outcome"]
    post = np.where(keep, want, 0) / np.sqrt(probs[keep].sum())
    np.testing.assert_allclose(_assemble(tmp_path, "measured", 8), post,
                               atol=1e-10)
    # The reshard across processes: SWAP(0, 5) as one all_to_all.
    swapped = roracle.simulate({"number_of_qubits": N, "gates": [
        {"qubits": [0, 5], "gate": "SWAP"}]}, initial_state=want)
    np.testing.assert_allclose(_assemble(tmp_path, "resharded", 8), swapped,
                               atol=1e-12)
    # The runner on the shared work dir, collected by both packages.
    for collect in (runner.collect_state, rrunner.collect_state):
        np.testing.assert_allclose(collect(tmp_path / "wd"), want, atol=1e-10)


def test_one_process_cluster(tmp_path):
    """A one-process group: the pod mesh is this process's, nothing
    crosses processes."""
    (rec,) = _cluster(tmp_path, 1, 4)
    assert rec["local"] == [0, 1, 2, 3] and rec["remote_bytes"] == 0
    assert rec["costs"] == [D.ICI_COST] * 2
    np.testing.assert_allclose(_assemble(tmp_path, "window", 4),
                               roracle.simulate(CD), atol=1e-10)



def test_pod_mesh_defaults_to_the_card(monkeypatch, tmp_path):
    """``make_pod_mesh`` and ``pod_worker`` run on the card LOCAL_RANK
    unless asked for the CPU: without a card they raise, as every entry
    point of the port does."""
    from quantum_simulations_tpu_torch.parallel import pod_worker

    for key in ("QST_COORDINATOR", "MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert D.make_pod_mesh(2, device="cpu").devices == [torch.device("cpu")] * 2
    if torch.cuda.is_available():
        assert D.make_pod_mesh(1).devices == [torch.device("cuda", 0)]
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.make_pod_mesh(2)
    path = tmp_path / "c.json"
    path.write_text(json.dumps(CD))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pod_worker.main([str(path), "--devices", "2"])


def test_pod_worker_two_processes(tmp_path):
    """The pod entry point in two gloo processes of 4 CPU positions each:
    every shard bit-equal to the in-process 8-position run, and the plain
    torch gate calls and the bytes handed between positions, summed over
    the processes, equal to that run's."""
    from quantum_simulations_tpu_torch.ops import dense
    from quantum_simulations_tpu_torch.parallel import comm
    from quantum_simulations_tpu_torch.parallel import executor as E
    from quantum_simulations_tpu_torch.parallel.pod_worker import shard_digests

    path = tmp_path / "c.json"
    path.write_text(json.dumps(CD))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("QST_", "MASTER_", "WORLD_SIZE", "RANK"))}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "quantum_simulations_tpu_torch.parallel.pod_worker",
         str(path), "--devices", "8", "--mode", "window", "--dtype",
         "complex128", "--device", "cpu"],
        env=dict(env, QST_COORDINATOR=f"file://{tmp_path}/store",
                 QST_NUM_PROCESSES="2", QST_PROCESS_ID=str(i),
                 QST_DIST_TIMEOUT="60"),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=WALL_S)
            assert p.returncode == 0, f"process {i} failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = json.loads(outs[0])
    assert outs[1] == "" and got["processes"] == 2 and got["multihost"]
    comm.reset_counts()
    dense.GATE_CALLS = 0
    state = E.simulate_sharded(make_mesh(8, device="cpu"), CD,
                               dtype="complex128", mode="window")
    assert got["shards_sha256"] == {str(s): h for s, h in
                                    shard_digests(state).items()}
    assert got["dense_gate_calls"] == dense.GATE_CALLS > 0
    moved = sum(p["ppermute_bytes"] + p["all_to_all_bytes"]
                for p in got["exchange_by_process"])
    assert moved == comm.moved_bytes() > 0
    assert sum(p["remote_bytes"] for p in got["exchange_by_process"]) > 0
    assert abs(got["norm2"] - 1) < 1e-12
