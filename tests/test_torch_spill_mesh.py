"""The port's spill tier across a mesh (the sharded x out-of-core
composition) against the JAX package's, on the CPU.

The cases of ``tests/test_spill_mesh.py``: every stripe group is sharded
over the positions of a CPU mesh; stripe-local gates run per shard,
mesh-bit gates by the XOR-offset exchange, stripe-index gates by
stack-and-relabel.  Held to the JAX tier's result (its 8-device virtual
mesh) or to the JAX package's numpy oracle at 1e-10 in complex128, with
the reference's refusals, and a disk run crashed after 3 stripe writes
(a process that imports only the port) and resumed (its chunk
files hold complex64 in both packages: 2e-5, as tests/test_torch_spill.py
holds the disk backend).
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

from quantum_simulations_tpu.circuit import library as rlib
from quantum_simulations_tpu.oracle import dense_numpy as roracle
from quantum_simulations_tpu.parallel.mesh import make_mesh as rmake_mesh
from quantum_simulations_tpu.runtime import spill as rspill
from quantum_simulations_tpu_torch.parallel.mesh import make_mesh
from quantum_simulations_tpu_torch.runtime import spill

REPO = Path(__file__).resolve().parent.parent
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


def _mixed_circuit(n, seed=0, depth=30):
    """Random circuit hitting local / mesh / host bits and straddlers (the
    reference test's)."""
    rng = np.random.default_rng(seed)
    gates = [{"qubits": [q], "gate": "H"} for q in range(n)]
    pool = ["CNOT", "CZ", "SWAP"]
    for _ in range(depth):
        kind = rng.integers(0, 3)
        if kind == 0:
            q = int(rng.integers(0, n))
            gates.append({"qubits": [q], "gate":
                          str(rng.choice(["H", "T", "S", "X"]))})
        elif kind == 1:
            q = int(rng.integers(0, n))
            gates.append({"qubits": [q], "gate": "RZ",
                          "params": {"theta": float(rng.uniform(0, 6))}})
        else:
            a, b = rng.choice(n, size=2, replace=False)
            gates.append({"qubits": [int(a), int(b)],
                          "gate": str(rng.choice(pool))})
    return {"number_of_qubits": n, "gates": gates}


def _run(cd, m, devs, **kw):
    return spill.run_out_of_core(cd, stripe_qubits=m, backend="host",
                                 dtype="complex128", use_wal=False,
                                 mesh=make_mesh(devs, device="cpu"),
                                 device="cpu", **kw)


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mesh_spill_random_vs_reference(seed):
    cd = _mixed_circuit(10, seed=seed)
    got = _run(cd, 6, 8)
    if seed == 0:
        _close(got, rspill.run_out_of_core(
            cd, stripe_qubits=6, backend="host", dtype="complex128",
            mesh=rmake_mesh(8), use_wal=False))
    _close(got, roracle.simulate(cd))


def test_mesh_spill_qft_with_staging():
    cd = rlib.qft(9)
    got = _run(cd, 6, 4, use_staging=True)
    _close(got, rspill.run_out_of_core(
        cd, stripe_qubits=6, backend="host", dtype="complex128",
        mesh=rmake_mesh(4), use_staging=True, use_wal=False))


@pytest.mark.parametrize("devs", [2, 4])
def test_mesh_spill_mesh_sizes(devs):
    """d = 1 and d = 2, stripes forcing host-bit groups."""
    cd = _mixed_circuit(8, seed=5, depth=20)
    _close(_run(cd, 5, devs), roracle.simulate(cd))


def test_mesh_spill_rejects_bad_configs():
    cd = rlib.ghz(6)
    cases = [(dict(stripe_qubits=3, devs=8), "shard-local"),
             (dict(stripe_qubits=5, devs=2, transfer="f32"), "single-device")]
    for kw, match in cases:
        devs = kw.pop("devs")
        with pytest.raises(ValueError, match=match):
            spill.run_out_of_core(cd, backend="host", device="cpu",
                                  mesh=make_mesh(devs, device="cpu"), **kw)
        with pytest.raises(ValueError, match=match):
            rspill.run_out_of_core(cd, backend="host", mesh=rmake_mesh(devs),
                                   **kw)


def test_mesh_spill_disk_wal_resume(tmp_path):
    """Disk backend + WAL under the mesh: a process crashed after 3 stripe
    writes; a fresh run finishes from the committed step."""
    cd = _mixed_circuit(9, seed=7, depth=16)
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(REPO)!r})
        from quantum_simulations_tpu_torch.parallel.mesh import make_mesh
        from quantum_simulations_tpu_torch.runtime import spill
        spill.run_out_of_core(json.loads({json.dumps(json.dumps(cd))}),
                              stripe_qubits=6, backend="disk",
                              work_dir={str(tmp_path)!r}, dtype="complex128",
                              mesh=make_mesh(4, device="cpu"), device="cpu")
        assert "jax" not in sys.modules
    """)
    env = dict(os.environ, QST_CRASH_AFTER_STRIPE="3")
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 1, p.stderr  # os._exit(1) crash hook fired
    assert json.loads((tmp_path / "wal.json").read_text())["done_steps"] == 0
    spill.run_out_of_core(cd, stripe_qubits=6, backend="disk",
                          work_dir=tmp_path, dtype="complex128",
                          mesh=make_mesh(4, device="cpu"), device="cpu")
    want = roracle.simulate(cd)
    for collect in (spill.collect_state, rspill.collect_state):
        np.testing.assert_allclose(collect(tmp_path), want, atol=2e-5, rtol=0)
