"""The port's sharded capacity tier against the JAX package's, on the CPU.

The cases of ``tests/test_capacity_sharded.py``: every shard runs in
place (each kernel's in-place instance; the state planar throughout),
whole-circuit and per step (the WAL runner's granularity), and staged
boundary SWAPs reshard each plane in the shards' own memory.  complex64
as the reference's test (float32 planes), held to the JAX tier's result
at its test's 3e-5.  Also the capacity guard: a genuinely exchanging
gate on shards of at least ``QST_CAPACITY_GUARD_MIN`` amplitudes raises
the reference's ``ValueError`` before anything runs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_simulations_tpu.circuit import library as rlib
from quantum_simulations_tpu.circuit import staging as RS
from quantum_simulations_tpu.oracle import dense_numpy as roracle
from quantum_simulations_tpu.parallel import executor as RE
from quantum_simulations_tpu.parallel import mesh as RM
from quantum_simulations_tpu.utils.transfer import fetch_array
from quantum_simulations_tpu_torch.circuit import staging as S
from quantum_simulations_tpu_torch.parallel import executor as E
from quantum_simulations_tpu_torch.parallel import mesh as M
from quantum_simulations_tpu_torch.parallel.reshard import plan_boundary_reshard

TOL = 3e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """One thread per xdist worker (as tests/test_torch_simulate.py)."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _run(cd, n_dev, per_step=False):
    mesh = M.make_mesh(n_dev, device="cpu")
    _, fns = E.build_circuit_fns(mesh, cd, mode="window", inplace=True,
                                 per_step=per_step)
    st = M.zero_state_planar_sharded(mesh, cd["number_of_qubits"])
    ptrs = {s: (re.data_ptr(), im.data_ptr()) for s, (re, im) in st.shards.items()}
    for fn in (fns if per_step else [fns]):
        st = fn(st)
    # In place: every shard still lives in the planes it was born in.
    assert ptrs == {s: (re.data_ptr(), im.data_ptr())
                    for s, (re, im) in st.shards.items()}
    return E.collect_state(st)


def _ref(cd, n_dev, per_step=False):
    mesh = RM.make_mesh(n_dev)
    _, fns = RE.build_circuit_fns(mesh, cd, mode="window", inplace=True,
                                  planar_io=True, per_step=per_step,
                                  dtype=jnp.complex64)
    re, im = RM.zero_state_planar_sharded(mesh, cd["number_of_qubits"])
    for fn in (fns if per_step else [fns]):
        re, im = fn(re, im)
    return (fetch_array(re) + 1j * fetch_array(im)).astype(np.complex64)


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("tag,cd", [
    ("qft10", rlib.qft(10)),
    ("nonstab11", rlib.non_stabilizer(11, depth=3)),
    ("ghz12", rlib.ghz(12)),
])
def test_sharded_capacity_inplace_vs_reference(tag, cd):
    got = _run(cd, 8)
    _close(got, _ref(cd, 8))
    _close(got, roracle.simulate(cd))


def test_sharded_capacity_per_step_chains_planes():
    cd = rlib.qft(10)
    _close(_run(cd, 4, per_step=True), _ref(cd, 4, per_step=True))


def _boundary_circuit(n, k):
    gates = [{"qubits": [q], "gate": "H"} for q in range(n)]
    for q in range(n - 1):
        gates.append({"qubits": [q, q + 1], "gate": "CNOT"})
    for q in range(k, n):
        gates.append({"qubits": [q % k, q], "gate": "SWAP"})
        gates.append({"qubits": [q], "gate": "H"})
    return {"number_of_qubits": n, "gates": gates}


def test_sharded_capacity_staged_reshard_on_planes():
    n, d = 11, 3
    k = n - d
    cd = _boundary_circuit(n, k)
    staged, log2phys, _ = S.stage_circuit(cd, k, "heuristic")
    rstaged, rlog2phys, _ = RS.stage_circuit(cd, k, "heuristic")
    assert staged == rstaged and log2phys == rlog2phys
    steps, _ = E.build_circuit_fns(M.make_mesh(8, device="cpu"), staged,
                                   mode="window", inplace=True)
    assert sum(len(plan_boundary_reshard(s.nonlocal_ops, k)[0])
               for s in steps) > 0, "staged plan produced no boundary reshard"
    got = S.permute_state(_run(staged, 8), log2phys)
    _close(got, RS.permute_state(_ref(staged, 8), log2phys))
    _close(got, roracle.simulate(cd))


def test_capacity_guard_refuses_exchanging_gates(monkeypatch):
    """With the guard at the shard size, the unstaged circuit's exchanging
    gates raise the reference's error: at build time in the port, at its
    first call (its trace) in the reference."""
    n, k = 11, 8
    cd = _boundary_circuit(n, k)
    monkeypatch.setenv("QST_CAPACITY_GUARD_MIN", str(1 << k))
    with pytest.raises(ValueError, match="Enable staging") as err:
        E.build_circuit_fns(M.make_mesh(8, device="cpu"), cd, mode="window",
                            inplace=True)
    rmesh = RM.make_mesh(8)
    _, fn = RE.build_circuit_fns(rmesh, cd, mode="window", inplace=True,
                                 planar_io=True, dtype=jnp.complex64)
    with pytest.raises(ValueError, match="Enable staging") as rerr:
        fn(*RM.zero_state_planar_sharded(rmesh, n))
    assert str(err.value).split("[")[0] == str(rerr.value).split("[")[0]
