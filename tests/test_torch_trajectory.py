"""The port's trajectory tier against the JAX package's, on the CPU.

The JAX tier (``quantum_simulations_tpu.runtime.trajectory``, complex128
through x64), the port's (``device="cpu"``: the fused mode's plain torch
twins) and the port's copy of the numpy oracle consume the same uniform
draws in the same order, so a shared seed pins the trajectory: the same
outcomes and classical registers, states within 1e-12 (4 qubits) or
1e-10 (traj14, ``chip_smoke.traj_circuit(14)``, the card request's
circuit at 14 qubits).  The MIXED and TELEPORT circuits are those of
``tests/test_trajectory.py``.
"""
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from quantum_simulations_tpu import api as rapi
from quantum_simulations_tpu.__main__ import main as rmain
from quantum_simulations_tpu.circuit.import_qasm import qasm_to_dict as rqasm
from quantum_simulations_tpu.ops import observables as RO
from quantum_simulations_tpu.ops import sampling as RS
from quantum_simulations_tpu.runtime import trajectory as RT
from quantum_simulations_tpu.utils.config import SimulatorConfig as RConfig
from quantum_simulations_tpu_torch import SimulatorConfig, api, oracle
from quantum_simulations_tpu_torch.__main__ import main
from quantum_simulations_tpu_torch.circuit.import_qasm import (
    QasmError, qasm_to_dict)
from quantum_simulations_tpu_torch.ops import observables as PO
from quantum_simulations_tpu_torch.ops import sampling as PS
from quantum_simulations_tpu_torch.runtime.trajectory import (
    simulate_trajectory, split_segments)

CPU = "cpu"

TELEPORT = """
OPENQASM 2.0;
include "qelib1.inc";
qreg q[3];
creg m0[1];
creg m1[1];
// entangle q1,q2
h q[1];
cx q[1],q[2];
// Bell-measure source against q1
cx q[0],q[1];
h q[0];
measure q[0] -> m0[0];
measure q[1] -> m1[0];
// corrections on q2
if(m1==1) x q[2];
if(m0==1) z q[2];
"""

MIXED = """
OPENQASM 2.0;
qreg q[4];
creg c[2];
h q[0];
cx q[0],q[1];
measure q[0] -> c[0];
if(c==1) x q[2];
reset q[1];
h q[1];
rz(pi/3) q[2];
measure q[1] -> c[1];
if(c==3) z q[3];
h q[3];
cp(pi/4) q[2],q[3];
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """One thread per xdist worker (as tests/test_torch_simulate.py)."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _meas(q, creg="c", cbit=0):
    return {"qubits": [q], "gate": "MEASURE",
            "params": {"creg": creg, "cbit": cbit}}


def _both(cd, seed, **kw):
    """(port's, JAX tier's) (psi, cregs, outcomes), complex128."""
    got = simulate_trajectory(cd, seed=seed, dtype="complex128", device=CPU,
                              **kw)
    want = RT.simulate_trajectory(cd, seed=seed, dtype=jnp.complex128, **kw)
    return got, want


@pytest.mark.parametrize("seed", range(8))
def test_mixed_matches_reference_and_oracle(seed):
    cd = qasm_to_dict(MIXED, nonunitary="trajectory")
    assert cd == rqasm(MIXED, nonunitary="trajectory")
    (psi, cregs, outs), (rpsi, rcregs, routs) = _both(cd, seed)
    psi_o, cregs_o, outs_o = oracle.simulate_trajectory(cd, seed=seed)
    assert outs == routs == outs_o
    assert cregs == rcregs == cregs_o
    assert psi.dtype == torch.complex128 and psi.device.type == "cpu"
    np.testing.assert_allclose(psi.numpy(), np.asarray(rpsi), atol=1e-12, rtol=0)
    np.testing.assert_allclose(psi.numpy(), psi_o, atol=1e-12, rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_teleport_matches_reference(seed):
    cd = qasm_to_dict(TELEPORT, nonunitary="trajectory")
    (psi, cregs, outs), (rpsi, rcregs, routs) = _both(cd, seed)
    assert outs == routs and cregs == rcregs
    np.testing.assert_allclose(psi.numpy(), np.asarray(rpsi), atol=1e-12, rtol=0)


def test_unfused_matches_reference():
    cd = qasm_to_dict(MIXED, nonunitary="trajectory")
    (psi, _, outs), (rpsi, _, routs) = _both(cd, 3, use_fusion=False,
                                            panel_width=None)
    psi_o, _, outs_o = oracle.simulate_trajectory(cd, seed=3)
    assert outs == routs == outs_o
    np.testing.assert_allclose(psi.numpy(), np.asarray(rpsi), atol=1e-12, rtol=0)
    np.testing.assert_allclose(psi.numpy(), psi_o, atol=1e-12, rtol=0)


@pytest.mark.parametrize("seed", [0, 3])
def test_traj14_matches_reference(seed):
    """The slice as a whole: traj28's composition at 14 qubits (223 + 67
    gates, three MEASUREs, a RESET, two conditions) through the fused
    segments, within 1e-10 of the JAX tier in complex128."""
    cd = chip_smoke.traj_circuit(14)
    (psi, cregs, outs), (rpsi, rcregs, routs) = _both(cd, seed)
    assert outs == routs and cregs == rcregs and len(outs) == 4
    np.testing.assert_allclose(psi.numpy(), np.asarray(rpsi), atol=1e-10, rtol=0)
    # the last MEASURE leaves its qubit collapsed onto the outcome
    assert PS.qubit_probability(psi, 10) == pytest.approx(outs[-1], abs=1e-12)


def test_complex64_follows_the_float64_trajectory():
    cd = chip_smoke.traj_circuit(14)
    psi, cregs, outs = simulate_trajectory(cd, seed=3, device=CPU)
    psi64, cregs64, outs64 = simulate_trajectory(cd, seed=3,
                                                 dtype="complex128", device=CPU)
    assert psi.dtype == torch.complex64
    assert outs == outs64 and cregs == cregs64
    assert float(torch.linalg.vector_norm(psi.to(torch.complex128) - psi64)) <= 1e-5


def test_split_segments_matches_reference():
    cd = chip_smoke.traj_circuit(14)
    assert split_segments(cd["gates"]) == RT.split_segments(cd["gates"])


@pytest.mark.parametrize("seed", range(6))
def test_teleportation_identity(seed):
    """Teleport a random 1q state: q2 must equal the input state for
    EVERY measurement branch (collapse and conditions checked without
    the twin)."""
    rng = np.random.default_rng(99)
    v = rng.standard_normal(2) + 1j * rng.standard_normal(2)
    v /= np.linalg.norm(v)
    init = np.zeros(8, dtype=np.complex128)
    init[0], init[1] = v[0], v[1]
    cd = qasm_to_dict(TELEPORT, nonunitary="trajectory")
    psi, _, outs = simulate_trajectory(cd, seed=seed, dtype="complex128",
                                       initial_state=init, device=CPU)
    got = psi.numpy().reshape(2, 2, 2)[:, outs[1], outs[0]]
    k = np.argmax(np.abs(v))
    phase = got[k] / v[k]
    np.testing.assert_allclose(got, v * phase, atol=1e-12)
    assert abs(abs(phase) - 1) < 1e-12


def test_reset_reuses_ancilla():
    cd = {"number_of_qubits": 2, "gates": [
        {"qubits": [1], "gate": "X"},
        {"qubits": [1], "gate": "RESET"},
        {"qubits": [0], "gate": "H"},
        {"qubits": [0, 1], "gate": "CNOT"},
    ]}
    psi, _, outs = simulate_trajectory(cd, seed=0, dtype="complex128",
                                       device=CPU)
    assert outs == [1]
    expect = np.zeros(4, dtype=np.complex128)
    expect[0] = expect[3] = 1 / math.sqrt(2)
    np.testing.assert_allclose(psi.numpy(), expect, atol=1e-12)


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_deterministic_measurement_branch(dtype):
    """|0>, P(1) = 0: the outcome is 0 for every draw and the state stays."""
    cd = {"number_of_qubits": 1, "gates": [_meas(0)]}
    for seed in range(4):
        psi, cregs, outs = simulate_trajectory(cd, seed=seed, dtype=dtype,
                                               device=CPU)
        assert outs == [0] and cregs == {"c": 0}
        np.testing.assert_allclose(psi.numpy(), [1.0, 0.0], atol=1e-6)


def test_zero_probability_collapse_follows_reference():
    """Collapsing onto a branch of zero weight divides by rsqrt(0) in the
    reference's tier (NaN), where the oracle raises: the port follows
    the tier."""
    re = torch.tensor([1.0, 0.0], dtype=torch.float64)
    im = torch.zeros(2, dtype=torch.float64)
    PS.collapse_planar_(re, im, 0, 1)
    assert bool(torch.isnan(re).all()) and bool(torch.isnan(im).all())


def test_outcome_distribution():
    cd = {"number_of_qubits": 1,
          "gates": [{"qubits": [0], "gate": "H"}, _meas(0)]}
    outs = [simulate_trajectory(cd, seed=s, device=CPU)[2][0] for s in range(64)]
    ref = [RT.simulate_trajectory(cd, seed=s)[2][0] for s in range(64)]
    assert outs == ref and 10 < sum(outs) < 54


# ---------------------------------------------------------------------------
# api and CLI
# ---------------------------------------------------------------------------

def test_api_routes_trajectory():
    cd = qasm_to_dict(MIXED, nonunitary="trajectory")
    cfg = SimulatorConfig(dtype="complex128", log_level="", trajectory_seed=5)
    psi = api.simulate(cd, cfg, device=CPU)
    psi_o, _, _ = oracle.simulate_trajectory(cd, seed=5)
    assert isinstance(psi, np.ndarray)
    np.testing.assert_allclose(psi, psi_o, atol=1e-12)
    np.testing.assert_allclose(psi, np.asarray(rapi.simulate(
        cd, RConfig(dtype="complex128", log_level="", trajectory_seed=5))),
        atol=1e-12)
    assert np.array_equal(psi, api.simulate(cd, cfg, device=CPU))
    # the trajectory route comes first, whatever else the config asks
    other = SimulatorConfig(dtype="complex128", trajectory_seed=5,
                            mode="capacity", n_devices=4, stripe_qubits=2)
    np.testing.assert_allclose(api.simulate(cd, other, device=CPU), psi_o,
                               atol=1e-12)


@pytest.mark.parametrize("seed", [0, 2])
def test_api_sample_of_a_trajectory(seed):
    """The final MEASURE of traj14 leaves q10 collapsed: every shot reads
    the recorded outcome there."""
    cd = chip_smoke.traj_circuit(14)
    cfg = SimulatorConfig(trajectory_seed=seed)
    _, _, outs = simulate_trajectory(cd, seed=seed, device=CPU)
    bits = api.sample(cd, 64, seed=1, config=cfg, device=CPU)
    assert bits.shape == (64, 14) and bits.dtype == np.int8
    assert set(bits[:, 10].tolist()) == {outs[-1]}


def test_top_level_sample_and_oracle():
    import quantum_simulations_tpu_torch as qst

    cd = qasm_to_dict(TELEPORT, nonunitary="trajectory")
    bits = qst.sample(cd, 16, seed=0, device=CPU)
    assert bits.shape == (16, 3)
    assert qst.oracle.simulate_trajectory is oracle.simulate_trajectory


@pytest.fixture
def mixed(tmp_path):
    path = tmp_path / "mixed.qasm"
    path.write_text(MIXED)
    return path


@pytest.mark.parametrize("seed", [0, 3])
def test_cli_trajectory_matches_reference(capsys, mixed, seed):
    argv = ["run", str(mixed), "--trajectory", "--trajectory-seed", str(seed),
            "--top", "4"]
    assert rmain(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["n_amplitudes"] == want["n_amplitudes"] == 16
    assert abs(got["norm2"] - want["norm2"]) <= 1e-6
    # rank by rank the same probability; ties may list other indices
    # (the port lists them by index, the reference as its argsort leaves
    # them), so the indices are held as a set of those above 0
    assert all(abs(p - q) <= 1e-6 for (_, p), (_, q) in zip(got["top"],
                                                             want["top"]))
    assert ({i for i, p in got["top"] if p > 1e-6}
            == {i for i, p in want["top"] if p > 1e-6})


def test_cli_without_trajectory_refuses_nonunitary_qasm(mixed):
    with pytest.raises(QasmError):
        main(["run", str(mixed), "--device", "cpu"])


# ---------------------------------------------------------------------------
# readout helpers against the reference's
# ---------------------------------------------------------------------------

def _state(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return psi / np.linalg.norm(psi)


@pytest.mark.parametrize("n,seed", [(5, 1), (8, 2)])
def test_normalize_project_fidelity(n, seed):
    a, b = _state(n, seed), _state(n, seed + 10)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(PS.normalize(3 * ta).numpy(),
                               np.asarray(RS.normalize(jnp.asarray(3 * a))),
                               atol=1e-12)
    for q in range(n):
        for v in (0, 1):
            for renorm in (True, False):
                np.testing.assert_allclose(
                    PS.project(ta, q, v, renormalize=renorm).numpy(),
                    np.asarray(RS.project(jnp.asarray(a), q, v,
                                          renormalize=renorm)), atol=1e-12)
    assert abs(PS.fidelity(ta, tb) - float(RS.fidelity(jnp.asarray(a),
                                                       jnp.asarray(b)))) <= 1e-12


def test_measure_qubit_collapses():
    psi = torch.from_numpy(_state(6, 4))
    gen = torch.Generator().manual_seed(0)
    outs = []
    for _ in range(40):
        out, post = PS.measure_qubit(psi, 2, gen)
        outs.append(out)
        np.testing.assert_allclose(post.numpy(), PS.project(psi, 2, out).numpy(),
                                   atol=0)
        assert PS.qubit_probability(post, 2) == pytest.approx(out, abs=1e-12)
    assert 0 < sum(outs) < 40


def test_expectation_sum_and_maxcut():
    n = 7
    a = _state(n, 5)
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    terms = [(0.5, "XZIIYII"), (-1.25, {0: "Z", 6: "Z"}), (2.0, "IIXXIII"),
             (0.75, "")]
    assert abs(PO.expectation_sum(ta, terms)
               - float(RO.expectation_sum(ja, terms))) <= 1e-12
    edges = [(0, 1), (1, 2), (2, 6), (3, 5)]
    for w in (None, [1.0, 0.5, 2.0, 1.5]):
        assert abs(PO.maxcut_energy(ta, edges, w)
                   - float(RO.maxcut_energy(ja, edges, w))) <= 1e-12
    assert PO.expectation_sum(ta, []) == 0.0
