"""The port's window-mode simulate against the JAX package's.

The JAX side runs as its own tests run it (CPU, interpret mode,
complex128 through x64); the port runs its plain torch twins on the CPU
(``device="cpu"``).  Same circuits, same seeded states.
"""
import numpy as np
import pytest
import torch

from quantum_simulations_tpu.circuit import library as rlib
from quantum_simulations_tpu.circuit.panelize import compile_window_schedule
from quantum_simulations_tpu.runtime import simulator as RS
from quantum_simulations_tpu_torch import SimulatorConfig, api, convert
from quantum_simulations_tpu_torch.ops import bitperm_kernels as bk
from quantum_simulations_tpu_torch.ops import diag_kernels as dk
from quantum_simulations_tpu_torch.ops import panel_kernels as pk
from quantum_simulations_tpu_torch.runtime import simulator as PS

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """pytest-xdist runs several workers on the machine's cores: numpy's
    and torch's thread pools then oversubscribe them, and the 128-wide
    panel products of these tests ran over 10x slower (174 s vs 11 s for
    tests/test_torch_schedule.py under 6 workers)."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _ref(cd, **kw):
    return np.asarray(RS.simulate(cd, dtype="complex128", mode="window", **kw))


def _random_state(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return psi / np.linalg.norm(psi)


@pytest.mark.parametrize("n", [14, 16, 18, 20])
def test_api_simulate_matches_reference_c128(n):
    cd = rlib.non_stabilizer(n)
    got = api.simulate(cd, SimulatorConfig(mode="window", dtype="complex128"),
                       device=CPU)
    assert isinstance(got, np.ndarray) and got.dtype == np.complex128
    np.testing.assert_allclose(got, _ref(cd), atol=1e-10)


@pytest.mark.parametrize("n", [16, 18])
def test_api_simulate_c64_within_2e5(n):
    cd = rlib.non_stabilizer(n)
    got = api.simulate(cd, SimulatorConfig(mode="window"), device=CPU)
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, _ref(cd), atol=2e-5)


@pytest.mark.parametrize("n", [16, 20])
def test_reference_schedule_on_port_executor(n):
    """The reference's exact op list and a random state, carried across
    by ``convert``, run through the port's executor."""
    cd = rlib.non_stabilizer(n)
    psi0 = _random_state(n, n)
    ref_ops = RS.pair_panel_diag(compile_window_schedule(cd, diag_terms_only=True))
    ops = convert.ops_from_reference(ref_ops)
    re, im = convert.planes_from_numpy(psi0, CPU, torch.float64)
    for op, terms in ops:
        re, im = PS.apply_window_op(re, im, op, terms)
    np.testing.assert_allclose(convert.to_numpy(re, im),
                               _ref(cd, initial_state=psi0), atol=1e-10)


def test_initial_state_and_planar_io():
    n = 16
    cd = rlib.non_stabilizer(n, depth=2, seed=3)
    psi0 = _random_state(n, 1)
    want = _ref(cd, initial_state=psi0)
    got = PS.simulate(cd, dtype="complex128", mode="window", device=CPU,
                      initial_state=psi0)
    assert got.dtype == torch.complex128 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10)
    fn = PS.build_window_circuit_fn(cd, dtype="complex128", planar_io=True,
                                    device=CPU)
    assert PS.build_window_circuit_fn(cd, dtype="complex128", planar_io=True,
                                      device=CPU) is fn  # cached
    re, im = fn(*convert.planes_from_numpy(psi0, CPU, torch.float64))
    np.testing.assert_allclose(convert.to_numpy(re, im), want, atol=1e-10)
    cfn = PS.build_window_circuit_fn(cd, dtype="complex128", device=CPU)
    np.testing.assert_allclose(cfn(torch.from_numpy(psi0)).numpy(), want,
                               atol=1e-10)


def test_segment_gates_matches_reference():
    cd = rlib.non_stabilizer(16)
    want = np.asarray(RS.simulate(cd, dtype="complex128", mode="window",
                                  segment_gates=40))
    got = PS.simulate(cd, dtype="complex128", mode="window", device=CPU,
                      segment_gates=40)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10)
    np.testing.assert_allclose(want, _ref(cd), atol=1e-10)


@pytest.mark.parametrize("name,n_parts", [
    ("non_stabilizer", 1), ("non_stabilizer", 5), ("qft", 3), ("ghz", 40)])
def test_partition_matches_reference_locality(name, n_parts):
    from quantum_simulations_tpu.circuit.dag import partition as rpartition
    from quantum_simulations_tpu_torch.circuit.dag import partition

    cd = getattr(rlib, name)(12)
    assert partition(cd, n_parts) == rpartition(cd, n_parts,
                                                strategy="locality")


def test_auto_mode_resolves_to_window():
    cd = rlib.non_stabilizer(16)
    got = api.simulate(cd, SimulatorConfig(mode="auto", dtype="complex128"),
                       device=CPU)
    np.testing.assert_allclose(got, _ref(cd), atol=1e-10)


def test_diag_op_raises_naming_the_op():
    """DiagOps run now; the op types still without a kernel raise and
    name the kernel they wait for: qft(16)'s terminal BitPermOp, and
    non_stabilizer(12)'s PhysGateOp."""
    cfg = SimulatorConfig(mode="window", dtype="complex128")
    with pytest.raises(NotImplementedError, match="BitPermOp.*bitperm_cross_planar"):
        api.simulate(rlib.qft(16), cfg, device=CPU)
    with pytest.raises(NotImplementedError, match="PhysGateOp"):
        api.simulate(rlib.non_stabilizer(12), cfg, device=CPU)


@pytest.mark.parametrize("kw,match", [
    (dict(mode="fused"), "mode='fused'"),
    (dict(mode="capacity"), "capacity"),
    (dict(mode="window", sparse=True), "sparse"),
    (dict(mode="window", stripe_qubits=10), "spill"),
    (dict(mode="window", n_devices=4), "sharded"),
])
def test_unported_tiers_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        api.simulate(rlib.non_stabilizer(14), SimulatorConfig(**kw), device=CPU)


def test_inplace_and_diag_epilogue_raise():
    """inplace=True still raises.  The diag epilogue runs now; a schedule
    with an op without a kernel (here a MultiSwapOp) raises when it is
    prepared, before any pass runs, and names the kernel it waits for."""
    from quantum_simulations_tpu_torch.circuit.panelize import MultiSwapOp

    cd = rlib.non_stabilizer(14)
    with pytest.raises(NotImplementedError, match="capacity"):
        PS.build_window_circuit_fn(cd, inplace=True, device=CPU)
    with pytest.raises(NotImplementedError,
                       match="MultiSwapOp.*apply_multiswap_planar"):
        PS.prepare_schedule([(MultiSwapOp(((7, 9), (8, 12))), None)],
                            torch.device(CPU), torch.float64)


def _reset_all():
    for m in (pk, dk, bk):
        m.reset_counts()


def test_cpu_run_uses_only_plain_twins():
    for name, plain in (
            ("non_stabilizer", {"positioned_panel": 3, "dual_panel": 2}),
            ("qft", {"positioned_panel+diag": 2, "dual_panel": 1,
                     "bitperm_swap": 1, "bitperm_transpose": 1})):
        _reset_all()
        api.simulate(getattr(rlib, name)(18), SimulatorConfig(mode="window"),
                     device=CPU)
        launches = {**pk.LAUNCHES, **dk.LAUNCHES, **bk.LAUNCHES}
        calls = {**pk.PLAIN_CALLS, **dk.PLAIN_CALLS, **bk.PLAIN_CALLS}
        assert not any(launches.values()), name
        assert {k: v for k, v in calls.items() if v} == plain, name


@pytest.mark.parametrize("name", ["qft", "qaoa_maxcut", "sycamore_like",
                                  "trotter_ising", "graph_state"])
def test_diag_and_bitperm_circuits_match_reference(name):
    """qft(18) reaches the positioned diag epilogue, bitperm_swap and
    bitperm_transpose; qaoa_maxcut(18) and sycamore_like(18) reach
    fused_diag and the dual panel; trotter_ising(18) and graph_state(18)
    are diagonal runs between panels as well.  Each from |0> and from a
    random state (from |0> a wrong phase on a control still 0 can
    hide)."""
    n = 18
    cd = getattr(rlib, name)(n)
    cfg = SimulatorConfig(mode="window", dtype="complex128")
    np.testing.assert_allclose(api.simulate(cd, cfg, device=CPU), _ref(cd),
                               atol=1e-10)
    psi0 = _random_state(n, 3)
    got = PS.simulate(cd, dtype="complex128", mode="window", device=CPU,
                      initial_state=psi0)
    np.testing.assert_allclose(got.numpy(), _ref(cd, initial_state=psi0),
                               atol=1e-10)


@pytest.mark.parametrize("name", ["qft", "qaoa_maxcut"])
def test_reference_diag_bitperm_schedule_on_port_executor(name):
    """The reference's op list with its diag epilogues, DiagOps and bit
    permutations, carried across by ``convert``."""
    n = 18
    cd = getattr(rlib, name)(n)
    psi0 = _random_state(n, 5)
    ref_ops = RS.pair_panel_diag(compile_window_schedule(cd, diag_terms_only=True))
    re, im = convert.planes_from_numpy(psi0, CPU, torch.float64)
    for op, terms in convert.ops_from_reference(ref_ops):
        re, im = PS.apply_window_op(re, im, op, terms)
    np.testing.assert_allclose(convert.to_numpy(re, im),
                               _ref(cd, initial_state=psi0), atol=1e-10)
