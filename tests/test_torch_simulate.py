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
from quantum_simulations_tpu_torch.ops import dense
from quantum_simulations_tpu_torch.ops import diag_kernels as dk
from quantum_simulations_tpu_torch.ops import pair_kernels as pq
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
    """The schedules that raised before the pair kernels and the crossing
    were ported now run and match the reference: qft(16)'s terminal
    BitPermOp (bitperm_cross) and non_stabilizer(12)'s PhysGateOps."""
    cfg = SimulatorConfig(mode="window", dtype="complex128")
    for cd in (rlib.qft(16), rlib.non_stabilizer(12)):
        np.testing.assert_allclose(api.simulate(cd, cfg, device=CPU), _ref(cd),
                                   atol=1e-10)


@pytest.mark.parametrize("kw,match", [
    # Fused mode runs (tests/test_torch_panel_mode.py); across four devices
    # it is the sharded tier, whose error names the mode.
    (dict(mode="fused", n_devices=4), "mode='fused'"),
    # The capacity tier runs (tests/test_torch_capacity.py); across four
    # devices it is the sharded tier, whose error names the tiers that run.
    (dict(mode="capacity", n_devices=4), "capacity"),
    # The sparse tier runs (tests/test_torch_sparse.py); the sharded
    # tier's error names it among the tiers that run.
    (dict(mode="window", n_devices=2), "sparse"),
    # The spill tier runs now (tests/test_torch_spill.py): the reference's
    # spill result (match None).
    (dict(mode="window", stripe_qubits=10, dtype="complex128"), None),
    (dict(mode="window", n_devices=4), "sharded"),
])
def test_unported_tiers_raise(kw, match):
    cd = rlib.non_stabilizer(14)
    if match is None:
        from quantum_simulations_tpu.api import simulate as rsimulate

        np.testing.assert_allclose(
            api.simulate(cd, SimulatorConfig(**kw), device=CPU),
            rsimulate(cd, SimulatorConfig(**kw)), atol=1e-10)
        return
    with pytest.raises(NotImplementedError, match=match):
        api.simulate(cd, SimulatorConfig(**kw), device=CPU)


def test_inplace_and_diag_epilogue_raise():
    """inplace=True (the capacity tier), which raised before, runs in
    place and equals the out-of-place run.  A MultiSwapOp, which raised
    before, is prepared and runs as one bitperm_swap pass, like the
    reference's multi-axis transpose."""
    from quantum_simulations_tpu_torch.circuit.panelize import MultiSwapOp

    cd = rlib.non_stabilizer(14)
    psi0 = _random_state(14, 4)
    re, im = convert.planes_from_numpy(psi0, CPU)
    fn = PS.build_window_circuit_fn(cd, dtype="complex128", planar_io=True,
                                    inplace=True, device=CPU)
    out = fn(re, im)
    assert out[0] is re and out[1] is im
    want = PS.simulate(cd, dtype="complex128", mode="window", device=CPU,
                       initial_state=psi0)
    np.testing.assert_allclose(convert.to_numpy(re, im), want.numpy(),
                               atol=1e-10, rtol=0)
    pairs = ((7, 9), (8, 12))
    (op, _), = PS.prepare_schedule([(MultiSwapOp(pairs), None)],
                                   torch.device(CPU), torch.float64)
    psi = _random_state(14, 9)
    bk.reset_counts()
    got = PS.apply_window_op(*convert.planes_from_numpy(psi, CPU), op)
    assert bk.PLAIN_CALLS["bitperm_swap"] == 1
    want = RS.apply_multiswap_planar(psi.real, psi.imag, pairs)
    np.testing.assert_array_equal(convert.to_numpy(*got),
                                  np.asarray(want[0]) + 1j * np.asarray(want[1]))


def _reset_all():
    for m in (pk, dk, bk, pq):
        m.reset_counts()
    dense.GATE_CALLS = 0


def test_cpu_run_uses_only_plain_twins():
    for cd, plain in (
            (rlib.non_stabilizer(18), {"positioned_panel": 3, "dual_panel": 2}),
            (rlib.qft(18), {"positioned_panel+diag": 2, "dual_panel": 1,
                            "bitperm_swap": 1, "bitperm_transpose": 1}),
            (rlib.qpe(17), {"dual_panel": 1, "positioned_panel": 4,
                            "lane_panel+diag": 1, "fused_diag": 3,
                            "mixed_pair": 7}),
            (rlib.deutsch_jozsa(18), {"dual_panel": 2, "positioned_panel": 2,
                                      "mixed_pair": 7, "pair_update": 4})):
        _reset_all()
        api.simulate(cd, SimulatorConfig(mode="window"), device=CPU)
        launches = {**pk.LAUNCHES, **dk.LAUNCHES, **bk.LAUNCHES, **pq.LAUNCHES}
        calls = {**pk.PLAIN_CALLS, **dk.PLAIN_CALLS, **bk.PLAIN_CALLS,
                 **pq.PLAIN_CALLS}
        assert not any(launches.values()), cd["number_of_qubits"]
        assert {k: v for k, v in calls.items() if v} == plain
        assert dense.GATE_CALLS == 0


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


PAIR_CIRCUITS = [("qpe", 17), ("qft_adder", 18), ("deutsch_jozsa", 18),
                 ("w_qft", 18), ("ghz_qft", 18), ("qft", 14), ("qft", 16),
                 ("non_stabilizer", 12), ("qnn", 18), ("ripple_adder", 18)]


@pytest.mark.parametrize("name,arg", PAIR_CIRCUITS,
                         ids=[f"{c}{a}" for c, a in PAIR_CIRCUITS])
def test_pair_and_swap_circuits_match_reference(name, arg):
    """Circuits with PhysGateOps, MultiSwapOps or a BitPermOp: qpe,
    qft_adder and deutsch_jozsa reach pair_update / mixed_pair and the
    multiswap, w_qft and ghz_qft mixed_low_pair, qft(14) and qft(16)
    bitperm_cross, qnn and ripple_adder the plain torch gate paths.
    From |0> and from a random state."""
    cd = getattr(rlib, name)(arg)
    n = cd["number_of_qubits"]
    cfg = SimulatorConfig(mode="window", dtype="complex128")
    np.testing.assert_allclose(api.simulate(cd, cfg, device=CPU), _ref(cd),
                               atol=1e-10)
    psi0 = _random_state(n, 7)
    got = PS.simulate(cd, dtype="complex128", mode="window", device=CPU,
                      initial_state=psi0)
    np.testing.assert_allclose(got.numpy(), _ref(cd, initial_state=psi0),
                               atol=1e-10)


def test_qft_without_bitperm_decomposition(monkeypatch):
    """QST_BITPERM_DECOMP=0 keeps qft(18)'s SWAP network one BitPermOp:
    its middle pairs through bitperm_swap, then bitperm_cross."""
    monkeypatch.setenv("QST_BITPERM_DECOMP", "0")
    cd = rlib.qft(18)
    psi0 = _random_state(18, 11)
    _reset_all()
    got = PS.simulate(cd, dtype="complex128", mode="window", device=CPU,
                      initial_state=psi0)
    assert bk.PLAIN_CALLS["bitperm_cross"] == 1
    np.testing.assert_allclose(got.numpy(), _ref(cd, initial_state=psi0),
                               atol=1e-10)


def test_reference_pair_schedule_on_port_executor():
    """qpe(17)'s op list from the reference's scheduler, carried across
    by ``convert``, on the port's executor."""
    cd = rlib.qpe(17)
    n = cd["number_of_qubits"]
    psi0 = _random_state(n, 13)
    ref_ops = RS.pair_panel_diag(compile_window_schedule(cd, diag_terms_only=True))
    assert any(type(op).__name__ == "MultiSwapOp" or
               type(op).__name__ == "PhysGateOp" for op, _ in ref_ops)
    re, im = convert.planes_from_numpy(psi0, CPU, torch.float64)
    for op, terms in convert.ops_from_reference(ref_ops):
        re, im = PS.apply_window_op(re, im, op, terms)
    np.testing.assert_allclose(convert.to_numpy(re, im),
                               _ref(cd, initial_state=psi0), atol=1e-10)
