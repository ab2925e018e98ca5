"""The port's panel mode (the CLI's default) and fused mode (the API's
default) against the JAX package's, on the CPU.

Schedules: ``compile_panel_schedule`` and ``compile_steps`` equal to the
reference's, op for op (numpy only).  Kernels: the plain twins of
``tiled_transpose`` and of the lane panel's rotated store against the JAX
entries in interpret mode, and ``dense.rotate_bits_right`` against the
reference's.  Whole circuits: ``simulate(mode="panel" | "fused" |
"auto")`` below n = 14 against the JAX ``simulate``, dense-tier readout
through ``api``, samples held statistically (4.5 sigma, as
tests/test_torch_capacity.py), and a host-only dry run of the n = 28
requests that pins the launch counts ``chip_smoke.py`` asserts.  float64
planes (complex128) on both sides; tolerance 1e-10 unless a case says
otherwise (round-off of 128-term sums is ~1e-15).
"""
import gc
import importlib.util
import math
import weakref
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_simulations_tpu import api as rapi
from quantum_simulations_tpu.circuit import library as rlib
from quantum_simulations_tpu.circuit.fusion import compile_steps as rcompile_steps
from quantum_simulations_tpu.circuit.panelize import (
    compile_panel_schedule as rcompile_panel,
)
from quantum_simulations_tpu.ops import dense as rdense
from quantum_simulations_tpu.ops import pallas_kernels as rk
from quantum_simulations_tpu.runtime import simulator as RS
from quantum_simulations_tpu_torch import SimulatorConfig, api
from quantum_simulations_tpu_torch.circuit.fusion import compile_steps
from quantum_simulations_tpu_torch.circuit.panelize import (
    PanelOp, RotateOp, compile_panel_schedule, panel_stats,
)
from quantum_simulations_tpu_torch.ops import bitperm_kernels as bk
from quantum_simulations_tpu_torch.ops import dense
from quantum_simulations_tpu_torch.ops import diag_kernels as dk
from quantum_simulations_tpu_torch.ops import observables
from quantum_simulations_tpu_torch.ops import pair_kernels as pq
from quantum_simulations_tpu_torch.ops import panel_kernels as pk
from quantum_simulations_tpu_torch.ops import sampling
from quantum_simulations_tpu_torch.runtime import simulator as PS

CPU = "cpu"
ATOL = 1e-10
ROOT = Path(__file__).resolve().parent.parent
MODS = (pk, dk, bk, pq)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """One thread per xdist worker (as tests/test_torch_simulate.py)."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _state(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return psi / np.linalg.norm(psi)


def _unitary(dim, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim))
                        + 1j * rng.standard_normal((dim, dim)))
    return q


def _planes(psi):
    return torch.from_numpy(psi.real.copy()), torch.from_numpy(psi.imag.copy())


def _numpy(planes):
    return planes[0].numpy() + 1j * planes[1].numpy()


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _ccx_circuit(n):
    """3-qubit gates across the lane window and inside it."""
    gates = [{"qubits": [q], "gate": "H"} for q in range(n)]
    gates += [{"qubits": [0, 1, n - 1], "gate": "CCX"},
              {"qubits": [2, 3, 4], "gate": "CCX"},
              {"qubits": [1], "gate": "T"},
              {"qubits": [n - 2, 5, 0], "gate": "CCX"},
              {"qubits": [3, n - 1], "gate": "CNOT"},
              {"qubits": [n - 3, 2, 6], "gate": "CCX"}]
    return {"number_of_qubits": n, "gates": gates}


# The circuit families held to the reference: name -> circuit at n.
FAMILIES = {
    "nonstab": lambda n: rlib.non_stabilizer(n),
    "qft": lambda n: rlib.qft(n),
    "qaoa": lambda n: rlib.qaoa_maxcut(n),
    "qpe": lambda n: rlib.qpe(n - 1),
    "ghz": lambda n: rlib.ghz(n),
    "qft_adder": lambda n: rlib.qft_adder(n),
    "hadamard_wall": lambda n: rlib.hadamard_wall(n),
}


# ---------------------------------------------------------------------------
# Schedules, op for op
# ---------------------------------------------------------------------------

def _same_op(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in ("r", "qubits", "name", "n_fused", "width"):
        assert getattr(a, f, None) == getattr(b, f, None), f
    for f in ("W", "U"):
        if hasattr(b, f):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("n", [12, 20, 28])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_panel_schedule_matches_reference(family, n):
    cd = FAMILIES[family](n)
    ops, shift = compile_panel_schedule(cd)
    want, want_shift = rcompile_panel(cd)
    assert shift == want_shift and len(ops) == len(want)
    for a, b in zip(ops, want):
        _same_op(a, b)


@pytest.mark.parametrize("n", [3, 7, 9])
def test_panel_schedule_small_states(n):
    """n <= 7: one panel of width n; n = 9: a 128-wide window."""
    cd = rlib.qft(n)
    ops, shift = compile_panel_schedule(cd)
    want, want_shift = rcompile_panel(cd)
    assert shift == want_shift and len(ops) == len(want)
    for a, b in zip(ops, want):
        _same_op(a, b)
    from quantum_simulations_tpu.circuit.panelize import panel_stats as rstats

    assert panel_stats(cd) == rstats(cd)


@pytest.mark.parametrize("kw", [dict(), dict(use_fusion=False),
                                dict(panel_width=None), dict(panel_width=4),
                                dict(max_levels_per_step=2)],
                         ids=["default", "nofusion", "nopanel", "width4",
                              "levels2"])
@pytest.mark.parametrize("family", ["nonstab", "qft", "qpe", "ghz", "ccx"])
def test_compile_steps_matches_reference(family, kw):
    n = 13
    cd = _ccx_circuit(n) if family == "ccx" else FAMILIES[family](n)
    kw = {"panel_width": 7, **kw}
    steps = compile_steps(cd, k=n, **kw)
    want = rcompile_steps(cd, k=n, **kw)
    assert len(steps) == len(want)
    for s, w in zip(steps, want):
        assert s.level_indices == w.level_indices
        assert len(s.local_ops) == len(w.local_ops)
        assert len(s.nonlocal_ops) == len(w.nonlocal_ops)
        for a, b in zip(s.local_ops + s.nonlocal_ops, w.local_ops + w.nonlocal_ops):
            _same_op(a, b)


def test_fusion_stats_matches_reference():
    from quantum_simulations_tpu.circuit.fusion import fusion_stats as rstats
    from quantum_simulations_tpu_torch.circuit.fusion import fusion_stats

    for cd in (rlib.qft(12), rlib.non_stabilizer(14), _ccx_circuit(10)):
        n = cd["number_of_qubits"]
        assert fusion_stats(cd, k=n) == rstats(cd, k=n)
        assert fusion_stats(cd, k=n, panel_width=7) == rstats(cd, k=n,
                                                              panel_width=7)


# ---------------------------------------------------------------------------
# Rotations and the two kernels' twins
# ---------------------------------------------------------------------------

def test_rotation_steps_match_reference():
    for n in range(1, 34):
        for r in range(-1, n + 2):
            assert dense._rotation_steps(r, n) == rdense._rotation_steps(r, n)


@pytest.mark.parametrize("n", [10, 16, 20])
def test_rotate_bits_right_matches_reference(n):
    psi = _state(n, n)
    x = torch.from_numpy(psi)
    for r in range(n + 1):
        want = np.asarray(rdense.rotate_bits_right(jnp.asarray(psi), r))
        assert np.array_equal(dense.rotate_bits_right(x, r).numpy(), want), r


@pytest.mark.parametrize("rows,cols", [(128, 256), (256, 128)])
def test_tiled_transpose_matches_reference(rows, cols):
    psi = _state(15, rows)
    got = bk.tiled_transpose(*_planes(psi), rows, cols)
    for p, x in zip(got, (psi.real, psi.imag)):
        want = np.asarray(rk.tiled_transpose(jnp.asarray(x), rows, cols,
                                             interpret=True)).reshape(-1)
        assert np.array_equal(p.numpy(), want)


def test_tiled_transpose_counts_and_checks_its_view():
    psi = _state(9, 1)
    bk.reset_counts()
    got = bk.tiled_transpose(*_planes(psi), 8, 64)
    assert bk.PLAIN_CALLS["tiled_transpose"] == 1
    assert not bk.LAUNCHES["tiled_transpose"]
    assert np.array_equal(_numpy(got), psi.reshape(8, 64).T.reshape(-1))
    with pytest.raises(ValueError, match="not a view"):
        bk.tiled_transpose(*_planes(psi), 8, 32)


@pytest.mark.parametrize("n", [10, 12])
def test_lane_panel_rotate_matches_reference(n):
    psi, W = _state(n, n + 1), _unitary(128, n)
    pk.reset_counts()
    got = _numpy(pk.lane_panel(*_planes(psi), W, rotate=True))
    assert pk.PLAIN_CALLS["lane_panel+rotate"] == 1
    re, im = rk.panel_apply_planar(jnp.asarray(psi.real), jnp.asarray(psi.imag),
                                   W, rotate=True, interpret=True, block_rows=2)
    _close(got, np.asarray(re) + 1j * np.asarray(im))
    flat = pk.lane_panel_plain(*_planes(psi), W)
    _close(got, _numpy(tuple(dense.rotate_bits_right(p, 7) for p in flat)))


def test_lane_panel_rotate_rules():
    """No in-place rotate (the reference asserts); with diag_terms the
    rotated panel, then the diag run on the rotated result."""
    psi, W = _state(10, 3), _unitary(128, 4)
    with pytest.raises(ValueError, match="cannot rotate"):
        pk.lane_panel(*_planes(psi), W, rotate=True, inplace=True)
    terms = ((( 0, 9), 0.7), ((3,), -1.2), ((), 0.4))
    got = _numpy(pk.lane_panel(*_planes(psi), W, rotate=True, diag_terms=terms))
    re, im = rk.panel_apply_planar(jnp.asarray(psi.real), jnp.asarray(psi.imag),
                                   W, rotate=True, interpret=True, block_rows=2,
                                   diag_terms=terms)
    _close(got, np.asarray(re) + 1j * np.asarray(im))


# ---------------------------------------------------------------------------
# simulate: panel, fused and auto against the JAX simulate
# ---------------------------------------------------------------------------

SIM_CIRCUITS = {**{k: (lambda n, f=f: f(n)) for k, f in FAMILIES.items()},
                "sycamore": lambda n: rlib.sycamore_like(n),
                "ccx": _ccx_circuit}


def _ref(cd, mode, **kw):
    return np.asarray(RS.simulate(cd, dtype="complex128", mode=mode, **kw))


@pytest.mark.parametrize("mode", ["panel", "fused"])
@pytest.mark.parametrize("name", list(SIM_CIRCUITS))
def test_simulate_matches_reference(name, mode):
    n = 11
    cd = SIM_CIRCUITS[name](n)
    cfg = SimulatorConfig(mode=mode, dtype="complex128")
    _close(api.simulate(cd, cfg, device=CPU), _ref(cd, mode))
    psi0 = _state(n, 5)
    got = PS.simulate(cd, dtype="complex128", mode=mode, device=CPU,
                      initial_state=psi0)
    _close(got.numpy(), _ref(cd, mode, initial_state=psi0))


@pytest.mark.parametrize("n", [5, 8, 13])
def test_default_config_and_auto_match_reference(n):
    """SimulatorConfig() (fused) and mode="auto" below n = 14 (fused too)
    instead of raising; n = 5 is a state inside one lane window."""
    cd = rlib.non_stabilizer(n)
    want = _ref(cd, "fused")
    _close(api.simulate(cd, SimulatorConfig(dtype="complex128"), device=CPU), want)
    _close(api.simulate(cd, SimulatorConfig(mode="auto", dtype="complex128"),
                        device=CPU), want)
    _close(api.simulate(cd, SimulatorConfig(mode="panel", dtype="complex128"),
                        device=CPU), _ref(cd, "panel"))


@pytest.mark.parametrize("kw", [dict(use_fusion=False), dict(panel_width=None),
                                dict(panel_width=3)],
                         ids=["nofusion", "nopanel", "width3"])
def test_fused_options_match_reference(kw):
    cd = rlib.qft_adder(12)
    got = PS.simulate(cd, dtype="complex128", mode="fused", device=CPU, **kw)
    _close(got.numpy(), _ref(cd, "fused", **kw))


@pytest.mark.parametrize("mode", ["panel", "fused"])
def test_segment_gates_matches_reference(mode):
    cd = rlib.non_stabilizer(12)
    got = PS.simulate(cd, dtype="complex128", mode=mode, device=CPU,
                      segment_gates=30)
    _close(got.numpy(), _ref(cd, mode, segment_gates=30))


def test_complex64_within_2e5():
    cd = rlib.qft(13)
    got = api.simulate(cd, SimulatorConfig(mode="panel"), device=CPU)
    assert got.dtype == np.complex64
    _close(got, _ref(cd, "panel"), 2e-5)


# ---------------------------------------------------------------------------
# The executor: the peephole, the counts, the release of planes
# ---------------------------------------------------------------------------

def test_peephole_takes_only_panel_then_rotate_by_7():
    W = np.eye(128)
    ops = [PanelOp(W, 1), RotateOp(7), PanelOp(W, 1), RotateOp(13),
           PanelOp(np.eye(64), 1), RotateOp(7), RotateOp(7), PanelOp(W, 1)]
    got = PS.pair_panel_rotate(ops)
    assert [(type(o).__name__, r) for o, r in got] == [
        ("PanelOp", True), ("PanelOp", False), ("RotateOp", False),
        ("PanelOp", False), ("RotateOp", False), ("RotateOp", False),
        ("PanelOp", False)]
    assert all(not r for _, r in PS.pair_panel_rotate(ops, enabled=False))


def test_panel_schedule_appends_the_unrotation_in_steps():
    """ghz(28): the final un-rotation by 4 is two transposes (11, 21),
    after the last panel, never swallowed by the peephole."""
    cd = rlib.ghz(28)
    ops, shift = compile_panel_schedule(cd)
    items = PS.panel_schedule(cd)
    assert shift == 24 and dense._rotation_steps(28 - shift, 28) == [11, 21]
    assert [(type(o).__name__, getattr(o, "r", None), r) for o, r in items[-3:]] == [
        ("PanelOp", None, False), ("RotateOp", 11, False), ("RotateOp", 21, False)]
    rot = sum(r for _, r in items)
    assert rot == sum(1 for a, b in zip(ops, ops[1:]) if isinstance(a, PanelOp)
                      and isinstance(b, RotateOp) and b.r == 7)


def test_final_unrotation_by_7_is_never_swallowed(monkeypatch):
    """A last 128-wide panel before an un-rotation by exactly 7 stays a
    plain panel: the un-rotation is its own pass, as the reference runs
    it."""
    monkeypatch.setattr(PS, "compile_panel_schedule",
                        lambda cd, window=7: ([PanelOp(np.eye(128), 1)], 13))
    items = PS.panel_schedule(rlib.ghz(20))
    assert [(type(o).__name__, getattr(o, "r", None), r) for o, r in items] == [
        ("PanelOp", None, False), ("RotateOp", 7, False)]


def test_unfused_rotation_gives_the_same_state():
    """The panel and the rotation by 7 as two passes (the reference's
    executor) give the rotated store's state."""
    cd = rlib.non_stabilizer(13)
    psi0 = _state(13, 2)
    want = PS.simulate(cd, dtype="complex128", mode="panel", device=CPU,
                       initial_state=psi0).numpy()
    items = PS.panel_schedule(cd, fuse_rotate=False)
    assert not any(r for _, r in items)
    body = PS.run_passes(PS.prepare_passes(items, torch.device(CPU),
                                           torch.float64))
    got = _numpy(body([torch.from_numpy(psi0.real.copy()),
                       torch.from_numpy(psi0.imag.copy())]))
    _close(got, want)


def _reset_all():
    for m in MODS:
        m.reset_counts()
    dense.GATE_CALLS = 0


def _plain_calls():
    return {k: v for m in MODS for k, v in m.PLAIN_CALLS.items() if v}


def test_cpu_run_uses_only_plain_twins():
    cd = rlib.non_stabilizer(12)
    _reset_all()
    PS.simulate(cd, mode="panel", device=CPU)
    assert not any(v for m in MODS for v in m.LAUNCHES.values())
    items = PS.panel_schedule(cd)
    assert _plain_calls() == {
        "lane_panel+rotate": sum(r for _, r in items),
        "lane_panel": sum(1 for o, r in items if isinstance(o, PanelOp) and not r),
        "tiled_transpose": sum(1 for o, _ in items if isinstance(o, RotateOp))}
    assert dense.GATE_CALLS == 0


def test_panel_run_releases_the_previous_planes(monkeypatch):
    """Out of place, each pass drops its input: the planes handed to the
    run are gone once the second pass starts (the card then holds 4
    planes, not 6)."""
    cd = rlib.non_stabilizer(12)
    fn = PS.build_panel_circuit_fn(cd, dtype="complex128", planar_io=True,
                                   device=CPU)
    state = [torch.zeros(1 << 12, dtype=torch.float64),
             torch.zeros(1 << 12, dtype=torch.float64)]
    state[0][0] = 1
    first = weakref.ref(state[0])
    seen = []
    real = PS.apply_panel_op

    def spy(re, im, op, rotated=False, **kw):
        gc.collect()
        seen.append(first() is None)
        return real(re, im, op, rotated, **kw)

    monkeypatch.setattr(PS, "apply_panel_op", spy)
    re, im = fn.consume(state)
    assert state == [] and seen[0] is False and all(seen[1:])
    _close(_numpy((re, im)), _ref(cd, "panel"))


def test_cache_keys_differ_by_mode():
    cd = rlib.qft(10)
    fns = {PS.build_panel_circuit_fn(cd, device=CPU),
           PS.build_circuit_fn(cd, device=CPU),
           PS.build_window_circuit_fn(cd, device=CPU)}
    assert len(fns) == 3
    assert PS.build_panel_circuit_fn(cd, device=CPU) in fns
    assert PS.build_circuit_fn(cd, device=CPU, panel_width=4) not in fns


# ---------------------------------------------------------------------------
# Dense-tier readout through api
# ---------------------------------------------------------------------------

DENSE = SimulatorConfig(mode="panel", dtype="complex128")


@pytest.mark.parametrize("qubits", [[0], [3, 9], [1, 4, 7, 10]])
def test_expectation_z_matches_reference(qubits):
    cd = rlib.random_circuit(11, 60, seed=4)
    want = rapi.expectation_z(cd, qubits, DENSE)
    _close(api.expectation_z(cd, qubits, DENSE, device=CPU), want)
    _close(api.expectation_z(cd, qubits, SimulatorConfig(dtype="complex128"),
                             device=CPU), want)


@pytest.mark.parametrize("pauli", ["XZIY", {0: "Y", 5: "X", 10: "Z"}, "III"])
def test_expectation_pauli_matches_reference(pauli):
    cd = rlib.random_circuit(11, 60, seed=6)
    want = rapi.expectation_pauli(cd, pauli, DENSE)
    _close(api.expectation_pauli(cd, pauli, DENSE, device=CPU), want)
    psi = torch.from_numpy(api.simulate(cd, DENSE, device=CPU))
    _close(observables.expectation_pauli(psi, pauli), want)


def test_dense_readout_functions_match_reference():
    from quantum_simulations_tpu.ops import sampling as rsampling

    psi = _state(12, 8)
    x = torch.from_numpy(psi)
    jx = jnp.asarray(psi)
    _close(sampling.probabilities(x).numpy(),
           np.asarray(rsampling.probabilities(jx)))
    _close(sampling.norm(x), float(rsampling.norm(jx)))
    for q in (0, 6, 11):
        _close(sampling.qubit_probability(x, q),
               float(rsampling.qubit_probability(jx, q)))
    _close(sampling.expectation_z(x, [2, 7]),
           float(rsampling.expectation_z(jx, [2, 7])))
    planes = (x.real.contiguous(), x.imag.contiguous())
    _close(sampling.expectation_z(planes, [2, 7]), sampling.expectation_z(x, [2, 7]))


def _bound(p: float, shots: int, sigmas: float = 4.5) -> float:
    return sigmas * math.sqrt(p * (1 - p) / shots)


def test_api_sample_ghz():
    shots = 4000
    bits = api.sample(rlib.ghz(12), shots, seed=3, config=DENSE, device=CPU)
    assert bits.shape == (shots, 12) and bits.dtype == np.int8
    rowsum = bits.sum(axis=1)
    assert set(rowsum.tolist()) <= {0, 12}
    assert abs((rowsum == 12).mean() - 0.5) < _bound(0.5, shots)


def test_api_sample_marginals_and_seed():
    """Each qubit's sampled frequency against its exact probability from
    the JAX state, within 4.5 sigma; the same seed draws the same bits."""
    cd = rlib.random_circuit(10, 80, seed=11)
    cfg = SimulatorConfig(dtype="complex128")
    want = np.abs(_ref(cd, "fused")) ** 2
    shots = 6000
    bits = api.sample(cd, shots, seed=5, config=cfg, device=CPU)
    idx = np.arange(want.size)
    for q in range(10):
        p1 = float(want[(idx >> q) & 1 == 1].sum())
        assert abs(bits[:, q].mean() - p1) < _bound(p1, shots) + 1e-12, q
    again = api.sample(cd, shots, seed=5, config=cfg, device=CPU)
    np.testing.assert_array_equal(again, bits)
    assert not np.array_equal(again, api.sample(cd, shots, seed=6, config=cfg,
                                                device=CPU))


# ---------------------------------------------------------------------------
# Host-only: the n = 28 requests' dispatch, on meta tensors
# ---------------------------------------------------------------------------

def _dry_run(items, n):
    """Launch counts and plain gate calls of one pass list as the card
    would make them: the wrappers see meta tensors (shape, no data) as
    card planes and launch nothing."""
    saved = [(m, m.on_card, m.launch) for m in MODS]
    for m in MODS:
        m.on_card = lambda name, re, im: True
        m.launch = lambda *a: None
    try:
        _reset_all()
        meta = torch.device("meta")
        body = PS.run_passes(PS.prepare_passes(items, meta, torch.float32),
                              False)
        body([torch.empty(1 << n, device=meta), torch.empty(1 << n, device=meta)])
        assert not _plain_calls()
        return ({k: v for m in MODS for k, v in m.LAUNCHES.items() if v},
                dense.GATE_CALLS)
    finally:
        for m, on_card, launch in saved:
            m.on_card, m.launch = on_card, launch


@pytest.mark.parametrize("label", list(cs.PANEL28 + cs.FUSED28))
def test_n28_panel_and_fused_launch_counts(label):
    name, mode = label.split()
    cd = cs.panel_circuits()[name]
    if mode == "panel":
        items = PS.panel_schedule(cd)
    else:
        items = [(op, False) for op in PS.fused_ops(cd)]
    assert _dry_run(items, 28) == (cs.WANT[label], cs.DENSE.get(label, 0))
