"""The port's bench diagnostics (``opprof``, ``overhead``, ``probe_transfer``,
``capacity.sample_run``, ``spill_bw``'s overlap / slice / real runs,
``sharded.run`` / ``run16``) against the JAX package, at tiny sizes on the
CPU (``QST_BENCH_PLATFORM=cpu``: the kernels' plain twins).

Each diagnostic is held to the JAX package or the numpy oracle on the
same inputs: opprof's op classes and counts, slice_run's step and stripe
counts, the spill runs' step counts and norms, the variants' states
(1e-6 in complex64), sampled one-counts (5 sigma of the oracle's
marginals), sharded rows (1e-10 in complex128).  Timings here are CPU
timings and are only held to be positive.  Then chip_smoke.py phase 10's
checks, fed these outputs, and corrupted copies they must refuse.
"""
import ast
import copy
import json
import math
import os
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

os.environ.setdefault("QST_BENCH_PLATFORM", "cpu")

from quantum_simulations_tpu.bench import opprof as ropprof  # noqa: E402
from quantum_simulations_tpu.bench import spill_bw as rspill_bw  # noqa: E402
from quantum_simulations_tpu.circuit import library as rlib  # noqa: E402
from quantum_simulations_tpu.circuit import panelize as rpanelize  # noqa: E402
from quantum_simulations_tpu.runtime import simulator as rsim  # noqa: E402
from quantum_simulations_tpu_torch.bench import (  # noqa: E402
    capacity, opprof, overhead, probe_transfer, sharded, spill_bw,
)
from quantum_simulations_tpu_torch.circuit import library  # noqa: E402
from quantum_simulations_tpu_torch.oracle import dense_numpy as oracle  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """One thread per xdist worker (as tests/test_torch_simulate.py)."""
    import torch
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Every JAX bench module has its counterpart
# ---------------------------------------------------------------------------

NOT_PORTED = {"_compile_with_retries"}  # retried remote-compile 500s


def _functions(path: Path) -> set:
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}


def test_every_bench_function_has_its_counterpart():
    jax_bench = ROOT / "quantum_simulations_tpu" / "bench"
    port_bench = ROOT / "quantum_simulations_tpu_torch" / "bench"
    modules = sorted(p.name for p in jax_bench.glob("*.py"))
    assert len(modules) == 20
    for name in modules:
        want = {f for f in _functions(jax_bench / name)
                if not f.startswith("_")} - NOT_PORTED
        assert (port_bench / name).exists(), name
        missing = want - _functions(port_bench / name)
        assert not missing, (name, missing)


# ---------------------------------------------------------------------------
# opprof
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cd_name", ["qft10", "nonstab12"])
def test_opprof_classes_match_reference(cd_name):
    """The JAX profile's classes and counts: its ``_class_key`` over its
    ``compile_window_schedule(cd, diag_terms_only=True)``, the op list
    its ``profile_schedule`` times."""
    make = {"qft10": lambda lib: lib.qft(10),
            "nonstab12": lambda lib: lib.non_stabilizer(12)}[cd_name]
    out = opprof.profile_schedule(make(library), iters=1, reps=1)
    rops = rpanelize.compile_window_schedule(make(rlib), diag_terms_only=True)
    want = Counter(ropprof._class_key(op) for op in rops)
    assert {k: v["count"] for k, v in out["classes"].items()} == dict(want)
    assert out["ops"] == len(rops)
    for v in out["classes"].values():
        assert v["s_per_pass"] > 0 and v["GBs"] > 0
        assert v["est_total_s"] == pytest.approx(v["s_per_pass"] * v["count"])


def test_opprof_straddler_policies_small():
    out = opprof.straddler_policies(16, iters=1, reps=1)
    assert set(out["cases"]) == {
        "swap_torch_transpose", "swap_pair_col", "swap_pair_row",
        "cnot_torch_flip", "cnot_pair_col", "cnot_pair_row",
        "dense2q_torch_gate", "dense2q_pair_col", "dense2q_pair_row",
        "swapmixed_torch", "swapmixed_kernel", "cnotmixed_torch",
        "cnotmixed_kernel", "two_swaps_one_transpose"}
    for v in out["cases"].values():
        assert v["s_per_pass"] > 0 and v["GBs"] > 0


@pytest.mark.parametrize("qubits,gate", [((3, 14), "CNOT"), ((14, 3), "SWAP"),
                                         ((2, 9), "random")])
def test_opprof_complex_path_is_the_gate(qubits, gate):
    """The raced complex torch path computes the gate the planar one does."""
    import torch

    from quantum_simulations_tpu_torch.circuit import gates as G
    from quantum_simulations_tpu_torch.ops import dense

    rng = np.random.default_rng(5)
    U = {"CNOT": G.CNOT(), "SWAP": G.SWAP(),
         "random": np.linalg.qr(rng.normal(size=(4, 4))
                                + 1j * rng.normal(size=(4, 4)))[0]}[gate]
    re = torch.from_numpy(rng.normal(size=1 << 16).astype(np.float32))
    im = torch.from_numpy(rng.normal(size=1 << 16).astype(np.float32))
    got = opprof._complex_gate(re, im, qubits, U)
    want = dense.apply_gate_planar(re, im, qubits, U)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# overhead
# ---------------------------------------------------------------------------

def test_overhead_variants_agree_with_reference():
    """The three I/O policies' states within 1e-6 of each other and of the
    JAX window state (nonstab12, complex64)."""
    from quantum_simulations_tpu_torch.ops import dense
    from quantum_simulations_tpu_torch.ops import panel_kernels as pk
    from quantum_simulations_tpu_torch.runtime import simulator

    n = 12
    rows = overhead.nonstab_variants(n, reps=1)
    assert [r["variant"] for r in rows] == [
        "planar_io", "complex_io", "planar_io_inplace"]
    for r in rows:
        assert abs(r["norm2"] - 1) < 1e-5 and r["l2_vs_planar_io"] <= 1e-6
        assert r["passes"] == 7 and r["steady_s"] > 0
        assert r["ms_per_pass"] == pytest.approx(r["steady_s"] / 7 * 1e3)
    cd = library.non_stabilizer(n, depth=4, seed=7)
    want = np.asarray(rsim.simulate(rlib.non_stabilizer(n, depth=4, seed=7),
                                    mode="window"))
    for kw in (dict(planar_io=True, inplace=False),
               dict(planar_io=False, inplace=False),
               dict(planar_io=True, inplace=True)):
        fn = simulator.build_window_circuit_fn(cd, device="cpu", **kw)
        if kw["planar_io"]:
            got = pk.from_planar(*fn(*dense.zero_state_planar(n)))
        else:
            got = fn(dense.zero_state(n))
        assert np.linalg.norm(got.numpy() - want) <= 1e-6, kw


def test_overhead_wal_tax_small(tmp_path):
    rows = overhead.wal_tax(10, work_dir=tmp_path)
    assert [r["config"] for r in rows] == [
        "no_wal_cold", "no_wal", "wal_final", "wal_ck4"]
    steps = {r["n_steps"] for r in rows}
    assert len(steps) == 1 and steps.pop() > 4
    state_bytes = 2 * (1 << 10) * 4
    for r in rows:
        assert r["checkpoint_MB_s"] > 0
        assert r["checkpoint_bytes"] == r["n_checkpoints"] * state_bytes
    assert [r["n_checkpoints"] for r in rows[:3]] == [1, 1, 1]
    assert rows[3]["n_checkpoints"] == math.ceil(rows[3]["n_steps"] / 4)
    assert list(tmp_path.iterdir()) == []  # each config's directory removed


def test_overhead_scaling_and_diag_small():
    sc = overhead.panel_scaling(10, ks=(2, 4), reps=1)
    assert [r["k"] for r in sc["rows"]] == [2, 4]
    assert abs(sc["norm2"] - 1) < 1e-5
    assert set(sc["fit"]) == {"slope_ms_per_pass", "intercept_ms"}
    rows = overhead.diag_variants(12, iters=1, reps=1)
    assert [r["variant"] for r in rows] == ["full_grouped", "row_only",
                                            "const_only"]
    rops = rpanelize.compile_window_schedule(rlib.qft(12),
                                             diag_terms_only=True)
    big = max((o for o in rops if isinstance(o, rpanelize.DiagOp)),
              key=lambda o: len(o.terms))
    assert rows[0]["n_terms"] == len(big.terms)
    assert all(r["s_per_pass"] > 0 for r in rows)


# ---------------------------------------------------------------------------
# capacity.sample_run
# ---------------------------------------------------------------------------

def test_sample_run_matches_oracle_marginals():
    n, shots = 12, 20_000
    out = capacity.sample_run(n=n, shots=shots, reps=1)
    assert abs(out["norm2"] - 1) < 1e-5
    psi = oracle.simulate(library.sycamore_like(n, depth=8, seed=11))
    p = np.abs(psi) ** 2
    idx = np.arange(1 << n)
    p1 = np.array([p[(idx >> q) & 1 == 1].sum() for q in range(n)])
    np.testing.assert_allclose(out["p1"], p1, atol=1e-6)
    z = np.abs(np.array(out["counts"]) - shots * p1) / np.sqrt(
        shots * p1 * (1 - p1))
    assert z.max() <= 5, z
    assert out["ones_z_max"] <= 5
    assert out["shots_per_s"] > 0 and len(out["counts"]) == n


# ---------------------------------------------------------------------------
# spill_bw
# ---------------------------------------------------------------------------

def test_slice_run_matches_reference():
    """As tests/test_out_of_core.py::test_slice_bench_smoke, held to the
    JAX package's slice_run."""
    out = spill_bw.slice_run(n=14, stripe_qubits=10, stripes_measured=2)
    ref = rspill_bw.slice_run(n=14, stripe_qubits=10, stripes_measured=2)
    assert {r["step_kind"] for r in out["measured"]} == {"local", "nonlocal"}
    assert out["steps"] == ref["steps"]
    assert out["total_stripe_passes"] == ref["total_stripe_passes"] \
        == out["steps"] * (1 << 4)
    assert [r["group_stripes"] for r in out["measured"]] \
        == [r["group_stripes"] for r in ref["measured"]]
    assert out["est_full_run_s"] > 0
    for r in out["measured"]:
        assert abs(r["norm2"] - 1) < 1e-5


@pytest.mark.parametrize("which", ["real_chip", "real_chip_ghz"])
def test_real_chip_runs_match_reference(which):
    out = getattr(spill_bw, which)(n=12, stripe_qubits=9)
    ref = getattr(rspill_bw, which)(n=12, stripe_qubits=9)
    assert (out["steps"], out["group_steps"]) == (ref["steps"],
                                                  ref["group_steps"])
    assert abs(out["norm2"] - ref["norm2"]) < 1e-6
    assert abs(out["norm2"] - 1) < 1e-5
    if which == "real_chip":
        assert out["l2_vs_inhbm"] <= 1e-5
    else:
        assert max(out["amp0_err"], out["ampN_err"],
                   out["max_offpole_amp"]) <= 1e-6


def test_overlap_bit_equal():
    out = spill_bw.overlap(n=12, stripe_qubits=8)
    assert out["bit_equal"]
    for k in ("pipelined", "synchronous"):
        assert abs(out[k]["norm"] - 1) < 1e-5


# ---------------------------------------------------------------------------
# sharded
# ---------------------------------------------------------------------------

def test_sharded_run_small():
    out = sharded.run(12)
    assert out["n_devices"] == 8 and out["device"] == "cpu"
    rows = {r["config"]: r for r in out["rows"]}
    assert set(rows) == {"ghz12_sharded8", "sycamore12_d2_sharded8",
                         "sycamore14_d4_sharded8_fused",
                         "sycamore14_d4_sharded8_window"}
    g = rows["ghz12_sharded8"]
    assert max(g["amp0_err"], g["ampN_err"]) <= 1e-6
    assert g["shard_amplitudes"] == 1 << 9
    assert abs(rows["sycamore12_d2_sharded8"]["norm2"] - 1) < 1e-5
    for mode in ("fused", "window"):
        assert rows[f"sycamore14_d4_sharded8_{mode}"]["max_err_vs_oracle"] \
            <= 1e-10


def test_run16_dryrun_and_pod14(tmp_path):
    out = sharded.run16(tmp_path)
    dry, pod = out["rows"]
    assert dry["ok"] and dry["tiers"] == list(sharded.DRYRUN_TIERS)
    assert set(dry["max_err"]) == set(sharded.DRYRUN_TIERS)
    assert max(dry["max_err"].values()) < 1e-4
    assert pod["config"] == "pod34q_program_n14_sharded16_capacity"
    assert pod["max_err_vs_oracle"] < 1e-4
    assert pod["sampler_min_prob_sampled"] > 1e-12
    assert not (tmp_path / "wal16").exists()


# ---------------------------------------------------------------------------
# probe_transfer
# ---------------------------------------------------------------------------

def test_probe_transfer_small():
    out = probe_transfer.run(sizes_mb=(1,), reps=1)
    assert out["failed"] == []
    assert [(r["dtype"], r["memory"]) for r in out["rows"]] == [
        ("float32", "pageable"), ("complex64", "pageable")]
    for r in out["rows"]:
        assert r["h2d_GBs"] > 0 and r["d2h_GBs"] > 0
    for r in out["both_ways"]:
        assert r["each_way_GBs"] > 0
        assert r["total_GBs"] == pytest.approx(2 * r["each_way_GBs"])


# ---------------------------------------------------------------------------
# No card: each diagnostic raises, none falls back to the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", [
    probe_transfer.run, opprof.run,
    lambda: opprof.profile_schedule(library.qft(8)),
    opprof.straddler_policies, overhead.nonstab_variants, overhead.wal_tax,
    overhead.panel_scaling, overhead.diag_variants, capacity.sample_run,
    spill_bw.overlap, spill_bw.slice_run, spill_bw.real_chip,
    spill_bw.real_chip_ghz, sharded.run, sharded.run16,
    lambda: sharded.dryrun_mesh(16), sharded.pod14,
], ids=["probe_transfer", "opprof", "profile_schedule", "straddler_policies",
        "nonstab_variants", "wal_tax", "panel_scaling", "diag_variants",
        "sample_run", "overlap", "slice_run", "real_chip", "real_chip_ghz",
        "sharded_run", "run16", "dryrun_mesh", "pod14"])
def test_diagnostics_raise_without_a_card(fn, monkeypatch):
    import torch

    monkeypatch.delenv("QST_BENCH_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fn()


# ---------------------------------------------------------------------------
# chip_smoke.py phase 10's checks
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase10_checks_rehearsal(tmp_path):
    """chip_smoke.py phase 10's checks, fed the diagnostics' JSON from CPU
    runs at tiny sizes (each through the JSON text a subprocess would
    print), and a corrupted copy of each that a check must refuse."""
    cs = _chip_smoke()
    assert set(cs.DIAG_ARGV) == {
        "probe_transfer", "opprof", "overhead", "wal_tax", "sample_run",
        "spill_overlap", "spill_slice", "spill_real", "spill_ghz31",
        "sharded_run", "sharded_run16"}
    assert cs.DIAG_BUDGET_S == 240.0
    scaling = overhead.panel_scaling(10, ks=(2, 4), reps=1)
    outs = {
        "probe_transfer": probe_transfer.run(sizes_mb=(1,), reps=1),
        "opprof": {"qft": opprof.profile_schedule(library.qft(10), iters=1,
                                                  reps=1),
                   "nonstab": opprof.profile_schedule(
                       library.non_stabilizer(12), iters=1, reps=1),
                   "policies": opprof.straddler_policies(16, iters=1,
                                                         reps=1)},
        "overhead": {"nonstab_variants": overhead.nonstab_variants(10, reps=1),
                     "panel_scaling": scaling,
                     "diag_variants": overhead.diag_variants(10, iters=1,
                                                             reps=1)},
        "wal_tax": {"wal_tax": overhead.wal_tax(8, work_dir=tmp_path)},
        "sample_run": capacity.sample_run(n=10, shots=4000, reps=1),
        "spill_overlap": spill_bw.overlap(n=10, stripe_qubits=7),
        "spill_slice": spill_bw.slice_run(n=12, stripe_qubits=9,
                                          stripes_measured=1),
        "spill_real": spill_bw.real_chip(n=10, stripe_qubits=7),
        "spill_ghz31": spill_bw.real_chip_ghz(n=10, stripe_qubits=7),
        "sharded_run": sharded.run(10),
        "sharded_run16": sharded.run16(tmp_path),
    }
    ref = {"ms": outs["opprof"]["nonstab"]["est_total_s"] * 1e3,
           "lane_panel_ms": scaling["fit"]["slope_ms_per_pass"]}
    for name, out in outs.items():
        assert isinstance(cs.check_diag(name, json.loads(json.dumps(out)),
                                        ref), str), name
    assert cs.bench_launches("x\nLAUNCHES {\"lane_panel\": 3}\n") == {
        "lane_panel": 3}

    def refused(name, edit):
        bad = copy.deepcopy(outs[name])
        edit(bad)
        with pytest.raises(AssertionError):
            cs.check_diag(name, bad, ref)

    refused("probe_transfer", lambda o: o["failed"].append({"error": "x"}))
    refused("probe_transfer", lambda o: o["rows"].append(
        {"dtype": "float32", "MB": 4, "memory": "pinned", "h2d_GBs": 70.0,
         "d2h_GBs": 1.0}))
    refused("opprof", lambda o: o["qft"]["classes"].popitem())
    refused("opprof", lambda o: next(iter(o["nonstab"]["classes"].values()))
            .update(GBs=3600.0))
    refused("opprof", lambda o: o["nonstab"].update(
        est_total_s=2 * o["nonstab"]["est_total_s"]))
    refused("overhead", lambda o: o["nonstab_variants"][2].update(
        l2_vs_planar_io=2e-6))
    refused("overhead", lambda o: o["nonstab_variants"][0].update(norm2=1.1))
    refused("overhead", lambda o: o["panel_scaling"]["fit"].update(
        slope_ms_per_pass=2 * ref["lane_panel_ms"]))
    refused("wal_tax", lambda o: o["wal_tax"][1].update(n_steps=1))
    refused("wal_tax", lambda o: o["wal_tax"][2].update(checkpoint_MB_s=None))
    refused("sample_run", lambda o: o["counts"].__setitem__(0, 0))
    refused("sample_run", lambda o: o.update(peak_gib=o["planes_gib"] + 2))
    refused("sample_run", lambda o: o.update(device="NVIDIA H100 80GB HBM3, "
                                             "700.00 W"))
    refused("spill_overlap", lambda o: o.update(bit_equal=False))
    refused("spill_slice", lambda o: o.update(
        total_stripe_passes=o["total_stripe_passes"] + 1))
    refused("spill_real", lambda o: o.update(l2_vs_inhbm=2e-5))
    refused("spill_ghz31", lambda o: o.update(max_offpole_amp=1e-3))
    refused("sharded_run", lambda o: o["rows"][-1].update(
        max_err_vs_oracle=1e-9))
    refused("sharded_run16", lambda o: o["rows"][1].update(
        sampler_min_prob_sampled=0.0))
