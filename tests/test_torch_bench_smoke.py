"""The port's bench tier (``quantum_simulations_tpu_torch/bench/``) against
the JAX package's (``tests/test_bench_smoke.py``), at the same tiny sizes
on the CPU (``QST_BENCH_PLATFORM=cpu``: the kernels' plain twins).

Each test mirrors one of the JAX package's bench smoke tests and holds
the port to the JAX package on the same inputs: the same rows,
configurations, schedules, byte counts and exchange counts; states to
the numpy oracle at the benches' own tolerances (1e-4 in complex64,
1e-10 in complex128).  Timings here are CPU timings and are only held
to be positive.
"""
import os

import numpy as np
import pytest

os.environ.setdefault("QST_BENCH_PLATFORM", "cpu")

from quantum_simulations_tpu.bench import e2e as re2e  # noqa: E402
from quantum_simulations_tpu.bench import passes as rpasses  # noqa: E402
from quantum_simulations_tpu.bench import projection as rprojection  # noqa: E402
from quantum_simulations_tpu.bench import sharded as rsharded  # noqa: E402
from quantum_simulations_tpu.bench import suite as rsuite  # noqa: E402
from quantum_simulations_tpu.bench import sweep as rsweep  # noqa: E402
from quantum_simulations_tpu.circuit import library as rlib  # noqa: E402
from quantum_simulations_tpu_torch.bench import (  # noqa: E402
    baseline_configs, c128_diff, capacity, e2e, headline, kernel_bw, matrix,
    passes, projection, sharded, spill_bw, suite, sweep,
)


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


def test_suite_matrix_small():
    out = suite.run(sizes=(5,), dtype="complex64")
    assert out["n_mismatch"] == 0
    assert len(out["rows"]) > 5
    assert out["device"] == "cpu"
    ref = rsuite.run(sizes=(5,), dtype="complex64")
    key = lambda r: (r["family"], r["n"], r.get("gates"), r["status"])  # noqa: E731
    assert [key(r) for r in out["rows"]] == [key(r) for r in ref["rows"]]


def test_kernel_bw_small():
    out = kernel_bw.run(n=14, reps=1, iters=2)
    assert "panel128_8gates" in out["ops"]
    # the JAX package's op classes, its two Pallas rows as the CUDA kernels
    assert set(out["ops"]) == {
        "1q_plane_q8", "1q_plane_q13", "2q_plane_hi", "2q_mixed_lo_hi",
        "panel128_8gates", "rotate7", "diag_cz_crossing",
        "cuda_lane_panel", "cuda_fused_diag_6gates"}
    for v in out["ops"].values():
        assert "error" not in v and v["s_per_pass"] > 0
        assert v["GBs"] >= 0 and v["pct_of_bound"] >= 0
    assert out["ops"]["cuda_lane_panel"]["route"] == "lane_panel"
    assert out["ops"]["rotate7"]["route"] == "tiled_transpose"
    assert out["bound_GBs"] == 3350.0


def test_kernel_bw_ops_match_their_plain_forms():
    """Each op class computes what it names: a chained pass of
    ``cuda_lane_panel`` equals ``panel128_8gates`` (the same W, one by
    the kernel wrapper, one by the framework's product), ``rotate7``
    equals ``dense.rotate_bits_right`` by 7, and the 6-gate diag terms
    make the 6 gates' phases."""
    import torch

    from quantum_simulations_tpu_torch.circuit import gates as G
    from quantum_simulations_tpu_torch.ops import bitperm_kernels as bk
    from quantum_simulations_tpu_torch.ops import dense
    from quantum_simulations_tpu_torch.ops import diag_kernels as dk
    from quantum_simulations_tpu_torch.ops import panel_kernels as pk

    n = 12
    rng = np.random.default_rng(3)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    x = torch.from_numpy(psi / np.linalg.norm(psi)).to(torch.complex128)
    re, im = pk.to_planar(x)
    W = dense.compose_low_panel(
        [((q,), G.H()) for q in range(7)] + [((0, 1), G.CNOT())], 7)
    want = x.view(-1, 128) @ torch.from_numpy(W.T.copy())
    got = pk.from_planar(*pk.lane_panel(re, im, W))
    assert float((got - want.view(-1)).abs().max()) < 1e-12
    got = pk.from_planar(*bk.tiled_transpose(re, im, 1 << (n - 7), 128))
    assert torch.equal(got, dense.rotate_bits_right(x, 7))
    terms = kernel_bw._diag_terms(n)
    theta = np.zeros(1 << n)
    idx = np.arange(1 << n)
    rng = np.random.default_rng(7)
    for qs in [(3, n - 3), (n - 1,), (5,), (8, 2), (n - 2, 9), (0,)]:
        dv = np.exp(1j * rng.uniform(-np.pi, np.pi, size=1 << len(qs)))
        sub = sum(((idx >> q) & 1) << (len(qs) - 1 - j) for j, q in enumerate(qs))
        theta += np.angle(dv)[sub]
    got = pk.from_planar(*dk.fused_diag(re, im, terms)).numpy()
    np.testing.assert_allclose(got, x.numpy() * np.exp(1j * theta), atol=1e-9)


def test_e2e_small():
    out = e2e.run(sizes=(10,), families=("ghz", "qft"), reps=1)
    assert len(out["results"]) == 6  # 2 families x 3 modes
    for r in out["results"]:
        assert r["wall_s"] > 0 and r["amp_updates_per_s"] > 0
        assert r["first_call_s"] > 0
    ref = re2e.run(sizes=(10,), families=("ghz", "qft"), reps=1)
    key = lambda r: (r["family"], r["n"], r["mode"], r["gates"])  # noqa: E731
    assert [key(r) for r in out["results"]] == [key(r) for r in ref["results"]]


def test_sweep_small():
    out = sweep.run(n=10, reps=1)
    assert len(out["rows"]) == 5
    ref = rsweep.run(n=10, reps=1)
    cfg = lambda r: {k: r[k] for k in ("mode", "use_fusion", "panel_width")  # noqa: E731
                     if k in r}
    assert [cfg(r) for r in out["rows"]] == [cfg(r) for r in ref["rows"]]
    assert out["gates"] == ref["gates"]
    assert all(r["wall_s"] > 0 for r in out["rows"])


def test_shard_timing_small():
    out = sharded.shard_timing(12, 4, depth=2, reps=1)
    assert out["shard_amplitudes"] == 1 << 10
    assert out["measured_shard_compute_s"] > 0
    assert out["collectives"] >= 1
    # every accounted byte figure must be <= collectives * full shard
    assert out["exchange_bytes_per_position"] <= out["collectives"] * (1 << 10) * 8
    assert out["pod_estimate_s"] >= out["measured_shard_compute_s"]
    assert out["link_model_GBs"] == 450.0
    ref = rsharded.shard_timing(12, 4, depth=2, reps=1, interpret=True)
    assert out["collectives"] == ref["collectives"]
    assert out["exchange_bytes_per_position"] == ref["ici_bytes_per_chip"]
    for k in ("steps", "local_window_passes", "gates", "config"):
        assert out[k] == ref[k], k


def test_spill_bw_small():
    out = spill_bw.run(n=10, stripe_qubits=7)
    assert len(out["rows"]) == 2
    assert abs(out["rows"][0]["norm"] - 1) < 1e-4
    assert all(r["MB_per_s"] > 0 and r["bytes_up"] > 0 for r in out["rows"])


def test_c128_diff_small():
    out = c128_diff.run(sizes=(8,), families=("qft", "nonstab"),
                        segmented_n=10, segment_gates=16)
    assert out["met"], out
    modes = {r["mode"] for r in out["rows"]}
    assert "end_to_end" in modes
    assert any(m.startswith("segmented_restart") for m in modes)


def test_c128_diff_main_exits_by_its_verdict(capsys):
    import json

    assert c128_diff.main(["--sizes", "6", "--families", "ghz"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["met"] and last["device"] == "cpu"


def test_passes_roofline_small():
    """Per-pass table smoke (plain twins on the CPU): every pass attributed
    once, the same op kinds and details per pass as the JAX package's
    schedule, each pass's plane bytes equal to the JAX package's HBM
    floor x its 819 GB/s (16 bytes an amplitude)."""
    from quantum_simulations_tpu.circuit.panelize import compile_window_schedule
    from quantum_simulations_tpu.runtime.simulator import pair_panel_diag

    out = passes.run(config="nonstab10", reps=2, samples=2)
    assert out["passes"] >= 1 and out["rows"]
    covered = [p for r in out["rows"] for p in r["passes"]]
    assert covered == list(range(out["passes"]))  # every pass attributed
    for r in out["rows"]:
        assert r["floor_ms"] >= 0 and r["measured_ms"] >= 0
        assert r["binding"] in ("bandwidth", "tensor cores (split TF32)",
                                "float32", "overhead/slack")
    ks = [c["k"] for c in out["raw_prefix_wall_ms"]]
    assert ks == list(range(out["passes"] + 1))
    assert len(out["per_rep_prefix_ms"]) == out["passes"] + 1

    cd = rlib.non_stabilizer(10, depth=4, seed=7)
    ref = pair_panel_diag(compile_window_schedule(cd, diag_terms_only=True))
    assert out["passes"] == len(ref)
    for got, (op, dterms) in zip(out["per_pass"], ref):
        assert got["kind"] == type(op).__name__
        assert got["detail"] == rpasses._op_detail(op)
        hbm_ms = rpasses._op_floors_ms(op, 10, dterms)[0]
        assert got["plane_bytes"] == 16 << 10
        assert got["plane_bytes"] == pytest.approx(
            hbm_ms * 1e-3 * rpasses.HBM_GBS * 1e9, rel=1e-12)


def test_passes_bound_by_pass_kind():
    """The bound of each pass kind at n = 28: a dim-128 panel and a dual
    by bytes (split TF32 under them), a narrower panel by float32
    operations, a diag run and a gate by bytes."""
    import torch

    from quantum_simulations_tpu_torch.circuit.panelize import (
        DiagOp, DualPanelOp, WindowPanelOp,
    )
    from quantum_simulations_tpu_torch.ops import panel_kernels as pk

    def W(d):
        return pk.w_planes(np.eye(d), "cpu", torch.float32)

    n, N = 28, 1 << 28
    w = passes._op_work(WindowPanelOp(14, W(128), 9), None, n)
    assert w["plane_bytes"] == 16 * N and w["ops_unit"] == "tensor cores (split TF32)"
    assert w["bytes_ms"] > w["ops_ms"]
    assert w["ops_ms"] == pytest.approx(1e3 * 18 * 128 * N / 495e12)
    w = passes._op_work(WindowPanelOp(14, W(64), 9), None, n)
    assert w["ops_unit"] == "float32"
    assert w["ops_ms"] == pytest.approx(1e3 * (6 * 64 + 4) * N / 67e12)
    dual = DualPanelOp(WindowPanelOp(0, W(128), 3), WindowPanelOp(7, W(128), 3))
    w = passes._op_work(dual, None, n)
    assert w["ops_ms"] == pytest.approx(1e3 * 2 * 18 * 128 * N / 495e12)
    assert w["bytes_ms"] == pytest.approx(
        1e3 * (16 * N + 2 * 2 * 128 * 128 * 4) / 3.35e12)
    w = passes._op_work(DiagOp((3,), None, terms=None), None, n)
    assert w["ops_ms"] == 0 and w["bytes_ms"] == pytest.approx(1e3 * 16 * N / 3.35e12)


def test_matrix_small():
    """n = 8: the JAX package's rows (families, skips, tiers), every one
    ok at 1e-10 in complex128; n = 10 adds the sharded tier on 8 CPU
    positions."""
    import jax.numpy as jnp

    from quantum_simulations_tpu.bench import matrix as rmatrix

    out = matrix.run(sizes=(8,))
    assert out["n_bad"] == 0 and out["tol"] == 1e-10
    rtiers = set(rmatrix._tiers(8, jnp.complex128, None)) | {"sparse"}
    want = []
    for fam, build in rlib.FAMILIES.items():
        try:
            cd = build(8)
        except Exception as e:
            want.append((fam, 8, f"skip: {e}", None))
            continue
        want.append((fam, cd["number_of_qubits"], "ok", rtiers))
    got = [(r["family"], r["n"], r["status"],
            set(r["tiers"]) if "tiers" in r else None) for r in out["rows"]]
    assert got == want
    out = matrix.run(sizes=(10,), families=("ghz", "qft", "nonstab"))
    assert out["n_bad"] == 0 and out["positions"] == 8
    assert all("sharded" in r["tiers"] and r["tiers"]["sharded"]["max_err"] < 1e-10
               for r in out["rows"])


def test_baseline_configs_small():
    got = [(tag, len(cd["gates"])) for tag, cd in baseline_configs.configs()]
    assert got == [
        ("ghz20", len(rlib.ghz(20)["gates"])),
        ("qft26", len(rlib.qft(26)["gates"])),
        ("sycamore26_d8", len(rlib.sycamore_like(26, depth=8, seed=11)["gates"])),
        ("qaoa26_p2", len(rlib.qaoa_maxcut(26, p=2)["gates"])),
        ("nonstab28", len(rlib.non_stabilizer(28, depth=4, seed=7)["gates"])),
    ]
    out = baseline_configs.run(reps=1, only=("ghz20",))
    (row,) = out["rows"]
    assert row["config"] == "ghz20" and row["gates"] == 20
    assert row["steady_s"] > 0 and row["amp_updates_per_s"] > 0


def test_capacity_small():
    out = capacity.run(ns=(12,))
    assert [r["config"] for r in out["rows"]] == ["ghz12", "nonstab12", "qft12"]
    ghz = out["rows"][0]
    assert ghz["amp0_err"] < 1e-6 and ghz["ampN_err"] < 1e-6
    for r in out["rows"]:
        assert abs(r["norm2"] - 1) < 1e-5 and r["steady_s"] > 0
        assert r["planes_gib"] == 2 * 4 * (1 << 12) / (1 << 30)


def test_projection_traffic_matches_reference():
    got = projection.project(amp_updates_per_s=1e11)
    ref = rprojection.project()
    assert got["reshard_gib_per_position"] == ref["reshard_gib_per_chip"]
    assert got["reshard_bytes_per_position"] / 2**30 == pytest.approx(
        ref["reshard_gib_per_chip"], abs=0.005)
    for k in ("residual_exchange_bytes", "boundary_reshards", "gates_staged",
              "stages"):
        assert got[k] == ref[k], k
    assert got["local_s"] == pytest.approx(
        got["gates_staged"] * (1 << 30) / 1e11)
    out = projection.run(rate_n=12)
    assert out["capacity_row"]["config"] == "nonstab12"
    assert out["amp_updates_per_s"] == out["capacity_row"]["amp_updates_per_s"]
    assert out["projected_total_s"] > out["local_s"] > 0


def test_headline_small():
    out = headline.run(n=12)
    assert out["metric"] == pytest.approx(98 * (1 << 12) / out["wall_s"])
    assert out["vs_baseline"] == pytest.approx(139.0 / out["wall_s"])
    assert out["unit"] == "amp-updates/s" and out["device"] == "cpu"
    assert abs(out["norm2"] - 1) < 1e-5
