"""The port's out-of-core spill tier against the JAX package's, on the CPU.

The cases of ``tests/test_out_of_core.py``, each through both packages:
the JAX tier as its own tests run it (CPU, complex128 through x64), the
port with ``device="cpu"`` (its kernels' plain torch twins; the same
stripe loop, slot ring and pipeline as on the card, with synchronous
copies).  Tolerances: 1e-10 in complex128, 2e-5 through the complex64
chunk files of the disk backend (float32 round-off of a few gates).
Bit-for-bit where the port's own two routes must agree (pipelined and
synchronous, ``transfer="f32"`` and native).  Also the WAL, the fencing
lock and the chunk store against the reference's (same records, same
errors), crash and resume in a subprocess that imports only the port, and
work dirs written by one package read by the other.
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
from quantum_simulations_tpu.runtime import spill as rspill
from quantum_simulations_tpu.runtime import wal as rwal
from quantum_simulations_tpu_torch import SimulatorConfig, api, library
from quantum_simulations_tpu_torch.oracle import dense_numpy as oracle
from quantum_simulations_tpu_torch.runtime import spill, wal
from quantum_simulations_tpu_torch.runtime.chunk_store import (
    DiskBuffer, HostBuffer,
)

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
C128 = "complex128"

CIRCUITS = {
    "ghz7": rlib.ghz(7),
    "qft6": rlib.qft(6),
    "w6": rlib.w_state(6),
    "random7": rlib.random_circuit(7, 60, seed=5),
    "sycamore6": rlib.sycamore_like(6, depth=4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """One thread per xdist worker (as tests/test_torch_simulate.py)."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _close(got, want, tol=1e-10):
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _random_state(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return psi / np.linalg.norm(psi)


# ---------------------------------------------------------------------------
# Host and disk backends against the JAX tier and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 3, 5])
@pytest.mark.parametrize("tag", list(CIRCUITS))
def test_host_spill_matches_reference(tag, m):
    cd = CIRCUITS[tag]
    got = spill.run_out_of_core(cd, stripe_qubits=m, dtype=C128, device=CPU)
    assert got.dtype == np.complex128 and got.shape == (1 << cd["number_of_qubits"],)
    want = rspill.run_out_of_core(cd, stripe_qubits=m, dtype=C128)
    _close(got, np.asarray(want))
    _close(got, oracle.simulate(cd))


@pytest.mark.parametrize("tag", ["ghz7", "qft6", "w6"])
def test_disk_spill_matches_reference(tmp_path, tag):
    cd = CIRCUITS[tag]
    wd = spill.run_out_of_core(cd, stripe_qubits=3, backend="disk",
                               work_dir=tmp_path / "port", device=CPU)
    got = spill.collect_state(wd)
    assert got.dtype == np.complex64  # the on-disk dtype
    want = rspill.collect_state(rspill.run_out_of_core(
        cd, stripe_qubits=3, backend="disk", work_dir=tmp_path / "ref"))
    _close(got, want, 2e-5)
    _close(got, oracle.simulate(cd), 2e-5)


@pytest.mark.parametrize("qa,qb", [(0, 1), (0, 3), (3, 0), (2, 4), (4, 2),
                                   (1, 4)])
def test_stripe_group_stacking_all_cases(qa, qb):
    """2q gates with every local / stripe-bit split (the butterfly grid)."""
    n, m = 5, 2
    cd = {"number_of_qubits": n, "gates": (
        [{"qubits": [q], "gate": "H"} for q in range(n)]
        + [{"qubits": [q], "gate": "T"} for q in range(0, n, 2)]
        + [{"qubits": [qa, qb], "gate": "CNOT"}]
    )}
    got = spill.run_out_of_core(cd, stripe_qubits=m, dtype=C128, device=CPU)
    _close(got, np.asarray(rspill.run_out_of_core(cd, stripe_qubits=m,
                                                  dtype=C128)))
    _close(got, oracle.simulate(cd))


def test_stats_count_steps_groups_and_bytes():
    cd = library.ghz(6)
    st = {}
    spill.run_out_of_core(cd, stripe_qubits=3, use_fusion=False, device=CPU,
                          stats=st)
    steps = spill.compile_steps(cd, k=3, use_fusion=False, panel_width=7)
    groups = sum(8 >> len(spill._group_bits(s, 3)) for s in steps)
    assert st.pop("alloc_s") >= 0 and st.pop("wait_s") >= 0
    assert st == dict(steps=len(steps), groups=groups,
                      bytes_up=len(steps) * 8 * 8 * 8,
                      bytes_down=len(steps) * 8 * 8 * 8, pinned=False)


# ---------------------------------------------------------------------------
# Staging (Atlas) on the spill tier
# ---------------------------------------------------------------------------

def test_host_staged_matches_reference():
    cd = rlib.qft(9)
    kw = dict(stripe_qubits=5, dtype=C128, use_staging=True,
              staging_method="heuristic")
    got = spill.run_out_of_core(cd, device=CPU, **kw)
    _close(got, np.asarray(rspill.run_out_of_core(cd, **kw)))
    _close(got, oracle.simulate(cd))


def test_disk_staged_matches_reference_and_records_mapping(tmp_path):
    cd = rlib.qft(8)
    kw = dict(stripe_qubits=4, backend="disk", dtype=C128, use_staging=True,
              staging_method="heuristic")
    out = spill.run_out_of_core(cd, work_dir=tmp_path / "port", device=CPU,
                                **kw)
    ref = rspill.run_out_of_core(cd, work_dir=tmp_path / "ref", **kw)
    mapping = (out / "qubit_mapping.json").read_bytes()
    assert mapping == (ref / "qubit_mapping.json").read_bytes()
    assert json.loads(mapping)["log2phys"] != list(range(8))
    got = spill.collect_state(out)
    _close(got, oracle.simulate(cd), 2e-5)
    _close(got, rspill.collect_state(ref), 2e-5)
    # Unstaged readout: the physical layout, as the reference's.
    _close(spill.collect_state(out, apply_permutation=False),
           rspill.collect_state(ref, apply_permutation=False), 2e-5)


@pytest.mark.parametrize("method", ["auto", "greedy", "ilp"])
def test_staging_methods_through_spill(method):
    cd = rlib.random_circuit(7, 40, seed=3)
    kw = dict(stripe_qubits=4, dtype=C128, use_staging=True,
              staging_method=method)
    got = spill.run_out_of_core(cd, device=CPU, **kw)
    _close(got, np.asarray(rspill.run_out_of_core(cd, **kw)))
    _close(got, oracle.simulate(cd))


# ---------------------------------------------------------------------------
# initial_state, single_copy, pipeline, transfer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("single_copy", [False, True])
def test_initial_state_array_adopted(single_copy):
    cd = rlib.random_circuit(7, 40, seed=8)
    psi0 = _random_state(7, 4)
    mine = psi0.copy()
    got = spill.run_out_of_core(cd, stripe_qubits=3, dtype=C128,
                                initial_state=mine, single_copy=single_copy,
                                device=CPU)
    want = rspill.run_out_of_core(cd, stripe_qubits=3, dtype=C128,
                                  initial_state=psi0.copy(),
                                  single_copy=single_copy)
    _close(got, np.asarray(want))
    _close(got, oracle.simulate(cd, initial_state=psi0))
    if single_copy:  # the caller's array is the working buffer
        assert got is mine


def test_initial_state_stripe_generator_single_copy():
    cd = rlib.qft(7)
    psi0 = _random_state(7, 9)

    def stripe(s):
        return psi0[s * 8:(s + 1) * 8]

    got = spill.run_out_of_core(cd, stripe_qubits=3, dtype=C128,
                                initial_state=stripe, single_copy=True,
                                device=CPU)
    want = rspill.run_out_of_core(cd, stripe_qubits=3, dtype=C128,
                                  initial_state=stripe, single_copy=True)
    _close(got, np.asarray(want))
    _close(got, oracle.simulate(cd, initial_state=psi0))


def test_pipeline_off_equals_pipelined_bit_for_bit():
    cd = rlib.qft(8)
    piped = spill.run_out_of_core(cd, stripe_qubits=5, device=CPU)
    sync = spill.run_out_of_core(cd, stripe_qubits=5, pipeline=False,
                                 device=CPU)
    np.testing.assert_array_equal(piped, sync)
    _close(piped, oracle.simulate(cd), 2e-5)
    for pipe in (True, False):
        _close(spill.run_out_of_core(cd, stripe_qubits=5, dtype=C128,
                                     pipeline=pipe, device=CPU),
               oracle.simulate(cd))


def test_f32_transfer_equals_native_bit_for_bit():
    cd = rlib.random_circuit(7, 40, seed=11)
    nat = spill.run_out_of_core(cd, stripe_qubits=3, device=CPU)
    f32 = spill.run_out_of_core(cd, stripe_qubits=3, transfer="f32",
                                device=CPU)
    np.testing.assert_array_equal(nat, f32)
    _close(f32, np.asarray(rspill.run_out_of_core(cd, stripe_qubits=3,
                                                  transfer="f32")), 2e-5)


@pytest.mark.parametrize("chunk", [8, 40, 1 << 12])
def test_copy_pieces_give_the_same_bits(monkeypatch, tmp_path, chunk):
    """Stripes move in pieces of ``transfer.COPY_CHUNK`` bytes (one
    amplitude, a ragged five, whole stripes): the same state bit for bit,
    host and disk (complex64 chunks up to a complex128 slot)."""
    from quantum_simulations_tpu_torch.utils import transfer

    cd = rlib.random_circuit(7, 40, seed=12)
    want = spill.run_out_of_core(cd, stripe_qubits=3, device=CPU)
    wd_want = spill.run_out_of_core(cd, stripe_qubits=3, backend="disk",
                                    dtype=C128, work_dir=tmp_path / "a",
                                    device=CPU)
    monkeypatch.setattr(transfer, "COPY_CHUNK", chunk)
    for f32 in ("native", "f32"):
        np.testing.assert_array_equal(spill.run_out_of_core(
            cd, stripe_qubits=3, transfer=f32, device=CPU), want)
    wd = spill.run_out_of_core(cd, stripe_qubits=3, backend="disk",
                               dtype=C128, work_dir=tmp_path / "b", device=CPU)
    np.testing.assert_array_equal(spill.collect_state(wd),
                                  spill.collect_state(wd_want))


def test_f32_group_path_sync_and_pipelined(tmp_path):
    cd = {"number_of_qubits": 6, "gates": (
        [{"qubits": [q], "gate": "H"} for q in range(6)]
        + [{"qubits": [0, 5], "gate": "CNOT"},
           {"qubits": [4, 1], "gate": "CNOT"},
           {"qubits": [3, 5], "gate": "CZ"}])}
    want = oracle.simulate(cd)
    for pipe in (True, False):
        _close(spill.run_out_of_core(cd, stripe_qubits=2, transfer="f32",
                                     pipeline=pipe, device=CPU), want, 2e-5)
    wd = spill.run_out_of_core(cd, stripe_qubits=2, backend="disk",
                               work_dir=tmp_path, transfer="f32", device=CPU)
    _close(spill.collect_state(wd), want, 2e-5)


def test_f32_rejects_complex128_and_mesh_is_unported():
    for run in (spill.run_out_of_core, rspill.run_out_of_core):
        kw = dict(device=CPU) if run is spill.run_out_of_core else {}
        with pytest.raises(ValueError, match="complex64"):
            run(rlib.ghz(4), stripe_qubits=2, dtype=C128, transfer="f32",
                **kw)
        with pytest.raises(ValueError, match="host-backend only"):
            run(rlib.ghz(4), stripe_qubits=2, backend="disk",
                single_copy=True, **kw)
        with pytest.raises(ValueError, match="unknown backend"):
            run(rlib.ghz(4), stripe_qubits=2, backend="tape", **kw)
    with pytest.raises(NotImplementedError, match="sharded"):
        spill.run_out_of_core(rlib.ghz(4), stripe_qubits=2, mesh=object(),
                              device=CPU)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spill.run_out_of_core(rlib.ghz(4), stripe_qubits=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.simulate(rlib.ghz(4), SimulatorConfig(stripe_qubits=2))


# ---------------------------------------------------------------------------
# The API and CLI routes
# ---------------------------------------------------------------------------

def test_api_routes_host_spill_with_staging():
    from quantum_simulations_tpu.api import simulate as rsimulate
    from quantum_simulations_tpu.utils.config import SimulatorConfig as RCfg

    cd = rlib.ghz(8)
    got = api.simulate(cd, SimulatorConfig(stripe_qubits=4, dtype=C128,
                                           use_staging=True), device=CPU)
    want = rsimulate(cd, RCfg(stripe_qubits=4, dtype=C128, use_staging=True))
    assert isinstance(got, np.ndarray)
    _close(got, np.asarray(want))
    _close(api.simulate(cd, SimulatorConfig(stripe_qubits=3,
                                            spill_transfer="f32"),
                        device=CPU), oracle.simulate(cd), 2e-5)


def test_api_routes_disk_spill(tmp_path):
    from quantum_simulations_tpu.api import simulate as rsimulate
    from quantum_simulations_tpu.utils.config import SimulatorConfig as RCfg

    cd = rlib.qft(7)
    got = api.simulate(cd, SimulatorConfig(stripe_qubits=4,
                                           spill_backend="disk"),
                       work_dir=tmp_path / "port", device=CPU)
    want = rsimulate(cd, RCfg(stripe_qubits=4, spill_backend="disk"),
                     work_dir=tmp_path / "ref")
    _close(got, want, 2e-5)
    assert (tmp_path / "port" / "wal.json").read_bytes() == (
        tmp_path / "ref" / "wal.json").read_bytes()


def test_api_sample_and_expectation_read_the_host_state():
    from quantum_simulations_tpu.api import expectation_z as rexp

    cfg = SimulatorConfig(stripe_qubits=3, dtype=C128)
    bits = api.sample(library.ghz(7), 30, seed=2, config=cfg, device=CPU)
    assert bits.shape == (30, 7) and set(bits.sum(axis=1).tolist()) <= {0, 7}
    cd = rlib.random_circuit(6, 30, seed=4)
    _close(api.expectation_z(cd, [1, 4], cfg, device=CPU),
           rexp(cd, [1, 4], cfg))
    _close(api.expectation_pauli(cd, "XIZYII", cfg, device=CPU),
           api.expectation_pauli(cd, "XIZYII",
                                 SimulatorConfig(dtype=C128), device=CPU))


@pytest.mark.parametrize("extra", [[], ["--staging"], ["--spill-backend",
                                                       "disk", "--work-dir"]],
                         ids=["host", "staging", "disk"])
def test_cli_stripe_qubits_matches_reference(capsys, tmp_path, extra):
    from quantum_simulations_tpu.__main__ import main as rmain
    from quantum_simulations_tpu_torch.__main__ import main

    rng = np.random.default_rng(6)  # generic angles: no ties in the top 5
    gates = [{"qubits": [q], "gate": g, "params": {"theta": float(t)}}
             for _ in range(2) for q in range(8)
             for g, t in (("RY", rng.uniform(0, 3)), ("RZ", rng.uniform(0, 3)))]
    gates += [{"qubits": [q, (q + 3) % 8], "gate": "CNOT"} for q in range(8)]
    path = tmp_path / "rot8.json"
    path.write_text(json.dumps({"number_of_qubits": 8, "gates": gates}))
    argv = ["run", str(path), "--stripe-qubits", "4", "--top", "5"]
    disk = extra[-1:] == ["--work-dir"]
    ref = extra + [str(tmp_path / "ref")] if disk else extra
    mine = extra + [str(tmp_path / "port")] if disk else extra
    assert rmain(argv + ref) == 0
    want = json.loads(capsys.readouterr().out)
    assert main(argv + mine + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["n_amplitudes"] == want["n_amplitudes"] == 256
    assert [i for i, _ in got["top"]] == [i for i, _ in want["top"]]
    for (_, a), (_, b) in zip(got["top"], want["top"]):
        assert abs(a - b) <= 1e-6
    assert abs(got["norm2"] - want["norm2"]) <= 1e-6


# ---------------------------------------------------------------------------
# Crash and resume (disk backend), in a process that imports only the port
# ---------------------------------------------------------------------------

def _crash_script(cd, work_dir) -> str:
    return textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(REPO)!r})
        from quantum_simulations_tpu_torch.runtime import spill
        assert not any(m == "jax" or m.startswith(("jax.", "quantum_simulations_tpu."))
                       for m in sys.modules), "the port imported JAX"
        cd = json.loads('''{json.dumps(cd)}''')
        spill.run_out_of_core(cd, stripe_qubits=3, backend="disk",
                              work_dir={str(work_dir)!r}, use_fusion=False,
                              device="cpu")
        print("COMPLETED")
    """)


@pytest.mark.parametrize("crash_after,where", [(20, "local"), (28, "group")])
def test_disk_crash_and_resume(tmp_path, crash_after, where):
    """GHZ-6 at m = 3, fusion off: 6 steps of 8 stripe writes, steps 3+
    CNOTs across stripe bits (the stripe-group path).  Crashing after 21
    writes lands in step 2 (local); after 29 in step 3 (a group step),
    so the resume must discard a half-written buffer."""
    cd = library.ghz(6)
    steps = spill.compile_steps(cd, k=3, use_fusion=False, panel_width=7)
    hit = steps[crash_after // 8]
    assert bool(spill._group_bits(hit, 3)) == (where == "group")
    script = _crash_script(cd, tmp_path)
    env = dict(os.environ, **{spill.CRASH_ENV: str(crash_after)})
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 1, res.stderr
    rec = json.loads((tmp_path / "wal.json").read_text())
    assert rec["done_steps"] == crash_after // 8 < len(steps)
    env.pop(spill.CRASH_ENV)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0 and "COMPLETED" in res.stdout, res.stderr
    _close(spill.collect_state(tmp_path), oracle.simulate(cd), 2e-5)


# ---------------------------------------------------------------------------
# Work dirs across the packages; WAL, fencing and chunk store parity
# ---------------------------------------------------------------------------

def test_work_dirs_read_across_packages(tmp_path):
    """The same disk run in each package: the same manifest, WAL record
    and chunk bytes (GHZ's amplitudes are exact in complex64), and each
    package's ``collect_state`` reads the other's work dir."""
    cd = rlib.ghz(7)
    mine = spill.run_out_of_core(cd, stripe_qubits=4, backend="disk",
                                 work_dir=tmp_path / "port", device=CPU)
    ref = rspill.run_out_of_core(cd, stripe_qubits=4, backend="disk",
                                 work_dir=tmp_path / "ref")
    assert (mine / "wal.json").read_bytes() == (ref / "wal.json").read_bytes()
    for buf in ("buf_a", "buf_b"):
        names = sorted(p.name for p in (ref / buf).iterdir())
        assert names == sorted(p.name for p in (mine / buf).iterdir())
        assert "chunk_00000007.c64" in names
        for name in names:
            assert (mine / buf / name).read_bytes() == (
                ref / buf / name).read_bytes(), (buf, name)
    np.testing.assert_array_equal(spill.collect_state(ref),
                                  rspill.collect_state(ref))
    np.testing.assert_array_equal(rspill.collect_state(mine),
                                  spill.collect_state(mine))
    _close(spill.collect_state(ref), oracle.simulate(cd), 2e-5)


def test_resume_across_packages(tmp_path):
    """A run the JAX tier crashed mid-way (its WAL says 2 of 6 steps) is
    finished by the port, and the reverse."""
    cd = rlib.ghz(6)
    kw = dict(stripe_qubits=3, backend="disk", use_fusion=False)
    for first, second, name in ((rspill, spill, "ref-then-port"),
                                (spill, rspill, "port-then-ref")):
        wd = tmp_path / name
        script = textwrap.dedent(f"""
            import json, sys
            sys.path.insert(0, {str(REPO)!r})
            import jax
            jax.config.update("jax_platforms", "cpu")
            from {first.__name__} import run_out_of_core
            extra = {{"device": "cpu"}} if "torch" in {first.__name__!r} else {{}}
            run_out_of_core(json.loads('''{json.dumps(cd)}'''),
                            work_dir={str(wd)!r}, **{kw!r}, **extra)
        """)
        env = dict(os.environ, **{spill.CRASH_ENV: "17"}, JAX_PLATFORMS="cpu")
        res = subprocess.run([sys.executable, "-c", script],
                             capture_output=True, text=True, env=env,
                             timeout=300)
        assert res.returncode == 1, res.stderr
        assert json.loads((wd / "wal.json").read_text())["done_steps"] == 2
        extra = {"device": CPU} if second is spill else {}
        second.run_out_of_core(cd, work_dir=wd, **kw, **extra)
        _close(second.collect_state(wd), oracle.simulate(cd), 2e-5)


def test_wal_record_and_errors_match_reference(tmp_path):
    cd, other = rlib.qft(5), rlib.ghz(5)
    a = wal.WAL(tmp_path / "a.json", cd, plan="ooc,m=3,fusion=True,steps=4")
    b = rwal.WAL(tmp_path / "b.json", cd, plan="ooc,m=3,fusion=True,steps=4")
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()
    a.commit_step(0, "b")
    b.commit_step(0, "b")
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()
    with pytest.raises(ValueError, match="out-of-order"):
        a.commit_step(3, "a")
    # Reopened by the other package: the same progress.
    again = wal.WAL(tmp_path / "b.json", cd, plan="ooc,m=3,fusion=True,steps=4")
    assert (again.done_steps, again.committed_buf) == (1, "b")
    for W, E in ((wal.WAL, wal.WALMismatchError),
                 (rwal.WAL, rwal.WALMismatchError)):
        with pytest.raises(E, match="different circuit"):
            W(tmp_path / "a.json", other, plan="ooc,m=3,fusion=True,steps=4")
        with pytest.raises(E):  # the plan is part of the identity
            W(tmp_path / "a.json", cd, plan="ooc,m=2,fusion=True,steps=4")
    (tmp_path / "bad.json").write_text("{not json")
    (tmp_path / "list.json").write_text("[1, 2]")
    for W, E in ((wal.WAL, wal.WALCorruptError),
                 (rwal.WAL, rwal.WALCorruptError)):
        for bad in ("bad.json", "list.json"):
            with pytest.raises(E, match="unreadable"):
                W(tmp_path / bad, cd)


def test_fencing_lock_matches_reference(tmp_path):
    held = wal.FencingLock(tmp_path).acquire()
    for Lock, E in ((wal.FencingLock, wal.FencingError),
                    (rwal.FencingLock, rwal.FencingError)):
        with pytest.raises(E, match="locked by pid"):
            Lock(tmp_path).acquire()
    held.release()
    assert not (tmp_path / "runner.lock").exists()
    # A stale lock (a pid that is not running) is broken by either.
    dead = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"],
                          capture_output=True, text=True).stdout.strip()
    import socket

    for Lock in (wal.FencingLock, rwal.FencingLock):
        (tmp_path / "runner.lock").write_text(json.dumps(
            {"pid": int(dead), "host": socket.gethostname(), "ts": 0}))
        with Lock(tmp_path):
            assert json.loads((tmp_path / "runner.lock").read_text())[
                "pid"] == os.getpid()
        assert not (tmp_path / "runner.lock").exists()


def test_chunk_store_matches_reference(tmp_path):
    from quantum_simulations_tpu.runtime.chunk_store import DiskBuffer as RDisk

    buf = DiskBuffer(tmp_path / "p", n=4, m=2)
    ref = RDisk(tmp_path / "r", n=4, m=2)
    arr = buf.to_array()
    assert arr[0] == 1.0 and np.count_nonzero(arr) == 1
    stripe = np.arange(4, dtype=np.complex64)
    buf.write(2, stripe)
    ref.write(2, stripe)
    for name in ("manifest.json", "chunk_00000000.c64", "chunk_00000002.c64"):
        assert (tmp_path / "p" / name).read_bytes() == (
            tmp_path / "r" / name).read_bytes()
    np.testing.assert_array_equal(DiskBuffer.open(tmp_path / "r").read(2),
                                  stripe)
    host = HostBuffer(4, 2, dtype=np.complex128)
    assert host.n_stripes == 4 and not host.pinned
    host.write(1, np.full(4, 2.0, dtype=np.complex128))
    assert host.to_array()[4:8].sum() == 8.0 and host.to_array()[0] == 1.0
