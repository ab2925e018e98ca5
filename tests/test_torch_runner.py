"""The port's WAL runner against the JAX package's, on the CPU.

The cases of ``tests/test_recovery_crash.py``: a real crash (a
subprocess that imports only the port hard-exits through
``QST_CRASH_AFTER_STEP`` after writing a buffer and before the WAL
commit), then a fresh run resumes and must reach the JAX package's
state; the other crashes (chained, mid-checkpoint through
``QST_CRASH_MID_CHECKPOINT``, the ledger's) catch the crash hook's
``os._exit`` in this process instead: the work dir is all a crash
leaves, and a subprocess a case costs seconds of start-up.
Also the checkpoint cadence, the a/b double buffer, fencing, the
metadata ledger, the event log, the sha256 check of a corrupted buffer,
and work dirs written by one package and collected by the other.
complex128 at 1e-10; window and capacity modes (float32 planes) at
2e-5, the reference's.
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
from quantum_simulations_tpu.runtime import runner as rrunner
from quantum_simulations_tpu_torch.circuit.contract import (
    circuit_hash, validate_circuit_dict,
)
from quantum_simulations_tpu_torch.circuit.fusion import compile_steps
from quantum_simulations_tpu_torch.parallel import mesh as M
from quantum_simulations_tpu_torch.runtime import runner
from quantum_simulations_tpu_torch.runtime.metadata import MetadataStore
from quantum_simulations_tpu_torch.runtime.wal import (
    WAL, FencingError, FencingLock, WALCorruptError, WALMismatchError,
)
from quantum_simulations_tpu_torch.utils.logging import EventLog

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """One thread per xdist worker (as tests/test_torch_simulate.py)."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture
def cd():
    # GHZ(6): 6 dependency levels; with fusion off the runner takes one
    # step per level, so crashes have commits to land between.
    return rlib.ghz(6)


def _close(got, want, tol=1e-10):
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _subprocess(cd, work_dir, crash_after=None):
    """Run the port's runner in a fresh process (real crash isolation)."""
    script = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(REPO)!r})
        from quantum_simulations_tpu_torch.runtime import runner
        cd = json.loads({json.dumps(json.dumps(cd))})
        runner.run(cd, {str(work_dir)!r}, checkpoint_every=1, device="cpu",
                   dtype="complex128", use_fusion=False)
        assert "jax" not in sys.modules
        print("COMPLETED")
    """)
    env = dict(os.environ)
    env.pop(runner.CRASH_MID_ENV, None)
    env.pop(runner.CRASH_ENV, None)
    if crash_after is not None:
        env[runner.CRASH_ENV] = str(crash_after)
    return subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=300)


class _Crash(Exception):
    pass


def _run_crashing(monkeypatch, cd, wd, crash_after, **kw):
    """One run that dies at its crash hook, caught in this process."""
    def die(code):
        raise _Crash(code)

    monkeypatch.setattr(runner.os, "_exit", die)
    monkeypatch.setenv(runner.CRASH_ENV, str(crash_after))
    with pytest.raises(_Crash):
        runner.run(cd, wd, device=CPU, **kw)
    monkeypatch.delenv(runner.CRASH_ENV)


def _wal(wd):
    return json.loads((Path(wd) / "wal.json").read_text())


def test_clean_run_and_collect(tmp_path, cd):
    runner.run(cd, tmp_path, dtype="complex128", device=CPU)
    _close(runner.collect_state(tmp_path), roracle.simulate(cd))
    assert _wal(tmp_path)["done_steps"] > 0


def test_crash_then_recover_converges(tmp_path, cd):
    """A real crash: the process hard-exits after writing step 1's buffer;
    a fresh run resumes from step 0's commit."""
    res = _subprocess(cd, tmp_path, crash_after=1)
    assert res.returncode == 1, res.stderr
    assert "COMPLETED" not in res.stdout
    assert _wal(tmp_path)["done_steps"] == 1
    runner.run(cd, tmp_path, dtype="complex128", use_fusion=False, device=CPU)
    _close(runner.collect_state(tmp_path), roracle.simulate(cd))


def test_crash_at_step_zero_leaves_wal_empty(tmp_path, cd, monkeypatch):
    _run_crashing(monkeypatch, cd, tmp_path, 0, dtype="complex128",
                  use_fusion=False)
    assert _wal(tmp_path)["done_steps"] == 0
    assert _wal(tmp_path)["committed_buf"] is None
    runner.recover(cd, tmp_path, dtype="complex128", use_fusion=False,
                   device=CPU)
    _close(runner.collect_state(tmp_path), roracle.simulate(cd))


def test_repeated_crashes_make_progress(tmp_path, cd, monkeypatch):
    kw = dict(dtype="complex128", use_fusion=False)
    for crash_at in (0, 1, 2, 3):
        _run_crashing(monkeypatch, cd, tmp_path, crash_at, **kw)
    assert _wal(tmp_path)["done_steps"] == 3
    runner.run(cd, tmp_path, device=CPU, **kw)
    _close(runner.collect_state(tmp_path), roracle.simulate(cd))


def test_double_buffer_alternates(tmp_path, cd):
    runner.run(cd, tmp_path, dtype="complex128", use_fusion=False, device=CPU)
    assert (tmp_path / "state_a.npy").exists()
    assert (tmp_path / "state_b.npy").exists()


def test_resume_is_noop_when_complete(tmp_path, cd):
    runner.run(cd, tmp_path, dtype="complex128", device=CPU)
    before = _wal(tmp_path)
    st = {}
    runner.run(cd, tmp_path, dtype="complex128", device=CPU, stats=st)
    assert _wal(tmp_path) == before and st["checkpoints"] == 0


def test_wal_hash_mismatch_raises(tmp_path, cd):
    runner.run(cd, tmp_path, dtype="complex128", device=CPU)
    with pytest.raises(WALMismatchError):
        runner.run(rlib.qft(6), tmp_path, dtype="complex128", device=CPU)


@pytest.mark.parametrize("every", [1, 3])
def test_checkpoint_cadence(tmp_path, cd, every):
    st = {}
    runner.run(cd, tmp_path, dtype="complex128", checkpoint_every=every,
               use_fusion=False, device=CPU, stats=st)
    _close(runner.collect_state(tmp_path), roracle.simulate(cd))
    n_steps = len(compile_steps(cd, k=6, use_fusion=False))
    assert st["checkpoints"] == -(-n_steps // every)
    assert _wal(tmp_path)["done_steps"] == n_steps


def test_no_wal_mode(tmp_path, cd):
    runner.run(cd, tmp_path / "nw", dtype="complex128", use_wal=False,
               device=CPU)
    _close(runner.collect_state(tmp_path / "nw"), roracle.simulate(cd))
    assert not (tmp_path / "nw" / "wal.json").exists()


def test_empty_circuit(tmp_path):
    runner.run({"number_of_qubits": 3, "gates": []}, tmp_path,
               dtype="complex128", device=CPU)
    want = np.zeros(8, dtype=complex)
    want[0] = 1
    _close(runner.collect_state(tmp_path), want, 1e-12)


@pytest.mark.parametrize("mode,tol", [("fused", 1e-10), ("window", 2e-5)])
def test_sharded_runner(tmp_path, cd, mode, tol):
    """On 4 positions; a planar checkpoint collects as complex64 (both
    packages), hence the window mode's 2e-5."""
    mesh = M.make_mesh(4, device=CPU)
    runner.run(cd, tmp_path, mesh=mesh, mode=mode, dtype="complex128")
    _close(runner.collect_state(tmp_path), roracle.simulate(cd), tol)


@pytest.mark.parametrize("mode,dtype,tol", [
    ("fused", "complex128", 1e-10), ("window", "complex64", 2e-5),
    ("capacity", "complex64", 2e-5)])
def test_runner_mode_vs_reference(tmp_path, mode, dtype, tol):
    """The same run through both packages: the same files, WAL record and
    manifest, planar (2, 2^n) float32 buffers in window and capacity
    mode, and each work dir collected by either package."""
    cd = rlib.random_circuit(6, 30, seed=4)
    want = roracle.simulate(cd)
    runner.run(cd, tmp_path / "port", mode=mode, dtype=dtype,
               max_levels_per_step=8, device=CPU)
    rrunner.run(cd, tmp_path / "ref", mode=mode, dtype=dtype,
                max_levels_per_step=8)
    for collect in (runner.collect_state, rrunner.collect_state):
        for wd in ("port", "ref"):
            _close(collect(tmp_path / wd), want, tol)
    names = {wd: sorted(p.name for p in (tmp_path / wd).iterdir())
             for wd in ("port", "ref")}
    assert names["port"] == names["ref"]
    manifest = {wd: json.loads((tmp_path / wd / "manifest.json").read_text())
                for wd in ("port", "ref")}
    assert manifest["port"] == manifest["ref"]
    assert manifest["port"]["mode"] == mode
    assert _wal(tmp_path / "port") == _wal(tmp_path / "ref")
    if mode != "fused":
        assert manifest["port"]["state_format"] == "planar"
        buf = np.load(tmp_path / "port" /
                      f"state_{_wal(tmp_path / 'port')['committed_buf']}.npy")
        assert buf.shape == (2, 64) and buf.dtype == np.float32


@pytest.mark.parametrize("mode", ["window", "capacity"])
def test_crash_recover_in_window_modes(tmp_path, mode, monkeypatch):
    cd = rlib.ghz(6)
    kw = dict(mode=mode, dtype="complex64", use_fusion=False)
    _run_crashing(monkeypatch, cd, tmp_path, 1, **kw)
    assert _wal(tmp_path)["done_steps"] <= 2
    runner.run(cd, tmp_path, device=CPU, **kw)
    _close(runner.collect_state(tmp_path), roracle.simulate(cd), 2e-5)


# ---------------------------------------------------------------------------
# Fencing, the metadata ledger, the event log, integrity
# ---------------------------------------------------------------------------

def test_fencing_blocks_a_second_runner(tmp_path, cd):
    with FencingLock(tmp_path):
        with pytest.raises(FencingError):
            runner.run(cd, tmp_path, use_fencing=True, device=CPU)
    runner.run(cd, tmp_path, use_fencing=True, dtype="complex128", device=CPU)
    assert not (tmp_path / "runner.lock").exists()
    _close(runner.collect_state(tmp_path), roracle.simulate(cd))


def test_metadata_ledger_reflects_crash_and_recovery(tmp_path, cd,
                                                    monkeypatch):
    wd = tmp_path / "wd"
    kw = dict(dtype="complex128", use_fusion=False)
    _run_crashing(monkeypatch, cd, wd, 2, **kw)
    run_id = circuit_hash(validate_circuit_dict(cd))[:16]
    with MetadataStore(wd / "metadata.sqlite") as meta:
        assert meta.wal_pending_steps(run_id) == [2]
        assert meta.get_run(run_id)["status"] == "RUNNING"
    runner.run(cd, wd, device=CPU, **kw)
    with MetadataStore(wd / "metadata.sqlite") as meta:
        assert meta.get_run(run_id)["status"] == "DONE"
        assert meta.wal_pending_steps(run_id) == []
        last = meta.wal_last_committed(run_id)
        assert last is not None and last[0] >= 2
        ck = meta.latest_checkpoint(run_id)
        assert ck is not None and ck["sha256"] and ck["size_bytes"] > 0
    _close(runner.collect_state(wd), roracle.simulate(cd))


def test_checkpoint_sha_verified_on_resume(tmp_path, cd, monkeypatch):
    wd = tmp_path / "wd"
    _run_crashing(monkeypatch, cd, wd, 2, dtype="complex128", use_fusion=False)
    buf_file = wd / f"state_{_wal(wd)['committed_buf']}.npy"
    blob = bytearray(buf_file.read_bytes())
    blob[-9] ^= 0xFF  # flip a payload byte
    buf_file.write_bytes(bytes(blob))
    with pytest.raises(RuntimeError, match="corrupt"):
        runner.run(cd, wd, dtype="complex128", use_fusion=False, device=CPU)


def test_event_log_written(tmp_path, cd):
    wd = tmp_path / "wd"
    runner.run(cd, wd, dtype="complex128", use_fusion=False, device=CPU)
    kinds = [e["kind"] for e in EventLog(wd / "events.jsonl").read()]
    assert kinds[0] == "run_start" and kinds[-1] == "run_done"
    assert "step_commit" in kinds
    assert "runner.step" in EventLog(wd / "events.jsonl").read()[-1]["metrics"]


def test_crash_mid_checkpoint_write_recovers(tmp_path, cd, monkeypatch):
    """Die during the checkpoint write (truncated .tmp, no rename): the
    resume ignores the .tmp and the stale buffer."""
    wd = tmp_path / "wd"

    def die(code):
        raise _Crash(code)

    monkeypatch.setattr(runner.os, "_exit", die)
    monkeypatch.setenv(runner.CRASH_MID_ENV, "2")
    with pytest.raises(_Crash):
        runner.run(cd, wd, dtype="complex128", use_fusion=False, device=CPU)
    monkeypatch.delenv(runner.CRASH_MID_ENV)
    assert _wal(wd)["done_steps"] == 2
    tmps = list(wd.glob("state_*.npy.tmp"))
    assert tmps and b"truncated" in tmps[0].read_bytes()
    runner.run(cd, wd, dtype="complex128", use_fusion=False, device=CPU)
    _close(runner.collect_state(wd), roracle.simulate(cd))


def test_crash_mid_first_checkpoint_then_recover(tmp_path, cd, monkeypatch):
    wd = tmp_path / "wd"

    def die(code):
        raise _Crash(code)

    monkeypatch.setattr(runner.os, "_exit", die)
    monkeypatch.setenv(runner.CRASH_MID_ENV, "0")
    with pytest.raises(_Crash):
        runner.run(cd, wd, dtype="complex128", use_fusion=False, device=CPU)
    monkeypatch.delenv(runner.CRASH_MID_ENV)
    assert _wal(wd)["done_steps"] == 0 and _wal(wd)["committed_buf"] is None
    for collect in (runner.collect_state, rrunner.collect_state):
        with pytest.raises(RuntimeError, match="no committed state"):
            collect(wd)
    runner.run(cd, wd, dtype="complex128", use_fusion=False, device=CPU)
    _close(runner.collect_state(wd), roracle.simulate(cd))


def test_corrupt_wal_file_fails_stop(tmp_path, cd):
    wd = tmp_path / "wd"
    runner.run(cd, wd, dtype="complex128", use_fusion=False, device=CPU)
    for garbage in (b"{not json", b'{"done_steps": "soon"}', b"[1, 2, 3]"):
        (wd / "wal.json").write_bytes(garbage)
        with pytest.raises(WALCorruptError, match="unreadable"):
            runner.run(cd, wd, dtype="complex128", use_fusion=False,
                       device=CPU)
        with pytest.raises(WALCorruptError, match="unreadable"):
            WAL(wd / "wal.json", cd)


def test_window_bounded_steps_cadence_and_crash(tmp_path, monkeypatch):
    """A deep all-local circuit with ``max_levels_per_step=1`` commits at
    a real cadence on one device, survives a kill, and resumes without
    redoing committed steps."""
    cd = rlib.qft(6)
    wd = tmp_path / "wd"
    kw = dict(mode="window", max_levels_per_step=1, dtype="complex64",
              checkpoint_every=2)
    total = len(compile_steps(cd, k=6, max_levels_per_step=1))
    _run_crashing(monkeypatch, cd, wd, 5, **kw)
    done = _wal(wd)["done_steps"]
    assert 0 < done < total
    runner.run(cd, wd, device=CPU, **kw)
    assert _wal(wd)["done_steps"] == total
    commits = [e for e in EventLog(wd / "events.jsonl").read()
               if e["kind"] == "step_commit"]
    assert len({e["step"] for e in commits}) >= 4
    assert {e["step"] for e in commits if e["step"] >= done}
    _close(runner.collect_state(wd), roracle.simulate(cd), 1e-6)


def test_staged_sharded_runner_records_the_mapping(tmp_path):
    cd = rlib.random_circuit(8, 60, seed=2)
    mesh = M.make_mesh(4, device=CPU)
    runner.run(cd, tmp_path, mesh=mesh, dtype="complex128", use_staging=True,
               staging_method="heuristic")
    l2p = json.loads((tmp_path / "qubit_mapping.json").read_text())["log2phys"]
    assert l2p and sorted(l2p) == list(range(8))
    _close(runner.collect_state(tmp_path), roracle.simulate(cd))
    _close(rrunner.collect_state(tmp_path), roracle.simulate(cd))
