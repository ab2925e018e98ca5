"""The port's CLI (``python -m quantum_simulations_tpu_torch``) against the
JAX package's (``python -m quantum_simulations_tpu``), on the CPU.

Both ``main``s run in this process on the same file (contract JSON and
OpenQASM), the port's with ``--device cpu``.  ``stats`` must print the
same JSON; ``run`` the same keys, indices and order (ties by index in
the port, wherever the reference's argsort puts them), with
probabilities, norms and amplitudes within 1e-6 (complex64 states, the
CLI's default dtype: float32 round-off is ~1e-7).  ``sample`` draws from
a ``torch.Generator``, so its rows are held to the state's support, not
to the reference's bits.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from quantum_simulations_tpu.__main__ import main as rmain
from quantum_simulations_tpu.circuit import library as rlib
from quantum_simulations_tpu_torch.__main__ import main

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-6

QASM = """OPENQASM 2.0;
include "qelib1.inc";
qreg q[9];
h q[0]; ry(0.4) q[3]; rx(1.3) q[8]; ry(0.9) q[6];
cx q[0],q[1];
ccx q[0],q[3],q[5];
rz(pi/4) q[5];
u3(0.3,0.2,0.1) q[7];
cu1(pi/8) q[8],q[2];
swap q[1],q[8];
ry(1.1) q[4];
"""


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


def _rotations(n, seed):
    """Random-angle RY / RZ layers and a CNOT ladder: generic
    probabilities, no ties among the largest."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gates = []
    for layer in range(3):
        for q in range(n):
            gates.append({"qubits": [q], "gate": "RY",
                          "params": {"theta": float(rng.uniform(0, 3))}})
            gates.append({"qubits": [q], "gate": "RZ",
                          "params": {"theta": float(rng.uniform(0, 3))}})
        gates += [{"qubits": [q, (q + 1 + layer) % n], "gate": "CNOT"}
                  for q in range(n)]
    return {"number_of_qubits": n, "gates": gates}


@pytest.fixture
def files(tmp_path):
    out = {"random": tmp_path / "random10.json", "ghz": tmp_path / "ghz10.json",
           "qasm": tmp_path / "mixed9.qasm"}
    out["random"].write_text(json.dumps(_rotations(10, seed=2)))
    out["ghz"].write_text(json.dumps(rlib.ghz(10)))
    out["qasm"].write_text(QASM)
    return out


def _both(capsys, argv):
    """(port's JSON, reference's JSON) of one command line."""
    assert rmain(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    return got, want


def _prob(v):
    return abs(complex(*v)) ** 2 if isinstance(v, list) else v


def _same_top(got, want):
    """Rank by rank: the same index and value, or (a tie at that rank) the
    same probability."""
    assert len(got) == len(want)
    for (i, a), (j, b) in zip(got, want):
        if i == j:
            d = complex(*a) - complex(*b) if isinstance(a, list) else a - b
            assert abs(d) <= TOL, (i, a, b)
        else:
            assert abs(_prob(a) - _prob(b)) <= TOL, (i, j, a, b)


@pytest.mark.parametrize("mode", ["panel", "fused", "window", "auto"])
def test_run_matches_reference(capsys, files, mode):
    got, want = _both(capsys, ["run", str(files["random"]), "--mode", mode,
                               "--top", "5"])
    assert [i for i, _ in got["top"]] == [i for i, _ in want["top"]]
    assert set(got) == set(want) == {"n_amplitudes", "norm2", "top"}
    assert got["n_amplitudes"] == want["n_amplitudes"] == 1 << 10
    assert abs(got["norm2"] - want["norm2"]) <= TOL
    _same_top(got["top"], want["top"])


def test_run_capacity_matches_reference(capsys, files):
    got, want = _both(capsys, ["run", str(files["random"]), "--mode",
                               "capacity", "--top", "4"])
    assert set(got) == set(want) and got["mode"] == want["mode"] == "capacity"
    assert got["n_qubits"] == want["n_qubits"] == 10
    assert abs(got["norm2"] - want["norm2"]) <= TOL
    _same_top(got["top"], want["top"])


def test_run_qasm_matches_reference(capsys, files):
    got, want = _both(capsys, ["run", str(files["qasm"]), "--top", "6"])
    assert got["n_amplitudes"] == want["n_amplitudes"] == 1 << 9
    assert abs(got["norm2"] - want["norm2"]) <= TOL
    _same_top(got["top"], want["top"])


def test_run_ghz_top_two(capsys, files):
    """GHZ's two equal probabilities: the same pair (in index order in the
    port), 0.5 each."""
    got, want = _both(capsys, ["run", str(files["ghz"]), "--top", "2"])
    assert [i for i, _ in got["top"]] == ["0x0", "0x3ff"]
    assert sorted(i for i, _ in want["top"]) == ["0x0", "0x3ff"]
    assert all(abs(p - 0.5) <= TOL for _, p in got["top"] + want["top"])


@pytest.mark.parametrize("which", ["random", "qasm"])
def test_stats_matches_reference(capsys, files, which):
    assert rmain(["stats", str(files[which])]) == 0
    want = json.loads(capsys.readouterr().out)
    assert main(["stats", str(files[which])]) == 0
    assert json.loads(capsys.readouterr().out) == want


def test_sample_draws_from_the_state(capsys, files):
    assert main(["sample", str(files["ghz"]), "--shots", "40", "--seed", "3",
                 "--device", "cpu"]) == 0
    rows = capsys.readouterr().out.split()
    assert len(rows) == 40 and set(rows) <= {"0" * 10, "1" * 10}
    assert main(["sample", str(files["qasm"]), "--shots", "30", "--mode",
                 "fused", "--device", "cpu"]) == 0
    rows = capsys.readouterr().out.split()
    assert len(rows) == 30 and all(len(r) == 9 for r in rows)


# Every tier's flags run now: ``--devices`` the sharded tier
# (tests/test_torch_sharded.py; fused for any mode but window, as the
# reference), ``--work-dir`` alone the WAL runner (tests/test_torch_runner.py;
# ``--trajectory`` on a unitary JSON circuit is the runner too),
# ``--stripe-qubits`` the spill tier (tests/test_torch_spill.py).  Each
# prints the reference's output (the runner in its own work dir for each
# package); disk spill without ``--work-dir`` raises the reference's own
# ValueError.
@pytest.mark.parametrize("flags,names", [
    (["--devices", "2"], None), (["--stripe-qubits", "4"], None),
    (["--devices", "2", "--mode", "window"], None),
    (["--stripe-qubits", "4", "--spill-backend", "disk"], ValueError),
    (["--work-dir", "wd"], None), (["--trajectory", "--work-dir", "wd"],
                                   None)],
    ids=["devices", "stripe", "sparse", "sparse-auto", "work-dir",
         "trajectory"])
def test_unported_tier_flags_exit_1(capsys, files, flags, names, tmp_path):
    argv = ["run", str(files["ghz"]), *flags]
    if names is ValueError:
        with pytest.raises(ValueError, match="disk backend requires work_dir"):
            rmain(argv)
        with pytest.raises(ValueError, match="disk backend requires work_dir"):
            main(argv + ["--device", "cpu"])
        return
    out = {}
    for who, run in (("ref", rmain), ("port", main)):
        cmd = [str(tmp_path / who) if f == "wd" else f for f in argv]
        cmd += ["--top", "2"] + (["--device", "cpu"] if who == "port" else [])
        assert run(cmd) == 0
        out[who] = json.loads(capsys.readouterr().out)
    got, want = out["port"], out["ref"]
    assert got["n_amplitudes"] == want["n_amplitudes"] == 1 << 10
    assert abs(got["norm2"] - want["norm2"]) <= TOL
    assert [i for i, _ in got["top"]] == ["0x0", "0x3ff"]
    _same_top(sorted(got["top"]), sorted(want["top"]))
    if "--work-dir" in flags:
        assert (json.loads((tmp_path / "port" / "wal.json").read_text())
                == json.loads((tmp_path / "ref" / "wal.json").read_text()))
        assert main(cmd) == 0  # a rerun resumes: nothing left to run
        assert json.loads(capsys.readouterr().out) == got


def test_default_device_is_the_card(files):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["run", str(files["ghz"])])


def test_module_entry_point(files):
    proc = subprocess.run(
        [sys.executable, "-m", "quantum_simulations_tpu_torch", "run",
         str(files["ghz"]), "--device", "cpu", "--top", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    out = json.loads(proc.stdout)
    assert [i for i, _ in out["top"]] == ["0x0", "0x3ff"]


def test_bench_choices_match_reference(capsys):
    """``bench`` takes the JAX package's nine choices, in its order."""
    import re

    from quantum_simulations_tpu_torch.__main__ import BENCHES

    with pytest.raises(SystemExit) as e:
        rmain(["bench", "--help"])
    assert e.value.code == 0
    choices = re.search(r"\{([a-z_,0-9]+)\}", capsys.readouterr().out).group(1)
    assert BENCHES == choices.split(",")
    assert len(BENCHES) == 9
    with pytest.raises(SystemExit) as e:
        main(["bench", "corpus"])
    assert e.value.code == 2


def test_bench_suite_prints_json_on_cpu(capsys, monkeypatch):
    monkeypatch.setenv("QST_BENCH_PLATFORM", "cpu")
    assert main(["bench", "suite", "--set", "sizes=[6]"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["n_mismatch"] == 0 and out["device"] == "cpu"
    assert {r["n"] for r in out["rows"]} <= {6, 2, 4, 5}  # fixed-size families
    for bad in ("sizes", "sizes=(6,)", "size=[6]"):
        with pytest.raises(SystemExit, match="--set"):
            main(["bench", "suite", "--set", bad])


def test_bench_platform_never_falls_back(monkeypatch):
    """Without a card and without ``QST_BENCH_PLATFORM=cpu`` a bench
    raises, naming the missing card; it does not run on the CPU."""
    import torch

    from quantum_simulations_tpu_torch.bench import setup_platform

    if torch.cuda.is_available():
        pytest.skip("a card is present: the benches measure it")
    monkeypatch.delenv("QST_BENCH_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        setup_platform()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["bench", "e2e"])
    monkeypatch.setenv("QST_BENCH_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="QST_BENCH_PLATFORM"):
        setup_platform()
    monkeypatch.setenv("QST_BENCH_PLATFORM", "cpu")
    assert setup_platform() == torch.device("cpu")


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase9_checks_rehearsal(monkeypatch):
    """chip_smoke.py phase 9's checks, fed the benches' JSON from CPU runs
    at tiny sizes (each through the JSON text a subprocess would print),
    and a corrupted copy of each that a check must refuse."""
    import copy

    from quantum_simulations_tpu_torch.bench import (
        baseline_configs, c128_diff, capacity, e2e, headline, kernel_bw,
        matrix, passes, projection, sharded, spill_bw, suite, sweep,
    )

    monkeypatch.setenv("QST_BENCH_PLATFORM", "cpu")
    cs = _chip_smoke()
    assert set(cs.BENCH_ARGV) == {
        "kernel_bw", "e2e", "sweep", "suite", "spill_bw", "baseline_configs",
        "capacity", "matrix", "projection", "c128_diff", "passes",
        "shard_timing", "headline"}
    outs = {
        "kernel_bw": kernel_bw.run(n=14, reps=1, iters=2),
        "e2e": e2e.run(sizes=(10,), families=("ghz",), reps=1),
        "sweep": sweep.run(n=10, reps=1),
        "suite": suite.run(sizes=(5,)),
        "spill_bw": spill_bw.run(n=10, stripe_qubits=7),
        "baseline_configs": baseline_configs.run(reps=1, only=("ghz20",)),
        "capacity": capacity.run(ns=(12,)),
        "matrix": matrix.run(sizes=(8, 10), families=("ghz", "nonstab")),
        "projection": projection.run(rate_n=12),
        "c128_diff": c128_diff.run(sizes=(8,), families=("qft",)),
        "passes": passes.run(config="nonstab10", reps=2, samples=2),
        "shard_timing": sharded.shard_timing(12, 4, depth=2, reps=1),
        "headline": headline.run(n=10),
    }
    # the printed forms: indented JSON after streamed rows, or a last line
    assert cs.last_json('{"row": 1}\n' + json.dumps(outs["suite"], indent=1)) \
        == outs["suite"]
    assert cs.last_json('{"row": 1}\n{"met": true}\n') == {"met": True}
    ref = {"ms": outs["passes"]["total_ms"],
           "amp_updates_per_s": outs["headline"]["metric"]}
    for name, out in outs.items():
        assert isinstance(cs.check_bench(name, json.loads(json.dumps(out)),
                                         ref), str), name

    def refused(name, edit):
        bad = copy.deepcopy(outs[name])
        edit(bad)
        with pytest.raises(AssertionError):
            cs.check_bench(name, bad, ref)

    refused("suite", lambda o: o.update(n_mismatch=1))
    refused("c128_diff", lambda o: o.update(met=False))
    refused("matrix", lambda o: o["rows"][-1].update(status="MISMATCH"))
    refused("matrix", lambda o: o["rows"][-1]["tiers"].pop("sharded"))
    refused("e2e", lambda o: o["results"][0].update(wall_s=0.0))
    refused("sweep", lambda o: o["rows"][0].update(wall_s=0.0))
    refused("baseline_configs", lambda o: o["rows"][0].update(steady_s=0.0))
    refused("kernel_bw", lambda o: o["ops"]["rotate7"].update(GBs=3600.0))
    refused("kernel_bw", lambda o: o["ops"]["rotate7"].update(error="x"))
    refused("passes", lambda o: o["rows"].pop())
    refused("passes", lambda o: o["rows"][0].update(
        floor_ms=2 * o["rows"][0]["measured_ms"] + 1))
    refused("passes", lambda o: o.update(total_ms=2 * o["total_ms"]))
    refused("shard_timing", lambda o: o.update(collectives=0))
    refused("shard_timing", lambda o: o.update(
        exchange_bytes_per_position=o["collectives"] * o["shard_amplitudes"] * 8 + 1))
    refused("capacity", lambda o: o["rows"][0].update(peak_gib=1.5))
    refused("headline", lambda o: o.update(metric=2 * o["metric"]))
    refused("spill_bw", lambda o: o["rows"][0].update(norm=0.5))
    refused("projection", lambda o: o.update(projected_total_s=float("nan")))
