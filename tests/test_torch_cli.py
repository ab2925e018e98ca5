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


# The sparse, adaptive and trajectory flags run now
# (tests/test_torch_sparse.py, test_torch_trajectory.py); their cases
# hold an unported tier's error to naming those tiers among what runs
# (``--trajectory`` on a unitary circuit with ``--work-dir`` is the runner).
# ``--stripe-qubits`` runs the spill tier now (tests/test_torch_spill.py):
# its case prints the reference's output (names None), and disk spill
# without ``--work-dir`` raises the reference's own ValueError.
@pytest.mark.parametrize("flags,names", [
    (["--devices", "2"], ""), (["--stripe-qubits", "4"], None),
    (["--devices", "2", "--mode", "window"], "sparse"),
    (["--stripe-qubits", "4", "--spill-backend", "disk"], ValueError),
    (["--work-dir", "wd"], ""), (["--trajectory", "--work-dir", "wd"],
                                 "trajectory")],
    ids=["devices", "stripe", "sparse", "sparse-auto", "work-dir",
         "trajectory"])
def test_unported_tier_flags_exit_1(capsys, files, flags, names, tmp_path):
    flags = [str(tmp_path / f) if f == "wd" else f for f in flags]
    argv = ["run", str(files["ghz"]), *flags]
    if names is None:
        got, want = _both(capsys, argv + ["--top", "2"])
        assert got["n_amplitudes"] == want["n_amplitudes"] == 1 << 10
        assert abs(got["norm2"] - want["norm2"]) <= TOL
        assert [i for i, _ in got["top"]] == ["0x0", "0x3ff"]
        _same_top(sorted(got["top"]), sorted(want["top"]))
        return
    if names is ValueError:
        with pytest.raises(ValueError, match="disk backend requires work_dir"):
            rmain(argv)
        with pytest.raises(ValueError, match="disk backend requires work_dir"):
            main(argv + ["--device", "cpu"])
        return
    assert main(["run", str(files["ghz"]), "--device", "cpu", *flags]) == 1
    err = capsys.readouterr().err
    assert "not ported yet" in err and "NotImplementedError" not in err
    assert names in err.split("runs", 1)[1]


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
