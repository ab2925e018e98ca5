"""The port's corpus tier (``bench/corpus``, ``corpus33``, ``fingerprints``,
``hisvsim_parts`` and ``simulator.simulate_np``) against the JAX package,
on the CPU (``QST_BENCH_PLATFORM=cpu``: the kernels' plain twins).

The QASMBench corpus is not in the repository, so each test writes a
small one under ``tmp_path`` (``<name>/<name>.qasm`` from ``circuit/library``
through ``export_qasm.to_qasm``, HiSVSIM partition files in its row format)
and points both packages' ``CLUSTER`` at it.  Inputs are made from numpy
seeds.  Tolerances: RNG states bit-equal, 1e-12 against the dense oracle,
1e-10 for complex128 rows, 1e-5 (norm) / 1e-6 (amplitudes) for the
complex64 corpus33 row.  The tests that need the real corpus skip without
it, as the JAX package's do.  Last, chip_smoke.py phase 11 on the CPU at
tiny sizes, and its checks against corrupted copies of what it read.
"""
import copy
import json
import os
import weakref
from functools import partial
from pathlib import Path

import numpy as np
import pytest

os.environ.setdefault("QST_BENCH_PLATFORM", "cpu")

from quantum_simulations_tpu.bench import corpus as rcorpus  # noqa: E402
from quantum_simulations_tpu.bench import corpus33 as rc33  # noqa: E402
from quantum_simulations_tpu.bench import fingerprints as rfp  # noqa: E402
from quantum_simulations_tpu.bench import hisvsim_parts as rhis  # noqa: E402
from quantum_simulations_tpu.runtime import simulator as rsim  # noqa: E402
from quantum_simulations_tpu_torch.bench import (  # noqa: E402
    corpus, corpus33, fingerprints, hisvsim_parts,
)
from quantum_simulations_tpu_torch.circuit import library  # noqa: E402
from quantum_simulations_tpu_torch.circuit.export_qasm import to_qasm  # noqa: E402
from quantum_simulations_tpu_torch.oracle import dense_numpy as oracle  # noqa: E402
from quantum_simulations_tpu_torch.runtime import simulator  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-10

TRAJ_QASM = """OPENQASM 2.0;
include "qelib1.inc";
qreg q[8];
creg c[2];
h q[0];
h q[4];
t q[4];
cx q[0],q[1];
cx q[4],q[6];
h q[5];
measure q[0] -> c[0];
if(c==1) x q[2];
reset q[1];
h q[1];
cx q[1],q[7];
rz(pi/3) q[2];
h q[3];
cx q[3],q[2];
t q[6];
h q[7];
measure q[1] -> c[1];
if(c==3) z q[3];
h q[3];
cp(pi/4) q[2],q[3];
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


def _write(root: Path, name: str, text: str) -> str:
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{name}.qasm"
    path.write_text(text)
    return str(path)


def _point(monkeypatch, root) -> None:
    """Both packages' corpus modules read ``root``."""
    for mod in (corpus, corpus33, hisvsim_parts, rcorpus, rc33, rhis):
        monkeypatch.setattr(mod, "CLUSTER", str(root))


CORPUS = {
    "qft_n6": lambda: to_qasm(library.qft(6)),
    "syc_n8": lambda: to_qasm(library.sycamore_like(8, depth=4)),
    "nonstab_n21": lambda: to_qasm(library.non_stabilizer(21, depth=1)),
    "traj_n8": lambda: TRAJ_QASM,
    "adder_n12": lambda: to_qasm(library.ripple_adder(12, 21, 13)),
    "qft_n33": lambda: to_qasm(library.qft(33)),
    "broken_n2": lambda: "OPENQASM 2.0;\nqreg q[2];\nfoo q[0];\n",
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cluster")
    for name, make in CORPUS.items():
        _write(root, name, make())
    return root


def _parsed(tree, name):
    return corpus.parse_one(str(tree / name / f"{name}.qasm"))


# ---------------------------------------------------------------------------
# corpus: discovery, parsing, the policies and plans
# ---------------------------------------------------------------------------

def test_discover_and_parse_match_reference(tree, monkeypatch):
    _point(monkeypatch, tree)
    assert corpus.discover() == rcorpus.discover()
    assert [n for n, _ in corpus.discover()] == sorted(CORPUS)
    for name, path in corpus.discover():
        cd, mode, err = corpus.parse_one(path)
        rcd, rmode, rerr = rcorpus.parse_one(path)
        assert (mode, err) == (rmode, rerr), name
        assert (cd is None) == (rcd is None)
        if cd is not None:
            assert cd == rcd, name
    assert _parsed(tree, "traj_n8")[1] == "trajectory"
    assert _parsed(tree, "broken_n2")[0] is None


_POLICY_CASES = [
    (14, [("H", [0])], "unitary", "e2e"),
    (28, [("H", [0])], "unitary", "segments"),
    (33, [("H", [0])], "unitary", "parse_only"),
    (37, [("X", [0]), ("CNOT", [0, 1])], "unitary", "classical"),
    (28, [("RESET", [0])], "trajectory", "trajectory"),
    (20, [("H", [0])], "unitary", "e2e"),
    (21, [("H", [0])], "unitary", "segments"),
    (31, [("H", [0])], "unitary", "segments"),
    (12, [("CCX", [0, 1, 2])], "unitary", "classical"),
]


@pytest.mark.parametrize("n,gates,mode,want", _POLICY_CASES)
def test_policy_routes(n, gates, mode, want):
    """The JAX test's five routes (tests/test_corpus.py) and their edges."""
    cd = {"number_of_qubits": n,
          "gates": [{"qubits": q, "gate": g} for g, q in gates]}
    assert corpus._policy("x", cd, mode) == want
    assert rcorpus._policy("x", cd, mode) == want


@pytest.mark.parametrize("n", [21, 26, 27, 28, 29, 30, 31])
@pytest.mark.parametrize("n_gates", [1, 200, 5700])
@pytest.mark.parametrize("override", [(None, None), (4, 1), (16, 3)])
def test_seg_plan_matches_reference(n, n_gates, override):
    got = corpus._seg_plan(n_gates, n, *override)
    assert got == rcorpus._seg_plan(n_gates, n, *override)
    seg, idxs = got
    assert idxs == sorted(set(idxs)) and max(idxs) < -(-n_gates // seg)


@pytest.mark.parametrize("n,seed", [(4, 0), (10, 1000), (16, 1003)])
def test_rand_state_bit_equal(n, seed):
    got = corpus._rand_state(n, seed)
    assert got.dtype == np.complex128
    np.testing.assert_array_equal(got, rcorpus._rand_state(n, seed))
    assert abs(np.linalg.norm(got) - 1) < 1e-12


# ---------------------------------------------------------------------------
# corpus: the verifications, against the JAX package's rows
# ---------------------------------------------------------------------------

_SAME = ("status", "method", "segments_checked", "segments_total",
         "gates_checked", "seeds", "boundaries", "basis_state", "nnz",
         "reason")


def _same_row(got: dict, want: dict) -> None:
    for key in _SAME:
        assert got.get(key) == want.get(key), (key, got, want)
    if "tiers" in want:
        assert set(got["tiers"]) == set(want["tiers"])
    if "max_amp_err" in want:
        assert got["max_amp_err"] < TOL and want["max_amp_err"] < TOL


@pytest.mark.parametrize("name,spot", [("qft_n6", False), ("syc_n8", False),
                                       ("syc_n8", True)])
def test_verify_e2e_matches_reference(tree, name, spot):
    cd, _, _ = _parsed(tree, name)
    got = corpus._verify_e2e(name, cd, spot)
    _same_row(got, rcorpus._verify_e2e(name, cd, spot))
    assert set(got["tiers"]) == ({"pergate", "fused", "window"}
                                 | ({"sharded8"} if spot else set()))
    assert got["status"] == "verified"


def test_verify_segments_matches_reference(tree):
    cd, _, _ = _parsed(tree, "nonstab_n21")
    got = corpus._verify_segments("nonstab_n21", cd, 8, 2)
    _same_row(got, rcorpus._verify_segments("nonstab_n21", cd, 8, 2))
    assert got["status"] == "verified" and len(got["segments_checked"]) == 2


def test_verify_segments_memmap_path(monkeypatch, tmp_path):
    """The memmap-streamed path (at most one full state in host RAM),
    forced at n = 9 as the JAX test forces it; the scratch dir is left
    empty."""
    monkeypatch.setenv("QST_SEG_DISK_MIN", "5")
    monkeypatch.setenv("QST_SCRATCH", str(tmp_path))
    cd = library.qpe(8)
    got = corpus._verify_segments("qpe_n9", cd)
    _same_row(got, rcorpus._verify_segments("qpe_n9", cd))
    assert got["status"] == "verified"
    assert not list(tmp_path.iterdir())


def test_verify_segments_blocked_memmap(monkeypatch, tmp_path):
    """The memmap path with every plain pass of the engine in blocks of
    2^5 amplitudes (``dense.PLAIN_BLOCK`` lowered) gives the JAX row."""
    from quantum_simulations_tpu_torch.ops import dense

    monkeypatch.setattr(dense, "PLAIN_BLOCK", 1 << 5)
    monkeypatch.setenv("QST_SEG_DISK_MIN", "5")
    monkeypatch.setenv("QST_SCRATCH", str(tmp_path))
    cd = library.non_stabilizer(10, depth=3)
    got = corpus._verify_segments("nonstab_n10", cd)
    _same_row(got, rcorpus._verify_segments("nonstab_n10", cd))
    assert got["status"] == "verified" and got["gates_checked"] > 0
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("short", ["disk", "ram"])
def test_verify_segments_refuses_without_room(short, monkeypatch, tmp_path):
    """A host without room for the row's states skips it with the
    numbers, before anything is drawn (where running on would end in
    an OOM kill)."""
    import shutil

    monkeypatch.setenv("QST_SEG_DISK_MIN", "5")
    monkeypatch.setenv("QST_SCRATCH", str(tmp_path))
    if short == "disk":
        usage = shutil.disk_usage(tmp_path)
        monkeypatch.setattr(corpus.shutil, "disk_usage",
                            lambda p: usage._replace(free=100))
    else:
        monkeypatch.setattr(corpus, "_mem_available", lambda: 1000)
    monkeypatch.setattr(corpus, "_rand_state", None)  # never reached
    row = corpus._verify_segments("qpe_n9", library.qpe(8))
    assert row["status"] == "skipped"
    assert row["reason"].startswith({"disk": "memmap of 0 GiB does not fit",
                                     "ram": "host needs 0 GiB"}[short]), row


def test_host_refusal_counts_a_tmpfs_memmap_in_ram(monkeypatch, tmp_path):
    """On a tmpfs the memmap is RAM beside the oracle's state; on a disk
    only the oracle's state is."""
    import shutil

    usage = shutil.disk_usage(tmp_path)
    monkeypatch.setattr(corpus.shutil, "disk_usage",
                        lambda p: usage._replace(free=1 << 40))
    monkeypatch.setattr(corpus, "_mem_available", lambda: 24 << 30)
    for fstype, refused in (("tmpfs", True), ("ext4", False)):
        monkeypatch.setattr(corpus, "_mount", lambda p, t=fstype: ("/x", t))
        reason = corpus._host_refusal(30, True, str(tmp_path))
        assert (reason is not None) == refused, (fstype, reason)
    assert corpus._host_refusal(30, False, str(tmp_path)).startswith(
        "host needs 32 GiB for the oracle's state and the result")


@pytest.mark.parametrize("full_n_max", [None, 4])
def test_verify_trajectory_matches_reference(tree, full_n_max):
    """The full twin (outcomes and registers equal to the oracle's) and,
    with the size cutoff below n, the unitary-runs segment branch."""
    cd, mode, _ = _parsed(tree, "traj_n8")
    assert mode == "trajectory"
    got = corpus._verify_trajectory("traj_n8", cd, full_n_max)
    _same_row(got, rcorpus._verify_trajectory("traj_n8", cd, full_n_max))
    assert got["status"] == "verified"
    assert got["method"] == ("trajectory_twin_c128" if full_n_max is None else
                             "unitary_runs_segment_restart_c128[32]_fusedtier")


def test_verify_trajectory_divergence_fails(tree, monkeypatch):
    """Outcomes that differ from the oracle's fail the row."""
    from quantum_simulations_tpu_torch.runtime import trajectory as T

    cd, _, _ = _parsed(tree, "traj_n8")
    real = T.simulate_trajectory

    def flipped(*a, **kw):
        psi, cregs, outs = real(*a, **kw)
        return psi, cregs, [1 - o for o in outs]

    monkeypatch.setattr(T, "simulate_trajectory", flipped)
    row = corpus._verify_trajectory("traj_n8", cd)
    assert row["status"] == "FAILED" and row["detail"] == "outcome/creg divergence"


def test_verify_classical_matches_reference(tree):
    cd, _, _ = _parsed(tree, "adder_n12")
    got = corpus._verify_classical("adder_n12", cd)
    _same_row(got, rcorpus._verify_classical("adder_n12", cd))
    assert got["status"] == "verified" and got["nnz"] == 1
    # 21 + 13 = 34 = 0b100010 over m = 5 bits: carry out, sum 2
    assert int(got["basis_state"], 16) == (21 << 1) | (2 << 6) | (1 << 11)


def test_classical_oracle_matches_reference():
    cd = library.ripple_adder(20, 301, 422)
    assert corpus._classical_oracle(cd) == rcorpus._classical_oracle(cd)


def test_run_summary_matches_reference(tree, monkeypatch, tmp_path):
    _point(monkeypatch, tree)
    kw = dict(tier="all", seg_gates=8, seg_k=1, spot_sharded_for=("syc_n8",))
    got = corpus.run(out_path=str(tmp_path / "rows.json"), **kw)
    want = rcorpus.run(**kw)
    for key in ("total_files", "checked", "verified", "failed", "skipped"):
        assert got[key] == want[key], key
    assert (got["total_files"], got["verified"], got["failed"],
            got["skipped"]) == (7, 5, 1, 1)
    for g, w in zip(got["rows"], want["rows"]):
        assert g["circuit"] == w["circuit"]
        _same_row(g, w)
    assert json.loads((tmp_path / "rows.json").read_text())["rows"] == got["rows"]
    small = corpus.run(tier="small", max_n=8)
    rsmall = rcorpus.run(tier="small", max_n=8)
    assert [(r["circuit"], r["status"]) for r in small["rows"]] == [
        (r["circuit"], r["status"]) for r in rsmall["rows"]]


def test_write_manifest_matches_reference(tmp_path):
    rows = [
        {"circuit": "a_n5", "n": 5, "gates": 9, "method": "e2e_c128",
         "status": "verified", "max_amp_err": 3.2e-16},
        {"circuit": "b_n33", "n": 33, "gates": 99, "method":
         "spill_c64_segment[6]_lightcone", "status": "verified_c64",
         "max_amp_err_vs_exact_lightcone": 4.1e-8},
        {"circuit": "c_n40", "n": 40, "gates": 7, "method": "parse_only",
         "status": "skipped", "reason": "r"},
        {"circuit": "d_n3", "n": 3, "gates": 1, "method": "e2e_c128",
         "status": "verified", "max_amp_err": 0.0},
        {"circuit": "e_n9", "status": "PARSE_FAIL", "error": "x"},
    ]
    src = tmp_path / "local.json"
    src.write_text(json.dumps({"qasmbench_corpus": {"rows": rows}}))
    got = corpus.write_manifest(str(src), str(tmp_path / "port.json"))
    want = rcorpus.write_manifest(str(src), str(tmp_path / "jax.json"))
    assert got == want
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert (got["verified"], got["skipped"]) == (3, 1)


def test_main_write_manifest_needs_its_paths(tmp_path, capsys):
    with pytest.raises(SystemExit):
        corpus.main(["--write-manifest"])
    src = tmp_path / "local.json"
    src.write_text(json.dumps({"qasmbench_corpus": {"rows": []}}))
    assert corpus.main(["--write-manifest", "--bench-local", str(src),
                        "--manifest-out", str(tmp_path / "m.json")]) == 0
    assert json.loads((tmp_path / "m.json").read_text())["circuits"] == {}


# ---------------------------------------------------------------------------
# corpus33
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,cb,L", [(12, 8, 1 << 10), (10, 24, 1 << 10),
                                    (14, 10, 1 << 12)])
def test_chunk_state_bit_equal(n, cb, L):
    stripe, amps = corpus33.chunk_state_fn(n, seed=5, chunk_bits=cb)
    rstripe, ramps = rc33.chunk_state_fn(n, seed=5, chunk_bits=cb)
    full = np.concatenate([stripe(s, L) for s in range((1 << n) // L)])
    np.testing.assert_array_equal(
        full, np.concatenate([rstripe(s, L) for s in range((1 << n) // L)]))
    assert abs(np.linalg.norm(full) - 1.0) < 1e-5
    idxs = np.random.default_rng(0).integers(0, 1 << n, size=32)
    np.testing.assert_array_equal(amps(idxs), ramps(idxs))
    np.testing.assert_allclose(amps(idxs), full[idxs], atol=1e-7)


def test_stripes_narrower_than_a_chunk():
    """A stripe narrower than a chunk is its slice of the chunk (the JAX
    stripe filler needs stripes of at least one chunk)."""
    n, L = 12, 1 << 8
    stripe, amps = corpus33.chunk_state_fn(n, seed=3)
    wide, _ = corpus33.chunk_state_fn(n, seed=3)
    full = np.concatenate([stripe(s, L) for s in range((1 << n) // L)])
    np.testing.assert_array_equal(full, wide(0, 1 << n))
    np.testing.assert_allclose(amps(np.arange(1 << n)), full, atol=1e-7)


def test_norm_sums_in_float64():
    """The norm check sums in float64 (a complex64 vdot sums in float32,
    which over a stripe of 2^24 amplitudes can drift past the 1e-5 the
    check allows)."""
    stripe, _ = corpus33.chunk_state_fn(24, seed=77)
    v = stripe(0, 1 << 24)
    want = float(np.sum(np.abs(v.astype(np.complex128)) ** 2))
    got = corpus33._norm2(v, "cpu", step=1 << 22)
    assert abs(np.sqrt(got) - np.sqrt(want)) < 1e-12
    assert abs(np.sqrt(want) - 1) < 1e-6


def _rand_segment(n, rng, n_gates=8):
    gates = []
    for _ in range(n_gates):
        kind = rng.choice(["X", "H", "CNOT", "CCX", "T", "SDG", "RY"])
        qs = rng.choice(n, size={"CNOT": 2, "CCX": 3}.get(kind, 1),
                        replace=False)
        g = {"qubits": [int(q) for q in qs], "gate": str(kind)}
        if kind == "RY":
            g["params"] = {"theta": float(rng.uniform(0, 6))}
        gates.append(g)
    return gates


@pytest.mark.parametrize("seed", range(4))
def test_backprop_amp_matches_reference_and_dense(seed):
    n = 10
    rng = np.random.default_rng(seed)
    gates = _rand_segment(n, rng)
    psi0 = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi0 /= np.linalg.norm(psi0)
    want = oracle.simulate({"number_of_qubits": n, "gates": gates},
                           initial_state=psi0.copy())
    for j in rng.integers(0, 1 << n, size=6):
        v = corpus33.backprop_amp(int(j), gates, n)
        assert v == rc33.backprop_amp(int(j), gates, n)
        keys = np.fromiter(v.keys(), np.int64, len(v))
        vals = np.fromiter(v.values(), np.complex128, len(v))
        assert abs(np.sum(np.conj(vals) * psi0[keys]) - want[int(j)]) < 1e-12


def test_backprop_amp_cap():
    gates = [{"qubits": [q], "gate": "H"} for q in range(6)]
    with pytest.raises(RuntimeError, match="lightcone exceeded"):
        corpus33.backprop_amp(0, gates, 6, nnz_cap=8)


_SEGMENT_CASES = [
    ("random", 12, 8, 7), ("random", 12, 8, 6), ("ghz", 12, 8, 6),
    ("qpe", 12, 8, 6), ("ghz", 12, 20, 6), ("traj", 8, 6, 3),
    ("random", 28, 24, 7),
]


@pytest.mark.parametrize("kind,n,host_min,seg", _SEGMENT_CASES)
def test_pick_segment_matches_reference(kind, n, host_min, seg, tree):
    if kind == "traj":
        cd = _parsed(tree, "traj_n8")[0]
    else:
        cd = {"random": lambda: library.random_circuit(n, 200, seed=8),
              "ghz": lambda: library.ghz(n),
              "qpe": lambda: library.qpe(n - 1)}[kind]()
    got = corpus33._pick_segment(cd, seg, host_min)
    assert got == rc33._pick_segment(cd, seg, host_min)
    assert len(got[0]) == seg and all("cond" not in g for g in got[0])


def test_pick_segment_without_a_long_run():
    cd = {"number_of_qubits": 3, "gates": [{"qubits": [0], "gate": "H"}]}
    with pytest.raises(ValueError, match="no unitary run"):
        corpus33._pick_segment(cd, 6, 2)


@pytest.mark.parametrize("seed", [7, 8])
def test_verify_one_33_matches_reference(seed, monkeypatch, tmp_path):
    """n = 12 in stripes of 2^8 on the host tier, a host-bit window of
    random_circuit(12, 200, seed).  The JAX filler needs stripes of at
    least one chunk, so both packages take chunks of 2^8 here."""
    name = "random_n12"
    _write(tmp_path, name, to_qasm(library.random_circuit(12, 200, seed=seed)))
    _point(monkeypatch, tmp_path)
    for mod in (corpus33, rc33):
        monkeypatch.setattr(mod, "chunk_state_fn",
                            partial(mod.chunk_state_fn, chunk_bits=8))
    got = corpus33.verify_one_33(name, seg_gates=7, stripe_qubits=8)
    want = rc33.verify_one_33(name, seg_gates=7, stripe_qubits=8)
    for key in ("status", "host_bit_qubits_in_segment", "method", "note",
                "n", "gates", "stripe_qubits"):
        assert got[key] == want[key], key
    assert got["status"] == "verified_c64" and got["host_bit_qubits_in_segment"]
    assert got["norm_err"] < 1e-5 and got["max_amp_err"] < 1e-6
    assert got["max_amp_err"] == got["max_amp_err_vs_exact_lightcone"]
    assert got["steps"] >= 1 and got["groups"] >= 1


def test_verify_one_33_default_chunks(monkeypatch, tmp_path):
    """With the default chunks of 2^24 (wider than every stripe here)."""
    name = "random_n12"
    _write(tmp_path, name, to_qasm(library.random_circuit(12, 200, seed=7)))
    _point(monkeypatch, tmp_path)
    row = corpus33.verify_one_33(name, seg_gates=7, stripe_qubits=8)
    assert row["status"] == "verified_c64"


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [lambda: library.non_stabilizer(7, depth=4),
                                  lambda: library.qaoa_maxcut(8),
                                  lambda: library.random_circuit(6, 40, seed=2)])
def test_torch_simulate_matches_reference_and_oracle(make):
    cd = make()
    got = fingerprints.torch_simulate(cd)
    np.testing.assert_array_equal(got, rfp.torch_simulate(cd))
    np.testing.assert_allclose(got, oracle.simulate(cd), atol=1e-12, rtol=0)


def test_fingerprint_and_corruption_match_reference():
    psi = fingerprints.torch_simulate(library.qaoa_maxcut(9))
    fp = fingerprints._fingerprint(psi, np.random.default_rng(42))
    assert fp == rfp._fingerprint(psi, np.random.default_rng(42))
    assert len(fp["topk"]) == fingerprints.TOPK
    assert len(fp["probes"]) == fingerprints.PROBES
    assert fingerprints.verify_circuit("x", fp, psi) == 0.0
    bad = copy.deepcopy(fp)
    bad["topk"][0][1] += 1e-6
    got = fingerprints.verify_circuit("x", bad, psi)
    assert got == rfp.verify_circuit("x", bad, psi) and got > fingerprints.TOL
    with pytest.raises(AssertionError):
        fingerprints.verify_circuit("x", dict(fp, norm2=fp["norm2"] + 1e-6), psi)


def test_verify_against_a_frozen_file(tmp_path, monkeypatch):
    """``verify`` (the port's simulate_np, complex128) against a file
    frozen by ``torch_simulate``, and the same file with one amplitude
    moved."""
    name = "qaoa_n9"
    _write(tmp_path, name, to_qasm(library.qaoa_maxcut(9)))
    _point(monkeypatch, tmp_path)
    cd, _, _ = corpus.parse_one(str(tmp_path / name / f"{name}.qasm"))
    fp = fingerprints._fingerprint(fingerprints.torch_simulate(cd),
                                   np.random.default_rng(42))
    path = tmp_path / "fp.json"
    path.write_text(json.dumps({"circuits": {name: fp}}))
    res = fingerprints.verify(str(path))
    assert res["all_ok"] and res["rows"][0]["max_amp_err"] < TOL
    fp["probes"][3][2] -= 1e-6
    path.write_text(json.dumps({"circuits": {name: fp}}))
    assert not fingerprints.verify(str(path))["all_ok"]


def test_frozen_file_complete():
    """tests/data/corpus_fingerprints.json is in the repository."""
    assert fingerprints.DATA == rfp.DATA
    frozen = json.loads(Path(fingerprints.DATA).read_text())
    assert set(frozen["circuits"]) == set(fingerprints.CIRCUITS)
    assert (fingerprints.CIRCUITS, fingerprints.TOPK, fingerprints.PROBES,
            fingerprints.TOL) == (rfp.CIRCUITS, rfp.TOPK, rfp.PROBES, rfp.TOL)
    for name, fp in frozen["circuits"].items():
        assert abs(fp["norm2"] - 1.0) < 1e-9, name
        assert len(fp["topk"]) == fingerprints.TOPK
        assert len(fp["probes"]) == fingerprints.PROBES
        assert fp["n"] >= 1 and fp["gates"] >= 1


# ---------------------------------------------------------------------------
# hisvsim_parts, on partition files in HiSVSIM's row format
# ---------------------------------------------------------------------------

def _rows(cd, parts, pseudo=True):
    """``<seq> <gate>_<id> <partition>`` rows, the qubit input / exit
    pseudo-nodes interleaved as HiSVSIM writes them."""
    names = {"H": "h", "X": "x", "CNOT": "cx", "CZ": "cz", "T": "t", "S": "s",
             "P": "u1", "RZ": "u1"}
    out, seq = [], 0
    if pseudo:
        for q in range(cd["number_of_qubits"]):
            out.append(f"{seq} qr{q} 0")
            seq += 1
    for i, (g, p) in enumerate(zip(cd["gates"], parts)):
        out.append(f"{seq} {names.get(g['gate'], g['gate'].lower())}_{i} {p}")
        seq += 1
    if pseudo:
        for q in range(cd["number_of_qubits"]):
            out.append(f"{seq} qr{q}_exit_{len(parts) + q} 1")
            seq += 1
    return "\n".join(out) + "\n"


@pytest.fixture
def parts_tree(tmp_path, monkeypatch):
    root = tmp_path / "cluster"
    _write(root, "bv_n8", to_qasm(library.bernstein_vazirani(8, secret=0b1011011)))
    gates = corpus.parse_one(str(root / "bv_n8" / "bv_n8.qasm"))[0]["gates"]
    g = len(gates)
    half = [0 if i < g // 2 else 1 for i in range(g)]
    (root / "bv_n8" / "bv_n8_part_smart").write_text(
        _rows({"number_of_qubits": 8, "gates": gates}, half))
    # partition 1 feeds 0 and 0 feeds 1 on one qubit: cyclic
    cyc = [0] * g
    on0 = [i for i, x in enumerate(gates) if 0 in x["qubits"]]
    cyc[on0[1]] = 1
    (root / "bv_n8" / "bv_n8_part_dfs").write_text(
        _rows({"number_of_qubits": 8, "gates": gates}, cyc))
    # one row short: row / gate mismatch
    (root / "bv_n8" / "bv_n8_part_nat").write_text(
        _rows({"number_of_qubits": 8, "gates": gates[:-1]}, half[:-1]))
    # q_0_25_1 style: a bare strategy file in the circuit's directory
    qft = library.qft(6)
    _write(root, "qft_n6", to_qasm(qft))
    qg = corpus.parse_one(str(root / "qft_n6" / "qft_n6.qasm"))[0]["gates"]
    (root / "qft_n6" / "smart").write_text(
        _rows({"number_of_qubits": 6, "gates": qg},
              [i * 3 // len(qg) for i in range(len(qg))], pseudo=False))
    # a non-unitary circuit's partitions are not scored
    _write(root, "traj_n8", TRAJ_QASM)
    (root / "traj_n8" / "traj_n8_part_smart").write_text("0 h_0 0\n")
    _point(monkeypatch, root)
    return root


def test_partition_files_match_reference(parts_tree):
    got = hisvsim_parts.partition_files()
    assert got == rhis.partition_files()
    assert [(n, s) for n, s, _ in got] == [
        ("bv_n8", "dfs"), ("bv_n8", "nat"), ("bv_n8", "smart"),
        ("qft_n6", "smart"), ("traj_n8", "smart")]


def test_load_and_sequence_match_reference(parts_tree):
    path = str(parts_tree / "bv_n8" / "bv_n8.qasm")
    gates = corpus.parse_one(path)[0]["gates"]
    for strat in ("smart", "dfs", "nat"):
        p = str(parts_tree / "bv_n8" / f"bv_n8_part_{strat}")
        parts = hisvsim_parts.load_partition(p, gates)
        assert parts == rhis.load_partition(p, gates), strat
        if parts is None:
            assert strat == "nat"
            continue
        seq = hisvsim_parts.sequence_partitions(gates, parts)
        assert seq == rhis.sequence_partitions(gates, parts), strat
        if strat == "dfs":
            assert seq is None
        else:
            key = lambda g: (g["gate"], tuple(g["qubits"]))  # noqa: E731
            assert sorted(map(key, seq)) == sorted(map(key, gates))
    wrong = [dict(g, gate="X" if g["gate"] == "H" else g["gate"]) for g in gates]
    p = str(parts_tree / "bv_n8" / "bv_n8_part_smart")
    assert hisvsim_parts.load_partition(p, wrong) is None
    assert rhis.load_partition(p, wrong) is None


@pytest.mark.parametrize("k", [4, 5, 7])
def test_score_matches_reference(parts_tree, k):
    cd = corpus.parse_one(str(parts_tree / "qft_n6" / "qft_n6.qasm"))[0]
    rev = list(reversed(cd["gates"]))
    for order in (cd["gates"], rev):
        assert hisvsim_parts.score(cd, order, k) == rhis.score(cd, order, k)


def test_run_matches_reference(parts_tree):
    got = hisvsim_parts.run(devices=(2, 4))
    want = rhis.run(devices=(2, 4))
    assert got == want
    status = {(r["circuit"], r["strategy"], r.get("devices")): r.get("status")
              for r in got["rows"]}
    assert status[("bv_n8", "nat", None)] == "row/gate mismatch"
    assert status[("bv_n8", "dfs", 2)].startswith("partition graph cyclic")
    assert got["wins"] + got["parity"] + got["losses"] == 4


# ---------------------------------------------------------------------------
# simulate_np and the card by default
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fused", "window"])
@pytest.mark.parametrize("make", [lambda lib: lib.qft(9),
                                  lambda lib: lib.sycamore_like(10, depth=4),
                                  lambda lib: lib.qpe(8)])
def test_simulate_np_matches_reference(mode, make):
    from quantum_simulations_tpu.circuit import library as rlib

    got = simulator.simulate_np(make(library), dtype="complex128", mode=mode,
                                device="cpu")
    want = rsim.simulate_np(make(rlib), dtype="complex128", mode=mode)
    assert isinstance(got, np.ndarray) and got.dtype == np.complex128
    assert float(np.max(np.abs(got - want))) < TOL


@pytest.mark.parametrize("segment_gates", [None, 6])
@pytest.mark.parametrize("donate", [True, False])
def test_donate_input_drops_the_reference(monkeypatch, donate, segment_gates):
    """With ``donate_input`` the call holds the input only until its
    planes are built: a tensor the caller keeps no name of is freed
    before the run ends (torch has no donation)."""
    import torch

    from quantum_simulations_tpu_torch.ops import panel_kernels as pk

    seen = []
    real = pk.from_planar

    def spy(re, im):
        seen.append(ref() is None)
        return real(re, im)

    monkeypatch.setattr(pk, "from_planar", spy)
    cd = library.qft(8)
    x = torch.from_numpy(corpus._rand_state(8, 3))
    ref = weakref.ref(x)
    box = [x]
    del x
    got = simulator.simulate(cd, dtype="complex128", initial_state=box.pop(),
                             donate_input=donate, segment_gates=segment_gates,
                             device="cpu")
    assert seen and all(seen) == donate
    want = oracle.simulate(cd, initial_state=corpus._rand_state(8, 3))
    assert float(np.max(np.abs(got.numpy() - want))) < TOL


def _no_card(monkeypatch):
    import torch

    monkeypatch.delenv("QST_BENCH_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["run", "e2e", "segments", "classical",
                                   "verify_one_33", "verify", "simulate_np"])
def test_engines_default_to_the_card(entry, tree, monkeypatch, tmp_path):
    _point(monkeypatch, tree)
    path = tmp_path / "fp.json"
    path.write_text(json.dumps({"circuits": {}}))
    cd = _parsed(tree, "qft_n6")[0]
    _no_card(monkeypatch)
    run = {"run": lambda: corpus.run(tier="small"),
           "e2e": lambda: corpus._verify_e2e("qft_n6", cd, False),
           "segments": lambda: corpus._verify_segments("qft_n6", cd),
           "classical": lambda: corpus._verify_classical("adder_n12", cd),
           "verify_one_33": lambda: corpus33.verify_one_33("qft_n6"),
           "verify": lambda: fingerprints.verify(str(path)),
           "simulate_np": lambda: simulator.simulate_np(cd)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        run()


def test_no_module_sets_a_platform():
    """No port module picks the CPU on its own (the JAX modules' jax
    config calls have no counterpart)."""
    for mod in ("corpus", "corpus33", "fingerprints", "hisvsim_parts"):
        text = (ROOT / "quantum_simulations_tpu_torch" / "bench" / f"{mod}.py").read_text()
        assert "QST_BENCH_PLATFORM\"]" not in text and "jax" not in text, mod


# ---------------------------------------------------------------------------
# The real corpus, where it is present
# ---------------------------------------------------------------------------

real_corpus = pytest.mark.skipif(not os.path.isdir(rcorpus.CLUSTER),
                                 reason="reference corpus absent")


@real_corpus
def test_real_corpus_discover_and_parse():
    files = corpus.discover()
    assert len(files) == 57
    for name, path in files:
        if os.path.getsize(path) < 200_000:
            assert corpus.parse_one(path)[0] is not None, name


@real_corpus
@pytest.mark.parametrize("name", ["adder_n10", "qpe_n9", "multiply_n13"])
def test_real_small_circuit_verifies(name):
    row = corpus.verify_one(name, os.path.join(corpus.CLUSTER, name,
                                               f"{name}.qasm"))
    assert row["status"] == "verified", row


@real_corpus
@pytest.mark.parametrize("name", ["qpe_n9", "adder_n10", "sat_n11",
                                  "multiply_n13", "qft_n15"])
def test_real_framework_matches_frozen(name):
    frozen = json.loads(Path(fingerprints.DATA).read_text())
    cd, _, _ = corpus.parse_one(os.path.join(corpus.CLUSTER, name,
                                             f"{name}.qasm"))
    psi = simulator.simulate_np(cd, dtype="complex128", device="cpu")
    assert fingerprints.verify_circuit(name, frozen["circuits"][name],
                                       psi) < fingerprints.TOL


@real_corpus
def test_real_partition_files():
    files = hisvsim_parts.partition_files()
    assert len(files) == 14
    assert files == rhis.partition_files()


# ---------------------------------------------------------------------------
# chip_smoke.py phase 11 on the CPU, and its checks
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def phase11():
    """Phase 11 through ``bench_tier`` on the CPU at tiny sizes (its four
    subprocesses; the plain twins' calls stand in for the launches, as on
    the CPU they equal what the card launches), opened while the last
    bench of a one-bench phase 10 runs, as the script opens it."""
    import torch

    cs = _chip_smoke()
    cs.CORPUS_N.update(qft=6, sycamore=8, nonstab=21, traj=8, adder=14)
    cs.C33_N, cs.C33_M, cs.C33_SEG, cs.C33_SEED = 12, 8, 7, 7
    cs.FP_N = 8
    cs.BIG_N.update(nonstab=21, traj=10)
    cs.CORPUS_ENV["corpus_big"].update(QST_SEG_DISK_MIN="21",
                                       QST_TRAJ_FULL_NMAX="8")
    cs._BENCH_RUN = cs._BENCH_RUN.replace("m.LAUNCHES.items()",
                                          "m.PLAIN_CALLS.items()")
    cpu = torch.device("cpu")
    opened = {}
    cs.bench_tier(cpu, {}, {"noop": ["-c", "print('{}')"]}, 60.0, 10,
                  lambda name, out, ref: "ok",
                  then=lambda: opened.update(cs.corpus_open(cpu)))
    assert set(opened["procs"]) == set(list(cs.corpus_argv())[:cs.BENCH_AHEAD + 1])
    counts = cs.corpus_tier(cpu, opened)
    assert all(p.poll() is not None for p in opened["procs"].values())
    return cs, counts


def test_phase11_runs_on_the_cpu(phase11, tmp_path):
    cs, counts = phase11
    rec = cs.RECORD["bench11"]
    assert set(rec) >= set(cs.corpus_argv()) | {"phase_s", "launches_by_kernel"}
    assert counts["corpus tier"]["lane_panel"] > 0
    assert not (ROOT / "build" / "chip_smoke_phase11").exists()
    ref = cs.write_corpus(tmp_path)
    assert rec["corpus33"]["launches"] == ref["corpus33_want"]


def test_phase11_texts_round_trip(phase11):
    """The trajectory text parses back to traj_circuit; the corpus is what
    the check expects, policy by policy."""
    from quantum_simulations_tpu_torch.circuit.contract import validate_circuit_dict
    from quantum_simulations_tpu_torch.circuit.import_qasm import QasmError, qasm_to_dict

    cs, _ = phase11
    got = validate_circuit_dict(qasm_to_dict(cs.traj_qasm(8), nonunitary="trajectory"),
                                allow_nonunitary=True)
    want = validate_circuit_dict(cs.traj_circuit(8), allow_nonunitary=True)
    assert [(g["gate"], g["qubits"], g.get("cond")) for g in got["gates"]] == [
        (g["gate"], g["qubits"], g.get("cond")) for g in want["gates"]]
    texts = cs.corpus_texts()
    for key, n in cs.CORPUS_N.items():
        name = cs.corpus_name(key)
        try:
            cd, mode = qasm_to_dict(texts["corpus"][name]), "unitary"
        except QasmError:
            cd, mode = qasm_to_dict(texts["corpus"][name], nonunitary="trajectory"), "trajectory"
        pol = corpus._policy(name, cd, mode)
        assert cd["number_of_qubits"] == n
        assert pol == {"qft": "e2e", "sycamore": "e2e", "nonstab": "segments",
                       "traj": "trajectory", "adder": "classical",
                       "qft33": "parse_only"}[key]
    assert corpus._classical_oracle(library.ripple_adder(
        cs.CORPUS_N["adder"], cs.ADDER_A, cs.ADDER_B)) == cs.adder_basis()
    for key, n in cs.BIG_N.items():
        text = texts["big"][cs.big_name(key)]
        mode = "trajectory" if key == "traj" else "unitary"
        cd = qasm_to_dict(text, **({"nonunitary": "trajectory"} if key == "traj" else {}))
        assert cd["number_of_qubits"] == n
        assert corpus._policy(cs.big_name(key), cd, mode) == {
            "nonstab": "segments", "traj": "trajectory"}[key]


def test_traj_short_round_trips_with_long_runs(phase11):
    """traj_short's text parses back to it; its three longest unitary
    runs, which the unitary-runs branch samples, have >= 4 gates each."""
    from quantum_simulations_tpu_torch.circuit.contract import validate_circuit_dict
    from quantum_simulations_tpu_torch.circuit.import_qasm import qasm_to_dict
    from quantum_simulations_tpu_torch.runtime import trajectory as T

    cs, _ = phase11
    for n in (8, 22, 28):
        got = validate_circuit_dict(qasm_to_dict(cs.nonunitary_qasm(cs.traj_short(n)),
                                                 nonunitary="trajectory"),
                                    allow_nonunitary=True)
        want = validate_circuit_dict(cs.traj_short(n), allow_nonunitary=True)
        assert [(g["gate"], g["qubits"], g.get("cond")) for g in got["gates"]] == [
            (g["gate"], g["qubits"], g.get("cond")) for g in want["gates"]]
        runs = sorted((len(r) for r, _ in T.split_segments(got["gates"])), reverse=True)
        assert runs[:3] == [6, 4, 4] and sum(runs) == 16


def _refuse(cs, name, res, ref, edit):
    bad = copy.deepcopy(res)
    edit(bad)
    with pytest.raises(AssertionError):
        cs.check_corpus(name, bad, ref)


_CORRUPT = {
    "corpus": [
        lambda r: r["json"].pop(0),
        lambda r: r["json"].clear(),
        lambda r: r["json"][-1].update(failed=1),
        lambda r: r["json"][-1].update(total_files=5),
        lambda r: next(d for d in r["json"] if d.get("mode") == "trajectory")
        .update(status="FAILED", detail="outcome/creg divergence"),
        lambda r: next(d for d in r["json"] if d.get("method") == "e2e_c128")
        .update(max_amp_err=2e-10),
        lambda r: next(d for d in r["json"] if d.get("method") == "e2e_c128")
        ["tiers"].update(window=3e-10),
        lambda r: next(d for d in r["json"] if d.get("method") == "parse_only")
        .update(reason="--max-n 32"),
        lambda r: next(d for d in r["json"] if str(d.get("method")).startswith("segment"))
        .update(status="skipped"),
        lambda r: next(d for d in r["json"] if str(d.get("method")).startswith("sparse"))
        .update(basis_state="0x1"),
    ],
    "corpus_sharded": [
        lambda r: r["json"][-1]["tiers"].pop("sharded8"),
        lambda r: r["json"][-1]["tiers"].update(sharded8=1e-9),
        lambda r: r["json"][-1].update(status="FAILED"),
    ],
    "corpus33": [
        lambda r: r["json"][-1].update(status="FAILED"),
        lambda r: r["json"][-1].update(norm_err=2e-5),
        lambda r: r["json"][-1].update(max_amp_err=2e-6),
        lambda r: r["json"][-1].update(host_bit_qubits_in_segment=[]),
        lambda r: r["launches"].pop("lane_panel"),
        lambda r: r.update(launches={"lane_panel": r["launches"]["lane_panel"]}),
        lambda r: r["launches"].update(bitperm_swap=1),
    ],
    "corpus_big": [
        lambda r: r["json"].pop(0),
        lambda r: r["json"][-1].update(failed=1),
        lambda r: r["json"][0].update(status="skipped"),
        lambda r: r["json"][1].update(method="trajectory_twin_c128"),
        lambda r: r["json"][0].update(gates_checked=0),
        lambda r: r["json"][1].update(max_amp_err=2e-10),
    ],
    "fingerprints": [
        lambda r: r["json"][-1]["verify"].update(all_ok=False),
        lambda r: r["json"][-1]["verify"]["rows"][0].update(max_amp_err=1e-9),
        lambda r: r["json"][-1]["corrupted"].update(all_ok=True),
        lambda r: r["json"][-1]["corrupted"]["rows"].clear(),
    ],
}


@pytest.mark.parametrize("name,i", [(n, i) for n, edits in _CORRUPT.items()
                                    for i in range(len(edits))])
def test_phase11_checks_refuse(phase11, tmp_path, name, i):
    cs, _ = phase11
    res = cs.RECORD["bench11"][name]["result"]
    ref = cs.write_corpus(tmp_path)
    assert isinstance(cs.check_corpus(name, copy.deepcopy(res), ref), str)
    _refuse(cs, name, res, ref, _CORRUPT[name][i])


# ---------------------------------------------------------------------------
# chip_smoke.corpus_full on the CPU at tiny sizes
# ---------------------------------------------------------------------------

def _full_texts(cs):
    return {"nonstab_n21": lambda: to_qasm(library.non_stabilizer(21, depth=1)),
            "nonstab_n22": lambda: to_qasm(library.non_stabilizer(22, depth=1)),
            "traj_n8": lambda: cs.nonunitary_qasm(cs.traj_short(8)),
            "traj_n10": lambda: cs.nonunitary_qasm(cs.traj_short(10))}


def test_corpus_full_rehearsal(monkeypatch, tmp_path):
    """corpus_full's rows at tiny sizes, each branch its policy takes at
    full size: segments, segments through the memmap (QST_SEG_DISK_MIN
    lowered), the trajectory twin and its unitary-runs branch
    (QST_TRAJ_FULL_NMAX lowered); every row verified, its wall split into
    the timed parts, and the record written where it was asked."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "full_texts", lambda: _full_texts(cs))
    monkeypatch.setenv("QST_SEG_DISK_MIN", "22")
    monkeypatch.setenv("QST_TRAJ_FULL_NMAX", "9")
    monkeypatch.delenv("QST_SCRATCH", raising=False)
    rec = cs.corpus_full(out_dir=tmp_path)
    assert json.loads((tmp_path / "corpus_full.json").read_text()) == rec
    assert "QST_SCRATCH" not in os.environ
    rows = {e["row"]["circuit"]: e for e in rec["rows"]}
    assert list(rows) == list(_full_texts(cs))
    assert {k: e["row"]["method"] for k, e in rows.items()} == {
        "nonstab_n21": "segment_restart_c128[32]_fusedtier",
        "nonstab_n22": "segment_restart_c128[32]_fusedtier",
        "traj_n8": "trajectory_twin_c128",
        "traj_n10": "unitary_runs_segment_restart_c128[32]_fusedtier"}
    for name, e in rows.items():
        assert e["row"]["status"] == "verified" and e["row"]["max_amp_err"] < TOL
        assert set(e["split_s"]) >= {"engine", "oracle", "download", "compare",
                                     "rest"}, name
        assert abs(sum(e["split_s"].values()) - e["wall_s"]) < 1e-6
        assert e["host_peak_rss_gib"] > 0 and e["card_peak_gib"] is None
    assert rows["nonstab_n22"]["oracle_s_per_gate"] > 0
    assert not (ROOT / "build" / "corpus_full").exists()


def test_corpus_full_raises_on_a_failed_row(monkeypatch, tmp_path):
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "full_texts", lambda: _full_texts(cs))
    monkeypatch.setattr(corpus, "verify_one", lambda name, path: {
        "circuit": name, "n": 21, "status": "FAILED", "method": "e2e_c128"})
    with pytest.raises(AssertionError, match="not verified"):
        cs.corpus_full(["nonstab_n21"], out_dir=tmp_path)
    assert json.loads((tmp_path / "corpus_full.json").read_text())["rows"]
