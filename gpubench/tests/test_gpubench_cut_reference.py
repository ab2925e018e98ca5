"""The cut reference (``reference/cut``) against the full-state reference
at n = 12-16 on the CPU, the check's cut path against its full-state
path, and the configurations each path serves.  The control and the
planted faults through the cut path are ``test_gpubench_faults.py``'s
cases of the cut cell."""
import copy
import math
import time

import numpy as np
import pytest
import torch

from gpubench import check, circuits, kinds
from gpubench import run as R
from gpubench.reference import cut as cr
from gpubench.reference import statevector as sv
from gpubench.systems import Control, Planes

SPEC = R.load_json(R.ROOT / "BENCHMARK.json")
CUT_CELL = "nonstab33.capacity.zsweep"
SEED = 2 ** 31 + 4321


def crossing(cd, cut):
    return sum(1 for g in cd["gates"] if len(g["qubits"]) == 2
               and min(g["qubits"]) < cut <= max(g["qubits"]))


def random_across(n, cut, count, seed):
    """1-qubit gates anywhere and 2-qubit gates of every kind the reference
    has, one qubit each side of the cut: SWAP's operator-Schmidt rank is 4."""
    rng = np.random.default_rng(seed)
    gates = []
    for _ in range(count):
        if rng.random() < 0.5:
            name = ["H", "T", "SX", "RY"][rng.integers(4)]
            g = {"gate": name, "qubits": [int(rng.integers(n))]}
            if name == "RY":
                g["params"] = {"theta": float(rng.uniform(-3, 3))}
        else:
            a, b = int(rng.integers(cut)), int(rng.integers(cut, n))
            name = ["CNOT", "CZ", "SWAP", "CP", "RZZ"][rng.integers(5)]
            pair = [a, b] if rng.random() < 0.5 else [b, a]
            g = {"gate": name, "qubits": pair}
            if name in ("CP", "RZZ"):
                g["params"] = {"phi" if name == "CP" else "theta":
                               float(rng.uniform(-3, 3))}
        gates.append(g)
    return {"number_of_qubits": n, "gates": gates}


CASES = {
    "nonstab14_cut10_0cnot": (circuits.non_stabilizer(14), 10),
    "nonstab14_cut8_1cnot": (circuits.non_stabilizer(14), 8),
    "nonstab14_cut1_3cnot": (circuits.non_stabilizer(14), 1),
    "nonstab16_cut8_3cnot": (circuits.non_stabilizer(16), 8),
    "qaoa12_cut11_rzz": (circuits.qaoa_maxcut(12), 11),
    "random13_cut6_rank4": (random_across(13, 6, 10, 1), 6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunks_match_the_full_state(case):
    cd, cut = CASES[case]
    n = cd["number_of_qubits"]
    tag = case.split("_")[-1]
    want_cross = {"0cnot": 0, "1cnot": 1, "3cnot": 3}.get(tag)
    if want_cross is not None:
        assert crossing(cd, cut) == want_cross
    full = sv.simulate(cd, "cpu")
    ref = cr.CutReference(cd, cut, "cpu")
    assert ref.n == n
    for size in (1 << 5, 1 << cut, 3 << cut, 1000, 1 << n):
        starts, parts = zip(*ref.chunks(size))
        assert all(p.numel() <= size for p in parts)
        assert list(starts) == list(range(0, 1 << n, size))
        got = torch.cat(parts)
        assert got.dtype == torch.complex128
        assert float((got - full).abs().max()) < 1e-12
    probs = sv.probabilities(full)
    rng = np.random.default_rng(n + cut)
    for k in (1, 2, 3, 4):
        qubits = sorted(int(q) for q in rng.choice(n, k, replace=False))
        assert ref.z_expectation(qubits) == pytest.approx(
            sv.z_expectation(probs, n, qubits), abs=1e-12)
    assert ref.norm2() == pytest.approx(1.0, abs=1e-12)


def test_terms_are_the_product_of_the_crossing_ranks():
    cd, cut = CASES["qaoa12_cut11_rzz"]
    assert cr.CutReference(cd, cut, "cpu").terms == 2 ** crossing(cd, cut)
    cd = {"number_of_qubits": 4, "gates": [
        {"gate": "SWAP", "qubits": [0, 3]}, {"gate": "CZ", "qubits": [2, 1]}]}
    assert cr.CutReference(cd, 2, "cpu").terms == 8
    cd = {"number_of_qubits": 4, "gates": [
        {"gate": "SWAP", "qubits": [0, 3]}] * 5}
    with pytest.raises(ValueError, match="over the cap of 256"):
        cr.CutReference(cd, 2, "cpu")
    with pytest.raises(ValueError, match="does not split"):
        cr.CutReference(cd, 4, "cpu")


@pytest.mark.parametrize("name, rank", [("CNOT", 2), ("CZ", 2), ("RZZ", 2),
                                        ("CP", 2), ("SWAP", 4), ("random", 4)])
def test_schmidt_sums_back_to_the_gate(name, rank):
    if name == "random":
        rng = np.random.default_rng(11)
        z = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
        U = np.linalg.qr(z)[0]
    else:
        g = {"gate": name, "qubits": [0, 1]}
        if name in ("RZZ", "CP"):
            g["params"] = {"theta" if name == "RZZ" else "phi": 0.9}
        U = sv.gate_matrix(g)
    factors = cr.schmidt(U)
    assert len(factors) == rank
    np.testing.assert_allclose(sum(np.kron(M, N) for M, N in factors), U,
                               atol=1e-14)


@pytest.mark.parametrize("form", ["tensor", "planes"])
def test_chunked_state_err_equals_the_full_one(form):
    cd, cut = CASES["nonstab14_cut1_3cnot"]
    psi = sv.simulate(cd, "cpu", tf32=True)  # a state 1e-3 or so off
    state = psi if form == "tensor" else Planes(psi.real.contiguous(),
                                                psi.imag.contiguous())
    want = check.state_err(psi, sv.simulate(cd, "cpu"))
    ref = cr.CutReference(cd, cut, "cpu")
    assert 1e-5 < want < 1e-1
    for chunk in (1 << 24, 1 << 9):
        assert check.state_err_cut(state, ref, chunk) == pytest.approx(
            want, rel=1e-9)


def test_the_tf32_halves_are_the_control():
    cd, cut = CASES["nonstab14_cut1_3cnot"]
    lo = cr.CutReference(cd, cut, "cpu", tf32=True)
    assert lo.A.dtype == torch.complex64
    planes = Control(torch.device("cpu"), {"reference": {
        "kind": "cut", "cut": cut}, "params": {"n": 14}}).run(cd, {})
    assert planes.re.dtype == torch.float32
    err = check.state_err_cut(planes, cr.CutReference(cd, cut, "cpu"))
    assert 1e-5 < err < 1e-1


def test_each_configuration_resolves_its_path():
    paths = {c["name"]: check.reference_cut(R.load_json(R.ROOT / c["file"]))
             for c in SPEC["configs"]}
    assert paths == {"nonstab28": None, "qaoa28": None, "nonstab33": 16}
    with pytest.raises(ValueError):
        check.reference_cut({"reference": {"kind": "mps"}})
    for name in ("sample", "maxcut_energy"):
        with pytest.raises(NotImplementedError, match="no cut reference yet"):
            kinds.cut_fn(kinds.load(name), "cut_error")


def full_state_numbers(kind, records, last_state, config, traffic, chk,
                       seed, device):
    """The full-state comparison as it stood before the cut path, line for
    line: the numbers the four full-state cells have to keep."""
    n = config["params"]["n"]
    out = {"state_err": math.inf}
    worst = 0.0
    recs = check.chosen(records, traffic.get("new_instance", False),
                        chk.get("requests", 1), seed)
    by_circuit = {}
    for r in recs:
        by_circuit.setdefault(id(r.request.circuit), []).append(r)
    last = recs[-1] if recs else None
    for group in by_circuit.values():
        ref = sv.simulate(group[0].request.circuit, device)
        if last in group and last_state is not None:
            out["state_err"] = check.state_err(last_state, ref)
        probs = sv.probabilities(ref)
        del ref
        for r in group:
            worst = max(worst, kind.error(r.answer, r.request, probs, n,
                                          config))
        del probs
    out[kind.NUMBER] = worst if recs else math.inf
    return out


def small(workload, n=10):
    cell = copy.deepcopy(R.load_cell(SPEC, workload))
    cell.config["params"]["n"] = n
    if "edges" in cell.config:
        cell.config["edges"]["params"]["n"] = n
    if "reference" in cell.config:
        cell.config["reference"]["cut"] = n // 2
    return cell


# The cells held to the whole state alone; a check that holds its answers to
# their light cones (``"answers": "light_cone"``) is tested in
# test_gpubench_lightcone.py.
FULL_STATE_CELLS = [w["name"] for w in SPEC["workloads"]
                    if w["name"] != CUT_CELL
                    and "answers" not in R.load_cell(SPEC, w["name"]).check]


@pytest.mark.parametrize("workload", FULL_STATE_CELLS)
def test_full_state_cells_keep_their_numbers(workload, monkeypatch):
    seen = []
    compare = check.compare

    def spy(*args):
        out = compare(*args)
        seen.append((args, out))
        return out

    monkeypatch.setattr(check, "compare", spy)
    monkeypatch.setattr(cr, "CutReference", None)  # the cut path is not taken
    R.run_cell(small(workload), SEED, 0.3, False, "cpu",
               t_start=time.perf_counter())
    (args, out), = seen
    assert out == full_state_numbers(*args)
    assert all(math.isfinite(v) for v in out.values())


def test_the_cut_cell_never_builds_the_state(monkeypatch):
    def no(*args, **kwargs):
        raise AssertionError("a state-sized reference")

    monkeypatch.setattr(sv, "simulate", no)
    monkeypatch.setattr(sv, "probabilities", no)
    sizes = []
    chunks = cr.CutReference.chunks

    def spy(self, size):
        for start, amps in chunks(self, size):
            sizes.append(amps.numel())
            yield start, amps

    monkeypatch.setattr(cr.CutReference, "chunks", spy)
    res = R.run_cell(small(CUT_CELL, n=12), SEED, 0.3, False, "cpu",
                     t_start=time.perf_counter())
    assert res["correct"] is True, res["checks"]
    assert sum(sizes) == 1 << 12 and max(sizes) <= 1 << 24
