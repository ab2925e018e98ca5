"""The port's window scheduler emits the reference's op list.

Same circuit -> the same ops, in order, with the same positions, panel
matrices (1e-12), fused-gate counts, straddler gates, diag terms and SWAP
networks, so every kernel of the port can be held op against op to the
JAX package's.  Scheduling is numpy-only on both sides.
"""
import numpy as np
import pytest
import torch

from quantum_simulations_tpu.circuit import library as rlib
from quantum_simulations_tpu.circuit import panelize as RP
from quantum_simulations_tpu.runtime import simulator as RS
from quantum_simulations_tpu_torch.circuit import panelize as PP
from quantum_simulations_tpu_torch.runtime import simulator as PS


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


CIRCUITS = [(f"nonstab{n}", rlib.non_stabilizer(n)) for n in (12, 16, 18, 20, 28)] + [
    ("nonstab12_d3", rlib.non_stabilizer(12, depth=3)),
    ("qft10", rlib.qft(10)),
    ("sycamore14", rlib.sycamore_like(14, depth=4)),
    ("random10", rlib.random_circuit(10, 80, seed=2)),
    ("ghz14", rlib.ghz(14)),
    ("qaoa10", rlib.qaoa_maxcut(10, p=2)),
    ("w9", rlib.w_state(9)),
    ("qpe7", rlib.qpe(6)),
    ("qft18", rlib.qft(18)),
    # PhysGateOps on every pair class, MultiSwapOps, at full width
    ("qpe28", rlib.qpe(27)),
    ("qft_adder28", rlib.qft_adder(28)),
    ("deutsch_jozsa28", rlib.deutsch_jozsa(28)),
    ("w_qft28", rlib.w_qft(28)),
]


def _close(a, b, tol=1e-12):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b), initial=0.0) <= tol


def _terms(t):
    return None if t is None else {tuple(qs): c for qs, c in t}


def assert_same_op(r, p):
    name = type(r).__name__
    assert type(p).__name__ == name
    if name == "WindowPanelOp":
        assert (p.pos, p.n_fused) == (r.pos, r.n_fused)
        _close(p.W, r.W)
        assert [q for q, _ in p.run] == [q for q, _ in r.run]
        for (_, up), (_, ur) in zip(p.run, r.run):
            _close(up, ur)
    elif name == "DualPanelOp":
        assert_same_op(r.first, p.first)
        assert_same_op(r.second, p.second)
        for sr, sp in ((r.pre_straddle, p.pre_straddle),
                       (r.post_straddle, p.post_straddle)):
            assert (sr is None) == (sp is None)
            if sr is not None:
                assert sp[:2] == sr[:2]
                _close(sp[2], sr[2])
    elif name == "PhysGateOp":
        assert (p.qubits, p.name) == (r.qubits, r.name)
        _close(p.U, r.U)
    elif name == "DiagOp":
        assert (p.qubits, p.name) == (r.qubits, r.name)
        _close(p.d, r.d)
        tp, tr = _terms(p.terms), _terms(r.terms)
        assert (tp is None) == (tr is None)
        if tp is not None:
            assert tp.keys() == tr.keys()
            assert all(abs(tp[k] - tr[k]) <= 1e-12 for k in tp)
    elif name == "MultiSwapOp":
        assert p.pairs == r.pairs
    elif name == "BitPermOp":
        assert (p.mid_pairs, p.cross) == (r.mid_pairs, r.cross)
    elif name == "BitPermGridOp":
        assert (p.pairs, p.grid_map) == (r.pairs, r.grid_map)
    else:
        assert name == "TransposeCrossOp", name


def assert_same_schedule(ref, port):
    assert [type(o).__name__ for o, _ in port] == [type(o).__name__ for o, _ in ref]
    for (r, tr), (p, tp) in zip(ref, port):
        assert_same_op(r, p)
        assert (_terms(tp) is None) == (_terms(tr) is None)
        if tr is not None:
            assert _terms(tp).keys() == _terms(tr).keys()


@pytest.mark.parametrize("terms_only", [True, False], ids=["terms", "vector"])
@pytest.mark.parametrize("tag,cd", CIRCUITS, ids=[c[0] for c in CIRCUITS])
def test_schedule_matches_reference(tag, cd, terms_only):
    ref = RS.pair_panel_diag(RP.compile_window_schedule(cd, diag_terms_only=terms_only))
    port = PS.pair_panel_diag(PP.compile_window_schedule(cd, diag_terms_only=terms_only))
    assert_same_schedule(ref, port)
    assert PP.window_stats(cd) == RP.window_stats(cd)


def test_nonstab28_is_five_panel_passes():
    ops = PP.compile_window_schedule(rlib.non_stabilizer(28, depth=4, seed=7),
                                     diag_terms_only=True)
    got = [(type(o).__name__, getattr(o, "pos", None),
            None if not hasattr(o, "pre_straddle") or o.pre_straddle is None
            else o.pre_straddle[:2]) for o in ops]
    assert got == [("DualPanelOp", None, None), ("WindowPanelOp", 14, None),
                   ("WindowPanelOp", 21, None), ("DualPanelOp", None, (6, 7)),
                   ("WindowPanelOp", 11, None)]


@pytest.mark.parametrize("switch", [
    "QST_PANEL_PAIR_FUSE", "QST_STRADDLE_FOLD", "QST_BITPERM_DECOMP",
    "QST_PANEL_GLOBAL_COALESCE", "QST_PANEL_DIAG_FUSE",
])
def test_switches_match_reference(monkeypatch, switch):
    monkeypatch.setenv(switch, "0")
    for cd in (rlib.non_stabilizer(16), rlib.qft(18), rlib.qaoa_maxcut(14, p=2)):
        ref = RS.pair_panel_diag(RP.compile_window_schedule(cd, diag_terms_only=True))
        port = PS.pair_panel_diag(PP.compile_window_schedule(cd, diag_terms_only=True))
        assert_same_schedule(ref, port)


def test_panel_diag_fuse_min(monkeypatch):
    monkeypatch.setenv("QST_PANEL_DIAG_FUSE_MIN", "2")
    cd = rlib.qft(18)
    ref = RS.pair_panel_diag(RP.compile_window_schedule(cd, diag_terms_only=True))
    port = PS.pair_panel_diag(PP.compile_window_schedule(cd, diag_terms_only=True))
    assert any(t is not None for _, t in ref)
    assert_same_schedule(ref, port)
