"""The diag path's plain twins against the JAX package: ``fused_diag``,
the panels' diag epilogue, ``DiagTerms`` packing and the dispatch of
``DiagOp``.

The JAX side runs as its own tests run it: on the CPU, ``interpret=True``,
float64 planes (x64 is on through ``tests/conftest.py``).  The port's
wrappers get CPU tensors, so they run their plain twins.  Both sides see
the same seeded numpy state and terms; float64 on both sides, so the
tolerance is 1e-10.
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from quantum_simulations_tpu.circuit import library as rlib
from quantum_simulations_tpu.circuit.panelize import (
    DiagOp as RDiagOp, compile_window_schedule,
)
from quantum_simulations_tpu.ops import pallas_kernels as rk
from quantum_simulations_tpu.runtime import simulator as RS
from quantum_simulations_tpu_torch import convert
from quantum_simulations_tpu_torch.ops import diag_kernels as dk
from quantum_simulations_tpu_torch.ops import panel_kernels as pk
from quantum_simulations_tpu_torch.runtime import simulator as PS

ATOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """pytest-xdist runs several workers on the machine's cores; one
    thread each keeps the 128-wide products from oversubscribing them."""
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


def _terms(n, count, seed, scale=5.0):
    """Random Möbius terms of order <= 3 on n qubits, the global term too."""
    rng = np.random.default_rng(seed)
    terms = {(): float(rng.uniform(-scale, scale))}
    while len(terms) < count:
        qs = sorted(rng.choice(n, rng.integers(1, 4), replace=False))
        terms[tuple(int(q) for q in qs)] = float(rng.uniform(-scale, scale))
    return tuple(terms.items())


def _qaoa18_run():
    """qaoa_maxcut(18)'s first merged diag run (32 terms) as the
    reference's scheduler makes it."""
    ops = compile_window_schedule(rlib.qaoa_maxcut(18), diag_terms_only=True)
    run = next(op for op in ops if isinstance(op, RDiagOp))
    assert len(run.terms) == 32
    return tuple(run.terms)


def _ref(fn, psi, *args, **kw):
    re, im = fn(jnp.asarray(psi.real), jnp.asarray(psi.imag), *args, **kw)
    return np.asarray(re) + 1j * np.asarray(im)


def _port(fn, psi, *args, **kw):
    re, im = fn(torch.from_numpy(psi.real.copy()),
                torch.from_numpy(psi.imag.copy()), *args, **kw)
    return re.numpy() + 1j * im.numpy()


def _check(got, want):
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) < ATOL


@pytest.mark.parametrize("case", ["qaoa18_run", "random_n12", "random_n16"])
def test_fused_diag_matches_fused_diag_planar(case):
    if case == "qaoa18_run":
        n, terms = 18, _qaoa18_run()
    else:
        n = int(case.removeprefix("random_n"))
        terms = _terms(n, 40, n)
    psi = _state(n, n)
    dk.reset_counts()
    got = _port(dk.fused_diag, psi, terms)
    assert dk.PLAIN_CALLS["fused_diag"] == 1
    _check(got, _ref(rk.fused_diag_planar, psi, terms, interpret=True))


@pytest.mark.parametrize("n", [3, 9])
def test_fused_diag_small_states(n):
    """Below the (8, 128) block the reference evaluates the phase on the
    host; the port's twin (and kernel) take every n."""
    psi, terms = _state(n, n), _terms(n, 6, n)
    _check(_port(dk.fused_diag, psi, terms),
           _ref(rk.fused_diag_planar, psi, terms, interpret=True))


def test_lane_panel_diag_matches_reference():
    n = 14
    psi, W, terms = _state(n, 1), _unitary(128, 1), _terms(n, 50, 1)
    pk.reset_counts()
    got = _port(pk.lane_panel, psi, W, diag_terms=terms)
    assert pk.PLAIN_CALLS["lane_panel+diag"] == 1
    _check(got, _ref(rk.panel_apply_planar, psi, W, diag_terms=terms,
                     interpret=True))


@pytest.mark.parametrize("n,pos,w", [(16, 7, 7), (16, 9, 7), (17, 10, 7),
                                     (14, 9, 5)],
                         ids=["pos7", "pos9", "pos10_4d", "ragged_dim32"])
def test_positioned_panel_diag_matches_reference(n, pos, w):
    psi, W, terms = _state(n, pos), _unitary(1 << w, pos), _terms(n, 60, pos)
    pk.reset_counts()
    got = _port(pk.positioned_panel, psi, W, pos, diag_terms=terms)
    assert pk.PLAIN_CALLS["positioned_panel+diag"] == 1
    _check(got, _ref(rk.positioned_panel_planar, psi, W, pos,
                     diag_terms=terms, interpret=True))


@pytest.mark.parametrize("n", [12, 15])
@pytest.mark.parametrize("order", [(0, 7), (7, 0)], ids=["lane_first", "full_first"])
@pytest.mark.parametrize("post", [False, True], ids=["no_post", "post_u4"])
def test_dual_panel_diag_matches_reference(n, order, post):
    psi, terms = _state(n, n), _terms(n, 55, n)
    Ws = {0: _unitary(128, 3), 7: _unitary(128 if n >= 14 else 32, 4)}
    args = (Ws[order[0]], order[0], Ws[order[1]], order[1])
    kw = dict(straddle=(6, 9, _unitary(4, 9)),
              post_straddle=(6, 8, _unitary(4, 8)) if post else None,
              diag_terms=terms)
    _check(_port(pk.dual_panel, psi, *args, **kw),
           _ref(rk.dual_panel_planar, psi, *args, interpret=True, **kw))


def _angles_u32(d, n):
    """The kernel's fixed-point angle of every index of 2^n, computed on
    the host from the packed words with the kernel's uint32 arithmetic
    (``csrc/phase.cuh``)."""
    L = dk.LANES
    w = d.words.astype(np.uint64)
    lane_tab, lmask = w[:L], w[L:L + d.G]
    start = w[L + d.G:L + 2 * d.G + 1].astype(np.int64)
    rmask = w[L + 2 * d.G + 1:L + 2 * d.G + 1 + d.T]
    coeff = w[L + 2 * d.G + 1 + d.T:]
    idx = np.arange(1 << n, dtype=np.uint64)
    row, lane = idx >> np.uint64(dk.LANE_BITS), idx & np.uint64(L - 1)
    acc = lane_tab[lane.astype(np.int64)].copy()
    for g in range(d.G):
        on = (lane & lmask[g]) == lmask[g]
        for k in range(start[g], start[g + 1]):
            acc += np.where(on & ((row & rmask[k]) == rmask[k]), coeff[k],
                            np.uint64(0))
    return (acc % np.uint64(1 << 32)).astype(np.uint32)


def test_fixed_point_packing_against_float64_theta():
    """Sum |coeff| > 100 rad: a float32 sum would be off by ~1e-5 rad;
    the 32-bit fixed-point turns stay within 1e-8 rad of float64."""
    n = 14
    terms = _terms(n, 48, 7, scale=6.0)
    assert sum(abs(c) for _, c in terms) > 100
    got = _angles_u32(dk.DiagTerms.of(terms), n).astype(np.float64) * (
        2 * np.pi / 2.0 ** 32)
    want = dk.terms_theta(1 << n, terms, torch.float64, "cpu").numpy()
    err = (got - want + np.pi) % (2 * np.pi) - np.pi
    assert float(np.max(np.abs(err))) < 1e-8


def test_diag_terms_grouping():
    """Lane-only terms fold into the lane table; row-side terms group by
    their lane-bit subset, pure-row terms in the group of L = {}."""
    terms = (((), 0.5), ((3,), 1.0), ((2, 5), 0.25), ((9,), 2.0),
             ((1, 9), 3.0), ((1, 12), 4.0), ((1, 2, 20), 5.0))
    d = dk.DiagTerms.of(terms)
    assert (d.G, d.T) == (3, 4)
    lmask = list(d.words[128:128 + d.G])
    assert sorted(lmask) == [0, 0b10, 0b110]
    assert d.words[0] == dk._turns_u32(0.5)
    assert d.words[0b101100] == (dk._turns_u32(0.5) + dk._turns_u32(1.0)
                                 + dk._turns_u32(0.25)) % (1 << 32)
    assert dk.DiagTerms.of(d) is d and dk.DiagTerms.of(None) is None


@pytest.mark.parametrize("n", [9, 12])
def test_diag_op_dispatch_matches_reference(n, monkeypatch):
    """DiagOps with a phase vector d (QST_DIAG_TERMS_ONLY=0) run from
    their terms through fused_diag; the reference runs the terms below
    2^10 amplitudes and the broadcast of d above.  A DiagOp without terms
    raises."""
    monkeypatch.setenv("QST_DIAG_TERMS_ONLY", "0")
    ref_ops = compile_window_schedule(rlib.qaoa_maxcut(n), diag_terms_only=False)
    diags = [op for op in ref_ops if isinstance(op, RDiagOp)]
    assert diags and all(op.d is not None and op.terms for op in diags)
    psi = _state(n, n)
    for rop in diags:
        op = convert.ops_from_reference([rop])[0]
        want = _ref(lambda re, im: RS.apply_window_op(
            re, im, rop, jnp.complex128, True), psi)
        _check(_port(PS.apply_window_op, psi, op), want)
    with pytest.raises(ValueError, match="only its phase vector d"):
        _port(PS.apply_window_op, psi, dataclasses.replace(op, terms=None))
