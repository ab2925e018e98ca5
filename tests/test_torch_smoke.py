"""The library calls that ``chip_smoke.py`` times beside each kernel
compute the same function as the kernel's plain twin.

They are timed on the card only and used nowhere in the port, so this is
their one check: on the CPU, in complex128, against the twins at 1e-10.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from quantum_simulations_tpu_torch.circuit.panelize import (
    DualPanelOp, WindowPanelOp,
)
from quantum_simulations_tpu_torch.ops import diag_kernels as dk
from quantum_simulations_tpu_torch.ops import panel_kernels as pk

ROOT = Path(__file__).resolve().parent.parent
N_QUBITS = 15
CPU = torch.device("cpu")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def _unitary(dim, seed):
    rng = np.random.default_rng(seed)
    return cs.rand_unitary(dim, rng)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    n = N_QUBITS
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi /= np.linalg.norm(psi)
    re, im = torch.from_numpy(psi.real.copy()), torch.from_numpy(psi.imag.copy())
    terms = dk.DiagTerms.of(cs.rand_terms(n, 30, rng))
    return (re, im), torch.from_numpy(psi), terms


def _cw(W):
    return torch.as_tensor(W, dtype=torch.complex128)


def _close(lib_out, twin_out):
    got = lib_out.reshape(-1)
    want = pk.from_planar(*twin_out)
    assert float((got - want).abs().max()) < 1e-10


@pytest.mark.parametrize("diag", [False, True], ids=["panel", "panel+diag"])
@pytest.mark.parametrize("pos", [0, 7, 8])
def test_panel_library_matches_twin(pos, diag):
    x, xc, terms = _inputs(pos)
    W = _unitary(128, pos + 1)
    dt = terms if diag else None
    ph = cs.phase_table(xc.numel(), terms, CPU, torch.float64) if diag else None
    lib = cs.panel_library(xc, _cw(W), pos, ph)
    if pos == 0:
        twin = pk.lane_panel_plain(*x, W, diag_terms=dt)
    else:
        twin = pk.positioned_panel_plain(*x, W, pos, diag_terms=dt)
    _close(lib(), twin)


@pytest.mark.parametrize("case", ["dual", "dual+pre", "dual+diag"])
def test_dual_library_matches_twin(case):
    x, xc, terms = _inputs(3)
    lane = WindowPanelOp(0, _unitary(128, 4), 1)
    row = WindowPanelOp(7, _unitary(128, 5), 1)
    pre = (6, 9, _unitary(4, 6)) if case == "dual+pre" else None
    op = DualPanelOp(row, lane, pre_straddle=pre)
    dt = terms if case == "dual+diag" else None
    ph = (cs.phase_table(xc.numel(), terms, CPU, torch.float64)
          if dt is not None else None)
    lib = cs.dual_library(xc, op, _cw, ph)
    twin = pk.dual_panel_plain(*x, row.W, 7, lane.W, 0, straddle=pre,
                               diag_terms=dt)
    _close(lib(), twin)


def test_fused_diag_library_matches_twin():
    x, xc, terms = _inputs(11)
    ph = cs.phase_table(xc.numel(), terms, CPU, torch.float64)
    _close(xc * ph, dk.fused_diag_plain(*x, terms))


@pytest.mark.parametrize("qs", [(0, 14), (9, 2), (6, 7), (7, 6), (7, 11),
                                (14, 13)])
def test_pair_library_matches_twin(qs):
    from quantum_simulations_tpu_torch.ops import pair_kernels as pq

    x, xc, _ = _inputs(sum(qs))
    U = _unitary(4, qs[0])
    _close(cs.pair_library(xc, *qs, U)(), pq.pair_gate_plain(*x, *qs, U))


def test_cross_library_matches_twin():
    from quantum_simulations_tpu_torch.ops import bitperm_kernels as bk

    x, xc, _ = _inputs(13)
    cross = (10, 14, 8, 12, 13, 9, 11)
    got = cs.cross_library(xc, cross)().reshape(-1)
    want = pk.from_planar(*bk.bitperm_cross_plain(*x, cross))
    assert torch.equal(got, want)
