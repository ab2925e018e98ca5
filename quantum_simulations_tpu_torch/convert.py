"""Carry schedules and states between the JAX package and the port.

``ops_from_reference`` rebuilds a window schedule made by the JAX
package as the port's op objects, by class name and fields alone (it
imports nothing of the JAX package), so the port's executor can run the
reference's exact op list.  ``planes_from_numpy`` and ``to_numpy`` move
a state across as host numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .circuit import panelize as P


def _terms(terms):
    if terms is None:
        return None
    return tuple((tuple(int(q) for q in qs), float(c)) for qs, c in terms)


def _straddle(s):
    if s is None:
        return None
    qa, qb, U = s
    return (int(qa), int(qb), np.asarray(U, np.complex128))


def _op(op):
    name = type(op).__name__
    if name == "WindowPanelOp":
        run = tuple((tuple(int(q) for q in qs), np.asarray(U))
                    for qs, U in op.run)
        return P.WindowPanelOp(int(op.pos), np.asarray(op.W), int(op.n_fused),
                               run=run)
    if name == "DualPanelOp":
        return P.DualPanelOp(_op(op.first), _op(op.second),
                             pre_straddle=_straddle(op.pre_straddle),
                             post_straddle=_straddle(op.post_straddle))
    if name == "PhysGateOp":
        return P.PhysGateOp(tuple(int(q) for q in op.qubits),
                            np.asarray(op.U), op.name)
    if name == "DiagOp":
        d = None if op.d is None else np.asarray(op.d)
        return P.DiagOp(tuple(int(q) for q in op.qubits), d,
                        name=op.name, terms=_terms(op.terms))
    if name == "MultiSwapOp":
        return P.MultiSwapOp(tuple(tuple(p) for p in op.pairs))
    if name == "BitPermOp":
        return P.BitPermOp(tuple(tuple(p) for p in op.mid_pairs),
                           tuple(op.cross))
    if name == "BitPermGridOp":
        return P.BitPermGridOp(tuple(tuple(p) for p in op.pairs),
                               tuple(tuple(m) for m in op.grid_map))
    if name == "TransposeCrossOp":
        return P.TransposeCrossOp()
    raise TypeError(f"no port counterpart for schedule op {name}")


def ops_from_reference(ops) -> list:
    """The port's ops for a reference window schedule: a list of ops, or
    of ``(op, diag_terms)`` pairs as ``pair_panel_diag`` returns them."""
    out = []
    for item in ops:
        if isinstance(item, tuple):
            op, terms = item
            out.append((_op(op), _terms(terms)))
        else:
            out.append(_op(item))
    return out


def planes_from_numpy(psi, device="cuda", fdtype=torch.float64):
    """(re, im) planes of ``fdtype`` on ``device`` from a complex vector."""
    psi = np.asarray(psi)
    return (torch.as_tensor(np.ascontiguousarray(psi.real), device=device).to(fdtype),
            torch.as_tensor(np.ascontiguousarray(psi.imag), device=device).to(fdtype))


def to_numpy(re: torch.Tensor, im: torch.Tensor) -> np.ndarray:
    """The complex host vector of (re, im) planes."""
    return re.cpu().numpy() + 1j * im.cpu().numpy()
