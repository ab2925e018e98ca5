"""Dense helpers of the window path: numpy panel composition and plain
torch state construction.

The counterparts of ``quantum_simulations_tpu/ops/dense.py``'s
``expand_to_low_block``, ``compose_low_panel``, ``_SWAP4``,
``zero_state``, ``zero_state_planar`` and ``apply_gate_planar``.
The reference's diagonal helpers have no copy here: every ``DiagOp``
carries its Möbius terms, so ``ops/diag_kernels.fused_diag`` serves it.

Endianness: little — qubit 0 is bit 0 of the flat index.
Gate matrices are big-endian in the gate subspace (qubits[0] = MSB).
"""
from __future__ import annotations

import numpy as np
import torch

_SWAP4 = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                   [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex128)


def expand_to_low_block(qubits: tuple[int, ...], U: np.ndarray, width: int) -> np.ndarray:
    """Expand an m-qubit gate to a 2^width x 2^width matrix over bits 0..width-1.

    The result W is little-endian over the low `width` bits and satisfies
    (psi.reshape(-1, 2^width) @ W.T) == gate applied.  All gate qubits
    must be < width.
    """
    m = len(qubits)
    assert all(q < width for q in qubits)
    dim = 1 << width
    idx = np.arange(dim)
    # gate subspace index of each low-block index (big-endian gate order)
    sub = np.zeros(dim, dtype=np.int64)
    for j, q in enumerate(qubits):
        sub |= ((idx >> q) & 1) << (m - 1 - j)
    other_mask = (dim - 1) ^ sum(1 << q for q in qubits)
    other = idx & other_mask
    W = np.zeros((dim, dim), dtype=np.complex128)
    same = other[:, None] == other[None, :]
    W[same] = np.asarray(U, dtype=np.complex128)[sub[:, None], sub[None, :]][same]
    return W


def compose_low_panel(ops: list[tuple[tuple[int, ...], np.ndarray]], width: int) -> np.ndarray:
    """Fuse a sequence of gates (applied first-to-last) on low qubits into one W."""
    W = np.eye(1 << width, dtype=np.complex128)
    for qubits, U in ops:
        W = expand_to_low_block(tuple(qubits), U, width) @ W
    return W


def zero_state(m: int, dtype=torch.complex64, device="cpu") -> torch.Tensor:
    psi = torch.zeros(1 << m, dtype=dtype, device=device)
    psi[0] = 1.0
    return psi


def zero_state_planar(m: int, fdtype=torch.float32, device="cpu"):
    """|0...0> as (re, im) planes — no complex materialisation."""
    re = torch.zeros(1 << m, dtype=fdtype, device=device)
    re[0] = 1.0
    return re, torch.zeros(1 << m, dtype=fdtype, device=device)


def apply_gate_planar(re: torch.Tensor, im: torch.Tensor,
                      qubits: tuple[int, ...], U: np.ndarray):
    """Any m-qubit gate on (re, im) planes, in plain torch.

    The reference tries elementwise plane forms and falls back to its
    complex path for a gate that straddles the lane window; here one
    dense contraction over the gate's axes serves every case.  Only the
    small-state branch of ``panel_kernels.dual_panel`` calls it.
    """
    n = re.numel().bit_length() - 1
    m = len(qubits)
    U = np.asarray(U, dtype=np.complex128)
    ur = torch.as_tensor(U.real, dtype=re.dtype, device=re.device)
    ui = torch.as_tensor(U.imag, dtype=re.dtype, device=re.device)
    axes = [n - 1 - q for q in qubits]

    def gather(x):
        x = torch.movedim(x.reshape((2,) * n), axes, list(range(m)))
        return x.reshape(1 << m, -1)

    def scatter(y):
        y = y.reshape((2,) * n)
        return torch.movedim(y, list(range(m)), axes).reshape(re.numel())

    xr, xi = gather(re), gather(im)
    return scatter(ur @ xr - ui @ xi), scatter(ur @ xi + ui @ xr)

