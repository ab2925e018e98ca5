"""The ``zstring_sum`` CUDA kernel (``csrc/readout.cu``): Z-string sums
over a whole state in one read.

``zstring_sum(re, im, masks)`` launches it once for up to ``CAP`` masks
(Python ints of up to 64 bits, the qubits of a Z-string) and gives the
float64 sums S_k = sum_i |psi_i|^2 (-1)^popcount(i & m_k) as a (K,)
tensor on the card.  It replaces no Pallas kernel (the JAX package's
readout is plain jnp).  ``sampling.zstring_sums`` is the readout's entry:
it asks ``takes`` whether the kernel reads the planes, runs the plain twin
(``sampling.zstring_sums_plain``) where it does not, and counts the
passes; this module only launches.

The kernel reads a complex64 tensor's ``.real`` / ``.imag`` views as the
data lies (stride 2, ``im`` four bytes after ``re``) or two contiguous
float32 planes (the capacity tier, the shards, the basis-changed planes
of ``expectation_pauli``).  ``LAUNCHES`` counts its launches and
``PLAIN_CALLS`` the twin's passes.  The module is not among the kernel
modules whose counts are state passes: a readout pass only reads.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import check_aligned, launch, load

CAP = 128   # masks a launch: csrc/readout.cu's KMAX, which refuses more

LAUNCHES = {"zstring_sum": 0}
PLAIN_CALLS = dict(LAUNCHES)


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def takes(re: torch.Tensor, im: torch.Tensor) -> bool:
    """True: the kernel reads these planes.  False: the twin does (CPU
    planes, or float64 planes on any device: the complex128 route).  Any
    other CUDA planes raise: there is no fallback."""
    if re.shape != im.shape or re.dim() != 1 or re.device != im.device:
        raise ValueError("zstring_sum: planes must be two flat tensors of one "
                         "shape on one device")
    if re.dtype == torch.float64 and im.dtype == torch.float64:
        return False
    if re.device.type == "cpu":
        return False
    if re.device.type != "cuda":
        raise RuntimeError(f"zstring_sum: no kernel for device {re.device}")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"zstring_sum: the CUDA kernel takes float32 planes, "
                        f"got {re.dtype} / {im.dtype}")
    return True


def _planar(re: torch.Tensor, im: torch.Tensor) -> bool:
    """The layout the kernel reads: False for a complex64 tensor's real and
    imaginary views, True for two contiguous planes; raise on any other."""
    if (re.stride() == im.stride() == (2,)
            and im.data_ptr() == re.data_ptr() + 4):
        check_aligned("zstring_sum", re)
        return False
    if re.is_contiguous() and im.is_contiguous():
        check_aligned("zstring_sum", re, im)
        return True
    raise ValueError("zstring_sum: the kernel reads a complex64 tensor's "
                     ".real / .imag or two contiguous float32 planes")


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "qst_error_string": (ctypes.c_char_p, [_I]),
    "qst_zstring_blocks": (_I, [_LL, _P, _I]),
    "qst_zstring_sums": (_I, [_P, _P, _I, _LL, _P, _I, _P, _I, _P, _I, _P]),
}
_GRID: dict[tuple[int, int], int] = {}


def _blocks(device: torch.device, n_amps: int) -> int:
    """The kernel's grid for a state of ``n_amps`` on ``device``, as
    csrc/readout.cu sets it (one query a device and size)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, n_amps)
    if key not in _GRID:
        lib = load("readout", _SIGNATURES)
        out = ctypes.c_int(0)
        err = lib.qst_zstring_blocks(n_amps, ctypes.addressof(out), index)
        if err != 0:
            msg = lib.qst_error_string(err).decode()
            raise RuntimeError(f"qst_zstring_blocks: CUDA error {err} ({msg})")
        _GRID[key] = out.value
    return _GRID[key]


def zstring_sum(re: torch.Tensor, im: torch.Tensor, masks) -> torch.Tensor:
    """One launch over at most ``CAP`` masks of planes that ``takes``
    accepts: the (K,) float64 sums on the card."""
    K, N = len(masks), re.numel()
    planar = _planar(re, im)
    blocks = _blocks(re.device, N)
    # One allocation: the K sums, then the blocks' partial sums.
    buf = torch.empty((blocks + 1) * K, dtype=torch.float64, device=re.device)
    words = (ctypes.c_uint64 * K)(*masks)
    launch("readout", _SIGNATURES, "qst_zstring_sums", re.device,
           re.data_ptr(), im.data_ptr(), int(planar), N,
           ctypes.addressof(words), K, buf.data_ptr() + 8 * K, blocks,
           buf.data_ptr())
    LAUNCHES["zstring_sum"] += 1
    return buf[:K]
