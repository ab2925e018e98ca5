"""Native host engine: build-on-first-use ctypes bindings (a copy of
``quantum_simulations_tpu/native/__init__.py``).

C++/OpenMP statevector kernels (see ``host_engine.cpp``, the reference's
source as it is): the CPU performance tier and the fast host oracle
(``oracle/native.py``).  The shared library is compiled once into
``build/libqst_host.so`` beside this file with g++ (to a temporary name,
then renamed, so a concurrent first use never loads a half-written
library); if no toolchain is available the module degrades gracefully
(``available()`` is False, ``BUILD_ERROR`` says why) and every call
raises ``RuntimeError``.  Nothing on the card's path calls it.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "host_engine.cpp"
_BUILD = _HERE / "build"
_SO = _BUILD / "libqst_host.so"

_lib = None
AVAILABLE = False
BUILD_ERROR: str | None = None


def _build() -> None:
    _BUILD.mkdir(exist_ok=True)
    tmp = _BUILD / f"{_SO.name}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-funroll-loops", "-std=c++17",
        "-fopenmp", "-shared", "-fPIC", str(_SRC), "-o", str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, _SO)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, AVAILABLE, BUILD_ERROR
    if _lib is not None or BUILD_ERROR is not None:
        return _lib
    try:
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(_SO))
    except (OSError, subprocess.CalledProcessError) as e:
        BUILD_ERROR = str(e)
        return None
    lib.qst_set_threads.argtypes = [ctypes.c_int]
    lib.qst_num_threads.restype = ctypes.c_int
    for name in ("qst_apply_1q_c64", "qst_apply_1q_c128"):
        getattr(lib, name).argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p,
        ]
    for name in ("qst_apply_2q_c64", "qst_apply_2q_c128"):
        getattr(lib, name).argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
    for name in ("qst_apply_diag_c64", "qst_apply_diag_c128"):
        getattr(lib, name).argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
        ]
    lib.qst_norm2_c64.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.qst_norm2_c64.restype = ctypes.c_double
    lib.qst_norm2_c128.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.qst_norm2_c128.restype = ctypes.c_double
    for name in ("qst_prob_qubit_c64", "qst_prob_qubit_c128"):
        getattr(lib, name).argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
        ]
        getattr(lib, name).restype = ctypes.c_double
    for name in ("qst_project_qubit_c64", "qst_project_qubit_c128"):
        getattr(lib, name).argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.c_double,
        ]
    for name in ("qst_measure_c64", "qst_measure_c128"):
        getattr(lib, name).argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_uint64,
        ]
        getattr(lib, name).restype = ctypes.c_uint64
    for name in ("qst_state_max_diff_c64", "qst_state_max_diff_c128"):
        getattr(lib, name).argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
        ]
        getattr(lib, name).restype = ctypes.c_double
    lib.qst_alloc_state.argtypes = [ctypes.c_uint64]
    lib.qst_alloc_state.restype = ctypes.c_void_p
    lib.qst_free_state.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    _lib = lib
    AVAILABLE = True
    return lib


def available() -> bool:
    return _load() is not None


def set_threads(n: int) -> None:
    lib = _load()
    if lib:
        lib.qst_set_threads(n)


def _suffix(psi: np.ndarray) -> str:
    if psi.dtype == np.complex64:
        return "c64"
    if psi.dtype == np.complex128:
        return "c128"
    raise TypeError(f"unsupported dtype {psi.dtype}")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def apply_1q(psi: np.ndarray, q: int, U: np.ndarray) -> None:
    """In-place 1q gate on a contiguous complex numpy buffer."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {BUILD_ERROR}")
    U = np.ascontiguousarray(U, dtype=np.complex128)
    getattr(lib, f"qst_apply_1q_{_suffix(psi)}")(_ptr(psi), psi.size, q, _ptr(U))


def apply_2q(psi: np.ndarray, qa: int, qb: int, U: np.ndarray) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {BUILD_ERROR}")
    U = np.ascontiguousarray(U, dtype=np.complex128)
    getattr(lib, f"qst_apply_2q_{_suffix(psi)}")(
        _ptr(psi), psi.size, qa, qb, _ptr(U)
    )


def apply_diag(psi: np.ndarray, qubits: list[int], d: np.ndarray) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {BUILD_ERROR}")
    d = np.ascontiguousarray(d, dtype=np.complex128)
    qarr = (ctypes.c_int * len(qubits))(*qubits)
    getattr(lib, f"qst_apply_diag_{_suffix(psi)}")(
        _ptr(psi), psi.size, qarr, len(qubits), _ptr(d)
    )


def norm2(psi: np.ndarray) -> float:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {BUILD_ERROR}")
    return float(getattr(lib, f"qst_norm2_{_suffix(psi)}")(_ptr(psi), psi.size))


def prob_qubit(psi: np.ndarray, q: int) -> float:
    """P(qubit q == 1) — parallel strided reduction."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {BUILD_ERROR}")
    return float(
        getattr(lib, f"qst_prob_qubit_{_suffix(psi)}")(_ptr(psi), psi.size, q))


def project_qubit(psi: np.ndarray, q: int, outcome: int, scale: float) -> None:
    """In-place collapse onto qubit q == outcome, rescaled by `scale`."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {BUILD_ERROR}")
    getattr(lib, f"qst_project_qubit_{_suffix(psi)}")(
        _ptr(psi), psi.size, q, int(outcome), float(scale))


def measure(psi: np.ndarray, qubits: list[int], seed: int) -> int:
    """Seeded sequential measurement with in-place collapse.

    Returns the packed outcome (bit j = outcome of ``qubits[j]``).  The
    RNG is a deterministic splitmix64 stream, so the same seed gives
    the same outcomes regardless of thread count — parity with the
    reference's measure path (hisvsim_repo/state_vector.hpp:829-1003).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {BUILD_ERROR}")
    qarr = (ctypes.c_int * len(qubits))(*qubits)
    return int(getattr(lib, f"qst_measure_{_suffix(psi)}")(
        _ptr(psi), psi.size, qarr, len(qubits), seed & (2**64 - 1)))


def state_max_diff(a: np.ndarray, b: np.ndarray) -> float:
    """Max elementwise |a - b| over two same-dtype state buffers."""
    if a.dtype != b.dtype or a.size != b.size:
        raise ValueError("state buffers must share dtype and size")
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {BUILD_ERROR}")
    return float(getattr(lib, f"qst_state_max_diff_{_suffix(a)}")(
        _ptr(a), _ptr(b), a.size))


def state_equal(a: np.ndarray, b: np.ndarray, tol: float = 1e-10) -> bool:
    """Elementwise state comparison within ``tol``
    (reference: state_equal, hisvsim_repo/state_vector.hpp:1003)."""
    return state_max_diff(a, b) <= tol


def alloc_state(n_amps: int, dtype=np.complex128) -> np.ndarray:
    """NUMA-interleaved zeroed state buffer as a numpy array.

    Portable equivalent of the reference's ``numa_alloc_interleaved``
    state allocation (hisvsim_repo/state_vector.hpp:104): anonymous
    mmap first-touched page-strided by all OpenMP threads in the same
    schedule(static) order the gate loops use, so pages interleave
    across sockets and the strided kernels read node-local memory.
    Free with :func:`free_state` — plain ``del`` leaks the mapping.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {BUILD_ERROR}")
    dtype = np.dtype(dtype)
    if dtype not in (np.dtype(np.complex64), np.dtype(np.complex128)):
        raise TypeError(f"unsupported dtype {dtype}")
    nbytes = int(n_amps) * dtype.itemsize
    ptr = lib.qst_alloc_state(nbytes)
    if not ptr:
        raise MemoryError(f"qst_alloc_state({nbytes}) failed")
    buf = (ctypes.c_char * nbytes).from_address(ptr)
    arr = np.frombuffer(buf, dtype=dtype)
    _ALLOCS[arr.ctypes.data] = (ptr, nbytes)
    return arr


def free_state(arr: np.ndarray) -> None:
    """Release a buffer returned by :func:`alloc_state`.

    The caller must drop every view first; the mapping is gone after
    this call and stale views would fault on access.
    """
    lib = _load()
    key = arr.ctypes.data
    ptr, nbytes = _ALLOCS.pop(key)
    if lib is not None:
        lib.qst_free_state(ptr, nbytes)


_ALLOCS: dict[int, tuple[int, int]] = {}
