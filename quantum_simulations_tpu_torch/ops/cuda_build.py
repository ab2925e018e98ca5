"""Build the port's CUDA sources with ``nvcc`` and load them through ctypes.

Each ``csrc/<name>.cu`` becomes ``build/torch_kernels/lib<name>-<hash>.so``
at first use: a plain C interface, no PyTorch headers, so a build takes
seconds.  The hash covers the source, every ``csrc/*.cuh`` header (a
header such as ``phase.cuh`` is shared by several sources) and the
flags, so an edited source or header is rebuilt and a stale library is
never loaded.  ``defines`` (``-D`` macros) build a measurement variant of
a source beside it (``panel_variants.py``); the package's own entries use
none.  ``QST_TORCH_BUILD_DIR`` moves the build directory; ``QST_NVCC``
names the compiler.

``on_card``, ``check_aligned``, ``launch`` and ``store`` are the
wrappers' shared halves: the first decides kernel (CUDA planes) or plain
twin (CPU planes) and raises on planes no kernel takes, the second raises
on planes a float4 kernel cannot take, the third calls a C entry on the
current stream and raises on a CUDA error, the last gives a twin's
out-of-place result the in-place contract (the caller's planes, updated).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOADED: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("QST_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "torch_kernels"


def nvcc() -> str:
    cands = [os.environ.get("QST_NVCC"), shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cands.append(str(Path(home) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "csrc/*.cu on a machine with the CUDA toolkit")


def _flags(defines: tuple) -> list[str]:
    return ARCH + FLAGS + [f"-D{d}" for d in defines]


def library_path(name: str, defines: tuple = ()) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(_flags(defines)).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str, verbose: bool, defines: tuple = ()):
    """Start nvcc for one source (None if its library is already built).

    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills
    of each kernel); it does not change the code, so not the hash.
    """
    out = library_path(name, defines)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *_flags(defines), *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job, verbose: bool) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    if verbose and log:
        print(log, file=sys.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file


def build(specs, verbose: bool = False) -> list[Path]:
    """Build each ``(name, defines)`` of ``specs``, one nvcc each, all
    started together."""
    jobs = [(name, _start(name, verbose, defines)) for name, defines in specs]
    for name, job in jobs:
        if job is not None:
            _finish(name, job, verbose)
    return [library_path(name, defines) for name, defines in specs]


def build_all(verbose: bool = False) -> list[Path]:
    """Build every ``csrc/*.cu``, one nvcc per source, all started together."""
    return build([(p.stem, ()) for p in sorted(CSRC.glob("*.cu"))], verbose)


def load(name: str, signatures: dict, defines: tuple = ()) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its entries typed.

    ``signatures`` maps each C entry to ``(restype, [argtypes])``.
    """
    lib = _LOADED.get((name, defines))
    if lib is None:
        build([(name, defines)])
        lib = ctypes.CDLL(str(library_path(name, defines)))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LOADED[(name, defines)] = lib
    return lib


def on_card(name: str, re: torch.Tensor, im: torch.Tensor) -> bool:
    """True: launch the kernel.  False: the planes lie on the CPU."""
    if re.shape != im.shape or re.dim() != 1 or re.device != im.device:
        raise ValueError(f"{name}: planes must be two flat tensors of one "
                         f"shape on one device")
    if re.device.type == "cpu":
        return False
    if re.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {re.device}")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32 planes, got "
                        f"{re.dtype}; float64 runs through the plain twin "
                        f"(plain=True)")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError(f"{name}: planes must be contiguous")
    return True


def check_aligned(name: str, *planes) -> None:
    """Raise unless every plane starts on a 16-byte boundary: the kernel
    moves float4s, and a misaligned one would end in a sticky CUDA error
    that spoils the context instead of an exception."""
    for x in planes:
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: planes must start on a 16-byte "
                             f"boundary (a view at an odd offset?)")


def store(re: torch.Tensor, im: torch.Tensor, out) -> tuple:
    """Copy a plain twin's out-of-place ``out`` into ``(re, im)`` and
    return them: the in-place mode of every twin."""
    re.copy_(out[0])
    im.copy_(out[1])
    return re, im


def outputs(re: torch.Tensor, im: torch.Tensor, inplace: bool) -> tuple:
    """A kernel's output planes: the input planes in place (the C entries
    launch their aliasing instance when out == in), else fresh ones."""
    if inplace:
        return re, im
    return torch.empty_like(re), torch.empty_like(im)


def launch(source: str, signatures: dict, entry: str,
           device: torch.device, *args) -> None:
    """Call ``entry`` of ``csrc/<source>.cu`` with ``args``, the device
    index and ``device``'s current stream; raise on a CUDA error."""
    lib = load(source, signatures)
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, entry)(*args, index, stream)
    if err != 0:
        msg = lib.qst_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err} ({msg})")
