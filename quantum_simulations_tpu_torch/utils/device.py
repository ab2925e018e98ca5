"""Device and dtype policy of the port.

Entry points run on the card by default (``device="cuda"``) and raise
``RuntimeError`` when there is none; they run on the CPU only when the
caller asks for ``device="cpu"`` (the tests do).
"""
from __future__ import annotations

import numpy as np
import torch

_COMPLEX = {"complex64": torch.complex64, "complex128": torch.complex128}


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the card "
                           "by default; pass device='cpu' for the plain "
                           "torch twins")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev


def complex_dtype(dtype) -> torch.dtype:
    """'complex64' / 'complex128' / numpy or torch complex dtype."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    else:
        name = np.dtype(dtype).name
    if name not in _COMPLEX:
        raise TypeError(f"state dtype must be complex64 or complex128, got {dtype}")
    return _COMPLEX[name]


def float_dtype(cdtype: torch.dtype) -> torch.dtype:
    return torch.float64 if cdtype == torch.complex128 else torch.float32
