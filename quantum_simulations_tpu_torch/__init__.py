"""quantum_simulations_tpu_torch — the PyTorch and CUDA port of
``quantum_simulations_tpu`` for an NVIDIA H100.

The JAX package stays the reference; this package imports nothing of it
and nothing of JAX.  The state is a pair of flat float planes (re, im) of
2^n amplitudes, index bit q is qubit q, and every panel pass runs as a
CUDA kernel written for Hopper (``csrc/``, built with ``nvcc`` at first
use).  Entry points run on the card unless the caller passes
``device="cpu"``, which runs each kernel's plain torch twin.

The port runs the dense single-device tier in its four modes (fused, the
default; panel, the CLI's default; window; auto), the capacity tier in
place, their readout, the out-of-core spill tier (the state in host DRAM
or disk chunks, streamed through the card in stripes; WAL and crash
recovery on disk; Atlas staging), the sparse tier (COO on the card;
bigint indices on the host), the adaptive sparse -> dense tier, the
trajectory tier (RESET / mid-circuit MEASURE / ``if``), the numpy and
native C++ oracles (``oracle``), and the CLI (``python -m
quantum_simulations_tpu_torch`` ``run`` / ``sample`` / ``stats`` /
``export``); see ROADMAP.md for what follows.
"""
from .circuit.contract import (
    ENDIANNESS,
    levelize,
    validate_circuit_dict,
)
from .circuit import gates, library
from .oracle import dense_numpy as oracle
from .utils.config import SimulatorConfig

__version__ = "0.1.0"


def simulate(circuit_dict, config=None, **kw):
    """Top-level convenience: see :func:`quantum_simulations_tpu_torch.api.simulate`."""
    from . import api

    return api.simulate(circuit_dict, config, **kw)


def sample(circuit_dict, shots, **kw):
    """Top-level convenience: see :func:`quantum_simulations_tpu_torch.api.sample`."""
    from . import api

    return api.sample(circuit_dict, shots, **kw)


__all__ = [
    "ENDIANNESS",
    "validate_circuit_dict",
    "levelize",
    "gates",
    "library",
    "oracle",
    "simulate",
    "sample",
    "SimulatorConfig",
    "__version__",
]
