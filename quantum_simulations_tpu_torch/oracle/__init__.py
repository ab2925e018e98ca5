"""The numpy oracle (host, complex128): ``quantum_simulations_tpu_torch.oracle``."""
from . import dense_numpy
from .dense_numpy import simulate, zero_state, fidelity_overlap

__all__ = ["dense_numpy", "simulate", "zero_state", "fidelity_overlap"]
