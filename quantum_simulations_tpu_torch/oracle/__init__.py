"""The host oracles (complex128): ``quantum_simulations_tpu_torch.oracle``,
numpy (``dense_numpy``) and the C++/OpenMP engine (``native``)."""
from . import dense_numpy, native
from .dense_numpy import simulate, zero_state, fidelity_overlap

__all__ = ["dense_numpy", "native", "simulate", "zero_state", "fidelity_overlap"]
