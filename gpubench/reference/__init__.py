"""The plain reference the benchmark holds the port to.

Plain PyTorch on the device it is given, complex128, gate by gate from
the circuit dict, with its own gate matrices (``statevector.GATES``):
the whole state (``statevector``), or, for a configuration that names a
cut, two halves whose sum of products is the state and which are never
as large as it (``cut``).  It imports neither JAX nor the JAX package
nor anything of the port, and takes nothing the port has made.
"""
