"""The plain reference the benchmark holds the port to.

Plain PyTorch on the device it is given, complex128, gate by gate from
the circuit dict, with its own gate matrices (``statevector.GATES``:
every 1- and 2-qubit gate of the circuit contract, core and extended,
and FSIM, each from its published definition; no 3-qubit gate):
the whole state (``statevector``); for a configuration that names a
cut, two halves whose sum of products is the state and which are never
as large as it (``cut``); or, for a check that holds every answer to
it, the gates in the backward light cone of a Z-string on the cone's
qubits alone (``lightcone``).  It imports neither JAX nor the JAX package
nor anything of the port, and takes nothing the port has made.
"""
