"""Capacity tier: planar end-to-end execution in place, and readout.

Port of ``quantum_simulations_tpu/runtime/capacity.py``.  The state is
born as two float planes on the device (a complex copy would not fit
beside them), every pass runs in place
(``runtime/simulator.build_window_circuit_fn(inplace=True)``), and the
readout (norm, top amplitudes, sampling, diagonal observables) works on
the planes in chunks (``ops/sampling.py``) without building the complex
vector.  On an 80 GB H100 this is the only way to n = 33: the two
float32 planes are 64 GiB.

Reachable from :func:`api.simulate` with ``SimulatorConfig(mode=
"capacity")`` (and ``mode="auto"`` at n >= 29).
"""
from __future__ import annotations

import numpy as np
import torch

from ..circuit.contract import validate_circuit_dict
from ..ops import sampling
from ..utils.device import complex_dtype, float_dtype, resolve_device


class CapacityResult:
    """Handle on a planar statevector living on the device.

    Fetches are scalars and (k,) / (shots, n) arrays, except
    :meth:`to_array`, which copies the whole state to the host.
    """

    def __init__(self, re: torch.Tensor, im: torch.Tensor, n: int):
        self.re = re
        self.im = im
        self.n = n

    def norm2(self) -> float:
        return sampling.norm2_planar(self.re, self.im)

    def norm(self) -> float:
        return self.norm2() ** 0.5

    def top_amplitudes(self, k: int = 8) -> list[tuple[int, complex]]:
        idx, _, ar, ai = sampling.top_amplitudes_planar(self.re, self.im, k)
        return [(int(i), complex(float(r), float(j)))
                for i, r, j in zip(idx.tolist(), ar.tolist(), ai.tolist())]

    def sample_bits(self, shots: int, n: int | None = None, *,
                    seed: int = 0) -> np.ndarray:
        gen = torch.Generator(device=self.re.device).manual_seed(seed)
        bits = sampling.sample_bits_planar(self.re, self.im, gen, shots,
                                           n or self.n)
        return bits.cpu().numpy()

    def expectation_z(self, qubits: list[int]) -> float:
        return sampling.expectation_z_planar(self.re, self.im, list(qubits))

    def qubit_probability(self, q: int) -> float:
        return sampling.qubit_probability_planar(self.re, self.im, q)

    def to_array(self) -> np.ndarray:
        """The dense complex state on the host (small n and tests only:
        at n = 33 it is 64 GiB)."""
        return torch.complex(self.re, self.im).cpu().numpy()

    def summary(self, top: int = 8) -> dict:
        return {
            "n_qubits": self.n,
            "mode": "capacity",
            "norm2": self.norm2(),
            "top": [[hex(i), [a.real, a.imag]]
                    for i, a in self.top_amplitudes(top)],
        }


def simulate_capacity(
    circuit_dict: dict,
    *,
    dtype="complex64",
    window: int = 7,
    initial_planes=None,
    device="cuda",
) -> CapacityResult:
    """Run a circuit planar end to end, in place, on one device.

    The planes start as |0...0> made on the device
    (``dense.zero_state_planar``), or are ``initial_planes``: planes
    already on the device with the state's float type are updated in
    place.  A gate with no in-place path raises the reference's
    ``ValueError`` before anything runs (a non-diagonal gate of 3+
    qubits straddling the lane window: decompose it first).
    """
    from ..ops import dense
    from . import simulator

    cd = validate_circuit_dict(circuit_dict)
    n = cd["number_of_qubits"]
    dev = resolve_device(device)
    fdtype = float_dtype(complex_dtype(dtype))
    fn = simulator.build_window_circuit_fn(
        cd, dtype=dtype, window=window, planar_io=True, inplace=True,
        device=dev)
    if initial_planes is None:
        re, im = dense.zero_state_planar(n, fdtype, dev)
    else:
        re, im = (x.to(device=dev, dtype=fdtype) for x in initial_planes)
    re, im = fn(re, im)
    return CapacityResult(re, im, n)
