"""Device mesh of the sharded statevector (port of
``quantum_simulations_tpu/parallel/mesh.py``).

The state is a flat vector of 2^n amplitudes split over a 1-D mesh of
D = 2^d positions: position s holds global indices [s * 2^k, (s+1) * 2^k)
with k = n - d.  Little-endian amplitude indexing means qubits 0..k-1 are
local and qubit k+b is mesh bit b.

A position is a ``(rank, torch.device)`` pair: the process that owns it
and the device its shard lives on.  One process drives every position of
its rank (the counterpart of JAX's single controller per host), several
positions may share one device (the counterpart of the virtual 8-device
CPU mesh, and how one card holds 2-8 positions), and positions are
contiguous per rank (``distributed.make_pod_mesh``), so the low mesh bits
stay inside a process.

A :class:`ShardedState` holds the shards this process owns, each as the
port's (re, im) pair of float planes of 2^k amplitudes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import complex_dtype, float_dtype, resolve_device

AXIS = "s"


class MeshError(ValueError):
    """The mesh asks for more devices than there are."""


@dataclass(frozen=True)
class Mesh:
    """The D positions in order, each ``(rank, device)``, and the rank of
    this process."""

    positions: tuple
    rank: int = 0

    @property
    def size(self) -> int:
        return len(self.positions)

    @property
    def devices(self) -> list:
        return [d for _, d in self.positions]

    def device(self, s: int) -> torch.device:
        return self.positions[s][1]

    def rank_of(self, s: int) -> int:
        return self.positions[s][0]

    @property
    def local(self) -> list[int]:
        """The positions this process owns."""
        return [s for s, (r, _) in enumerate(self.positions) if r == self.rank]

    @property
    def world(self) -> int:
        return len({r for r, _ in self.positions})

    def key(self) -> tuple:
        """The layout, for caches: ranks and devices by position (an
        ``id`` may be reused by another mesh)."""
        return tuple((r, str(d)) for r, d in self.positions)


def _pow2(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"n_devices must be a power of two, got {n}")


def _normalise(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, devices=None, *,
              device="cuda") -> Mesh:
    """A 1-D mesh of ``n_devices`` positions in this process.

    ``devices=None``: on ``device="cuda"`` the first ``n_devices`` cards
    (all of them by default, cut to a power of two), raising
    :class:`MeshError` that names the cards found when there are fewer;
    on ``device="cpu"`` ``n_devices`` positions on the CPU (the
    counterpart of the virtual CPU mesh; one by default).  An explicit
    ``devices=[...]`` list may repeat a device: that is how several
    positions share one card.
    """
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cpu":
            devices = [dev] * (n_devices or 1)
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
            if n_devices is not None and n_devices > len(devices):
                names = ", ".join(f"{d} ({torch.cuda.get_device_name(d)})"
                                  for d in devices)
                raise MeshError(f"need {n_devices} devices, have "
                                f"{len(devices)}: {names}")
    devices = [_normalise(d) for d in devices]
    if n_devices is None:
        n_devices = 1 << int(math.log2(len(devices)))
    _pow2(n_devices)
    if n_devices > len(devices):
        raise MeshError(f"need {n_devices} devices, have {len(devices)}")
    return Mesh(tuple((0, d) for d in devices[:n_devices]), 0)


def device_bits(mesh: Mesh) -> int:
    return int(math.log2(mesh.size))


def shard_width(mesh: Mesh, n: int) -> int:
    """k = number of local qubits for an n-qubit state on this mesh."""
    d = device_bits(mesh)
    if d > n:
        raise ValueError(f"mesh of {mesh.size} devices too large for n={n}")
    return n - d


@dataclass
class ShardedState:
    """The shards of an n-qubit state that this process owns: position ->
    (re, im) planes of 2^k amplitudes on the position's device."""

    mesh: Mesh
    n: int
    shards: dict

    @property
    def k(self) -> int:
        return shard_width(self.mesh, self.n)

    @property
    def fdtype(self) -> torch.dtype:
        return next(iter(self.shards.values()))[0].dtype


def zero_state_planar_sharded(mesh: Mesh, n: int,
                              fdtype=torch.float32) -> ShardedState:
    """|0...0> as sharded (re, im) planes, made on each device: amplitude
    1 at index 0, on position 0."""
    k = shard_width(mesh, n)
    shards = {}
    for s in mesh.local:
        dev = mesh.device(s)
        re = torch.zeros(1 << k, dtype=fdtype, device=dev)
        if s == 0:
            re[0] = 1.0
        shards[s] = (re, torch.zeros(1 << k, dtype=fdtype, device=dev))
    return ShardedState(mesh, n, shards)


def zero_state_sharded(mesh: Mesh, n: int, dtype="complex64") -> ShardedState:
    """|0...0> of a complex dtype, held as its planes."""
    return zero_state_planar_sharded(mesh, n, float_dtype(complex_dtype(dtype)))


def put_state_planar(mesh: Mesh, planes, fdtype=torch.float32) -> ShardedState:
    """Host (2, 2^n) planes (or a complex vector) as sharded planes: each
    process uploads the slices of its own positions (the runner's resume
    path)."""
    arr = np.asarray(planes)
    if arr.ndim == 1:
        arr = np.stack([arr.real, arr.imag])
    n = arr.shape[1].bit_length() - 1
    k = shard_width(mesh, n)
    shards = {}
    for s in mesh.local:
        lo, hi = s << k, (s + 1) << k
        shards[s] = tuple(torch.from_numpy(np.ascontiguousarray(arr[p, lo:hi]))
                          .to(device=mesh.device(s), dtype=fdtype, copy=True)
                          for p in (0, 1))
    return ShardedState(mesh, n, shards)


def put_state(mesh: Mesh, psi, dtype="complex64") -> ShardedState:
    """A host statevector as a sharded state of ``dtype``."""
    return put_state_planar(mesh, psi, float_dtype(complex_dtype(dtype)))
