"""Chunked state buffers for the out-of-core tier (a copy of
``quantum_simulations_tpu/runtime/chunk_store.py``: the same file names,
on-disk dtype and manifest, so a work dir written by one package reads
in the other).

Two backends behind one interface:

* :class:`HostBuffer` — the full amplitude vector in host DRAM
  (the spill tier: states bigger than the card, smaller than RAM).  With
  ``device`` a card it is allocated pinned (``utils/transfer.py``), so
  stripe copies are asynchronous DMA; on the CPU a plain numpy array.
* :class:`DiskBuffer` — one file per stripe with a manifest and
  atomic tmp+fsync+rename writes (capability parity with the
  reference's block store, ``wenbo_engine/storage/block_store.py`` /
  ``storage/manifest.py``, including the complex64 on-disk dtype and
  the chunk_size * n_chunks == 2^n invariant).

Stripes are indexed by the top (n - m) index bits; stripe ``s`` holds
amplitudes [s * 2^m, (s+1) * 2^m).
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from ..utils.transfer import pinned_empty
from .wal import atomic_write_bytes, atomic_write_json

DISK_DTYPE = np.complex64


class HostBuffer:
    """Full statevector in host DRAM, stripe-addressable."""

    def __init__(self, n: int, m: int, dtype=np.complex64, *,
                 init_zero_state=True, device=None):
        if m > n:
            raise ValueError("stripe width exceeds state size")
        self.n, self.m = n, m
        self.n_stripes = 1 << (n - m)
        self.stripe_len = 1 << m
        self.pinned = False
        if device is not None and torch.device(device).type == "cuda":
            self.data, self.pinned = pinned_empty(1 << n, dtype,
                                                  torch.device(device))
            torch.from_numpy(self.data.view(np.uint8)).zero_()  # all threads
        else:
            self.data = np.zeros(1 << n, dtype=dtype)
        if init_zero_state:
            self.data[0] = 1.0

    def read(self, s: int) -> np.ndarray:
        return self.data[s * self.stripe_len:(s + 1) * self.stripe_len]

    def write(self, s: int, stripe: np.ndarray) -> None:
        self.data[s * self.stripe_len:(s + 1) * self.stripe_len] = stripe

    def wipe(self) -> None:
        self.data[:] = 0

    def to_array(self) -> np.ndarray:
        return self.data


class DiskBuffer:
    """One complex64 file per stripe; atomic writes; manifest."""

    def __init__(self, root, n: int, m: int, *, init_zero_state=True,
                 create: bool = True):
        self.root = Path(root)
        self.n, self.m = n, m
        self.n_stripes = 1 << (n - m)
        self.stripe_len = 1 << m
        if create:
            self.root.mkdir(parents=True, exist_ok=True)
            if init_zero_state:
                zero = np.zeros(self.stripe_len, dtype=DISK_DTYPE)
                zero[0] = 1.0
                self._write_file(0, zero)
                zero[0] = 0.0
                for s in range(1, self.n_stripes):
                    self._write_file(s, zero)
            self.write_manifest()

    def _path(self, s: int) -> Path:
        return self.root / f"chunk_{s:08d}.c64"

    def _write_file(self, s: int, stripe: np.ndarray) -> None:
        atomic_write_bytes(
            self._path(s), np.ascontiguousarray(stripe, dtype=DISK_DTYPE).tobytes()
        )

    def read(self, s: int) -> np.ndarray:
        return np.fromfile(self._path(s), dtype=DISK_DTYPE)

    def write(self, s: int, stripe: np.ndarray) -> None:
        self._write_file(s, stripe)

    def wipe(self) -> None:
        zero = np.zeros(self.stripe_len, dtype=DISK_DTYPE)
        for s in range(self.n_stripes):
            self._write_file(s, zero)

    def write_manifest(self) -> None:
        atomic_write_json(self.root / "manifest.json", {
            "n_qubits": self.n,
            "stripe_qubits": self.m,
            "n_stripes": self.n_stripes,
            "stripe_len": self.stripe_len,
            "dtype": "complex64",
        })

    @classmethod
    def open(cls, root) -> "DiskBuffer":
        root = Path(root)
        man = json.loads((root / "manifest.json").read_text())
        assert man["stripe_len"] * man["n_stripes"] == 1 << man["n_qubits"], (
            "manifest invariant violated"
        )
        return cls(root, man["n_qubits"], man["stripe_qubits"], create=False)

    def to_array(self) -> np.ndarray:
        return np.concatenate([self.read(s) for s in range(self.n_stripes)])
