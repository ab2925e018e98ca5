"""Frozen copies of the circuit makers the configurations name.

The same circuit dicts go to the port and to the reference.  These are
copies of ``quantum_simulations_tpu_torch.circuit.library``'s makers as
they stood when the benchmark was written, so a change to the library
cannot change the benchmark's inputs; ``tests/test_gpubench_streams.py``
holds them equal to the library.  ``qaoa_maxcut`` also takes the angles
a request draws.  A maker that a later configuration needs goes in a
module of its own, ``gpubench/makers/<name>.py`` with a function of that
name, which :func:`maker` finds.
"""
from __future__ import annotations

import importlib
import math
import random


def _g(name: str, qubits: list[int], params: dict | None = None) -> dict:
    out: dict = {"qubits": qubits, "gate": name}
    if params:
        out["params"] = params
    return out


def non_stabilizer(n: int, depth: int = 4, seed: int = 7) -> dict:
    """H+T+CNOT layers: the upstream's scaling-benchmark family."""
    rng = random.Random(seed)
    gates: list[dict] = []
    for _ in range(depth):
        for q in range(n):
            gates.append(_g("H", [q]))
            if rng.random() < 0.5:
                gates.append(_g("T", [q]))
        order = list(range(n - 1))
        rng.shuffle(order)
        for q in order[: n // 2]:
            gates.append(_g("CNOT", [q, q + 1]))
    return {"number_of_qubits": n, "gates": gates}


def maxcut_edges(n: int, seed: int = 3) -> list[tuple[int, int]]:
    """The edges of ``qaoa_maxcut``'s random 3-regular-ish graph, sorted."""
    rng = random.Random(seed)
    edges: set[tuple[int, int]] = set()
    for i in range(n):
        for _ in range(2):
            j = rng.randrange(n)
            if i != j:
                edges.add((min(i, j), max(i, j)))
    return sorted(edges)


def qaoa_maxcut(n: int, p: int = 2, seed: int = 3,
                angles: list[float] | None = None) -> dict:
    """QAOA MaxCut: H on every qubit, then p layers of RZZ(gamma) on every
    edge and RX(2 beta) on every qubit.  ``angles`` = (gamma_1, beta_1,
    ..., gamma_p, beta_p); without it the library's own draw from
    ``seed``, which follows the graph's draws."""
    rng = random.Random(seed)
    edges: set[tuple[int, int]] = set()
    for i in range(n):
        for _ in range(2):
            j = rng.randrange(n)
            if i != j:
                edges.add((min(i, j), max(i, j)))
    if angles is not None and len(angles) != 2 * p:
        raise ValueError(f"qaoa_maxcut wants {2 * p} angles, got {len(angles)}")
    gates: list[dict] = [_g("H", [q]) for q in range(n)]
    for layer in range(p):
        if angles is None:
            gamma = rng.uniform(0, math.pi)
            beta = rng.uniform(0, math.pi)
        else:
            gamma, beta = angles[2 * layer], angles[2 * layer + 1]
        for (i, j) in sorted(edges):
            gates.append(_g("RZZ", [i, j], {"theta": gamma}))
        for q in range(n):
            gates.append(_g("RX", [q], {"theta": 2 * beta}))
    return {"number_of_qubits": n, "gates": gates}


def maker(name: str):
    """The maker a configuration names: one of this module's, else
    ``gpubench.makers.<name>.<name>``."""
    fn = globals().get(name)
    if callable(fn) and not name.startswith("_") and name != "maker":
        return fn
    return getattr(importlib.import_module(f"gpubench.makers.{name}"), name)
