"""Merging sparse partial states (a copy of
``quantum_simulations_tpu/sparse/merge.py``).

Capability parity with v3's state merger
(``v3_hisvsim_spark/src/state_merger_module.py`` — union + groupBy of
partition outputs).  Here the semantic is exact, not approximate:
merging sums amplitudes per basis index (the correct operation for
additive partial results, e.g. distributing an initial superposition's
branches across workers), with optional renormalisation and pruning.
"""
from __future__ import annotations

import math

from .engine import SparseState


def merge_sparse_states(
    states: list[SparseState],
    *,
    renormalize: bool = False,
    threshold: float = 0.0,
) -> SparseState:
    if not states:
        raise ValueError("nothing to merge")
    n = states[0].n
    if any(s.n != n for s in states):
        raise ValueError("qubit-count mismatch between partial states")
    merged: dict = {}
    for s in states:
        for idx, amp in s.items():
            v = merged.get(idx, 0.0) + amp
            merged[idx] = v
    if threshold > 0:
        merged = {i: a for i, a in merged.items() if abs(a) > threshold}
    if renormalize:
        nrm = math.sqrt(sum(abs(a) ** 2 for a in merged.values()))
        if nrm > 0:
            merged = {i: a / nrm for i, a in merged.items()}
    return SparseState(n, merged)
