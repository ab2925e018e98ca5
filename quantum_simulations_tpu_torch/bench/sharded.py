"""Sharded-tier benchmark: one shard's timing of the n = 30 mesh config.

:func:`shard_timing` runs the per-position half of the sharded program
on the card: every step's local window ops over one 2^(n - log2 P) shard
(what each position executes between exchanges), and accounts the
exchange half exactly (``ops/exchange.offset_traffic`` per non-local op
x shard bytes), converted to time at a link rate the caller passes.  The
default rate is the H100 SXM data sheet's NVLink 4, 450 GB/s each way:
a data-sheet figure, not a measurement (the machine has one card).

Run: ``python -m quantum_simulations_tpu_torch.bench.sharded shard_timing [n]``.
"""
from __future__ import annotations

import json

from . import (
    NVLINK_BYTES_PER_S, describe, force, setup_platform, timeit, warm_grant,
)


def shard_timing(n: int = 30, n_devices: int = 8, *, depth: int = 8,
                 reps: int = 3,
                 link_GBs: float = NVLINK_BYTES_PER_S / 1e9) -> dict:
    """Measured per-shard compute of the n-qubit sycamore-like circuit on
    ``n_devices`` positions, on one card, plus the exchange bytes each
    position sends, over ``link_GBs``."""
    import math

    import numpy as np
    import torch

    from ..circuit import library as lib
    from ..circuit.fusion import compile_steps
    from ..circuit.panelize import compile_window_ops
    from ..ops.exchange import offset_traffic
    from ..runtime import simulator

    dev = setup_platform()
    warm_grant(dev)
    d = int(math.log2(n_devices))
    k = n - d
    cd = lib.sycamore_like(n, depth=depth, seed=11)
    steps = compile_steps(cd, k=k)

    terms_only = k >= 10
    win_ops = [
        simulator.prepare_schedule(
            [(op, None) for op in compile_window_ops(
                [(op.qubits, op.U, getattr(op, "name", "panel"))
                 for op in s.local_ops],
                k, diag_terms_only=terms_only)],
            dev, torch.float32)
        for s in steps
    ]

    # The exchange, exactly: bytes each position sends per non-local op.
    shard_bytes = (1 << k) * 8  # complex64
    n_collectives = 0
    exchange_bytes = 0.0
    for s in steps:
        for op in s.nonlocal_ops:
            for _off, frac in offset_traffic(
                    np.asarray(op.U), tuple(op.qubits), k):
                n_collectives += 1
                exchange_bytes += frac * shard_bytes

    gen = torch.Generator(device=dev).manual_seed(0)
    re0 = torch.randn(1 << k, generator=gen, device=dev) * 1e-4
    im0 = torch.zeros(1 << k, device=dev)

    def prog() -> float:
        re, im = re0, im0
        for wops in win_ops:
            for op, dterms in wops:
                re, im = simulator.apply_window_op(re, im, op, dterms)
        return force(re, im)

    shard_s = timeit(prog, reps)
    link_s = exchange_bytes / (link_GBs * 1e9)
    return {
        "device": describe(dev),
        "config": f"sycamore{n}_d{depth}_{n_devices}shards",
        "n": n,
        "n_devices": n_devices,
        "shard_amplitudes": 1 << k,
        "gates": len(cd["gates"]),
        "steps": len(steps),
        "local_window_passes": sum(len(w) for w in win_ops),
        "measured_shard_compute_s": shard_s,
        "collectives": n_collectives,
        "exchange_bytes_per_position": int(exchange_bytes),
        "link_model_GBs": link_GBs,
        "accounted_link_s": link_s,
        "pod_estimate_s": shard_s + link_s,
        "note": ("shard compute measured on the device named; the exchange "
                 "is exact bytes over the link rate given (default: H100 "
                 "SXM data sheet, NVLink 4, 450 GB/s each way; not "
                 "measured: one card)"),
    }


if __name__ == "__main__":
    import sys

    if "shard_timing" not in sys.argv[1:]:
        raise SystemExit("usage: python -m quantum_simulations_tpu_torch.bench"
                         ".sharded shard_timing [n]")
    ns = [int(a) for a in sys.argv[1:] if a.isdigit()]
    print(json.dumps(shard_timing(ns[0] if ns else 30), indent=1))
