"""Projected 34-qubit random-circuit sampling on 16 positions.

16 cards are not available; what is measured is the per-position cost
of exactly the work each position would do:

* a 34q state on 16 positions is a 2^30-amplitude shard a position, the
  same shard size as the capacity tier's n = 30 run (``bench/capacity``):
  the per-position rate is that run's amp-updates/s, measured on the
  card in the same call (:func:`run`);
* the exchange of the staged plan is enumerable exactly: the
  stage-transition boundary SWAPs collapse into per-plane
  ``all_to_all`` reshards of shard_bytes * (1 - 2^-r) a position
  (``parallel/reshard.reshard_bytes``), any other non-local gate is
  counted by ``ops/exchange.exchange_bytes``; the link rate is a
  parameter (default: the H100 SXM data sheet's NVLink 4, 450 GB/s each
  way, not measured: one card);
* the sampler costs one probability pass over the shard (its bytes at
  the card's 3.35 TB/s) + O(shots) small gathers.

The projection composes these pieces; every assumption is carried in
the row.  It is not a timing of 16 cards.

Run: ``python -m quantum_simulations_tpu_torch.bench.projection``.
"""
from __future__ import annotations

import json

from . import HBM_BYTES_PER_S, NVLINK_BYTES_PER_S


def project(n: int = 34, n_chips: int = 16, depth: int = 8,
            shots: int = 1_000_000, seed: int = 7, *,
            amp_updates_per_s: float,
            link_bytes_per_s: float = NVLINK_BYTES_PER_S,
            rate_source: str = "given") -> dict:
    """The projection at a per-position rate ``amp_updates_per_s`` (a
    measured n = 30 in-place rate: :func:`run`)."""
    import numpy as np

    from ..circuit import library as lib
    from ..circuit import staging as S
    from ..circuit.fusion import compile_steps
    from ..ops.exchange import exchange_bytes
    from ..parallel.reshard import plan_boundary_reshard, reshard_bytes

    k = n - int(np.log2(n_chips))
    cd = lib.sycamore_like(n, depth=depth, seed=seed)
    staged, _, st = S.stage_circuit(cd, k, "heuristic")
    steps = compile_steps(staged, k=k, panel_width=None)

    shard_amps = 1 << k
    shard_bytes = shard_amps * 8  # two f32 planes

    # Exchange bytes a position sends: boundary reshards (exact all_to_all
    # volume) + any residual per-gate exchanges.
    reshard_total = 0
    residual = 0
    n_reshards = 0
    for s in steps:
        pairs, rest = plan_boundary_reshard(s.nonlocal_ops, k)
        if pairs:
            reshard_total += reshard_bytes(k, len(pairs))["all_to_all_bytes"]
            n_reshards += 1
        for op in rest:
            residual += exchange_bytes(np.asarray(op.U), tuple(op.qubits), k)

    gates = len(staged["gates"])
    local_s = gates * shard_amps / amp_updates_per_s
    comm_s = (reshard_total + residual) / link_bytes_per_s
    sample_s = shard_bytes / HBM_BYTES_PER_S
    return {
        "config": f"PROJECTED sycamore-like n={n} sampling on "
                  f"{n_chips} positions of 2^{k}",
        "method": (
            f"per-position local time = staged gate count x 2^{k} shard "
            f"amps / the n={k} in-place rate ({rate_source}); comm = "
            "exact all_to_all reshard bytes + residual exchange bytes "
            f"at {link_bytes_per_s / 1e9:.0f} GB/s each way (H100 SXM data "
            "sheet, NVLink 4; not measured: one card); sampler = one "
            "probability pass at 3.35 TB/s. NOT a hardware timing."
        ),
        "gates_staged": gates,
        "stages": st["stages"],
        "boundary_reshards": n_reshards,
        "reshard_bytes_per_position": reshard_total,
        "reshard_gib_per_position": round(reshard_total / 2**30, 2),
        "residual_exchange_bytes": residual,
        "amp_updates_per_s": amp_updates_per_s,
        "local_s": local_s,
        "comm_s": comm_s,
        "sample_s": sample_s,
        "projected_total_s": local_s + comm_s + sample_s,
        "shots": shots,
    }


def run(rate_n: int = 30) -> dict:
    """The projection at the card's own in-place rate: nonstab<rate_n>
    through ``bench/capacity`` in this call."""
    from . import capacity

    cap = capacity.run(ns=(rate_n,), only={f"nonstab{rate_n}"})
    rate = cap["rows"][0]["amp_updates_per_s"]
    row = project(amp_updates_per_s=rate,
                  rate_source=f"nonstab{rate_n} in place, measured in this "
                              f"call on {cap['device']}")
    row["device"] = cap["device"]
    row["capacity_row"] = cap["rows"][0]
    return row


if __name__ == "__main__":
    print(json.dumps(run(), indent=1))
