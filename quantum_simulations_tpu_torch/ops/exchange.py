"""Cross-shard exchange accounting: the numpy cost helpers of
``quantum_simulations_tpu/ops/exchange.py`` (copies).

The state of a sharded run is split over devices by its top index bits:
at shard width 2^k, qubit q >= k is device bit q - k.  A gate on such a
qubit pairs amplitudes on different devices, and its update decomposes
by XOR offset x over its device bits: the blocks W_x of U coupling a
device's bit values ``a`` to its partner's ``a ^ x``.  An offset whose
block is zero for every ``a`` ships nothing (a diagonal gate, a control
on a device bit).  These helpers count what a gate ships; the staging
scheduler (``circuit/staging.py``) minimises it.  ``apply_nonlocal``,
which ships it, comes with the multi-device tier.
"""
from __future__ import annotations

import numpy as np

def nonzero_offsets(U: np.ndarray, qubits: tuple[int, ...], k: int) -> list[int]:
    """Which XOR offsets over the device-bit qubits have nonzero blocks."""
    m = len(qubits)
    dev_pos = [j for j, q in enumerate(qubits) if q >= k]
    loc_pos = [j for j, q in enumerate(qubits) if q < k]
    r, p = len(dev_pos), len(loc_pos)

    def sub_index(dev_bits: int, loc_sub: int) -> int:
        s = 0
        for t, j in enumerate(dev_pos):
            s |= ((dev_bits >> (r - 1 - t)) & 1) << (m - 1 - j)
        for t, j in enumerate(loc_pos):
            s |= ((loc_sub >> (p - 1 - t)) & 1) << (m - 1 - j)
        return s

    out = []
    for x in range(1 << r):
        nz = False
        for a in range(1 << r):
            for lo in range(1 << p):
                for li in range(1 << p):
                    if U[sub_index(a, lo), sub_index(a ^ x, li)] != 0:
                        nz = True
                        break
                if nz:
                    break
            if nz:
                break
        if nz:
            out.append(x)
    return out


def zero_offset_block(U: np.ndarray, qubits: tuple[int, ...], k: int,
                      a: int) -> np.ndarray:
    """W_0 for device-bit value pattern ``a``: the (2^p, 2^p) block of
    U coupling local sub-indices when every device-bit qubit keeps its
    value.  For a zero-traffic gate (only offset x=0 nonzero — device
    bits insular) this IS the whole local update for a device whose
    bit pattern is ``a`` (bit t of ``a`` = value of ``dev_pos[t]``,
    most significant first — matching ``apply_nonlocal``'s tables).
    """
    U = np.asarray(U, dtype=np.complex128)
    m = len(qubits)
    dev_pos = [j for j, q in enumerate(qubits) if q >= k]
    loc_pos = [j for j, q in enumerate(qubits) if q < k]
    r, p = len(dev_pos), len(loc_pos)
    base = sum(((a >> (r - 1 - t)) & 1) << (m - 1 - j)
               for t, j in enumerate(dev_pos))
    off = [sum(((lo >> (p - 1 - t)) & 1) << (m - 1 - j)
               for t, j in enumerate(loc_pos)) for lo in range(1 << p)]
    idx = np.asarray([base + o for o in off])
    return U[np.ix_(idx, idx)]



# ---------------------------------------------------------------------------
# Traffic accounting (scheduler cost model / stats)
# ---------------------------------------------------------------------------

def exchange_cost(U: np.ndarray, qubits: tuple[int, ...], k: int) -> int:
    """Number of ppermute rounds this gate costs at shard width 2^k."""
    if all(q < k for q in qubits):
        return 0
    return sum(1 for x in nonzero_offsets(np.asarray(U), tuple(qubits), k) if x != 0)


def offset_traffic(U: np.ndarray, qubits: tuple[int, ...], k: int) -> list[tuple[int, float]]:
    """Per-nonzero-offset shipped volume, as a fraction of the shard.

    Mirrors :func:`apply_nonlocal`'s dispatch: an offset whose block
    has a single nonzero cell per device value ships only the active
    local plane (fraction 0.5); others ship the full shard (1.0).
    """
    U = np.asarray(U, dtype=np.complex128)
    m = len(qubits)
    dev_pos = [j for j, q in enumerate(qubits) if q >= k]
    loc_pos = [j for j, q in enumerate(qubits) if q < k]
    r, p = len(dev_pos), len(loc_pos)
    if r == 0:
        return []
    dev_weight = [1 << (m - 1 - j) for j in dev_pos]
    loc_off = [
        sum(((lo >> (p - 1 - t)) & 1) << (m - 1 - j)
            for t, j in enumerate(loc_pos))
        for lo in range(1 << p)
    ]

    out = []
    for x in nonzero_offsets(U, tuple(qubits), k):
        if x == 0:
            continue
        frac = 1.0
        if p == 1:
            single = True
            for a in range(1 << r):
                ro = sum(((a >> (r - 1 - t)) & 1) * dev_weight[t]
                         for t in range(r))
                ci = sum((((a >> (r - 1 - t)) & 1) ^ ((x >> (r - 1 - t)) & 1))
                         * dev_weight[t] for t in range(r))
                cells = sum(
                    1 for lo in range(2) for li in range(2)
                    if U[ro + loc_off[lo], ci + loc_off[li]] != 0
                )
                if cells != 1:
                    single = False
                    break
            if single:
                frac = 0.5
        out.append((x, frac))
    return out


def exchange_bytes(U: np.ndarray, qubits: tuple[int, ...], k: int,
                   itemsize: int = 8) -> int:
    """ICI bytes shipped per device for this gate at shard width 2^k."""
    shard_bytes = (1 << k) * itemsize
    return int(sum(frac * shard_bytes
                   for _, frac in offset_traffic(U, qubits, k)))


def weighted_exchange_bytes(
    U: np.ndarray, qubits: tuple[int, ...], k: int,
    bit_costs: list[float], itemsize: int = 8,
) -> float:
    """Link-cost-weighted bytes per device for this gate.

    ``bit_costs[b]`` is the per-byte cost of an exchange that flips
    device bit b (``parallel.distributed.device_bit_costs``: ICI=1,
    DCN~20 on a host-contiguous pod mesh).  A ppermute by XOR offset
    crosses the most expensive link among its flipped device bits —
    the mesh-aware cost the staging scheduler minimizes, replacing
    round counts (reference analogue: the byte accounting of
    ``hisvsim_repo/mpi_redistributer.hpp``'s plan selection).
    """
    m = len(qubits)
    dev_pos = [j for j, q in enumerate(qubits) if q >= k]
    r = len(dev_pos)
    shard_bytes = (1 << k) * itemsize
    total = 0.0
    for x, frac in offset_traffic(U, qubits, k):
        # Map the gate-subspace offset back to device-index bits.
        mask = 0
        for t, j in enumerate(dev_pos):
            if (x >> (r - 1 - t)) & 1:
                mask |= 1 << (qubits[j] - k)
        w = max(
            (bit_costs[b] for b in range(len(bit_costs)) if (mask >> b) & 1),
            default=1.0,
        )
        total += w * frac * shard_bytes
    return total
