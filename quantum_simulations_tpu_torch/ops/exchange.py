"""Cross-shard gate application, the exchange tier of the sharded state
(port of ``quantum_simulations_tpu/ops/exchange.py``).

The state of a sharded run is split over the mesh by its top index bits:
at shard width 2^k, qubit q >= k is mesh bit q - k.  A gate on such a
qubit pairs amplitudes of different positions.  One mechanism covers
every case: for a gate on qubits Q = (mesh bits D, local bits L), the
update decomposes by **XOR offset** x over the mesh bits,

    new_shard = sum_x  W_x  applied-to  ppermute(shard, pairing s <-> s^x)

where W_x is the 2^|L| x 2^|L| block of U coupling a position's bit
values ``a`` to its partner's ``a ^ x``.  Offsets whose block is zero for
every ``a`` ship nothing, so a diagonal gate or a control on a mesh bit
costs no traffic, a general 1q gate one exchange, and a block with one
nonzero cell for every ``a`` (a CNOT's target, a SWAP across the
boundary) ships only the half plane it reads.

A position's bit values are host integers here (the reference traces
them from ``axis_index``), so each W_x is a host constant per position.
The arithmetic is plain torch on the (re, im) planes, as it is jnp/XLA
in the reference: W_x through ``dense.apply_gate_planar`` (counted in
``GATE_CALLS``), a scalar or a single cell as one complex scale.  The
counting helpers below say what each gate ships; the staging scheduler
(``circuit/staging.py``) minimises it.
"""
from __future__ import annotations

import numpy as np
import torch


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


def bit_value(s: int, qubits, dev_pos, k: int) -> int:
    """Position s's value of the gate's mesh-bit qubits, dev_pos[0]
    most significant (the order of the reference's tables)."""
    r = len(dev_pos)
    return sum(((s >> (qubits[j] - k)) & 1) << (r - 1 - t)
               for t, j in enumerate(dev_pos))


def scale_planes(c: complex, re, im):
    """(c * psi) as new planes; 1 returns the planes themselves."""
    if c == 1:
        return re, im
    if c.imag == 0:
        return re * c.real, im * c.real
    return re * c.real - im * c.imag, re * c.imag + im * c.real


def apply_nonlocal(mesh, shards: dict, k: int, qubits: tuple[int, ...],
                   U: np.ndarray) -> dict:
    """Apply a gate with >= 1 mesh-bit qubit to every shard of this
    process; returns the new (re, im) planes by position (fresh tensors:
    every contribution reads the old planes, which are left as they
    were).  Made by every rank in the same order (it calls
    ``comm.ppermute`` once per nonzero offset)."""
    from ..parallel import comm
    from . import dense

    U = np.asarray(U, dtype=np.complex128)
    qubits = tuple(qubits)
    m = len(qubits)
    dev_pos = [j for j, q in enumerate(qubits) if q >= k]
    loc_pos = [j for j, q in enumerate(qubits) if q < k]
    r, p = len(dev_pos), len(loc_pos)
    if r == 0:
        raise ValueError("apply_nonlocal called with an all-local gate")
    loc_qubits = tuple(qubits[j] for j in loc_pos)
    dev_weight = [1 << (m - 1 - j) for j in dev_pos]
    loc_off = np.asarray([
        sum(((lo >> (p - 1 - t)) & 1) << (m - 1 - j)
            for t, j in enumerate(loc_pos))
        for lo in range(1 << p)], dtype=np.int64)

    def base(a: int) -> int:
        return sum(((a >> (r - 1 - t)) & 1) * dev_weight[t] for t in range(r))

    def block(a: int, x: int) -> np.ndarray:
        """W_x of a position whose mesh-bit value is ``a``."""
        return U[np.ix_(base(a) + loc_off, base(a ^ x) + loc_off)]

    def mesh_mask(x: int) -> int:
        return sum(1 << (qubits[j] - k) for t, j in enumerate(dev_pos)
                   if (x >> (r - 1 - t)) & 1)

    def single_cell(x: int):
        """(lo_t, li_t) over the 2^r values when offset x's block has one
        nonzero cell for every value (a local plane in, a local plane
        out), else None."""
        if p != 1:
            return None
        cells = [list(zip(*np.nonzero(block(a, x)))) for a in range(1 << r)]
        if any(len(c) != 1 for c in cells):
            return None
        return [c[0][0] for c in cells], [c[0][1] for c in cells]

    vals = {s: bit_value(s, qubits, dev_pos, k) for s in shards}
    acc: dict = {}
    owned: set = set()  # positions whose acc planes are fresh tensors

    def add(s, re, im):
        if s in acc:
            ar, ai = acc[s]
            acc[s] = (ar + re, ai + im)
            owned.add(s)
        else:
            acc[s] = (re, im)
            if re is not shards[s][0]:
                owned.add(s)

    for x in nonzero_offsets(U, qubits, k):
        tables = single_cell(x) if x else None
        if tables is not None:
            # Ship only the plane the partner reads: li_t[partner's value]
            # (not li_t[mine]; they differ for a SWAP across the boundary).
            lo_t, li_t = tables
            C = 1 << loc_qubits[0]
            sends = {s: [pl.view(-1, 2, C)[:, li_t[a ^ x]]
                         for pl in shards[s]] for s, a in vals.items()}
            got = comm.ppermute(mesh, sends, mesh_mask(x))
            for s, a in vals.items():
                lout, lin = lo_t[a], li_t[a]
                hr, hi = scale_planes(complex(block(a, x)[lout, lin]),
                                      *got[s])
                if s not in acc:
                    acc[s] = tuple(torch.zeros_like(pl) for pl in shards[s])
                elif s not in owned:
                    acc[s] = tuple(pl.clone() for pl in acc[s])
                owned.add(s)
                for dst, h in zip(acc[s], (hr, hi)):
                    dst.view(-1, 2, C)[:, lout] += h
            continue
        got = (comm.ppermute(mesh, {s: list(pl) for s, pl in shards.items()},
                             mesh_mask(x)) if x else
               {s: list(pl) for s, pl in shards.items()})
        for s, a in vals.items():
            W = block(a, x)
            if p == 0:
                re, im = scale_planes(complex(W[0, 0]), *got[s])
            else:
                re, im = dense.apply_gate_planar(*got[s], loc_qubits, W)
            add(s, re, im)
    return acc


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
