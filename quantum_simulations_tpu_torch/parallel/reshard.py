"""Bit-permutation resharding: the all-to-all qubit redistribution (port
of ``quantum_simulations_tpu/parallel/reshard.py``).

Swapping local bits L = (l_0..l_{r-1}) with mesh bits D = (d_0..d_{r-1})
is, semantically, the gate sequence ``SWAP(l_0, d_0) ... SWAP(l_{r-1},
d_{r-1})``, but one ``all_to_all`` moves every amplitude once: chunk j
of a shard (its amplitudes whose L bits spell j, bit i of j on l_i) goes
to the member of its 2^r-position subgroup whose D bits spell j, and
lands there as chunk (the sender's D bits).  Each position ships
2^k * (1 - 2^-r) amplitudes, against r * 2^k for the SWAP-by-SWAP
``ppermute`` chain.

The reference transposes the shard so the L bits lead, runs the
collective on the (2^r, 2^(k-r)) view and transposes back.  Here each
chunk is a strided view of the shard (``comm.all_to_all_`` copies what it
ships and swaps chunks between positions of one process through one
chunk of temporary), so the exchange runs in the shard's own memory with
no transposed copy: a capacity-size shard holds no second plane.
"""
from __future__ import annotations

from ..ops.dense import _gate_view
from . import comm


def _axis_groups(n_dev: int, dev_bits: list[int]) -> list[list[int]]:
    """Subgroups of the 1-D mesh varying exactly in ``dev_bits``.

    Group member j (leading-axis chunk j) is the device whose
    ``dev_bits`` pattern encodes j with bit i of j on mesh-axis bit
    ``dev_bits[i]``; all other bits identify the group.
    """
    r = len(dev_bits)
    rest_mask = (n_dev - 1) & ~sum(1 << b for b in dev_bits)
    groups = []
    seen = set()
    for base in range(n_dev):
        key = base & rest_mask
        if key in seen:
            continue
        seen.add(key)
        members = []
        for j in range(1 << r):
            s = key
            for i, b in enumerate(dev_bits):
                if (j >> i) & 1:
                    s |= 1 << b
            members.append(s)
        groups.append(members)
    return groups


def bit_chunks(x, k: int, bits: list[int]) -> list:
    """The 2^r strided views of the flat (2^k,) ``x`` with local bit
    ``bits[i]`` fixed to bit i of the view's index."""
    shape, axes = _gate_view(k, tuple(bits))
    v = x.view(shape)
    out = []
    for j in range(1 << len(bits)):
        idx = [slice(None)] * len(shape)
        for i, a in enumerate(axes):
            idx[a] = (j >> i) & 1
        out.append(v[tuple(idx)])
    return out


def swap_device_bits(mesh, planes: dict, k: int,
                     pairs: list[tuple[int, int]]) -> None:
    """Exchange local bits with mesh bits in one ``all_to_all``, in place.

    ``planes`` maps each position of this process to one flat (2^k,)
    tensor (a plane of its shard).  ``pairs`` is a list of (local_qubit,
    device_qubit) with local_qubit < k <= device_qubit, all locals
    distinct, all device qubits distinct.  Semantically identical to
    applying ``SWAP(lq, dq)`` for every pair.
    """
    if not pairs:
        return
    lqs = [p[0] for p in pairs]
    dqs = [p[1] for p in pairs]
    r = len(pairs)
    if len(set(lqs)) != r or len(set(dqs)) != r:
        raise ValueError(f"reshard pairs must be disjoint: {pairs}")
    if not all(lq < k <= dq for lq, dq in pairs):
        raise ValueError(f"reshard pairs must cross the boundary {k}: {pairs}")
    groups = _axis_groups(mesh.size, [dq - k for dq in dqs])
    comm.all_to_all_(mesh, {s: bit_chunks(x, k, lqs)
                            for s, x in planes.items()}, groups)


def plan_boundary_reshard(
    ops: list, k: int,
) -> tuple[list[tuple[int, int]], list]:
    """Split a step's nonlocal ops into (reshard pairs, remaining ops).

    Staging emits stage transitions as runs of boundary SWAPs (one
    local qubit, one device qubit, pairwise disjoint); they collapse
    into one reshard collective, everything else stays on the per-gate
    exchange path.  A SWAP is hoisted to the front only when it shares
    no qubit with any earlier non-hoisted op (always true inside one
    level, where gates are mutually disjoint), so reordering is safe.
    """
    pairs: list[tuple[int, int]] = []
    used: set[int] = set()
    rest: list = []
    seen_qubits: set[int] = set()
    for op in ops:
        name = getattr(op, "name", None)
        qs = tuple(op.qubits)
        if (
            name == "SWAP"
            and len(qs) == 2
            and min(qs) < k <= max(qs)
            and not (set(qs) & used)
            and not (set(qs) & seen_qubits)
        ):
            pairs.append((min(qs), max(qs)))
            used.update(qs)
        else:
            rest.append(op)
            seen_qubits.update(qs)
    return pairs, rest


def reshard_bytes(k: int, r: int, itemsize: int = 8) -> dict:
    """Bytes one position ships in one reshard vs the equivalent SWAP
    ppermute chain."""
    shard = (1 << k) * itemsize
    return {
        "all_to_all_bytes": shard - (shard >> r),
        "ppermute_chain_bytes": r * shard,
    }
