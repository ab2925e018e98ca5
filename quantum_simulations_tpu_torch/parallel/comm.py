"""Collectives of the sharded tier: the counterparts of the XLA collectives
the JAX tier calls inside ``shard_map`` (``lax.ppermute`` by XOR mask,
``lax.all_to_all`` over ``axis_index_groups``, ``lax.psum`` and
``lax.all_gather``).

Each call takes the tensors of every position this process owns (a dict
position -> list of tensors) and is made by every rank of the mesh in the
same order, as SPMD code is.  Moves between positions of one process are
tensor moves: on one device a reference (``ppermute``) or a ``copy_``
(``all_to_all_``), between devices a peer copy.  Moves between processes
go through ``torch.distributed`` point-to-point batches
(``batch_isend_irecv``, tagged by sender and receiver position, so no
subgroup has to exist): under NCCL a card's tensor moves directly, under
gloo it is staged through pinned host memory.

The JAX tier is functional, and so are these: every contribution of an
exchange is read before any position's data is overwritten.  With
positions that share a device, ``ppermute`` hands over the partner's own
tensor, so its caller must not write a received tensor in place; the
in-place ``all_to_all_`` takes its copies itself.

``TRAFFIC`` counts the bytes each kind of call hands from one position to
another (across processes among them, with the seconds those took).
"""
from __future__ import annotations

import math
import time

import torch

TRAFFIC = {"ppermute_bytes": 0, "all_to_all_bytes": 0, "remote_bytes": 0,
           "remote_s": 0.0}
_GLOO = None  # the gloo group of host scalars beside an NCCL default group


def reset_counts() -> None:
    for key in TRAFFIC:
        TRAFFIC[key] = 0.0 if key.endswith("_s") else 0


def moved_bytes() -> int:
    return TRAFFIC["ppermute_bytes"] + TRAFFIC["all_to_all_bytes"]


def _dist():
    import torch.distributed as dist

    return dist


def _stage_on_host() -> bool:
    """Whether card tensors cross processes through host memory: every
    backend but NCCL moves host tensors only."""
    return _dist().get_backend() != "nccl"


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _exchange_remote(sends: list, recvs: list) -> None:
    """Post ``sends`` ``(peer rank, tag, tensor)`` and ``recvs`` ``(peer
    rank, tag, out tensor)`` as one batch and wait for all of them.  The
    tensors to send are copied first (contiguous, staged to host where
    the backend needs it), so the caller may overwrite them after."""
    if not sends and not recvs:
        return
    dist = _dist()
    t0 = time.perf_counter()
    stage = _stage_on_host()
    # NCCL moves card tensors only: host tensors cross through the card.
    card = None if stage else torch.device("cuda", torch.cuda.current_device())
    ops, landing = [], []
    for peer, tag, t in sends:
        if stage:
            buf = _host_copy(t) if t.is_cuda else t.contiguous()
        else:
            buf = t.to(card).contiguous()
        ops.append(dist.P2POp(dist.isend, buf, peer, tag=tag))
        TRAFFIC["remote_bytes"] += t.nbytes
    for peer, tag, out in recvs:
        if stage and out.is_cuda:
            buf = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        elif not stage and not out.is_cuda:
            buf = torch.empty(out.shape, dtype=out.dtype, device=card)
        elif not out.is_contiguous():
            buf = torch.empty(out.shape, dtype=out.dtype, device=out.device)
        else:
            buf = out
        if buf is not out:
            landing.append((out, buf))
        ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for out, buf in landing:
        out.copy_(buf)
    TRAFFIC["remote_s"] += time.perf_counter() - t0


def _tag(mesh, sender: int, receiver: int, index: int = 0,
         count: int = 1) -> int:
    return (sender * mesh.size + receiver) * count + index


def ppermute(mesh, xs: dict, mask: int) -> dict:
    """Position s receives the tensors of position ``s ^ mask``.

    ``xs[s]`` is a list of tensors (the same shapes on every position);
    the result maps each position this process owns to the list it
    received: the partner's own tensors when they lie on the same device
    (read them, do not write them), a peer copy across devices, fresh
    tensors from another process."""
    out, sends, recvs = {}, [], []
    for s, ts in xs.items():
        p = s ^ mask
        if mask:
            TRAFFIC["ppermute_bytes"] += sum(t.nbytes for t in ts)
        if mesh.rank_of(p) == mesh.rank:
            dev = mesh.device(s)
            out[s] = [t if t.device == dev else t.to(dev) for t in xs[p]]
            continue
        peer = mesh.rank_of(p)
        out[s] = [torch.empty_like(t) for t in ts]
        for i, (t, buf) in enumerate(zip(ts, out[s])):
            sends.append((peer, _tag(mesh, s, p, i, len(ts)), t))
            recvs.append((peer, _tag(mesh, p, s, i, len(ts)), buf))
    _exchange_remote(sends, recvs)
    return out


def all_to_all_(mesh, chunks: dict, groups: list) -> None:
    """In-place ``all_to_all`` over the subgroups ``groups``
    (``reshard._axis_groups``): ``chunks[s]`` lists position s's G
    chunks (writable views, possibly strided), and afterwards chunk i of
    member g[j] holds what chunk j of member g[i] held: chunk j goes to
    member j, landing at the sender's own index.  Chunks that go across
    processes are copied out before anything is written; two members in
    this process swap their chunks through one chunk-sized temporary."""
    member = {s: (g, i) for g in groups for i, s in enumerate(g)}
    sends, recvs = [], []
    for s, views in chunks.items():
        g, i = member[s]
        for j, q in enumerate(g):
            if j == i:
                continue
            TRAFFIC["all_to_all_bytes"] += views[j].nbytes
            if mesh.rank_of(q) != mesh.rank:
                peer = mesh.rank_of(q)
                sends.append((peer, _tag(mesh, s, q), views[j]))
                recvs.append((peer, _tag(mesh, q, s), views[j]))
    if recvs:
        # Receive into fresh buffers: the slots are also sent from.
        landing = [(peer, tag, torch.empty(v.shape, dtype=v.dtype,
                                           device=v.device))
                   for peer, tag, v in recvs]
        _exchange_remote(sends, landing)
        for (_, _, v), (_, _, buf) in zip(recvs, landing):
            v.copy_(buf)
    for s, views in chunks.items():
        g, i = member[s]
        for j, q in enumerate(g):
            if j > i and q in chunks:
                a, b = views[j], chunks[q][i]
                tmp = a.clone()
                a.copy_(b)
                b.copy_(tmp)
                del tmp


def _cpu_group():
    """The process group that carries host scalars: the default one,
    unless it is NCCL (card tensors only); then one gloo group, made
    on every rank at its first use, in the same order."""
    global _GLOO
    dist = _dist()
    if dist.get_backend() != "nccl":
        return None
    if _GLOO is None:
        _GLOO = dist.new_group(backend="gloo")
    return _GLOO


def all_sum_(mesh, t: torch.Tensor) -> torch.Tensor:
    """A host tensor summed over the ranks in place (each rank filled
    its own positions' entries)."""
    if mesh.world > 1:
        _dist().all_reduce(t, group=_cpu_group())
    return t


def psum(mesh, vals: dict) -> float:
    """The sum over every position of the scalars ``vals[s]`` (floats or
    0-d tensors) of this process's positions, the same on every rank."""
    local = math.fsum(float(v) for v in vals.values())
    return float(all_sum_(mesh, torch.tensor([local], dtype=torch.float64))[0])


def all_gather(mesh, vals: dict) -> list[float]:
    """The scalars of every position, in position order, on every rank."""
    vec = torch.zeros(mesh.size, dtype=torch.float64)
    for s, v in vals.items():
        vec[s] = float(v)
    return all_sum_(mesh, vec).tolist()


def gather_into(mesh, xs: dict, dests: dict | None) -> None:
    """Gather every position's tensors on rank 0: ``dests[s]`` (rank 0
    only) lists host tensors to fill from position s's ``xs[s]``.
    Positions of rank 0 copy directly (asynchronously into pinned
    memory; synchronise before reading), the others arrive by
    point-to-point."""
    sends, recvs = [], []
    if mesh.rank == 0:
        for s in range(mesh.size):
            if mesh.rank_of(s) == 0:
                for d, x in zip(dests[s], xs[s]):
                    d.copy_(x, non_blocking=True)
            else:
                for i, d in enumerate(dests[s]):
                    recvs.append((mesh.rank_of(s), _tag(mesh, s, 0, i, 2), d))
    else:
        for s, ts in xs.items():
            for i, t in enumerate(ts):
                sends.append((0, _tag(mesh, s, 0, i, 2), t))
    _exchange_remote(sends, recvs)
