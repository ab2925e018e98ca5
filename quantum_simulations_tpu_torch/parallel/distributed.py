"""Multi-process scaffolding: process-group init and meshes over every
process (port of ``quantum_simulations_tpu/parallel/distributed.py``).

The JAX tier joins hosts with ``jax.distributed``; here every process
joins one ``torch.distributed`` process group and drives the positions of
its own rank (``mesh.Mesh``), and the collectives of ``comm.py`` move
amplitudes between processes: NCCL between cards, gloo on the CPU, or
gloo with each card's pieces staged through host memory where NCCL
cannot run (two ranks on one card).

Positions are ordered (rank, local) by :func:`make_pod_mesh`, so the low
mesh bits change within a process (moves between positions of one
process are tensor moves) and only the top bits cross processes; the
staging scheduler reads :func:`device_bit_costs` to keep traffic off
them.
"""
from __future__ import annotations

import datetime
import math
import os

import torch

from ..utils.device import resolve_device
from .mesh import Mesh, _pow2

# Relative per-byte costs of moving a shard across one mesh bit: between
# positions of one process (a tensor move, a peer copy between cards)
# against between processes (the network, or host staging).  The
# scheduler needs the order of magnitude, not the figure.
ICI_COST = 1.0
DCN_COST = 20.0


def _env_int(*names) -> int | None:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    timeout_s: float | None = None,
) -> bool:
    """Join the process group (idempotent).

    Arguments default from the environment: ``QST_COORDINATOR`` (a
    ``host:port``, or an init URL such as ``file:///path``),
    ``QST_NUM_PROCESSES`` and ``QST_PROCESS_ID``, else torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.
    ``backend`` (default ``QST_DIST_BACKEND``, else NCCL when a card is
    present and gloo otherwise); ``timeout_s`` (default
    ``QST_DIST_TIMEOUT``, else torch's) bounds every collective, so a
    lost peer fails the run instead of hanging it.  Returns True when a
    process group is (or already was) initialised, False when nothing is
    configured (a single-process run).
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "QST_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("QST_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("QST_PROCESS_ID")
    if coordinator_address is not None:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    elif "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        init = "env://"
        num_processes = num_processes or _env_int("WORLD_SIZE")
        process_id = process_id if process_id is not None else _env_int("RANK")
    else:
        return False
    backend = backend or os.environ.get("QST_DIST_BACKEND") or (
        "nccl" if torch.cuda.is_available() else "gloo")
    if timeout_s is None and "QST_DIST_TIMEOUT" in os.environ:
        timeout_s = float(os.environ["QST_DIST_TIMEOUT"])
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        torch.cuda.set_device(_local_rank())
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id, **kw)
    # Every rank takes part in the first collective (NCCL's point-to-point
    # batches need it).
    dist.barrier()
    return True


def _local_rank() -> int:
    return _env_int("LOCAL_RANK") or 0


def is_multihost() -> bool:
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() > 1


def make_pod_mesh(n_devices: int | None = None, *, device="cuda") -> Mesh:
    """A 1-D mesh over every process, positions contiguous per rank.

    Each rank brings ``n_devices / world`` positions (one by default) on
    its device: ``device="cuda"`` is the card ``LOCAL_RANK`` (torchrun's;
    0 without it) and raises without a card; ``"cpu"`` or an indexed
    card as given.  Every rank learns the others' devices, so the mesh
    is the same everywhere.  Call after :func:`init_distributed`;
    without a process group it is this process's mesh.
    """
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_devices is None:
        n_devices = world
    _pow2(n_devices)
    if n_devices % world:
        raise ValueError(f"{n_devices} positions do not split over "
                         f"{world} processes")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank())
    per = n_devices // world
    names = [str(dev)] * world
    if world > 1:
        names = [None] * world
        dist.all_gather_object(names, str(dev))
    positions = tuple((r, torch.device(names[r]) if r != rank else dev)
                      for r in range(world) for _ in range(per))
    return Mesh(positions, rank)


def device_bit_costs(mesh: Mesh) -> list[float]:
    """Per-mesh-bit exchange cost (index b = mesh bit b): an exchange
    that flips bit b moves data between processes when two positions
    2^b apart belong to different ranks."""
    d = int(math.log2(mesh.size))
    costs = []
    for b in range(d):
        stride = 1 << b
        cross = any(mesh.rank_of(i) != mesh.rank_of(i ^ stride)
                    for i in range(mesh.size))
        costs.append(DCN_COST if cross else ICI_COST)
    return costs
