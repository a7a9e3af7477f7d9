"""
Joining the process group of a multi-process run.  Counterpart of
:mod:`magicsoup_tpu.parallel.multihost`.

The JAX package has two entry points, a mesh over one process's devices
and JAX's distributed runtime across hosts; here both are one process
group, one process per tile, whether the ranks share a host or not.
Launch the same script once per rank (``torchrun``)::

    torchrun --nproc-per-node 2 run.py

    # run.py
    from magicsoup_tpu_torch.parallel import multihost, tiled

    multihost.initialize()           # reads torchrun's environment
    mesh = multihost.global_mesh()   # 1D mesh over every rank
    world = mt.World(chemistry=..., seed=7, mesh=mesh)

Every stochastic decision is drawn on the host from the World's seed, so
all ranks take the same decisions and stay in lockstep with no extra
communication; only tensors cross between ranks.  A rank that takes
another decision deadlocks the collectives, which then fail at the
group's timeout.
"""
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from magicsoup_tpu_torch.parallel import tiled

#: seconds a collective (and the group's rendezvous) may wait
DEFAULT_TIMEOUT = 300.0


def choose_backend(local_ranks: int | None = None) -> str:
    """NCCL when each of this host's ranks can have a card of its own,
    else gloo (ranks sharing a card, or no card): NCCL refuses two ranks
    on one device."""
    if local_ranks is None:
        local_ranks = int(
            os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1"))
        )
    if torch.cuda.is_available() and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    timeout: float = DEFAULT_TIMEOUT,
) -> None:
    """Join this process to the run's process group.  Without arguments
    it reads the environment ``torchrun`` sets (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with them it rendezvouses
    over TCP at ``coordinator_address`` (``"host:port"``).  ``backend``
    defaults to :func:`choose_backend` and is never switched afterwards;
    ``timeout`` bounds the rendezvous and every collective."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        init_method = "env://"
        world_size = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
        rank = process_id if process_id is not None else int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
        world_size, rank = int(num_processes), int(process_id)
    if backend is None:
        backend = choose_backend(
            int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        )
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=world_size,
        rank=rank,
        timeout=timedelta(seconds=timeout),
    )


def global_mesh(*, axis_name: str = tiled.TILE_AXIS, device=None) -> tiled.Mesh:
    """1D mesh over every rank of every host, in rank order: each rank
    owns a contiguous band of map rows, so only the two band edges cross
    between neighbouring ranks per diffusion step.  ``device`` defaults
    to this rank's card, and without one raises naming ``device='cpu'``."""
    if device is None:
        device = tiled.default_device("global_mesh")
    return tiled.make_mesh(axis_name=axis_name, device=device)
