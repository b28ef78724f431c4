"""Multi-process execution (counterpart of vqtpu/parallel/multihost.py).

One process a rank: each calls `init_multihost` once, which initializes
the default `torch.distributed` process group, then builds one mesh over
every rank (`parallel.shard.make_mesh`) and trains as on one process. The
collectives run over NCCL between cards, or over gloo, which also takes
CUDA tensors (staged through the host): the way to run several ranks on
one card, since NCCL refuses two ranks on one device.
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..core.utils import resolve_device


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    *,
    backend: str | None = None,
    timeout: timedelta = timedelta(minutes=10),
) -> None:
    """Initialize the default process group of a multi-process job.

    `coordinator_address`: 'host:port' of rank 0 (a `tcp://` rendezvous),
    or a URL with its scheme (`tcp://...`, `file://...`); None reads the
    rendezvous from the environment (`env://`: MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK, as torchrun sets them). `local_device_ids`: the
    CUDA cards of this process; the first becomes its current device.
    `backend`: 'nccl' or 'gloo'; None takes NCCL when CUDA is available and
    gloo otherwise."""
    if coordinator_address is None:
        init_method = 'env://'
    elif '://' in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f'tcp://{coordinator_address}'
    if local_device_ids is not None:
        torch.cuda.set_device(int(list(local_device_ids)[0]))
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    kwargs = {}
    if num_processes is not None:
        kwargs['world_size'] = num_processes
    if process_id is not None:
        kwargs['rank'] = process_id
    dist.init_process_group(backend, init_method=init_method, timeout=timeout, **kwargs)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_batch(mesh, spec, full_array, device: str | torch.device | None = None) -> torch.Tensor:
    """This rank's block of a host-level batch that every rank holds whole
    (made, say, from a shared seed): `spec` names, per leading dim, the mesh
    axis it is split over or None (`('data',)`: dim 0 over 'data'), as a
    JAX PartitionSpec does. Each split dim must divide evenly. The block
    lands on `device` (the CUDA card when None; raises without one, unless
    `full_array` is already a tensor on the card)."""
    if isinstance(full_array, np.ndarray):
        full_array = torch.from_numpy(full_array)
    block = full_array
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        size, index = mesh.size(axis), mesh.index(axis)
        if block.shape[dim] % size:
            raise ValueError(f'dim {dim} of {tuple(full_array.shape)} does not split over {size} ranks')
        step = block.shape[dim] // size
        block = block.narrow(dim, index * step, step)
    if device is None and block.device.type == 'cuda':
        return block.contiguous()
    return block.to(resolve_device(device)).contiguous()
