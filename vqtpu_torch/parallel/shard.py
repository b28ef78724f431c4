"""Meshes of process groups and the data-parallel trainer (counterpart of
the data-parallel half of vqtpu/parallel/shard.py).

The quantizers take `sync_axis='data'`; a training step runs with a mesh
bound, so every codebook statistic is a psum over that axis (the ranks'
EMA codebooks stay bit-identical by construction), and the trainer
averages the parameter gradients (`pmean`). The model is not wrapped in
`torch.nn.parallel.DistributedDataParallel`: by default it broadcasts
rank 0's buffers before each forward, which would overwrite the other
ranks' codebooks and hide a replica that drifted.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from . import collectives


class Mesh:
    """Named axes over the ranks of the default process group, each axis a
    process group of the ranks that differ only in that coordinate. Rank r
    sits at the row-major coordinates of r in `shape`. `with mesh:` binds
    its axis names for the collectives."""

    def __init__(self, axis_names: tuple[str, ...], shape: tuple[int, ...], groups: dict, coords: tuple[int, ...]):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape)
        self.groups = groups
        self.coords = tuple(coords)
        self._bindings = []

    def group(self, axis: str):
        return self.groups[axis]

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def __enter__(self):
        binding = collectives.bind(self)
        self._bindings.append(binding)
        return binding.__enter__()

    def __exit__(self, *exc):
        return self._bindings.pop().__exit__(*exc)

    def __repr__(self):
        return f'Mesh(axis_names={self.axis_names}, shape={self.shape}, coords={self.coords})'


def make_mesh(axis_names: tuple[str, ...] = ('data',), shape: tuple[int, ...] | None = None) -> Mesh:
    """A mesh over every rank of the initialized default process group. With
    the default single 'data' axis, all ranks form one data-parallel group.
    Every rank must call this, with the same arguments and in the same
    order as its other group creations."""
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs an initialized process group '
                           '(parallel.init_multihost or torch.distributed.init_process_group)')
    world, rank = dist.get_world_size(), dist.get_rank()
    axis_names = tuple(axis_names)
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError('give the shape of a mesh with more than one axis')
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f'mesh shape {shape} over axes {axis_names} does not cover {world} ranks')
    coords = tuple(rank // math.prod(shape[k + 1:]) % shape[k] for k in range(len(shape)))
    groups = {}
    for k, name in enumerate(axis_names):
        if shape[k] == world:
            groups[name] = dist.group.WORLD
            continue
        others = [range(s) for j, s in enumerate(shape) if j != k]
        for rest in itertools.product(*others):
            members = []
            for i in range(shape[k]):
                c = list(rest)
                c.insert(k, i)
                members.append(sum(ci * math.prod(shape[j + 1:]) for j, ci in enumerate(c)))
            pg = dist.new_group(members)
            if rank in members:
                groups[name] = pg
    return Mesh(axis_names, shape, groups, coords)


class DataParallelTrainer:
    """Data-parallel training of a model whose quantizers take
    `sync_axis=axis`: each rank runs `step` on its own shard of the global
    batch. The step binds the mesh, so the quantizers' statistics psum over
    `axis`; it averages every trainable parameter's gradient over the axis
    (a parameter the backward did not reach counts a zero gradient, as in
    the JAX package, where every parameter gets one), steps the optimizer
    and returns the loss averaged over the axis.

    With the quantizers' psum (whose backward sums the cotangent) and this
    mean, a step on W ranks takes the single-process gradient of the mean
    of the ranks' losses, the loss on the global batch when the shards are
    equal.

    Usage:
        mesh = make_mesh(('data',))
        trainer = DataParallelTrainer(model, torch.optim.Adam(model.parameters(), 1e-3), loss_fn, mesh)
        loss = trainer.step(local_batch)
    """

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer, loss_fn: Callable,
                 mesh: Mesh, axis: str = 'data'):
        if axis not in mesh.axis_names:
            raise ValueError(f'axis {axis!r} is not an axis of {mesh}')
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.axis = axis

    def _average_gradients(self):
        params = [p for p in self.model.parameters() if p.requires_grad]
        if not params:
            return
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        flat = collectives.pmean(flat, self.axis)
        offset = 0
        for p, g in zip(params, grads):
            p.grad = flat[offset:offset + g.numel()].reshape(g.shape).to(g.dtype, copy=True)
            offset += g.numel()

    def step(self, batch) -> torch.Tensor:
        """One optimizer step on this rank's shard `batch`; updates the
        model and the optimizer in place and returns the mean loss over
        the axis (detached)."""
        with self.mesh:
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.loss_fn(self.model, batch)
            loss.backward()
            with torch.no_grad():
                self._average_gradients()
            self.optimizer.step()
            return collectives.pmean(loss.detach(), self.axis)


def eval_step_fn(model: nn.Module, mesh: Mesh, axis: str = 'data') -> Callable:
    """f(batch) -> the model's outputs on this rank's shard, without
    gradients, with the mesh bound (a quantizer that syncs statistics in
    eval, affine_param's batch moments, finds its axis)."""
    if axis not in mesh.axis_names:
        raise ValueError(f'axis {axis!r} is not an axis of {mesh}')

    def run(batch):
        with mesh, torch.no_grad():
            return model(batch)

    return run
