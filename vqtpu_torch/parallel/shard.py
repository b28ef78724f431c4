"""Meshes of process groups, the data-parallel trainer and the helpers of
row-sharded codebooks (counterpart of vqtpu/parallel/shard.py).

The quantizers take `sync_axis='data'`; a training step runs with a mesh
bound, so every codebook statistic is a psum over that axis (the ranks'
EMA codebooks stay bit-identical by construction), and the trainer
averages the parameter gradients (`pmean`). The model is not wrapped in
`torch.nn.parallel.DistributedDataParallel`: by default it broadcasts
rank 0's buffers before each forward, which would overwrite the other
ranks' codebooks and hide a replica that drifted.

Row-sharded codebooks (`code_axis`): `sharded_nearest_code` runs the
selection kernel on each rank's rows and reduces the shards' winners,
`sharded_gather_codes` looks rows up from their owners, and
`slice_local_cols` and `local_onehot_from_global` cut a rank's code
columns out of replicated tensors. The TPU's one-hot lookup for small
shards is not ported: every lookup here is a row gather.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from ..core.compile import compile_step
from ..core.optim import optimizer_update, prepare_adamw_for_graph
from ..kernels.distance import bf16_select, nearest_code
from ..kernels.train_fused import code_sums
from . import collectives


class Mesh:
    """Named axes over the ranks of the default process group, each axis a
    process group of the ranks that differ only in that coordinate. Rank r
    sits at the row-major coordinates of r in `shape`. `with mesh:` binds
    its axis names for the collectives. `backends`: each axis's
    torch.distributed backend ('gloo', 'nccl'), where known."""

    def __init__(self, axis_names: tuple[str, ...], shape: tuple[int, ...], groups: dict, coords: tuple[int, ...],
                 backends: dict | None = None):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape)
        self.groups = groups
        self.coords = tuple(coords)
        self.backends = dict(backends or {})

    def group(self, axis: str):
        return self.groups[axis]

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def __enter__(self):
        collectives.push_mesh(self)
        return self

    def __exit__(self, *exc):
        collectives.pop_mesh()

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
    return Mesh(axis_names, shape, groups, coords, {name: dist.get_backend(pg) for name, pg in groups.items()})


def _pmean_flat(grads: list, axis: str, reduce: Callable = collectives.pmean) -> list:
    """`reduce` of each gradient over `axis`, in one collective over the
    flattened gradients; each back in its shape and dtype."""
    flat = reduce(torch.cat([g.reshape(-1) for g in grads]), axis)
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset:offset + g.numel()].reshape(g.shape).to(g.dtype, copy=True))
        offset += g.numel()
    return out


def average_gradients(params: list, axis: str, reduce: Callable = collectives.pmean) -> None:
    """Replace each parameter's gradient by `reduce` of it over `axis`
    (pmean by default), in one collective over the flattened gradients; a
    parameter without a gradient counts a zero one."""
    if not params:
        return
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    for p, g in zip(params, _pmean_flat(grads, axis, reduce)):
        p.grad = g


def _on_card(model: nn.Module) -> bool:
    return any(t.is_cuda for t in itertools.chain(model.parameters(), model.buffers()))


def _state_copy(module: nn.Module, held: dict | None = None) -> tuple:
    """What a call that keeps no state puts back afterwards
    (`_restore_state`): each parameter and buffer of `module` with a copy of
    its data, or with `held[id(tensor)]` where `held` has it, and each
    codebook's host mirror of its `initted` flag."""
    held = held or {}
    tensors = {id(t): t for t in [*module.parameters(), *module.buffers()]}
    return ([(t, held[i] if i in held else t.detach().clone()) for i, t in tensors.items()],
            [(m, m.initted_on_host) for m in module.modules() if hasattr(m, 'initted_on_host')])


def _restore_state(saved: tuple) -> None:
    """Put back what `_state_copy` took: each tensor's data (the tensor
    objects stay, and the call's outputs keep what they hold) and the host
    mirrors, so that the next call meets the guards of this one."""
    tensors, mirrors = saved
    with torch.no_grad():
        for t, data in tensors:
            t.data = data
    for m, on_host in mirrors:
        m.initted_on_host = on_host


def _graph_params(model: nn.Module, optimizer: torch.optim.Optimizer) -> tuple[list, list]:
    """For a compiled step, fixed outside the trace: the model's trainable
    parameters, and where each of the optimizer's parameters sits among
    them (None for one the model does not train). Adam's state is made
    here, in the parameters' shapes as they are now."""
    params = [p for p in model.parameters() if p.requires_grad]
    at = {id(p): i for i, p in enumerate(params)}
    slots = [at.get(id(p)) for group in optimizer.param_groups for p in group['params']]
    if isinstance(optimizer, torch.optim.Adam) and not any(g['amsgrad'] for g in optimizer.param_groups):
        prepare_adamw_for_graph(optimizer)
    return params, slots


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

    `compiled`: run the step compiled whole, as the JAX package jits its
    shard_map'd step (`core.compile.compile_step` with `backend`: one
    graph, or an error): the loss, `torch.autograd.grad` over
    the trainable parameters, one pmean of the flattened gradients, the
    optimizer's functional update (`core.optim.optimizer_update`; SGD, Adam
    and AdamW trace) and the pmean of the loss, the collectives inside the
    graph. None compiles when the model is on the card and runs eagerly on
    the CPU. The compiled step leaves the parameters' `.grad` alone; the
    eager one (`compiled=False`) leaves the averaged gradients there. A
    codebook with kmeans init compiles twice: once for the step that runs
    the init, once for the steps after it (`Codebook.initted_on_host`).

    Usage:
        mesh = make_mesh(('data',))
        trainer = DataParallelTrainer(model, torch.optim.Adam(model.parameters(), 1e-3), loss_fn, mesh)
        loss = trainer.step(local_batch)
    """

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer, loss_fn: Callable,
                 mesh: Mesh, axis: str = 'data', *, compiled: bool | None = None, backend: str = 'inductor'):
        if axis not in mesh.axis_names:
            raise ValueError(f'axis {axis!r} is not an axis of {mesh}')
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.axis = axis
        self.compiled = _on_card(model) if compiled is None else bool(compiled)
        self._graph_step = None
        if self.compiled:
            self._params, self._slots = _graph_params(model, optimizer)
            self._graph_step = compile_step(self._step_body, backend=backend)

    def step(self, batch) -> torch.Tensor:
        """One optimizer step on this rank's shard `batch`; updates the
        model and the optimizer in place and returns the mean loss over
        the axis (detached)."""
        with self.mesh:
            if self._graph_step is not None:
                return self._graph_step(batch)
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.loss_fn(self.model, batch)
            loss.backward()
            with torch.no_grad():
                average_gradients([p for p in self.model.parameters() if p.requires_grad], self.axis)
            self.optimizer.step()
            return collectives.pmean(loss.detach(), self.axis)

    def _step_body(self, batch) -> torch.Tensor:
        """The compiled step: the gradients as the eager step averages
        them, handed to the optimizer's update in its parameters' order (a
        parameter the model does not train gets None, which leaves it)."""
        params, grads = self._params, ()
        loss = self.loss_fn(self.model, batch)
        if params:
            raw = torch.autograd.grad(loss, params, allow_unused=True)
            grads = _pmean_flat([torch.zeros_like(p) if g is None else g for p, g in zip(params, raw)], self.axis)
        # each parameter updated on its own: inductor (torch 2.11, H100) ran
        # a foreach update before a fused kernel that still read the
        # parameter's old value, and the step returned the loss of the
        # updated parameter
        optimizer_update(self.optimizer, [None if i is None else grads[i] for i in self._slots], foreach=False)
        return collectives.pmean(loss.detach(), self.axis)


def eval_step_fn(model: nn.Module, mesh: Mesh, axis: str = 'data', *, compiled: bool | None = None,
                 backend: str = 'inductor') -> Callable:
    """f(batch) -> the model's outputs on this rank's shard, without
    gradients, with the mesh bound (a quantizer that syncs statistics in
    eval, affine_param's batch moments, finds its axis). `compiled` as
    `DataParallelTrainer`'s: None compiles `model(batch)` when the model
    is on the card."""
    if axis not in mesh.axis_names:
        raise ValueError(f'axis {axis!r} is not an axis of {mesh}')

    def forward(batch):
        with torch.no_grad():
            return model(batch)

    if _on_card(model) if compiled is None else compiled:
        forward = compile_step(forward, backend=backend)

    def run(batch):
        with mesh:
            return forward(batch)

    return run


# -- row-sharded codebooks (tensor parallelism over a `code` axis) ---------------
#
# Counterpart of the tensor-parallel half of vqtpu/parallel/shard.py. A
# codebook's rows split over the ranks of a mesh axis in rank order: rank r
# holds global codes [r * c_local, (r + 1) * c_local). Tokens are
# replicated over the axis; every function here is called by every rank of
# the axis with the same tokens.


def code_row0(axis: str, c_local: int) -> int:
    """The global index of this rank's first codebook row."""
    return collectives.axis_index(axis) * c_local


def _global_winner_index(local_idx: torch.Tensor, score: torch.Tensor, axis: str, c_local: int) -> torch.Tensor:
    """The shards' (score, local index) pairs -> global int32 indices: pmax
    of the scores, pmin of the ranks that hold the best, psum of the
    winner's index. Within a shard the argmax took the first index, and the
    global index is rank-major, so the lowest global index wins a tie, as
    the unsharded argmax's does."""
    rank, world = collectives.axis_index(axis), collectives.axis_size(axis)
    best = collectives.pmax(score, axis)
    is_best = score == best
    win_rank = collectives.pmin(torch.where(is_best, rank, world).to(torch.int32), axis)
    mine = is_best & (win_rank == rank)
    global_idx = torch.where(mine, local_idx.to(torch.int32) + rank * c_local, 0).to(torch.int32)
    return collectives.psum(global_idx, axis)


def sharded_nearest_code(
    x: torch.Tensor, embed_shard: torch.Tensor, axis: str, metric: str = 'euclidean',
) -> torch.Tensor:
    """(n, d) tokens against this rank's (c_local, d) rows -> (n,) global
    int32 indices of the nearest code of the whole codebook, first index on
    ties. Each rank runs the selection kernel on its rows with the winning
    score (`nearest_code(..., return_best=True)`; `nearest_code_plain` on
    the CPU) and the shards' winners reduce over the axis
    (`_global_winner_index`): a column's score does not depend on the shard
    that computes it, so nothing is scored again."""
    local_idx, score = nearest_code(x.float().contiguous(), embed_shard.detach().float().contiguous(), metric,
                                    return_best=True)
    return _global_winner_index(local_idx, score, axis, embed_shard.shape[0])


def sharded_quantize_lookup_bf16(
    x: torch.Tensor, embed_shard: torch.Tensor, axis: str, metric: str = 'euclidean',
) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 tier (`quantize_lookup(..., tier='bf16')`) against
    row-sharded codes: (n, d), (c_local, d) -> ((n,) global int32 indices,
    (n, d) bf16 rows), bit-identical to the unsharded tier (a column's f32
    score of bf16 values does not depend on the shard; the winner reduction
    keeps the first index; the row comes from its one owner)."""
    eb = embed_shard.detach().to(torch.bfloat16)
    local_idx, score = bf16_select(x, eb, metric)
    idx = _global_winner_index(local_idx, score, axis, eb.shape[0])
    return idx, sharded_gather_codes(eb, idx, axis)


class _SliceLocalCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, full, c_local, axis, row0):
        ctx.axis, ctx.row0, ctx.c_full = axis, row0, full.shape[-1]
        return full.narrow(-1, row0, c_local)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(*g.shape[:-1], ctx.c_full)
        full.narrow(-1, ctx.row0, g.shape[-1]).copy_(g)
        return collectives.psum(full, ctx.axis), None, None, None


def slice_local_cols(full: torch.Tensor, c_local: int, axis: str) -> torch.Tensor:
    """This rank's code columns [row0, row0 + c_local) of a replicated
    (..., c) tensor. The backward scatters each rank's cotangent into its
    window and psums over the axis, so the replicated tensor (a
    straight-through one-hot over global codes) receives the full
    cotangent on every rank."""
    return _SliceLocalCols.apply(full, c_local, axis, code_row0(axis, c_local))


def local_onehot_from_global(ind: torch.Tensor, c_local: int, row0: int) -> torch.Tensor:
    """(...) global code indices -> (..., c_local) f32 one-hot over this
    rank's window [row0, row0 + c_local), all zero for codes another rank
    owns."""
    local = ind.long() - row0
    mine = (local >= 0) & (local < c_local)
    out = torch.zeros(*ind.shape, c_local + 1, device=ind.device)
    out.scatter_(-1, torch.where(mine, local, c_local)[..., None], 1.0)
    return out[..., :c_local]


def local_or_dump(ind: torch.Tensor, c_local: int, row0: int) -> torch.Tensor:
    """Global code indices -> int32 indices into this rank's rows, with the
    codes another rank owns sent to the dump row c_local (one past the
    rank's rows)."""
    local = ind.long() - row0
    mine = (local >= 0) & (local < c_local)
    return torch.where(mine, local, c_local).to(torch.int32)


class _RowGather(torch.autograd.Function):
    """Rows of (c_local + 1, d) by local index; the backward sums the rows'
    gradients by code (`code_sums`, deterministic on the card), the dump
    row's sum dropped."""

    @staticmethod
    def forward(ctx, embed_shard, safe):
        ctx.save_for_backward(safe)
        ctx.c_local = embed_shard.shape[0]
        padded = torch.cat([embed_shard, embed_shard.new_zeros(1, embed_shard.shape[-1])])
        return padded.index_select(0, safe.long())

    @staticmethod
    def backward(ctx, g):
        safe, = ctx.saved_tensors
        _, esum = code_sums(g.float().contiguous(), safe, ctx.c_local + 1)
        return esum[:ctx.c_local].to(g.dtype), None


def sharded_gather_codes(embed_shard: torch.Tensor, indices: torch.Tensor, axis: str) -> torch.Tensor:
    """Row lookup against a codebook sharded over `axis`: (c_local, d) rows,
    (...) global indices -> (..., d). Each rank gathers the rows it owns
    from its rows with one zero row appended (where codes of other ranks
    land), then `psum_exact` over the axis: each token's row comes from its
    one owner and the others add zeros, so the rows are bit-equal to
    codebook rows. Differentiable with respect to the rows: each rank's
    rows take the gradient of the tokens they own."""
    c_local = embed_shard.shape[0]
    safe = local_or_dump(indices.reshape(-1), c_local, code_row0(axis, c_local))
    out = _RowGather.apply(embed_shard, safe)
    if out.dtype in (torch.bfloat16, torch.float16):
        # the sum of one row and zeros is exact in f32, and every backend
        # sums f32
        out = collectives.psum_exact(out.float(), axis).to(out.dtype)
    else:
        out = collectives.psum_exact(out, axis)
    return out.reshape(*indices.shape, embed_shard.shape[-1])
