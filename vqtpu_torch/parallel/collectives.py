"""Cross-replica collectives over torch.distributed, named by mesh axis
(counterpart of vqtpu/parallel/collectives.py).

Every quantizer takes `sync_axis: str | None`. An axis is a name, as in
JAX: it resolves against the mesh the caller binds (`with mesh:`, or
`DataParallelTrainer.step`), whose axes each map to a
`torch.distributed` process group (`parallel.shard.make_mesh`). `None`
means the identity, the single-replica path. A collective on a name that
no bound mesh has raises NameError, as JAX's unbound psum does; the eval
forward, decode and checkpointing reach none.

Gradient contracts, as in the JAX package under `shard_map(check_vma=False)`:

  - `psum`: backward is a sum all-reduce of the cotangent (JAX's psum
    transpose, and `torch.distributed.nn.functional.all_reduce`'s);
  - `psum_exact`: backward the identity;
  - `all_gather_exact`: backward the rank's own block of the cotangent;
  - `psum_in_bwd`: forward the identity, backward a psum;
  - `pmean`: psum / axis size, both ways;
  - `all_gather`: backward the rank's own block of the summed cotangent
    (JAX's psum_scatter transpose);
  - `pmax`, `pmin`: no gradient (the winner reductions of row-sharded
    selection, whose operands are scores and ranks).

Every rank must call the same collectives in the same order, forward and
backward, as with any torch.distributed program.

Under `torch.compile` every collective traces (`fullgraph=True`), forward
and backward: the binding is a plain module-level stack, which Dynamo
reads and guards on, and the in-place `torch.distributed` calls become
functional collectives (`_c10d_functional`) in the captured graphs. Bind
the mesh outside the compiled function (`DataParallelTrainer` does), so
that an op whose body runs collectives when it runs (`vqtpu::kmeans`)
finds it too. Each rank is its own process, so the stack is not
per-thread.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the meshes the caller bound (parallel.shard.Mesh), innermost last
_BOUND_MESHES: list = []


def push_mesh(mesh) -> None:
    """Resolve axis names against `mesh` until the matching `pop_mesh`
    (`with mesh:` calls both)."""
    _BOUND_MESHES.append(mesh)


def pop_mesh() -> None:
    _BOUND_MESHES.pop()


def bound_mesh():
    """The innermost bound mesh, or None."""
    return _BOUND_MESHES[-1] if _BOUND_MESHES else None


def group(axis: str):
    """The process group of a bound axis name; NameError if none is bound."""
    mesh = bound_mesh()
    if mesh is None or axis not in mesh.axis_names:
        raise NameError(f'unbound axis name: {axis!r} (bind a mesh that has it: `with mesh:`)')
    return mesh.group(axis)


def _all_reduce(x: torch.Tensor, pg) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=pg)
    return out


def _gather(x: torch.Tensor, pg, concat_axis: int, tiled: bool, by_sum: bool = False) -> torch.Tensor:
    x = x.contiguous()
    world = dist.get_world_size(pg)
    if by_sum:
        # each rank's block among zeros, summed over the ranks: exact (only
        # a -0.0 comes back +0.0)
        rank = dist.get_group_rank(pg, dist.get_rank())
        parts = _all_reduce(torch.stack([x if r == rank else torch.zeros_like(x) for r in range(world)]),
                            pg).unbind(0)
    else:
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=pg)
    return torch.cat(parts, concat_axis) if tiled else torch.stack(parts, concat_axis)


def _gathers_by_sum(x: torch.Tensor, axis: str) -> bool:
    """Whether a compiled graph gathers `x` over `axis` as a sum of blocks
    placed among zeros: gloo's all_gather into one CUDA tensor (the
    functional collective a compiled graph holds) crashed the process on an
    H100 (torch 2.11), while its all-reduce of CUDA tensors runs."""
    return torch.compiler.is_compiling() and x.is_cuda and bound_mesh().backends.get(axis) == 'gloo'


def _own_block(g: torch.Tensor, pg, concat_axis: int, tiled: bool, size: int) -> torch.Tensor:
    rank = dist.get_group_rank(pg, dist.get_rank())
    if tiled:
        return g.narrow(concat_axis, rank * size, size)
    return g.select(concat_axis, rank)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, sum_cotangent):
        ctx.pg, ctx.sum_cotangent = pg, sum_cotangent
        return _all_reduce(x, pg)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, ctx.pg) if ctx.sum_cotangent else g), None, None


class _PsumInBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.pg), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, concat_axis, tiled, sum_cotangent, by_sum):
        ctx.pg, ctx.concat_axis, ctx.tiled, ctx.sum_cotangent = pg, concat_axis, tiled, sum_cotangent
        ctx.size = x.shape[concat_axis] if tiled else 1
        return _gather(x, pg, concat_axis, tiled, by_sum)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_cotangent:
            g = _all_reduce(g, ctx.pg)
        return _own_block(g, ctx.pg, ctx.concat_axis, ctx.tiled, ctx.size), None, None, None, None, None


def psum(x: torch.Tensor, axis: str | None) -> torch.Tensor:
    """Sum over the axis; backward sums the cotangent over the axis."""
    if axis is None:
        return x
    return _Psum.apply(x, group(axis), True)


def psum_exact(x: torch.Tensor, axis: str | None) -> torch.Tensor:
    """Sum over the axis; the cotangent passes to each rank's partial
    unchanged (a replicated cotangent flowing to each partial: the contract
    of a tensor-parallel lookup)."""
    if axis is None:
        return x
    return _Psum.apply(x, group(axis), False)


def all_gather_exact(x: torch.Tensor, axis: str | None, *, concat_axis: int = 0) -> torch.Tensor:
    """Concatenate every rank's `x` along `concat_axis`, in rank order;
    backward hands each rank its own block of the cotangent, unscaled."""
    if axis is None:
        return x
    return _AllGather.apply(x, group(axis), concat_axis, True, False, _gathers_by_sum(x, axis))


def psum_in_bwd(x: torch.Tensor, axis: str | None) -> torch.Tensor:
    """The identity forward; backward sums the cotangent over the axis."""
    if axis is None:
        return x
    return _PsumInBwd.apply(x, group(axis))


def pmean(x: torch.Tensor, axis: str | None) -> torch.Tensor:
    """Mean over the axis (psum / axis size)."""
    if axis is None:
        return x
    return psum(x, axis) / axis_size(axis)


def all_gather(x: torch.Tensor, axis: str | None, *, tiled: bool = True, concat_axis: int = 0) -> torch.Tensor:
    """Every rank's `x` in rank order: concatenated along `concat_axis`
    (`tiled`) or stacked on a new axis there. Pools the per-rank candidate
    buffers of kmeans init and dead-code expiry (a fixed-size buffer from
    each rank)."""
    if axis is None:
        return x
    return _AllGather.apply(x, group(axis), concat_axis, tiled, True, _gathers_by_sum(x, axis))


def _reduce_no_grad(x: torch.Tensor, axis: str | None, op) -> torch.Tensor:
    if axis is None:
        return x.detach()
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group(axis))
    return out


def pmax(x: torch.Tensor, axis: str | None) -> torch.Tensor:
    """Elementwise maximum over the axis, without gradient."""
    return _reduce_no_grad(x, axis, dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, axis: str | None) -> torch.Tensor:
    """Elementwise minimum over the axis, without gradient."""
    return _reduce_no_grad(x, axis, dist.ReduceOp.MIN)


def axis_size(axis: str | None) -> int:
    if axis is None:
        return 1
    return dist.get_world_size(group(axis))


def axis_index(axis: str | None) -> int:
    if axis is None:
        return 0
    return dist.get_group_rank(group(axis), dist.get_rank())


def axis_is_bound(axis: str | None) -> bool:
    """Whether a bound mesh has `axis`; False for None."""
    mesh = bound_mesh()
    return axis is not None and mesh is not None and axis in mesh.axis_names
