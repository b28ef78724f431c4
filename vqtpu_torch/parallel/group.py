"""Group-parallel execution of the Grouped composites over torch.distributed
(counterpart of vqtpu/parallel/group.py).

GroupedResidualVQ, GroupedResidualFSQ and GroupedResidualLFQ run their
feature-dim groups as a loop over independent member modules, each with its
own codebooks and state. Over a `group` mesh axis of W ranks, rank r runs
members [r * g_local, (r + 1) * g_local) (g_local = groups / W) on its
feature slices of the same tokens, with the ordinary member forward, so the
members' kernels launch there as they do in the serial loop. The outputs
are all-gathered over the axis and assembled in group order as the serial
forward assembles them; then every member's state (parameters and buffers,
its random streams' states among them) is broadcast from the rank that ran it, so every rank's module
equals the serial loop's (the JAX package's writeback).

Each member draws from its own random streams, on its owner rank, as it
does in the serial loop, so even a stochastic forward matches the serial
one, and the groups' streams differ (each member's was seeded apart). The
shared quantize-dropout index is drawn once, by every rank alike, from the
first member's stream, as the serial forward draws it.

With `data_axis`, `x` (and `mask`, the indices of the cross-entropy path)
are this rank's shard of the batch; members built with
`sync_axis=data_axis` psum their statistics over it, and the losses come
back averaged over it. The gradient of the output reaches each rank's own
members (their parameters' gradients land on their owner rank) and all of
`x` on every rank.

With `update_state=False` the call leaves every member as it found it (its
parameters, buffers and random streams' states), as the JAX package
discards a non-writeback call's state; only the shared dropout draw, made
before, advances the first member's stream.

Compiled (`compiled=True`, or None with the module on the card), the
members' forwards, the all-gather of their outputs and the losses' pmean
run as one graph (`core.compile.compile_step`), as the JAX package jits its
shard_map; the layout check, the dropout draw, the binding of the mesh and
the write-back stay outside it. The compiled bodies are cached
(`_GP_CACHE`) on the keys the JAX package uses, so a training or serving
loop compiles once; Dynamo's guards on the module stand for JAX's
graphdef.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.compile import cached_body
from . import collectives
from .shard import Mesh, _on_card, _restore_state, _state_copy

# the compiled bodies, FIFO (core.compile.cached_body)
_GP_CACHE: dict = {}


def _layout(gmodule, mesh: Mesh, group_axis: str) -> tuple[int, int]:
    world = mesh.size(group_axis)
    if gmodule.groups % world:
        raise ValueError(f'{gmodule.groups} groups do not split over {world} ranks of {group_axis!r}')
    g_local = gmodule.groups // world
    return g_local, mesh.index(group_axis) * g_local


def _gather_groups(per_member: list, group_axis: str) -> list:
    """This rank's members' tensors -> every group's, in group order."""
    stacked = collectives.all_gather_exact(torch.stack(per_member), group_axis)
    return list(stacked.unbind(0))


@torch.no_grad()
def broadcast_member_state(gmodule, mesh: Mesh, group_axis: str = 'group') -> None:
    """Copy every member's parameters and buffers (its random streams' states
    among them) from the rank that owns it to the other ranks of
    `group_axis`."""
    g_local, _ = _layout(gmodule, mesh, group_axis)
    pg = mesh.group(group_axis)
    for g, member in enumerate(gmodule.rvqs):
        src = dist.get_global_rank(pg, g // g_local)
        seen = set()
        for t in [*member.parameters(), *member.buffers()]:
            if id(t) in seen:
                continue
            seen.add(id(t))
            # flags go as bytes: not every backend broadcasts bool
            buf = t.data.to(torch.uint8) if t.dtype == torch.bool else t.data.contiguous()
            dist.broadcast(buf, src=src, group=pg)
            if buf is not t.data:
                t.data.copy_(buf)


def _body(key: tuple, build, gmodule, compiled: bool | None, backend: str):
    """The body `build()` makes, compiled and cached on `key` and the
    backend when `compiled` (None: when the module is on the card)."""
    if not (_on_card(gmodule) if compiled is None else compiled):
        return build()
    return cached_body(_GP_CACHE, (*key, backend), build, backend)


def _forward_body(first_group: int, g_local: int, group_axis: str, data_axis: str | None, has_loss: bool,
                  return_ce_loss: bool, return_all_codes: bool, fkwargs: dict):
    """f(gmodule, x, indices, mask, dropout_index): this rank's members'
    forwards, their outputs gathered over `group_axis` in group order, the
    losses averaged over `data_axis`; run with the mesh bound."""
    def body(gmodule, x, indices, mask, dropout_index):
        members = gmodule.rvqs
        # each rank's members take the gradient of their own slices; the
        # psum in the backward gives every rank all of x's
        xs = collectives.psum_in_bwd(x, group_axis) if x.requires_grad else x
        chunks = xs.chunk(gmodule.groups, dim=gmodule.split_dim)
        outs = []
        for g in range(first_group, first_group + g_local):
            kwargs = dict(fkwargs)
            if mask is not None:
                kwargs['mask'] = mask
            if return_ce_loss:
                outs.append(members[g](chunks[g], indices=indices[g], **kwargs))
            else:
                outs.append(members[g](chunks[g], return_all_codes=return_all_codes,
                                       rand_quantize_dropout_index=dropout_index, **kwargs))
        fields = [_gather_groups(list(f), group_axis) for f in zip(*outs)]
        if return_ce_loss:
            quantized, ce = fields
            return (torch.cat(quantized, dim=gmodule.split_dim),
                    sum(collectives.pmean(c, data_axis) for c in ce))
        result = [torch.cat(fields[0], dim=gmodule.split_dim), torch.stack(fields[1])]
        if has_loss:
            result.append(collectives.pmean(torch.stack(fields[2]), data_axis))
        if return_all_codes:
            result.append(tuple(fields[-1]))
        return tuple(result)
    return body


def group_parallel_forward(
    gmodule,
    x: torch.Tensor,
    mesh: Mesh,
    *,
    group_axis: str = 'group',
    data_axis: str | None = None,
    indices=None,
    mask: torch.Tensor | None = None,
    return_all_codes: bool = False,
    update_state: bool = True,
    compiled: bool | None = None,
    backend: str = 'inductor',
    **fkwargs,
):
    """`gmodule(x, ...)` with its groups split over `group_axis`: the same
    returns, and (with `update_state`) the same state on every rank
    afterwards; without it, every member's state as before the call (a
    serving loop). Extra `fkwargs` (`sample_codebook_temp`,
    `freeze_codebook`, ...) pass to each member.

    `compiled`: run the members' part as one cached graph
    (`core.compile.compile_step` with `backend`); None compiles when the
    module is on the card and runs eagerly on the CPU. A call whose key
    (the mesh, the axes, the returns asked for, whether a dropout index or
    a mask is given, `fkwargs`) was seen before reuses its graph. Each key's
    body is a code object of its own, whose graphs (one a module class,
    mode and input signature) count apart from other keys' against
    Dynamo's `recompile_limit`."""
    g_local, first_group = _layout(gmodule, mesh, group_axis)
    if x.shape[gmodule.split_dim] != gmodule.dim:
        raise ValueError(f'expected dim {gmodule.dim} on axis {gmodule.split_dim}, got {tuple(x.shape)}')
    members = list(gmodule.rvqs)
    # GroupedResidualFSQ's members return no loss
    has_loss = type(gmodule).__name__ != 'GroupedResidualFSQ'
    return_ce_loss = indices is not None and len(indices) > 0
    if return_ce_loss and len(indices) != gmodule.groups:
        raise ValueError(f'{len(indices)} index groups for {gmodule.groups} groups')

    dropout_index = None
    if gmodule.training and getattr(members[0], 'quantize_dropout', False) and not return_ce_loss:
        dropout_index = members[0].draw_dropout_index()
    # after the shared draw, whose advance stays, as in the JAX package
    saved = None if update_state else _state_copy(gmodule.rvqs)

    fkey = tuple(sorted(fkwargs.items()))
    key = ('fwd', mesh, group_axis, data_axis, g_local, has_loss, return_ce_loss, return_all_codes,
           dropout_index is not None, mask is not None, fkey)
    body = _body(key, lambda: _forward_body(first_group, g_local, group_axis, data_axis, has_loss, return_ce_loss,
                                            return_all_codes, fkwargs),
                 gmodule, compiled, backend)
    try:
        with mesh:
            result = body(gmodule, x, indices if return_ce_loss else None, mask, dropout_index)
    finally:
        if saved is not None:
            _restore_state(saved)
    if update_state:
        broadcast_member_state(gmodule, mesh, group_axis)
    return result


def group_parallel_output_from_indices(
    gmodule,
    indices,
    mesh: Mesh,
    *,
    group_axis: str = 'group',
    data_axis: str | None = None,
    compiled: bool | None = None,
    backend: str = 'inductor',
) -> torch.Tensor:
    """`gmodule.get_output_from_indices(indices)` with the groups split over
    `group_axis`: each rank decodes its members' codes and the outputs are
    all-gathered in group order. `indices`: the per-group index tensors, as
    the serial method takes them (this rank's batch shard with
    `data_axis`). `compiled` as `group_parallel_forward`'s."""
    g_local, first_group = _layout(gmodule, mesh, group_axis)

    def build():
        def body(gmodule, indices):
            members = gmodule.rvqs
            outs = [members[g].get_output_from_indices(indices[g]) for g in range(first_group, first_group + g_local)]
            return torch.cat(_gather_groups(outs, group_axis), dim=gmodule.split_dim)
        return body

    body = _body(('decode', mesh, group_axis, data_axis, g_local), build, gmodule, compiled, backend)
    with mesh:
        return body(gmodule, indices)
