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
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import collectives
from .shard import Mesh


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
    **fkwargs,
):
    """`gmodule(x, ...)` with its groups split over `group_axis`: the same
    returns, and (with `update_state`) the same state on every rank
    afterwards. Extra `fkwargs` (`sample_codebook_temp`,
    `freeze_codebook`, ...) pass to each member."""
    g_local, first_group = _layout(gmodule, mesh, group_axis)
    split_dim = gmodule.split_dim
    if x.shape[split_dim] != gmodule.dim:
        raise ValueError(f'expected dim {gmodule.dim} on axis {split_dim}, got {tuple(x.shape)}')
    members = list(gmodule.rvqs)
    # GroupedResidualFSQ's members return no loss
    has_loss = type(gmodule).__name__ != 'GroupedResidualFSQ'
    return_ce_loss = indices is not None and len(indices) > 0
    if return_ce_loss and len(indices) != gmodule.groups:
        raise ValueError(f'{len(indices)} index groups for {gmodule.groups} groups')

    dropout_index = None
    if gmodule.training and getattr(members[0], 'quantize_dropout', False) and not return_ce_loss:
        dropout_index = members[0].draw_dropout_index()

    with mesh:
        # each rank's members take the gradient of their own slices; the
        # psum in the backward gives every rank all of x's
        xs = collectives.psum_in_bwd(x, group_axis) if x.requires_grad else x
        chunks = xs.chunk(gmodule.groups, dim=split_dim)
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
            result = (torch.cat(quantized, dim=split_dim),
                      sum(collectives.pmean(c, data_axis) for c in ce))
        else:
            quantized, all_indices, *rest = fields
            result = [torch.cat(quantized, dim=split_dim), torch.stack(all_indices)]
            if has_loss:
                result.append(collectives.pmean(torch.stack(rest.pop(0)), data_axis))
            if return_all_codes:
                result.append(tuple(rest.pop(0)))
            result = tuple(result)
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
) -> torch.Tensor:
    """`gmodule.get_output_from_indices(indices)` with the groups split over
    `group_axis`: each rank decodes its members' codes and the outputs are
    all-gathered in group order. `indices`: the per-group index tensors, as
    the serial method takes them (this rank's batch shard with
    `data_axis`)."""
    g_local, first_group = _layout(gmodule, mesh, group_axis)
    members = list(gmodule.rvqs)
    with mesh:
        outs = [members[g].get_output_from_indices(indices[g]) for g in range(first_group, first_group + g_local)]
        return torch.cat(_gather_groups(outs, group_axis), dim=gmodule.split_dim)
