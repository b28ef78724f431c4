"""Row-sharded (tensor-parallel) codebooks over torch.distributed: which
leaves shard, sharding and gathering them, the trainer and `tp_apply`
(counterpart of vqtpu/parallel/tp.py).

In the JAX package a `code_axis` module holds the full codebook at rest and
sees its rows inside a shard_map that binds the axis. In processes:

  - at rest (construction, `load_vqtpu_state`, checkpoints, decode outside
    a mesh) the module holds the full codebook;
  - `shard_codebooks(model, mesh)` narrows every declared per-code leaf to
    the rank's rows, as a copy that frees the full tensor (a Parameter's
    `.data` is replaced, so the object an optimizer holds stays the same);
    `gather_codebooks` all-gathers them back;
  - inside a bound mesh that has the axis, each module works on its rows
    with collectives over the axis; a leaf whose row count is not
    codebook_size / axis size raises (so does a sharded leaf outside one).

A module takes part by declaring `code_axis` (a string) and
`_code_sharded_leaves`, {leaf name: position of the code-row dim from the
end}: Codebook its EMA state, SimVQ its frozen codebook. A replicated
submodule that sees only its shard's rows in the forward (SimVQ's
transform, QINCo's MLPs) is declared in `_code_partial_grad_submodules`:
its gradients are partial per shard and psum over the code axis
(`psum_partial_grads`, which TensorParallelTrainer calls).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..core.compile import cached_body, compile_step
from ..core.optim import optimizer_update
from . import collectives
from .shard import Mesh, _graph_params, _on_card, _pmean_flat, _restore_state, _state_copy, average_gradients


def _declares(module) -> bool:
    return (isinstance(getattr(module, 'code_axis', None), str)
            and isinstance(getattr(module, '_code_sharded_leaves', None), dict))


def find_sharded_codebooks(model: nn.Module) -> list:
    """[(name, module)] of the submodules that declare code sharding."""
    return [(name, m) for name, m in model.named_modules() if _declares(m)]


def _declared_keys(model: nn.Module):
    """(state_dict key, code-row position from the end, code axis) of every
    per-code leaf; a module shared by several parents under each of its
    names, as in the state_dict."""
    for name, m in model.named_modules(remove_duplicate=False):
        if _declares(m):
            for leaf, pos in m._code_sharded_leaves.items():
                if getattr(m, leaf, None) is not None:
                    yield (f'{name}.{leaf}' if name else leaf), pos, m.code_axis


def codebook_pspecs(model: nn.Module) -> dict:
    """{state_dict key: position of the code-row dim from the end} of every
    per-code leaf of `model`, the counterpart of the JAX package's
    PartitionSpec tree (every other key is replicated)."""
    return {key: pos for key, pos, _ in _declared_keys(model)}


def codebook_axes(model: nn.Module) -> dict:
    """{state_dict key: the code axis its rows shard over} of every per-code
    leaf of `model`."""
    return {key: axis for key, _, axis in _declared_keys(model)}


def find_code_partial_grad_paths(model: nn.Module) -> list:
    """[(submodule name, code axis)] of the replicated submodules whose
    parameter gradients are partial per code shard."""
    out = []
    for name, m in model.named_modules():
        subs = getattr(m, '_code_partial_grad_submodules', None)
        axis = getattr(m, 'code_axis', None)
        if isinstance(subs, (tuple, list)) and isinstance(axis, str):
            out += [(f'{name}.{s}' if name else s, axis) for s in subs if getattr(m, s, None) is not None]
    return out


@torch.no_grad()
def psum_partial_grads(model: nn.Module, partial_paths: list | None = None) -> None:
    """psum, over its code axis, the gradient of every parameter under the
    declared partial-gradient submodules (a parameter without a gradient
    counts a zero one); the identity for every other parameter. Call it
    with the mesh bound, after the backward."""
    partial_paths = find_code_partial_grad_paths(model) if partial_paths is None else partial_paths
    seen = set()
    for path, axis in partial_paths:
        params = [p for p in model.get_submodule(path).parameters() if p.requires_grad and id(p) not in seen]
        seen.update(id(p) for p in params)
        average_gradients(params, axis, collectives.psum)


def _leaves(model: nn.Module):
    """(module, leaf name, tensor, code-row dim) of every declared leaf,
    each tensor once."""
    seen = set()
    for _, m in find_sharded_codebooks(model):
        for leaf, pos in m._code_sharded_leaves.items():
            t = getattr(m, leaf, None)
            if t is None or id(t) in seen:
                continue
            seen.add(id(t))
            yield m, leaf, t, t.ndim - pos


def is_sharded(model: nn.Module) -> bool:
    """Whether the declared leaves hold a rank's rows (not the full
    codebook)."""
    return any(t.shape[dim] != m.codebook_size for m, _, t, dim in _leaves(model))


def check_code_rows(module: nn.Module, rows: int) -> bool:
    """Whether `module` (a declaring module) works on a row shard: True
    inside a bound mesh that has its code axis, False outside. Raises when
    `rows`, the row count of its leaves, is not what that needs:
    codebook_size / axis size inside, codebook_size outside."""
    axis = getattr(module, 'code_axis', None)
    bound = collectives.axis_is_bound(axis)
    want = module.codebook_size // collectives.axis_size(axis) if bound else module.codebook_size
    if rows != want:
        where = f"inside a mesh binding {axis!r}" if bound else 'outside a mesh binding its code axis'
        raise ValueError(
            f'{type(module).__name__} holds {rows} codebook rows {where}, where it needs {want}: shard the '
            'codebooks for the mesh (parallel.shard_codebooks, TensorParallelTrainer, tp_apply) and gather '
            'them back (parallel.gather_codebooks) before using the module at rest')
    return bound


@torch.no_grad()
def shard_codebooks(model: nn.Module, mesh: Mesh, optimizer: torch.optim.Optimizer | None = None) -> nn.Module:
    """Narrow every declared leaf of `model` to this rank's rows of `mesh`'s
    code axis, in place. Refuses an optimizer that already holds state (its
    moments would keep the full rows)."""
    if optimizer is not None and len(optimizer.state):
        raise ValueError('shard the codebooks before the optimizer takes its first step: '
                         'its state holds the full rows')
    for m, _, t, dim in list(_leaves(model)):
        world, index = mesh.size(m.code_axis), mesh.index(m.code_axis)
        if t.shape[dim] != m.codebook_size:
            raise ValueError(f'{type(m).__name__} is sharded already')
        if m.codebook_size % world:
            raise ValueError(f'codebook_size {m.codebook_size} does not split over {world} ranks')
        c_local = m.codebook_size // world
        t.data = t.data.narrow(dim, index * c_local, c_local).clone()
        if hasattr(m, 'rewritten_rows'):
            m.rewritten_rows = None
    return model


@torch.no_grad()
def gather_codebooks(model: nn.Module, mesh: Mesh) -> nn.Module:
    """The inverse of `shard_codebooks`: every declared leaf all-gathered
    over its code axis back to the full codebook, in place. Every rank of
    the axis calls it."""
    with mesh:
        for m, _, t, dim in list(_leaves(model)):
            if t.shape[dim] == m.codebook_size:
                raise ValueError(f'{type(m).__name__} holds its full codebook already')
            t.data = collectives.all_gather_exact(t.data.contiguous(), m.code_axis, concat_axis=dim)
            if hasattr(m, 'rewritten_rows'):
                m.rewritten_rows = None
    return model


def gathered_state_dict(model: nn.Module, mesh: Mesh) -> dict:
    """`model`'s state_dict with its codebooks gathered to full rows
    (copies; the model stays as it is). Every rank of the code axes calls
    it."""
    if not is_sharded(model):
        return {k: v.detach().clone() for k, v in model.state_dict().items()}
    specs, axes = codebook_pspecs(model), codebook_axes(model)
    out = {}
    with mesh, torch.no_grad():
        for k, v in model.state_dict().items():
            if k in specs:
                out[k] = collectives.all_gather_exact(v.detach().contiguous(), axes[k],
                                                      concat_axis=v.ndim - specs[k])
            else:
                out[k] = v.detach().clone()
    return out


class TensorParallelTrainer:
    """Training of a model whose codebooks take `code_axis` (and, for data
    parallelism, `sync_axis=data_axis`) over a mesh with a code axis and
    optionally a data axis. The constructor shards the codebooks; each rank
    then runs `step` on its shard of the global batch (the same shard on
    the ranks of a code group). A step binds the mesh, averages every
    trainable parameter's gradient over `data_axis` (pmean), psums the
    declared partial gradients over the code axis, steps the optimizer and
    returns the loss averaged over `data_axis`, as the JAX package's
    shard_map body does.

    `compiled`: run the step compiled whole, as the JAX package jits its
    shard_map'd step (`core.compile.compile_step` with `backend`: one
    graph, or an error): the loss, `torch.autograd.grad` over the trainable
    parameters (a codebook's rows are the rank's), one pmean of the
    flattened gradients over `data_axis`, one psum of the flattened
    partial gradients over their code axis, the optimizer's functional
    update (`core.optim.optimizer_update`) and the pmean of the loss, the
    collectives inside the graph. None compiles when the model is on the
    card and runs eagerly on the CPU. As `parallel.DataParallelTrainer`'s,
    the compiled step leaves the parameters' `.grad` alone, and a codebook
    with kmeans init compiles twice.

    Usage:
        mesh = make_mesh(('data', 'code'), shape=(2, 4))
        trainer = TensorParallelTrainer(model, torch.optim.Adam(model.parameters(), 1e-3), loss_fn, mesh,
                                        compiled=None)      # compiled on the card, eager on the CPU
        loss = trainer.step(global_batch(mesh, ('data',), batch))

    `gather_codebooks(model, mesh)` (or `utils.checkpoint.save_checkpoint`
    with the mesh) brings the full codebooks back for a checkpoint.
    """

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer, loss_fn: Callable, mesh: Mesh,
                 data_axis: str | None = 'data', *, compiled: bool | None = None, backend: str = 'inductor'):
        if data_axis is not None and data_axis not in mesh.axis_names:
            raise ValueError(f'data axis {data_axis!r} is not an axis of {mesh}')
        for _, m in find_sharded_codebooks(model):
            if m.code_axis not in mesh.axis_names:
                raise ValueError(f'code axis {m.code_axis!r} is not an axis of {mesh}')
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.data_axis = data_axis
        shard_codebooks(model, mesh, optimizer)
        self._partial_grad_paths = find_code_partial_grad_paths(model)
        self.compiled = _on_card(model) if compiled is None else bool(compiled)
        self._graph_step = None
        if self.compiled:
            # after the sharding: the graph traces the rank's rows, and a
            # learnable codebook's Adam state holds them
            self._params, self._slots = _graph_params(model, optimizer)
            at = {id(p): i for i, p in enumerate(self._params)}
            # {code axis: the positions among the parameters of those whose
            # gradients are partial per code shard}, each parameter once
            self._partial_at, seen = {}, set()
            for path, axis in self._partial_grad_paths:
                for p in model.get_submodule(path).parameters():
                    if id(p) in at and id(p) not in seen:
                        seen.add(id(p))
                        self._partial_at.setdefault(axis, []).append(at[id(p)])
            self._graph_step = compile_step(self._step_body, backend=backend)

    def step(self, batch) -> torch.Tensor:
        """One optimizer step on this rank's shard `batch`; returns the mean
        loss over the data axis (detached)."""
        with self.mesh:
            if self._graph_step is not None:
                return self._graph_step(batch)
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.loss_fn(self.model, batch)
            loss.backward()
            with torch.no_grad():
                if self.data_axis is not None:
                    average_gradients([p for p in self.model.parameters() if p.requires_grad], self.data_axis)
                psum_partial_grads(self.model, self._partial_grad_paths)
            self.optimizer.step()
            return collectives.pmean(loss.detach(), self.data_axis)

    def _step_body(self, batch) -> torch.Tensor:
        """The compiled step: the gradients as the eager step reduces them
        (the pmean over the data axis first, then the partial gradients'
        psum, as in JAX), handed to the optimizer's update in its
        parameters' order."""
        params, grads = self._params, []
        loss = self.loss_fn(self.model, batch)
        if params:
            raw = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, raw)]
            if self.data_axis is not None:
                grads = _pmean_flat(grads, self.data_axis)
            for axis, at in self._partial_at.items():
                for i, g in zip(at, _pmean_flat([grads[i] for i in at], axis, collectives.psum)):
                    grads[i] = g
        # without foreach, as DataParallelTrainer's compiled step updates
        optimizer_update(self.optimizer, [None if i is None else grads[i] for i in self._slots], foreach=False)
        return collectives.pmean(loss.detach(), self.data_axis)


# the compiled bodies of tp_apply, FIFO (core.compile.cached_body)
_TP_APPLY_CACHE: dict = {}


def _apply_body(fn: Callable) -> Callable:
    """fn(model, *args), as a function that `cached_body` gives a code
    object of its own (`fn` may be any callable)."""
    def tp_apply_body(model, *args):
        return fn(model, *args)
    return tp_apply_body


def tp_apply(model: nn.Module, mesh: Mesh, fn: Callable, *args, mutates_state: bool = False,
             compiled: bool | None = None, backend: str = 'inductor'):
    """`fn(model, *args)` with `mesh` bound and the model's codebooks
    sharded (an eval forward, or `get_output_from_indices` against sharded
    rows). A model at rest is sharded for the call. With `mutates_state`
    the state the call leaves (EMA statistics, expired codes) is kept, and
    a model that was at rest is gathered back to full rows; without it the
    model's parameters and buffers (its random streams' states among them)
    are restored after the call, as the JAX package discards a non-mutating
    call's state.

    `compiled`: run `fn(model, *args)` as one graph
    (`core.compile.compile_step` with `backend`), as the JAX package jits
    its shard_map, with the sharded selection's winner reduction, the
    statistics' psums and the decode's row psum inside it; the sharding,
    the binding of the mesh, the restore and the gather back stay outside.
    None compiles when the model is on the card and runs eagerly on the
    CPU. The compiled body is cached on (fn, mesh, mutates_state, backend),
    and Dynamo's guards on the model stand for JAX's graphdef, so a loop
    that passes the same `fn` (a module-level function or a
    functools.partial of one) compiles once; a fresh lambda a call
    compiles a call. Each key's body is a code object of its own, whose
    graphs count apart from other keys' against Dynamo's
    `recompile_limit`."""
    run = fn
    if _on_card(model) if compiled is None else compiled:
        run = cached_body(_TP_APPLY_CACHE, (fn, mesh, mutates_state, backend), lambda: _apply_body(fn), backend)
    at_rest = not is_sharded(model)
    saved = None
    if not mutates_state:
        # a model at rest gets its full rows back
        saved = _state_copy(model, {id(t): t.data for _, _, t, _ in _leaves(model)} if at_rest else None)
    if at_rest:
        shard_codebooks(model, mesh)
    try:
        with mesh:
            return run(model, *args)
    finally:
        if mutates_state:
            if at_rest:
                gather_codebooks(model, mesh)
        else:
            _restore_state(saved)
            for m, _, _, _ in _leaves(model):
                if hasattr(m, 'rewritten_rows'):
                    m.rewritten_rows = None
