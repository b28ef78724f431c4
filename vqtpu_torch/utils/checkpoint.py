"""Checkpoint and resume of quantizer and model state (counterpart of
vqtpu/utils/checkpoint.py).

  - `state_dict(module)` / `load_state_dict(module, d)`: an in-process
    snapshot, the module's own `state_dict()` with every tensor copied, and
    its strict inverse;
  - `save_checkpoint(path, module)` / `restore_checkpoint(path, module)`:
    the same snapshot on disk, `torch.save` and `torch.load(weights_only=True)`
    (tensors only: loading a checkpoint runs no code).

What is PERSISTENT and what is DERIVED (the reference's buffer persistence,
vector_quantize_pytorch.py:415-448, as the JAX package keeps it):

  persistent: the Codebook's embed, embed_avg, cluster_size, initted,
              accum_cluster_size, accum_embed_avg, and the affine batch and
              codebook means and variances with their *_initted flags;
              every parameter (projections, SimVQ's transform,
              LatentQuantize's values, QINCo's MLPs, HierarchicalVQ's Phi
              convolutions); SimVQ's frozen codebook, the
              RandomProjectionQuantizer's projections, LFQ's and FSQ's
              orthogonal rotations; every random stream's `rng_state`.
  derived (made again at construction, never checkpointed): FSQ's levels
              and mixed-radix basis, LFQ's bit mask, ResidualFSQ's scales
              (buffers registered with persistent=False), LFQ's implicit
              codebook and FSQ's (computed from them when asked for).

A module's random stream (`module.generator`, core.sampling.RandomStream)
keeps its key and counter in the buffer `rng_state`, so a snapshot holds
them and a restored module draws on from where the saved one was (the JAX
package persists no RNG state: there a fresh module brings its own).

Row-sharded codebooks (`code_axis`, parallel.tp): given the mesh, a sharded
module's snapshot gathers every codebook over its code axis (every rank
calls it), so a checkpoint always holds the full codebook, as the JAX
package's state_dict of a sharded module does; `save_checkpoint` writes it
from rank 0 alone, and it restores into a module at rest.
"""

from __future__ import annotations

import os

import torch
from torch import nn

DERIVED_STATE_DOC = __doc__


def state_dict(module: nn.Module, mesh=None) -> dict:
    """{name: tensor} of every parameter and persistent buffer of `module`,
    copied (a later step does not change the snapshot); with `mesh`, a
    row-sharded module's codebooks gathered to their full rows."""
    if mesh is not None:
        from ..parallel.tp import gathered_state_dict
        return gathered_state_dict(module, mesh)
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def load_state_dict(module: nn.Module, d: dict) -> nn.Module:
    """Write a `state_dict` snapshot back into `module` in place; every key
    must match (strict)."""
    module.load_state_dict(d, strict=True)
    return module


def save_checkpoint(path: str | os.PathLike, module: nn.Module, mesh=None) -> None:
    """Persist `module`'s state to the file `path`. With `mesh` (every rank
    calls it), the state of a row-sharded module gathered to its full
    codebooks, written by rank 0 alone; the ranks wait for the file."""
    snapshot = state_dict(module, mesh)
    if mesh is None:
        torch.save(snapshot, os.fspath(path))
        return
    import torch.distributed as dist
    if dist.get_rank() == 0:
        torch.save(snapshot, os.fspath(path))
    dist.barrier()


def restore_checkpoint(path: str | os.PathLike, module: nn.Module) -> nn.Module:
    """Restore the state saved by `save_checkpoint` into `module` in place.
    `module` is constructed with the same configuration; each tensor lands
    on the device of the module's own."""
    load_state_dict(module, torch.load(os.fspath(path), map_location='cpu', weights_only=True))
    return module
