"""Carry a vqtpu (JAX) model's state into the matching vqtpu_torch module.

`state` is the JAX model's state as a nested dict of numpy arrays, in the
form `nnx.to_pure_dict(nnx.state(model))` gives once each leaf is a numpy
array. Keys follow the module tree; the port uses the JAX package's
attribute names, so the trees line up. Layouts converted:

  - nnx.Linear kernel (in, out)       -> nn.Linear weight (out, in)
  - nnx.Conv kernel (H, W, I, O)      -> nn.Conv2d weight (O, I, H, W)
  - nnx.LayerNorm scale               -> nn.LayerNorm weight
  - codebook buffers, LFQ's orthogonal_rot, CosineSimLinear's
    (in, out) weight                  -> copied as they are
  - the integer keys of an nnx.List   -> the nn.ModuleList children '0', '1', ...

A `rngs` entry (flax's RNG streams) has no torch counterpart and is
skipped. Any other key the module does not have, and any parameter or
persistent buffer the state does not give, raises KeyError. A submodule
may be missing from the state when every parameter and persistent buffer
under it was filled under another path, or when it holds none: flax stores
a module that two parents share (a ResidualVQ's shared codebook) once,
under its first path, and leaves out a module whose only state is an RNG
stream it shares with another.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

# JAX leaf name -> (torch name, layout conversion) for the leaf modules
_LEAF_RULES = {
    nn.Linear: {'kernel': ('weight', lambda a: a.T), 'bias': ('bias', None)},
    nn.Conv2d: {
        'kernel': ('weight', lambda a: a.transpose(3, 2, 0, 1)),
        'bias': ('bias', None),
    },
    nn.LayerNorm: {'scale': ('weight', None), 'bias': ('bias', None)},
}


def _copy(target: torch.Tensor, value, key: str) -> None:
    value = torch.from_numpy(np.array(value))
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(
            f'{key}: state has shape {tuple(value.shape)}, module {tuple(target.shape)}'
        )
    with torch.no_grad():
        target.copy_(value)


def load_vqtpu_state(module: nn.Module, state: Mapping, prefix: str = '') -> None:
    """Fill `module` in place from the JAX model's state (see module doc)."""
    filled: set[int] = set()
    absent: list[tuple[str, nn.Module]] = []
    _load(module, state, prefix, filled, absent)
    missing = [path for path, child in absent
               if any(id(t) not in filled for t in child.state_dict(keep_vars=True).values())]
    if missing:
        raise KeyError(f'state gives no value for {", ".join(missing)}')


def _load(module: nn.Module, state: Mapping, prefix: str, filled: set[int],
          absent: list[tuple[str, nn.Module]]) -> None:
    """Fill `module` from `state`, adding the id of every tensor it fills to
    `filled` and every child the state leaves out to `absent`."""
    rules = _LEAF_RULES.get(type(module))
    tensors = dict(module.named_parameters(recurse=False))
    tensors.update((name, t) for name, t in module.named_buffers(recurse=False)
                   if name not in module._non_persistent_buffers_set)
    children = dict(module.named_children())
    given = set()

    for key, value in state.items():
        key = str(key)                       # nnx.List children are keyed 0, 1, ...
        path = prefix + key
        if key == 'rngs':
            continue
        if rules is not None and key in rules:
            name, convert = rules[key]
            value = np.asarray(value)
            _copy(tensors[name], convert(value) if convert else value, path)
        elif rules is None and key in tensors:
            name = key
            _copy(tensors[name], value, path)
        elif rules is None and key in children:
            if not isinstance(value, Mapping):
                raise KeyError(f'{path}: state holds an array where the module has a submodule')
            _load(children[key], value, path + '.', filled, absent)
            given.add(key)
            continue
        else:
            raise KeyError(f'{path}: no such parameter, buffer or submodule in the torch module')
        filled.add(id(tensors[name]))
        given.add(name)

    missing = sorted(set(tensors) - given)
    if missing:
        raise KeyError(f'state gives no value for {", ".join(prefix + m for m in missing)}')
    if rules is None:
        absent.extend((prefix + name, child) for name, child in children.items() if name not in given)
