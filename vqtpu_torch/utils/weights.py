"""Carry a vqtpu (JAX) model's state into the matching vqtpu_torch module.

`state` is the JAX model's state as a nested dict of numpy arrays, in the
form `nnx.to_pure_dict(nnx.state(model))` gives once each leaf is a numpy
array. Keys follow the module tree; the port uses the JAX package's
attribute names, so the trees line up. Layouts converted:

  - nnx.Linear kernel (in, out)       -> nn.Linear weight (out, in)
    (SimVQ's code_transform, FSP's and LatentQuantize's projections)
  - a leaf class's own `flax_leaf_rules` (below), such as the
    MultiHeadAttention kernels of models.transformer's HeadsIn / HeadsOut
  - nnx.Conv kernel (H, W, I, O)      -> nn.Conv2d weight (O, I, H, W)
    (HierarchicalVQ's Phi convolutions among them)
  - nnx.LayerNorm scale               -> nn.LayerNorm weight
  - codebook buffers, LFQ's orthogonal_rot, CosineSimLinear's
    (in, out) weight, SimVQ's frozen_codebook, the
    RandomProjectionQuantizer's rand_projs, LatentQuantize's
    values_per_latent (an nnx.List of per-dimension values, an
    nn.ParameterList here)            -> copied as they are
  - the integer keys of an nnx.List   -> the nn.ModuleList children '0', '1', ...

A `rngs` entry (flax's RNG streams) seeds the port's random streams
instead of loading as a tensor: every module's stream state (the buffer
`rng_state`, core.sampling) becomes the key of the nearest stream at or
above the module's path in the state (its 'default' stream, else its
first; the state's first stream where none is above), folded with the
module's path (threefry-2x32 of the key on the path's CRC-32), and that
stream's count. So a module loaded from a JAX state draws the same on
every load and in every process, and a state without `rngs` leaves the
streams as they were. The two frameworks' streams still draw different
numbers. So are VectorQuantize's and LatentQuantize's
`in_place_codebook_optimizer` (optax's state) and `_pending_inner_grads`
as long as every leaf under them is 0, the state before the first
in-place step: the port's inner optimizer starts
fresh and cannot take optax's state, so a state past that step raises.
Any other key the module does not have, and any parameter or persistent
buffer the state does not give, raises KeyError. A submodule
may be missing from the state when every parameter and persistent buffer
under it was filled under another path, or when it holds none: flax stores
a module that two parents share (a ResidualVQ's shared codebook) once,
under its first path, and leaves out a module whose only state is an RNG
stream it shares with another.
"""

from __future__ import annotations

import zlib
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ..core.sampling import STATE_BUFFER, threefry2x32

# keys of optimizer state the port does not carry; they load only while
# every leaf under them is 0
_FRESH_ONLY = ('in_place_codebook_optimizer', '_pending_inner_grads')

# JAX leaf name -> (torch name, layout conversion) for the leaf modules; a
# module class of the port with a layout of its own declares it as the class
# attribute `flax_leaf_rules`, in the same form
_LEAF_RULES = {
    nn.Linear: {'kernel': ('weight', lambda a: a.T), 'bias': ('bias', None)},
    nn.Conv2d: {
        'kernel': ('weight', lambda a: a.transpose(3, 2, 0, 1)),
        'bias': ('bias', None),
    },
    nn.LayerNorm: {'scale': ('weight', None), 'bias': ('bias', None)},
}


def leaf_rules(module: nn.Module) -> dict | None:
    """The layout rules of a leaf module ({JAX leaf name: (torch name,
    conversion)}), or None for a module whose children and tensors keep
    their names."""
    return getattr(type(module), 'flax_leaf_rules', None) or _LEAF_RULES.get(type(module))


def _all_zero(value) -> bool:
    if isinstance(value, Mapping):
        return all(_all_zero(v) for v in value.values())
    return not np.any(np.asarray(value))


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
               if any(id(t) not in filled for key, t in child.state_dict(keep_vars=True).items()
                      if key.rpartition('.')[2] != STATE_BUFFER)]
    if missing:
        raise KeyError(f'state gives no value for {", ".join(missing)}')
    _seed_streams(module, list(_rng_streams(state)))
    # a loaded `initted` may be False: each codebook's next forward reads it
    for m in module.modules():
        if hasattr(m, 'initted_on_host'):
            m.initted_on_host = False


def _rng_streams(state: Mapping, path: str = ''):
    """(path of the module that holds it, key (2,) uint32, count) of every
    flax RNG stream entry in `state`, in the state's order."""
    for key, value in state.items():
        if not isinstance(value, Mapping):
            continue
        if str(key) == 'rngs':
            streams = value.get('default') or next((v for v in value.values() if isinstance(v, Mapping)), None)
            if streams is not None and 'key' in streams and 'count' in streams:
                yield path, np.asarray(streams['key']).reshape(-1)[-2:], int(np.asarray(streams['count']))
        else:
            yield from _rng_streams(value, f'{path}{key}.')


def _seed_streams(module: nn.Module, streams: list) -> None:
    """Seed each module's `rng_state` from the nearest JAX stream (see the
    module doc)."""
    if not streams:
        return
    for path, m in module.named_modules():
        state = m._buffers.get(STATE_BUFFER)
        if state is None:
            continue
        above = [s for s in streams if f'{path}.'.startswith(s[0])]
        where, key, count = max(above, key=lambda s: len(s[0])) if above else streams[0]
        k0, k1 = (torch.tensor(int(k)) for k in key)
        y0, y1 = threefry2x32(k0, k1, torch.tensor(zlib.crc32(path.encode())), torch.tensor(0))
        with torch.no_grad():
            state.copy_(torch.stack((y0, y1, torch.tensor(count))))


def _load(module: nn.Module, state: Mapping, prefix: str, filled: set[int],
          absent: list[tuple[str, nn.Module]]) -> None:
    """Fill `module` from `state`, adding the id of every tensor it fills to
    `filled` and every child the state leaves out to `absent`."""
    rules = leaf_rules(module)
    tensors = dict(module.named_parameters(recurse=False))
    tensors.update((name, t) for name, t in module.named_buffers(recurse=False)
                   if name not in module._non_persistent_buffers_set and name != STATE_BUFFER)
    children = dict(module.named_children())
    given = set()

    for key, value in state.items():
        key = str(key)                       # nnx.List children are keyed 0, 1, ...
        path = prefix + key
        if key == 'rngs':
            continue
        if key in _FRESH_ONLY:
            if not _all_zero(value):
                raise ValueError(f'{path}: the in-place optimizer state is past its first step, '
                                 'and the port does not carry it')
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
