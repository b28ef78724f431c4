"""Import trained upstream (lucidrains/vector-quantize-pytorch) checkpoints
(counterpart of vqtpu/utils/torch_import.py).

`import_torch_state(module, torch_state)` writes an upstream `state_dict()`
(torch tensors or numpy arrays) into the equivalent port module in place.
Both are PyTorch, so Linear and Conv2d weights keep their layout and the
work is a map of keys onto the port's attribute names:

  - VectorQuantize: `_codebook.{embed, embed_avg, cluster_size, initted}`
    (and the affine means and variances), `project_in` (a Linear, or
    `project_in.0` / `project_in.1` for Linear then LayerNorm) ->
    `project_in_linear` / `project_in_norm`, `project_out` ->
    `project_out_linear`;
  - ResidualVQ, ResidualSimVQ, ResidualFSQ, ResidualLFQ: `layers.{i}.`
    into each layer, their projections, ResidualVQ's QINCo MLPs
    (`mlps.{i}.layers.{j}.0` / `.2` -> `lin1` / `lin2`);
  - the grouped ones: `rvqs.{g}.` into each group;
  - SimVQ: `frozen_codebook` and `code_transform`;
  - LatentQuantize: `values_per_latent.{i}` and its projections;
  - RandomProjectionQuantizer: `rand_projs` and `vq.`;
  - HierarchicalVQ: `vq.` and the smoothers, `phi_shared.conv` (one shared)
    or `phi_levels.{i}.conv`;
  - FSQ, FSP, LFQ, BinaryMapper: only their projections hold parameters.
    LFQ's `CosineSimLinear` keeps the JAX package's (in, out) weight, which
    the JAX import takes as the upstream weight transposed; so does this.

Any other module raises NotImplementedError by name, as the JAX function
does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _set(target: torch.Tensor, value):
    value = torch.as_tensor(np.asarray(value) if not isinstance(value, torch.Tensor) else value)
    if tuple(target.shape) != tuple(value.shape):
        raise ValueError(f'shape mismatch: {tuple(target.shape)} vs {tuple(value.shape)}')
    with torch.no_grad():
        target.copy_(value.to(dtype=target.dtype, device=target.device))


def _linear(torch_state, prefix, lin: nn.Linear):
    _set(lin.weight, torch_state[f'{prefix}.weight'])
    if f'{prefix}.bias' in torch_state and lin.bias is not None:
        _set(lin.bias, torch_state[f'{prefix}.bias'])


def _conv2d(torch_state, prefix, conv: nn.Conv2d):
    _set(conv.weight, torch_state[f'{prefix}.weight'])
    if f'{prefix}.bias' in torch_state:
        _set(conv.bias, torch_state[f'{prefix}.bias'])


def _sub(torch_state, prefix):
    return {k[len(prefix):]: v for k, v in torch_state.items() if k.startswith(prefix)}


def _codebook(torch_state, prefix, cb):
    _set(cb.embed, torch_state[f'{prefix}.embed'])
    for name in ('embed_avg', 'cluster_size'):
        if f'{prefix}.{name}' in torch_state:
            _set(getattr(cb, name), torch_state[f'{prefix}.{name}'])
    if f'{prefix}.initted' in torch_state:
        cb.initted.fill_(bool(np.asarray(torch_state[f'{prefix}.initted'])))
        cb.initted_on_host = False
    for stat in ('batch_mean', 'batch_variance', 'codebook_mean', 'codebook_variance'):
        key = f'{prefix}.{stat}'
        if key in torch_state and hasattr(cb, stat):
            _set(getattr(cb, stat), torch_state[key])


def _vq(torch_state, vq):
    _codebook(torch_state, '_codebook', vq._codebook)
    if not vq.has_projections:
        return
    if 'project_in.weight' in torch_state:
        _linear(torch_state, 'project_in', vq.project_in_linear)
    elif 'project_in.0.weight' in torch_state:
        _linear(torch_state, 'project_in.0', vq.project_in_linear)
        if 'project_in.1.weight' in torch_state and vq.project_in_norm is not None:
            _set(vq.project_in_norm.weight, torch_state['project_in.1.weight'])
            _set(vq.project_in_norm.bias, torch_state['project_in.1.bias'])
    if 'project_out.weight' in torch_state:
        _linear(torch_state, 'project_out', vq.project_out_linear)


def _projections(torch_state, module):
    for name in ('project_in', 'project_out'):
        target = getattr(module, name, None)
        if f'{name}.weight' not in torch_state or target is None:
            continue
        if isinstance(target, nn.Linear):
            _linear(torch_state, name, target)
        else:                                   # LFQ's CosineSimLinear, (in, out)
            _set(target.weight, np.asarray(torch_state[f'{name}.weight']).T)


def import_torch_state(module: nn.Module, torch_state: dict) -> None:
    """Write an upstream state_dict (tensors or numpy arrays) into `module`
    in place."""
    import vqtpu_torch as vt

    name = type(module).__name__
    if isinstance(module, vt.VectorQuantize):
        _vq(torch_state, module)
    elif isinstance(module, (vt.GroupedResidualVQ, vt.GroupedResidualLFQ, vt.GroupedResidualFSQ)):
        for g, rvq in enumerate(module.rvqs):
            import_torch_state(rvq, _sub(torch_state, f'rvqs.{g}.'))
    elif isinstance(module, (vt.ResidualVQ, vt.ResidualSimVQ)):
        for i, layer in enumerate(module.layers):
            import_torch_state(layer, _sub(torch_state, f'layers.{i}.'))
        for pname in ('project_in', 'project_out'):
            if f'{pname}.weight' in torch_state and getattr(module, pname, None) is not None:
                _linear(torch_state, pname, getattr(module, pname))
        for i, mlp in enumerate(getattr(module, 'mlps', None) or ()):      # QINCo
            _linear(torch_state, f'mlps.{i}.proj_in', mlp.proj_in)
            for j, block in enumerate(mlp.layers):
                _linear(torch_state, f'mlps.{i}.layers.{j}.0', block.lin1)
                _linear(torch_state, f'mlps.{i}.layers.{j}.2', block.lin2)
    elif isinstance(module, vt.SimVQ):
        _set(module.frozen_codebook, torch_state['frozen_codebook'])
        if isinstance(module.code_transform, nn.Linear):
            _linear(torch_state, 'code_transform', module.code_transform)
        else:                                   # a custom transform, keyed as upstream's
            transform = _sub(torch_state, 'code_transform.')
            module.code_transform.load_state_dict(
                {k: torch.as_tensor(np.asarray(v)) for k, v in transform.items()}, strict=True)
    elif isinstance(module, vt.LatentQuantize):
        for i, values in enumerate(module.values_per_latent):
            _set(values, torch_state[f'values_per_latent.{i}'])
        if module.project_in is not None and 'project_in.weight' in torch_state:
            _linear(torch_state, 'project_in', module.project_in)
            _linear(torch_state, 'project_out', module.project_out)
    elif isinstance(module, vt.RandomProjectionQuantizer):
        _set(module.rand_projs, torch_state['rand_projs'])
        import_torch_state(module.vq, _sub(torch_state, 'vq.'))
    elif isinstance(module, vt.HierarchicalVQ):
        import_torch_state(module.vq, _sub(torch_state, 'vq.'))
        # upstream keeps one smoother under 'phi_shared' when share_quant_resi
        # == 1; the port always has phi_levels (one entry when shared)
        if any(k.startswith('phi_shared.') for k in torch_state):
            _conv2d(torch_state, 'phi_shared.conv', module.phi_levels[0].conv)
        else:
            for i, phi in enumerate(module.phi_levels):
                _conv2d(torch_state, f'phi_levels.{i}.conv', phi.conv)
    elif isinstance(module, (vt.FSQ, vt.FSP, vt.LFQ, vt.BinaryMapper)):
        _projections(torch_state, module)
    elif isinstance(module, (vt.ResidualFSQ, vt.ResidualLFQ)):
        for i, layer in enumerate(module.layers):
            import_torch_state(layer, _sub(torch_state, f'layers.{i}.'))
        for pname in ('project_in', 'project_out'):
            if f'{pname}.weight' in torch_state and getattr(module, pname, None) is not None:
                _linear(torch_state, pname, getattr(module, pname))
    else:
        raise NotImplementedError(f'import_torch_state: unsupported module {name}')
