"""FSP, Finite Scalar Perturbation (counterpart of vqtpu/quantizers/fsp.py).

https://arxiv.org/abs/2602.17133 (VP-VAE): each scalar maps to [0, 1]
through a CDF activation and quantizes to the midpoint of its bin with a
straight-through gradient; in training it is instead perturbed within its
bin at rate 1 - quantize_rate. A moment-matching regularizer (VectorNorm)
keeps the pre-activation batch distribution near the activation's scale.
No kernel: elementwise ops and batch reductions in PyTorch.

The perturbation's two uniform draws (the offsets, then the mask) come
from `self.generator` through `core.sampling.uniform_noise`, looked up at
call time. With `sync_axis` (a mesh axis name; see `parallel.collectives`)
VectorNorm's moments are those of the global batch: every sum is psum'd
over the replicas.
"""

from __future__ import annotations

import math
from itertools import accumulate
from typing import Callable

import torch
from torch import nn

from ..core import sampling
from ..core.sampling import attach_stream
from ..core.utils import default, resolve_device
from ..parallel.collectives import axis_size, psum

_SQRT2 = math.sqrt(2.0)

# CDF activations (-inf, inf) -> [0, 1], with their inverses
_CDF_REGISTRY: dict[str, tuple[Callable, Callable]] = {
    'tanh': (
        lambda z: (torch.tanh(z) + 1.0) / 2.0,
        lambda p: torch.atanh(p * 2.0 - 1.0),
    ),
    'sigmoid': (
        torch.sigmoid,
        lambda p: torch.log(p) - torch.log1p(-p),
    ),
    'normal': (
        lambda z: (1.0 + torch.erf(z / _SQRT2)) / 2.0,
        lambda p: torch.erfinv(2.0 * p - 1.0) * _SQRT2,
    ),
    'laplace': (
        lambda z: 0.5 * (1.0 + torch.sign(z) * (1.0 - torch.exp(-z.abs()))),
        lambda p: -torch.sign(p - 0.5) * torch.log(1.0 - 2.0 * (p - 0.5).abs()),
    ),
    'cauchy': (
        lambda z: torch.atan(z) / math.pi + 0.5,
        lambda p: torch.tan((p - 0.5) * math.pi),
    ),
}


def build_cdf_act(act_name: str) -> tuple[Callable, Callable]:
    if act_name not in _CDF_REGISTRY:
        raise ValueError(f'CDF activation {act_name} not available: {list(_CDF_REGISTRY)}')
    return _CDF_REGISTRY[act_name]


def batch_stats(batch: torch.Tensor, eps: float = 1e-8, sync_axis: str | None = None):
    """(n, d) -> per-dim mean, unbiased variance, skewness and excess
    kurtosis; with `sync_axis`, those of the global batch over the axis
    (psum'd sums; every rank's n the same)."""
    n = batch.shape[0] * axis_size(sync_axis)
    mean = psum(batch.sum(0), sync_axis) / n
    centered = batch - mean
    variance = psum((centered ** 2).sum(0), sync_axis) / max(n - 1, 1)
    std = torch.sqrt(variance).clamp_min(eps)
    z = centered / std
    skewness = psum((z ** 3).sum(0), sync_axis) / n
    kurtosis = psum((z ** 4).sum(0), sync_axis) / n - 3.0
    return mean, variance, skewness, kurtosis


class VectorNorm(nn.Module):
    """Moment-matching regularizer over the batch distribution."""

    PRESETS = {
        'none': dict(l1_weight=0.0, l2_weight=0.0, l3_weight=0.0, l4_weight=0.0),
        'var': dict(l1_target=0.0, l1_weight=0.1, l2_target=1.0, l2_weight=0.07,
                    l3_weight=0.0, l4_weight=0.0),
        'kurt': dict(l1_target=0.0, l1_weight=0.1, l2_target=1.0, l2_weight=0.07,
                     l3_target=0.0, l3_weight=0.06, l4_target=0.0, l4_weight=0.05),
        'var_tanh': dict(l1_target=0.0, l1_weight=0.1, l2_target=0.8225,
                         l2_weight=0.07, l3_weight=0.0, l4_weight=0.0),
        'var_sigmoid': dict(l1_target=0.0, l1_weight=0.1, l2_target=3.29,
                            l2_weight=0.07, l3_weight=0.0, l4_weight=0.0),
        'var_laplace': dict(l1_target=0.0, l1_weight=0.1, l2_target=2.0,
                            l2_weight=0.07, l3_weight=0.0, l4_weight=0.0),
    }

    def __init__(
        self,
        l1_target: float = 0.0, l1_weight: float = 0.1,
        l2_target: float = 1.0, l2_weight: float = 0.07,
        l3_target: float = 0.0, l3_weight: float = 0.06,
        l4_target: float = 0.0, l4_weight: float = 0.05,
        eps: float = 1e-8,
    ):
        super().__init__()
        self.targets = (l1_target, l2_target, l3_target, l4_target)
        self.weights = (l1_weight, l2_weight, l3_weight, l4_weight)
        self.eps = eps
        self.sync_axis = None          # set by FSP when data-parallel

    @classmethod
    def build(cls, name: str) -> 'VectorNorm':
        if name not in cls.PRESETS:
            raise ValueError(f'unknown vector_norm preset: {name}, available: {list(cls.PRESETS)}')
        return cls(**cls.PRESETS[name])

    def forward(self, z: torch.Tensor) -> tuple[torch.Tensor, dict]:
        moments = batch_stats(z, self.eps, self.sync_axis)
        norm_loss = sum(((m - t) ** 2).mean() * w for m, t, w in zip(moments, self.targets, self.weights))
        return norm_loss, dict(zip(('mean', 'variance', 'skewness', 'kurtosis'), moments))


# the bin midpoints are uniform on [0, 1], std 1/sqrt(12): the linear decode
# divides by it so that q_z has unit variance
_UNIFORM_STD = 0.28867513459481287


class FSP(nn.Module):
    def __init__(
        self,
        levels: list[int] | tuple[int, ...],
        dim: int | None = None,
        channel_first: bool = False,
        projection_has_bias: bool = True,
        act_name: str = 'tanh',
        quantize_rate: float = 0.0,
        need_inv_act: bool = False,
        vector_norm: str = 'var_tanh',
        sync_axis: str | None = None,
        *,
        rngs=None,
        device: str | torch.device | None = None,
    ):
        """`device` as for VectorQuantize; `rngs` must be None (the
        projections come from torch's global generator, the perturbation
        from `self.generator`, seeded from it)."""
        super().__init__()
        if rngs is not None:
            raise TypeError('rngs is a flax RNG stream; seed torch with torch.manual_seed instead')
        if not 0.0 <= quantize_rate <= 1.0:
            raise ValueError(f'quantize_rate must be in [0.0, 1.0], got {quantize_rate}')
        device = resolve_device(device)
        self.levels = tuple(int(l) for l in levels)
        self.basis = tuple(accumulate((1,) + self.levels[:-1], lambda a, b: a * b))
        self.codebook_dim = len(self.levels)
        self.codebook_size = math.prod(self.levels)
        self.dim = default(dim, self.codebook_dim)
        self.channel_first = channel_first

        self.has_projections = self.dim != self.codebook_dim
        self.project_in = (nn.Linear(self.dim, self.codebook_dim, bias=projection_has_bias, device=device)
                           if self.has_projections else None)
        self.project_out = (nn.Linear(self.codebook_dim, self.dim, bias=projection_has_bias, device=device)
                            if self.has_projections else None)

        self.act_name = act_name
        self.act_func, self.inv_act_func = build_cdf_act(act_name)
        self.need_inv_act = need_inv_act
        self.quantize_rate = quantize_rate
        self.vector_norm = VectorNorm.build(vector_norm)
        # data-parallel: the moments psum over this mesh axis
        self.vector_norm.sync_axis = sync_axis
        self.sync_axis = sync_axis
        self.generator = attach_stream(self, device)

    def extra_repr(self) -> str:
        return (f'levels={list(self.levels)}, codebook_size={self.codebook_size}, '
                f'codebook_dim={self.codebook_dim}, dim={self.dim}, '
                f"act_name='{self.act_name}', need_inv_act={self.need_inv_act}, "
                f'quantize_rate={self.quantize_rate}')

    def _levels_arr(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.levels, dtype=like.dtype, device=like.device)

    def quantize_act_value(self, act_z: torch.Tensor, eps: float):
        """[0, 1] activations -> (bin midpoints with a straight-through
        gradient, bin indices)."""
        levels = self._levels_arr(act_z)
        level_indices = torch.floor(act_z.clamp(max=1.0 - eps) * levels)
        q_act_z = (level_indices + 0.5) / levels
        return act_z + (q_act_z - act_z).detach(), level_indices.detach()

    def level_indices_to_indices(self, level_indices: torch.Tensor) -> torch.Tensor:
        basis = torch.tensor(self.basis, dtype=level_indices.dtype, device=level_indices.device)
        return (level_indices * basis).sum(-1).to(torch.int32)

    def indices_to_level_indices(self, indices: torch.Tensor) -> torch.Tensor:
        basis = torch.tensor(self.basis, dtype=torch.int32, device=indices.device)
        levels = torch.tensor(self.levels, dtype=torch.int32, device=indices.device)
        return torch.div(indices.to(torch.int32)[..., None], basis, rounding_mode='floor') % levels

    def indices_to_act_value(self, indices: torch.Tensor) -> torch.Tensor:
        level_indices = self.indices_to_level_indices(indices).float()
        return (level_indices + 0.5) / self._levels_arr(level_indices)

    def _decode_act(self, q_act_z: torch.Tensor, eps: float) -> torch.Tensor:
        if self.need_inv_act:
            return self.inv_act_func(q_act_z.clamp(eps, 1.0 - eps))
        return (q_act_z - 0.5) / _UNIFORM_STD

    def indices_to_codes(self, indices: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        codes = self._decode_act(self.indices_to_act_value(indices), eps)
        if self.project_out is not None:
            codes = self.project_out(codes)
        if self.channel_first:
            codes = codes.movedim(-1, 1)
        return codes

    def forward(self, z: torch.Tensor, eps: float | None = None):
        """z -> (q_z, indices int32, norm loss, info: level_indices,
        norm_info and, when it perturbs, p_accept_prob)."""
        eps = eps or torch.finfo(z.dtype).eps
        if self.channel_first:
            z = z.movedim(1, -1)
        z_shape = z.shape
        if z_shape[-1] != self.dim:
            raise ValueError(f'expected dimension of {self.dim} but found {z_shape[-1]}')
        z = z.reshape(-1, self.dim)
        if self.project_in is not None:
            z = self.project_in(z.to(self.project_in.weight.dtype))

        norm_loss, norm_info = self.vector_norm(z)
        act_z = self.act_func(z)
        q_act_z, level_indices = self.quantize_act_value(act_z, eps=eps)
        other_info = {}

        quantize_rate = self.quantize_rate if self.training else 1.0
        if quantize_rate < 1.0:
            p_max_norm = 1.0 / (self._levels_arr(act_z) * 2)
            u_p = sampling.uniform_noise(self.generator, act_z.shape, dtype=act_z.dtype, device=act_z.device)
            proposal = act_z + p_max_norm * (u_p * 2.0 - 1.0)
            accept_mask = (proposal > 0.0) & (proposal < 1.0)
            other_info['p_accept_prob'] = accept_mask.float().mean()
            p_act_z = torch.where(accept_mask, proposal, act_z)
            u_m = sampling.uniform_noise(self.generator, q_act_z.shape, device=act_z.device)
            q_act_z = torch.where(u_m > quantize_rate, p_act_z, q_act_z)

        q_z = self._decode_act(q_act_z, eps)
        if self.need_inv_act:
            q_z = z + (q_z - z).detach()

        indices = self.level_indices_to_indices(level_indices)
        if self.project_out is not None:
            q_z = self.project_out(q_z)

        level_indices = level_indices.reshape(*z_shape[:-1], -1)
        indices = indices.reshape(z_shape[:-1])
        q_z = q_z.reshape(z_shape)
        if self.channel_first:
            q_z = q_z.movedim(-1, 1)
        return q_z, indices, norm_loss, {'level_indices': level_indices, 'norm_info': norm_info, **other_info}
