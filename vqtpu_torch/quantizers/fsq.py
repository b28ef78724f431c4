"""FSQ, finite scalar quantization (counterpart of vqtpu/quantizers/fsq.py).

https://arxiv.org/abs/2309.15505. Each dimension is bounded and rounded
onto a fixed grid of `levels[i]` values, and a mixed-radix codec turns the
per-dimension digits into one index. The codebook is implicit arithmetic,
so the only state is the optional projections and the optional orthogonal
rotation buffer. The level and basis constants are derived, non-persistent
buffers, as in the JAX package (nothing to carry in a checkpoint).

The forward is plain PyTorch on any device: FSQ has no kernel of its own.
Every expression keeps the JAX package's order of operations, so that the
values round alike; the hard-clamp, symmetry-preserving bound has no
transcendental and gives the JAX module's codes and indices bit for bit.
The noise dropout of training draws from `self.generator` through
`core.sampling.bernoulli_and_uniform`.
"""

from __future__ import annotations

import math
import warnings
from itertools import accumulate

import torch
from torch import nn

from ..core.layout import to_tokens
from ..core.sampling import attach_stream, bernoulli_and_uniform
from ..core.ste import floor_ste, round_ste
from ..core.utils import autocast_off, default, random_orthogonal, resolve_device, rotate


class FSQ(nn.Module):
    def __init__(
        self,
        levels: list[int] | tuple[int, ...],
        dim: int | None = None,
        num_codebooks: int = 1,
        keep_num_codebooks_dim: bool | None = None,
        scale: float | None = None,
        channel_first: bool = False,
        projection_has_bias: bool = True,
        return_indices: bool = True,
        force_quantization_f32: bool = True,
        allowed_dtypes: tuple = ('float32', 'float64'),
        preserve_symmetry: bool = False,
        noise_dropout: float = 0.0,
        bound_hard_clamp: bool = False,
        orthogonal_rotation: bool = False,
        *,
        rngs=None,
        device: str | torch.device | None = None,
    ):
        """`device`: where the module lives; the CUDA card when None (raises
        if there is none), or 'cpu'. `rngs` is kept for the JAX signature
        and must be None: parameters come from torch's global generator, and
        the draws (orthogonal rotation, noise dropout) from `self.generator`,
        seeded from it. `scale` is kept for the signature and unused, as in
        the JAX package."""
        super().__init__()
        if rngs is not None:
            raise TypeError('rngs is a flax RNG stream; seed torch with torch.manual_seed instead')
        if any(level == 2 for level in levels) and not preserve_symmetry:
            raise ValueError('turn on `preserve_symmetry` for using any levels == 2, or use a greater level')
        if noise_dropout > 0 and not preserve_symmetry:
            raise ValueError('noise_dropout needs preserve_symmetry')
        device = resolve_device(device)

        self.levels = tuple(int(level) for level in levels)
        # mixed-radix basis: index = sum_i digit_i * basis_i
        self.basis = tuple(accumulate((1,) + self.levels[:-1], lambda a, b: a * b))
        self.register_buffer('levels_f32', torch.tensor(self.levels, dtype=torch.float32, device=device),
                             persistent=False)
        self.register_buffer('basis_i32', torch.tensor(self.basis, dtype=torch.int32, device=device),
                             persistent=False)

        self.scale = scale
        self.preserve_symmetry = preserve_symmetry
        self.noise_dropout = noise_dropout
        self.bound_hard_clamp = bound_hard_clamp

        codebook_dim = len(self.levels)
        self.codebook_dim = codebook_dim
        effective_codebook_dim = codebook_dim * num_codebooks
        self.num_codebooks = num_codebooks
        self.effective_codebook_dim = effective_codebook_dim

        keep_num_codebooks_dim = default(keep_num_codebooks_dim, num_codebooks > 1)
        if num_codebooks > 1 and not keep_num_codebooks_dim:
            raise ValueError('keep_num_codebooks_dim must be True with several codebooks')
        self.keep_num_codebooks_dim = keep_num_codebooks_dim

        self.dim = default(dim, effective_codebook_dim)
        self.channel_first = channel_first

        has_projections = self.dim != effective_codebook_dim
        self.project_in = (nn.Linear(self.dim, effective_codebook_dim, bias=projection_has_bias, device=device)
                           if has_projections else None)
        self.project_out = (nn.Linear(effective_codebook_dim, self.dim, bias=projection_has_bias, device=device)
                            if has_projections else None)
        self.has_projections = has_projections

        self.return_indices = return_indices
        self.codebook_size = math.prod(self.levels)
        self.force_quantization_f32 = force_quantization_f32
        # accepts strings or dtypes
        self.allowed_dtypes = tuple(getattr(torch, d) if isinstance(d, str) else d for d in allowed_dtypes)

        self.generator = attach_stream(self, device)

        self.orthogonal_rotation = orthogonal_rotation
        if orthogonal_rotation:
            if len(set(self.levels)) != 1:
                warnings.warn('orthogonal_rotation is not recommended for FSQ with asymmetric levels')
            self.register_buffer('orthogonal_rot', random_orthogonal(codebook_dim, self.generator, device))

    # -- level constants -------------------------------------------------------

    def _levels_arr(self, dtype=torch.float32) -> torch.Tensor:
        return self.levels_f32.to(dtype)

    @property
    def implicit_codebook(self) -> torch.Tensor:
        """All codebook vectors, derived arithmetically; recomputed, not stored."""
        return self._indices_to_codes(torch.arange(self.codebook_size, device=self.levels_f32.device))

    # -- quantization ----------------------------------------------------------

    def bound(self, z: torch.Tensor, eps: float = 1e-3, hard_clamp: bool = False) -> torch.Tensor:
        """Bound z onto the level grid, then round with a straight-through
        gradient."""
        levels = self._levels_arr()
        half_l = (levels - 1) * (1 + eps) / 2
        offset = torch.where(levels % 2 == 0, 0.5, 0.0)
        if hard_clamp:
            shift = offset / half_l
            bounded_z = torch.clamp(z + shift, -1.0, 1.0) * half_l - offset
        else:
            shift = torch.atanh(offset / half_l)
            bounded_z = torch.tanh(z + shift) * half_l - offset
        half_width = torch.div(levels, 2, rounding_mode='floor').to(z.dtype)
        return round_ste(bounded_z) / half_width

    def symmetry_preserving_bound(self, z: torch.Tensor, hard_clamp: bool = False) -> torch.Tensor:
        """QL(x) = 2 / (L - 1) * [(L - 1) * (tanh(x) + 1) / 2 + 0.5] - 1
        (section 3.2 of https://arxiv.org/abs/2411.19842), with clip(x, -1, 1)
        in place of tanh under `hard_clamp`."""
        levels_minus_1 = self._levels_arr() - 1
        scale = 2.0 / levels_minus_1
        bounded = torch.clamp(z, -1.0, 1.0) if hard_clamp else torch.tanh(z)
        bracket = (levels_minus_1 * (bounded + 1) / 2.0) + 0.5
        bracket = floor_ste(bracket)
        return scale * bracket - 1.0

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        bound_fn = self.symmetry_preserving_bound if self.preserve_symmetry else self.bound
        return bound_fn(z, hard_clamp=self.bound_hard_clamp)

    def maybe_apply_noise(self, bounded_z: torch.Tensor) -> torch.Tensor:
        """In training, move each value by a uniform offset in [-0.5, 0.5)
        with probability `noise_dropout`, then clip to [-1, 1]."""
        if not self.training or self.noise_dropout == 0.0:
            return bounded_z
        offset_mask, uniform = bernoulli_and_uniform(self.generator, self.noise_dropout, bounded_z.shape,
                                                     bounded_z.dtype, bounded_z.device)
        out = torch.where(offset_mask, bounded_z + (uniform - 0.5), bounded_z)
        return torch.clamp(out, -1.0, 1.0)

    # -- index codec -----------------------------------------------------------

    def _scale_and_shift(self, zhat_normalized: torch.Tensor) -> torch.Tensor:
        levels = self._levels_arr(zhat_normalized.dtype)
        if self.preserve_symmetry:
            return (zhat_normalized + 1.0) / (2.0 / (levels - 1))
        half_width = torch.div(levels, 2, rounding_mode='floor')
        return (zhat_normalized * half_width) + half_width

    def _scale_and_shift_inverse(self, zhat: torch.Tensor) -> torch.Tensor:
        levels = self._levels_arr()
        if self.preserve_symmetry:
            return zhat * (2.0 / (levels - 1)) - 1.0
        half_width = torch.div(levels, 2, rounding_mode='floor')
        return (zhat - half_width) / half_width

    def indices_to_level_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """Mixed-radix decomposition: the per-dimension digits of indices."""
        levels = self.levels_f32.to(torch.int32)
        return torch.remainder(torch.div(indices[..., None].int(), self.basis_i32, rounding_mode='floor'), levels)

    def _indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        return self._scale_and_shift_inverse(self.indices_to_level_indices(indices).float())

    def codes_to_indices(self, zhat: torch.Tensor) -> torch.Tensor:
        if zhat.shape[-1] != self.codebook_dim:
            raise ValueError(f'expected codes of dim {self.codebook_dim}, got {zhat.shape[-1]}')
        zhat = self._scale_and_shift(zhat)
        return torch.round((zhat * self.basis_i32.to(zhat.dtype)).sum(-1)).to(torch.int32)

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        """Decode indices back to (projected) codes."""
        is_img_or_video = indices.ndim >= (3 + int(self.keep_num_codebooks_dim))
        codes = self._indices_to_codes(indices)
        if self.orthogonal_rotation:
            codes = rotate(codes, self.orthogonal_rot.T)
        if self.keep_num_codebooks_dim:
            codes = codes.reshape(*codes.shape[:-2], -1)
        if self.project_out is not None:
            codes = self.project_out(codes)
        if is_img_or_video or self.channel_first:
            codes = codes.movedim(-1, 1)
        return codes

    # -- forward ---------------------------------------------------------------

    def forward(self, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        is_img_or_video = z.ndim >= 4
        need_move_channel_last = is_img_or_video or self.channel_first
        if need_move_channel_last:
            z, layout = to_tokens(z, channel_first=True)
        if z.shape[-1] != self.dim:
            raise ValueError(f'expected dimension of {self.dim} but found {z.shape[-1]}')

        if self.project_in is not None:
            # a bf16 or fp16 input meets the f32 weights in f32, as JAX promotes it
            z = self.project_in(z.to(self.project_in.weight.dtype))

        b, n = z.shape[:2]
        z = z.reshape(b, n, self.num_codebooks, self.codebook_dim)
        # the quantization runs with autocast off, in f32 unless the input
        # dtype is allowed
        with autocast_off(z.device):
            if self.orthogonal_rotation:
                z = rotate(z, self.orthogonal_rot)
            orig_dtype = z.dtype
            if self.force_quantization_f32 and orig_dtype not in self.allowed_dtypes:
                z = z.float()

            codes = self.quantize(z)
            indices = self.codes_to_indices(codes) if self.return_indices else None
            codes = self.maybe_apply_noise(codes)

            if self.orthogonal_rotation:
                codes = rotate(codes, self.orthogonal_rot.T)
        codes = codes.reshape(b, n, -1).to(orig_dtype)
        out = self.project_out(codes) if self.project_out is not None else codes

        if need_move_channel_last:
            out = layout.restore(out)
            if indices is not None:
                indices = layout.restore_indices(indices)
        if not self.keep_num_codebooks_dim and self.return_indices:
            indices = indices[..., 0]
        return out, indices
