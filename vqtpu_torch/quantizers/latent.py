"""LatentQuantize (counterpart of vqtpu/quantizers/latent.py).

Disentanglement via Latent Quantization (https://arxiv.org/abs/2305.18378):
each latent dimension quantizes to the nearest of a small set of values of
its own, learnable parameters when `optimize_values`; commitment and
quantization MSE losses pull the encoder and the values together. No
kernel: a per-dimension argmin over a handful of values in PyTorch.

`in_place_codebook_optimizer`: a callable that takes the parameters the
inner loss reaches (the values and project_out's) and returns a
`torch.optim.Optimizer` over them, as for VectorQuantize (the JAX package
takes an optax transformation over every parameter; project_in's gradient
in the inner loss is 0, so only a weight decay would move it there). Each
training forward then takes one step of it on the unweighted sum of the two
losses of the raw gathered values (no straight-through, so the values take
the gradient) and quantizes again. The step leaves every parameter's
`.grad` as it found it; unlike the JAX package's, the outer gradient is not
differentiated through the step.
"""

from __future__ import annotations

import math
from itertools import accumulate

import torch
from torch import nn

from ..core.optim import optimizer_update
from ..core.utils import resolve_device


def _init_values(level: int) -> torch.Tensor:
    """Zero-centred values that start at -0.5."""
    if level % 2 == 1:
        return torch.linspace(-0.5, 0.5, level)
    return torch.arange(level) / level - 0.5


class LatentQuantize(nn.Module):
    def __init__(
        self,
        levels: list[int] | int,
        dim: int,
        commitment_loss_weight: float = 0.1,
        quantization_loss_weight: float = 0.1,
        num_codebooks: int = 1,
        codebook_dim: int = -1,
        keep_num_codebooks_dim: bool | None = None,
        optimize_values: bool = True,
        in_place_codebook_optimizer=None,
        *,
        rngs=None,
        device: str | torch.device | None = None,
    ):
        """`device` as for VectorQuantize; `rngs` must be None (the
        projections come from torch's global generator)."""
        super().__init__()
        if rngs is not None:
            raise TypeError('rngs is a flax RNG stream; seed torch with torch.manual_seed instead')
        device = resolve_device(device)
        self.dim = dim
        if isinstance(levels, int):
            if codebook_dim <= 0:
                raise ValueError('codebook_dim must be set when levels is a scalar')
            levels = [levels] * codebook_dim
        self.levels = tuple(int(l) for l in levels)
        self.basis = tuple(accumulate((1,) + self.levels[:-1], lambda a, b: a * b))
        self.commitment_loss_weight = commitment_loss_weight
        self.quantization_loss_weight = quantization_loss_weight
        self.codebook_dim = codebook_dim if codebook_dim > 0 else len(self.levels)
        self.num_codebooks = num_codebooks
        self.effective_codebook_dim = self.codebook_dim * num_codebooks
        keep_num_codebooks_dim = keep_num_codebooks_dim if keep_num_codebooks_dim else num_codebooks > 1
        if num_codebooks > 1 and not keep_num_codebooks_dim:
            raise ValueError('several codebooks need keep_num_codebooks_dim')
        self.keep_num_codebooks_dim = keep_num_codebooks_dim

        self.has_projections = self.dim != self.effective_codebook_dim
        self.project_in = (nn.Linear(self.dim, self.effective_codebook_dim, device=device)
                           if self.has_projections else None)
        self.project_out = (nn.Linear(self.effective_codebook_dim, self.dim, device=device)
                            if self.has_projections else None)
        self.codebook_size = math.prod(self.levels)

        # one leaf a dimension (the sets are ragged); frozen without optimize_values
        self.optimize_values = optimize_values
        self.values_per_latent = nn.ParameterList([
            nn.Parameter(_init_values(level).to(device), requires_grad=optimize_values)
            for level in self.levels
        ])
        # the inner loss reaches the values and project_out; project_in's
        # gradient there is 0 (it acts before the step), and it is left out,
        # since the step would write in place a weight the outer graph holds
        inner_params = [p for p in self.values_per_latent if p.requires_grad]
        if self.project_out is not None:
            inner_params += list(self.project_out.parameters())
        self.in_place_codebook_optimizer = (
            None if in_place_codebook_optimizer is None else in_place_codebook_optimizer(inner_params)
        )

    # -- codec ---------------------------------------------------------------

    def _int_table(self, values, device) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32, device=device)

    def _scale_and_shift(self, zhat_normalized: torch.Tensor) -> torch.Tensor:
        half_width = self._int_table(self.levels, zhat_normalized.device) // 2
        return zhat_normalized * 2 * half_width + half_width

    def _scale_and_shift_inverse(self, zhat: torch.Tensor) -> torch.Tensor:
        half_width = self._int_table(self.levels, zhat.device) // 2
        return (zhat - half_width) / half_width / 2

    def _level_digits(self, indices: torch.Tensor) -> torch.Tensor:
        basis = self._int_table(self.basis, indices.device)
        levels = self._int_table(self.levels, indices.device)
        return torch.div(indices.to(torch.int32)[..., None], basis, rounding_mode='floor') % levels

    @property
    def implicit_codebook(self) -> torch.Tensor:
        device = self.values_per_latent[0].device
        return self._scale_and_shift_inverse(self._level_digits(torch.arange(self.codebook_size, device=device)))

    def codes_to_indices(self, zhat: torch.Tensor) -> torch.Tensor:
        if zhat.shape[-1] != self.codebook_dim:
            raise ValueError(f'expected codes of {self.codebook_dim} dims, got {zhat.shape[-1]}')
        zhat = self._scale_and_shift(zhat)
        basis = torch.tensor(self.basis, dtype=zhat.dtype, device=zhat.device)
        return (zhat * basis).sum(-1).to(torch.int32)

    def indices_to_codes(self, indices: torch.Tensor, project_out: bool = True) -> torch.Tensor:
        codes = self._scale_and_shift_inverse(self._level_digits(indices))
        if self.keep_num_codebooks_dim:
            codes = codes.reshape(*codes.shape[:-2], -1)
        if project_out and self.project_out is not None:
            codes = self.project_out(codes)
        return codes.movedim(-1, 1)

    # -- quantization ----------------------------------------------------------

    def quantize(self, z: torch.Tensor, ste: bool = True) -> torch.Tensor:
        """Each dimension to its nearest value (the first on ties), with a
        straight-through gradient; `ste=False` returns the gathered values,
        through which the values take their gradient. As in the JAX package,
        this quantizes to the learned values while the index codec uses the
        canonical grid."""
        quantized_dims = []
        for i, values in enumerate(self.values_per_latent):
            idx = (z[..., i, None] - values).abs().argmin(-1)
            quantized_dims.append(values[idx])
        quantize = torch.stack(quantized_dims, dim=-1)
        if not ste:
            return quantize
        return z + (quantize - z).detach()

    def quantize_and_project(self, z: torch.Tensor, is_img_or_video=None, ps=None):
        """Quantize tokens already through project_in, (b, n, c, d), and
        project them back out -> (codes (b, n, c * d), out, indices). `ps`
        is the channel-last shape of the original input, (b, *spatial,
        dim): `out` takes it and `indices` (b, *spatial, c); `out` comes
        back channel-first, and `indices` without their codebook dim unless
        `keep_num_codebooks_dim`. `is_img_or_video` is accepted and unused,
        as upstream."""
        codes, out, indices = self._quantize_tokens(z)
        if ps is not None:
            out = out.reshape(ps)
            indices = indices.reshape(*ps[:-1], self.num_codebooks)
        out = out.movedim(-1, 1)
        if not self.keep_num_codebooks_dim:
            indices = indices[..., 0]
        return codes, out, indices

    @staticmethod
    def quantization_loss(z: torch.Tensor, zhat: torch.Tensor) -> torch.Tensor:
        return ((zhat.detach() - z) ** 2).mean()

    @staticmethod
    def commitment_loss(z: torch.Tensor, zhat: torch.Tensor) -> torch.Tensor:
        return ((z.detach() - zhat) ** 2).mean()

    def _quantize_tokens(self, z_tokens: torch.Tensor, ste: bool = True):
        """(b, N, c, d) -> (codes (b, N, c * d), out (b, N, dim), indices
        (b, N, c))."""
        codes = self.quantize(z_tokens, ste=ste)
        indices = self.codes_to_indices(codes)
        codes = codes.reshape(*codes.shape[:-2], -1)
        out = self.project_out(codes) if self.project_out is not None else codes
        return codes, out, indices

    def _inner_step(self, z: torch.Tensor, original_input: torch.Tensor, finalize) -> None:
        """One step of the in-place optimizer on the two losses of the raw
        gathered values; every parameter's `.grad` is left as it was."""
        params = [p for group in self.in_place_codebook_optimizer.param_groups for p in group['params']]
        with torch.enable_grad():
            out, _ = finalize(*self._quantize_tokens(z.detach(), ste=False)[1:])
            loss = torch.zeros((), device=out.device)
            if self.commitment_loss_weight != 0:
                loss = loss + self.commitment_loss(original_input, out)
            if self.quantization_loss_weight != 0:
                loss = loss + self.quantization_loss(original_input, out)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        optimizer_update(self.in_place_codebook_optimizer,
                         [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)])

    def forward(self, z: torch.Tensor):
        """Channel-first (b, dim, ...) -> (out (b, dim, ...), indices
        (b, ...) or (b, ..., num_codebooks), loss)."""
        original_input = z
        z = z.movedim(1, -1)
        z_shape = z.shape
        if z_shape[-1] != self.dim:
            raise ValueError(f'expected dimension of {self.dim} but found {z_shape[-1]}')
        z = z.reshape(z.shape[0], -1, self.dim)
        if self.project_in is not None:
            z = self.project_in(z.to(self.project_in.weight.dtype))
        z = z.reshape(*z.shape[:-1], self.num_codebooks, self.codebook_dim)

        def finalize(out_tokens, indices_tokens):
            out = out_tokens.reshape(z_shape).movedim(-1, 1)
            indices = indices_tokens.reshape(*z_shape[:-1], self.num_codebooks)
            if not self.keep_num_codebooks_dim:
                indices = indices[..., 0]
            return out, indices

        if self.in_place_codebook_optimizer is not None and self.training:
            self._inner_step(z, original_input, finalize)

        out, indices = finalize(*self._quantize_tokens(z)[1:])
        zero = torch.zeros((), device=out.device)
        commitment_loss = quantization_loss = zero
        if self.training:
            if self.commitment_loss_weight != 0:
                commitment_loss = self.commitment_loss(original_input, out)
            if self.quantization_loss_weight != 0:
                quantization_loss = self.quantization_loss(original_input, out)
        loss = self.commitment_loss_weight * commitment_loss + self.quantization_loss_weight * quantization_loss
        return out, indices, loss
