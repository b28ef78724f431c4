"""ResidualFSQ and GroupedResidualFSQ (counterpart of
vqtpu/composite/residual_fsq.py).

A residual stack of preserve-symmetry FSQ layers, layer i quantizing the
residual at scale L^-i, behind a soft input clamp tanh(x / c) * c with
c = 1 + 1 / (L - 1) under the default hard-clamp bound. In training,
quantize dropout zeroes the layers after a drawn index and gives them index
-1; the draw comes from `self.generator`, or from
`rand_quantize_dropout_index` when the caller gives it.

`eval_fused` keeps the JAX meaning, with "TPU" read as "the tensors are on
the card": 'auto' takes the fused eval kernel
(`kernels.residual_fsq_fused.fused_residual_fsq_eval`, the hand-written
Hopper kernel) for an eval forward of an eligible configuration whose input
is on the card, and the loop over the layers otherwise; 'on' takes the
fused function wherever the configuration is eligible (its plain version on
the CPU); 'off' always loops. Training, and an eval forward whose input
needs a gradient, always loop.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.sampling import attach_stream, quantize_dropout_index
from ..core.utils import resolve_device
from ..kernels.residual_fsq_fused import fused_residual_fsq_eval, soft_clamp_plain
from ..quantizers.fsq import FSQ


class ResidualFSQ(nn.Module):
    def __init__(
        self,
        *,
        levels: list[int],
        num_quantizers: int,
        dim: int | None = None,
        is_channel_first: bool = False,
        quantize_dropout: bool = False,
        quantize_dropout_cutoff_index: int = 0,
        quantize_dropout_multiple_of: int = 1,
        soft_clamp_input_value: float | list[float] | None = None,
        bound_hard_clamp: bool = True,
        eval_fused: str = 'auto',
        rngs=None,
        device: str | torch.device | None = None,
        **kwargs,
    ):
        """`device` as for FSQ; `rngs` must be None (see FSQ). Other kwargs
        go to every FSQ layer."""
        super().__init__()
        if rngs is not None:
            raise TypeError('rngs is a flax RNG stream; seed torch with torch.manual_seed instead')
        if eval_fused not in ('auto', 'on', 'off'):
            raise ValueError(f"eval_fused must be 'auto', 'on' or 'off', got {eval_fused!r}")
        if any(level <= 1 for level in levels):
            raise ValueError(f'every level must be > 1, got {list(levels)}')
        if quantize_dropout_cutoff_index < 0:
            raise ValueError('quantize_dropout_cutoff_index must be >= 0')
        device = resolve_device(device)

        codebook_dim = len(levels)
        dim = codebook_dim if dim is None else dim
        requires_projection = codebook_dim != dim
        self.project_in = nn.Linear(dim, codebook_dim, device=device) if requires_projection else None
        self.project_out = nn.Linear(codebook_dim, dim, device=device) if requires_projection else None
        self.has_projections = requires_projection

        self.is_channel_first = is_channel_first
        self.num_quantizers = num_quantizers
        self.levels = tuple(int(level) for level in levels)

        self.layers = nn.ModuleList(
            FSQ(levels=list(levels), dim=codebook_dim, preserve_symmetry=True, bound_hard_clamp=bound_hard_clamp,
                device=device, **kwargs)
            for _ in range(num_quantizers)
        )
        if any(fsq.has_projections for fsq in self.layers):
            raise ValueError('the layers of a ResidualFSQ take codebook_dim inputs and have no projections')
        self.codebook_size = self.layers[0].codebook_size

        self.quantize_dropout = quantize_dropout and num_quantizers > 1
        self.quantize_dropout_cutoff_index = quantize_dropout_cutoff_index
        self.quantize_dropout_multiple_of = quantize_dropout_multiple_of

        # the soft clamp: 1 + 1 / (L - 1) under the hard-clamp bound
        if bound_hard_clamp:
            if soft_clamp_input_value is not None:
                raise ValueError('soft_clamp_input_value is set by bound_hard_clamp')
            soft_clamp_input_value = [1.0 + 1.0 / (level - 1) for level in self.levels]
        if isinstance(soft_clamp_input_value, float):
            soft_clamp_input_value = [soft_clamp_input_value] * codebook_dim
        self.soft_clamp_input_value = (tuple(soft_clamp_input_value) if soft_clamp_input_value is not None
                                       else None)

        # levels^-i in float64, rounded once to f32: the JAX module's f32
        # power on the CPU, whatever the card's powf gives
        scales = torch.tensor([[float(level) ** -i for level in self.levels] for i in range(num_quantizers)],
                              dtype=torch.float64)
        self.register_buffer('scales_f32', scales.float().to(device), persistent=False)

        self.eval_fused = eval_fused
        self.generator = attach_stream(self, device)

    def _scales(self) -> torch.Tensor:
        """(q, d) per-layer scales levels^-i."""
        return self.scales_f32

    @property
    def codebooks(self) -> torch.Tensor:
        return torch.stack([layer.implicit_codebook for layer in self.layers])

    def get_codes_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """(b, ..., q') indices, -1 where dropped, q' <= q ->
        (num_quantizers, b, ..., d) scaled codes."""
        lead_shape = indices.shape[:-1]
        quantize_dim = indices.shape[-1]
        ind = indices.reshape(indices.shape[0], -1, quantize_dim)
        if quantize_dim < self.num_quantizers:
            if not self.quantize_dropout:
                raise ValueError('quantize dropout must be greater than 0 if you wish to '
                                 'reconstruct from a signal with less fine quantizations')
            ind = nn.functional.pad(ind, (0, self.num_quantizers - quantize_dim), value=-1)

        dropout_mask = ind == -1
        ind = ind.masked_fill(dropout_mask, 0)
        # row k of a layer's implicit codebook, computed as the codebook computes it
        all_codes = torch.stack([layer._indices_to_codes(ind[..., i]) for i, layer in enumerate(self.layers)])
        all_codes = all_codes.masked_fill(dropout_mask.movedim(-1, 0)[..., None], 0.0)
        all_codes = all_codes * self._scales()[:, None, None, :]
        return all_codes.reshape(self.num_quantizers, *lead_shape, -1)

    def get_output_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        summed = self.get_codes_from_indices(indices).sum(0)
        if self.project_out is not None:
            summed = self.project_out(summed)
        return summed

    def _fused_eval_ok(self, x: torch.Tensor) -> bool:
        """Take the fused eval function for this forward? Only in eval mode
        with no gradient asked of x (the fused chain has no backward), on
        the ResidualFSQ configuration proper (preserve-symmetry hard-clamp
        layers, one codebook, no inner projections or rotation, f32-forced,
        indices on); under 'auto' only when x is on the card."""
        if self.eval_fused == 'off' or self.training or self.soft_clamp_input_value is None:
            return False
        if torch.is_grad_enabled() and x.requires_grad:
            return False
        l0 = self.layers[0]
        eligible = (l0.preserve_symmetry and l0.bound_hard_clamp and l0.num_codebooks == 1
                    and not l0.keep_num_codebooks_dim and l0.return_indices and l0.force_quantization_f32
                    and not l0.orthogonal_rotation and not l0.has_projections)
        return eligible and (self.eval_fused == 'on' or x.device.type == 'cuda')

    def draw_dropout_index(self) -> torch.Tensor:
        return quantize_dropout_index(self.generator, self.quantize_dropout_cutoff_index, self.num_quantizers,
                                      self.quantize_dropout_multiple_of)

    def forward(self, x: torch.Tensor, return_all_codes: bool = False,
                rand_quantize_dropout_index: int | torch.Tensor | None = None):
        if self.is_channel_first:
            x = x.movedim(1, -1)
            spatial = x.shape[1:-1]
            x = x.reshape(x.shape[0], -1, x.shape[-1])

        if self.project_in is not None:
            x = self.project_in(x.to(self.project_in.weight.dtype))

        if self._fused_eval_ok(x):
            quantized_out, all_indices = fused_residual_fsq_eval(
                x, self._scales(), levels=self.levels, clamp=self.soft_clamp_input_value,
                num_quantizers=self.num_quantizers)
        else:
            quantized_out, all_indices = self._loop(x, rand_quantize_dropout_index)

        if self.project_out is not None:
            quantized_out = self.project_out(quantized_out)

        if self.is_channel_first:
            quantized_out = quantized_out.reshape(quantized_out.shape[0], *spatial, -1).movedim(-1, 1)
            all_indices = all_indices.reshape(all_indices.shape[0], *spatial, -1).movedim(-1, 1)

        ret = (quantized_out, all_indices)
        if not return_all_codes:
            return ret
        return (*ret, self.get_codes_from_indices(all_indices))

    def _loop(self, x: torch.Tensor, rand_quantize_dropout_index):
        """The layers one after another: the soft clamp in x.dtype, the
        quantization in f32; the JAX module's loop op for op."""
        if self.soft_clamp_input_value is not None:
            x = soft_clamp_plain(x, self.soft_clamp_input_value)

        dropout_index = None
        if self.training and self.quantize_dropout:
            dropout_index = (torch.as_tensor(rand_quantize_dropout_index, device=x.device)
                             if rand_quantize_dropout_index is not None else self.draw_dropout_index())

        scales = self._scales()
        orig_dtype = x.dtype
        residual = x.float()
        quantized_out = torch.zeros_like(residual)
        all_indices = []
        for quantizer_index, layer in enumerate(self.layers):
            scale = scales[quantizer_index]
            quantized, indices = layer(residual / scale)
            quantized = quantized.float() * scale
            if dropout_index is not None:
                keep = quantizer_index <= dropout_index
                quantized = torch.where(keep, quantized, 0.0)
                indices = torch.where(keep, indices, -1)
            residual = residual - quantized.detach()
            quantized_out = quantized_out + quantized
            all_indices.append(indices)
        return quantized_out.to(orig_dtype), torch.stack(all_indices, -1)


class GroupedResidualFSQ(nn.Module):
    def __init__(self, *, dim: int, groups: int = 1, accept_image_fmap: bool = False, rngs=None,
                 device: str | torch.device | None = None, **kwargs):
        super().__init__()
        if rngs is not None:
            raise TypeError('rngs is a flax RNG stream; seed torch with torch.manual_seed instead')
        if dim % groups:
            raise ValueError(f'dim {dim} is not a multiple of groups {groups}')
        self.dim = dim
        self.groups = groups
        self.accept_image_fmap = accept_image_fmap
        self.rvqs = nn.ModuleList(ResidualFSQ(dim=dim // groups, device=device, **kwargs) for _ in range(groups))
        self.codebook_size = self.rvqs[0].codebook_size

    @property
    def codebooks(self) -> torch.Tensor:
        return torch.stack([rvq.codebooks for rvq in self.rvqs])

    @property
    def split_dim(self) -> int:
        return 1 if self.accept_image_fmap else -1

    def get_codes_from_indices(self, indices):
        return torch.stack([rvq.get_codes_from_indices(chunk) for rvq, chunk in zip(self.rvqs, indices)])

    def get_output_from_indices(self, indices):
        outputs = [rvq.get_output_from_indices(chunk) for rvq, chunk in zip(self.rvqs, indices)]
        return torch.cat(outputs, dim=self.split_dim)

    def forward(self, x: torch.Tensor, return_all_codes: bool = False,
                rand_quantize_dropout_index: int | torch.Tensor | None = None):
        """`rand_quantize_dropout_index`: the dropout index all groups share;
        drawn from the first group's random stream when None."""
        if x.shape[self.split_dim] != self.dim:
            raise ValueError(f'expected dim {self.dim} on axis {self.split_dim}, got {tuple(x.shape)}')
        chunks = x.chunk(self.groups, dim=self.split_dim)

        shared_dropout_index = None
        if self.training and self.rvqs[0].quantize_dropout:
            shared_dropout_index = (rand_quantize_dropout_index if rand_quantize_dropout_index is not None
                                    else self.rvqs[0].draw_dropout_index())

        out = tuple(rvq(chunk, return_all_codes=return_all_codes, rand_quantize_dropout_index=shared_dropout_index)
                    for rvq, chunk in zip(self.rvqs, chunks))
        quantized, all_indices, *maybe_all_codes = tuple(zip(*out))
        quantized = torch.cat(quantized, dim=self.split_dim)
        all_indices = torch.stack(all_indices)
        return (quantized, all_indices, *maybe_all_codes)
