"""ResidualLFQ and GroupedResidualLFQ (counterpart of
vqtpu/composite/residual_lfq.py).

A residual stack of LFQ layers, layer i with codebook_scale = 2^-i and a
soft input clamp that halves from layer to layer, with quantize dropout:
in training, the layers after a drawn index give zeros, index -1 and no
loss. The draw comes from `self.generator`, or from
`rand_quantize_dropout_index` when the caller gives it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core.sampling import attach_stream, quantize_dropout_index
from ..core.utils import exists, resolve_device
from ..quantizers.lfq import LFQ


class ResidualLFQ(nn.Module):
    def __init__(
        self,
        *,
        dim: int,
        num_quantizers: int,
        codebook_size: int,
        quantize_dropout: bool = False,
        quantize_dropout_cutoff_index: int = 0,
        quantize_dropout_multiple_of: int = 1,
        soft_clamp_input_value: float | None = None,
        rngs=None,
        device: str | torch.device | None = None,
        **kwargs,
    ):
        """`device` as for LFQ; `rngs` must be None (see LFQ). Other kwargs
        go to every layer."""
        super().__init__()
        if rngs is not None:
            raise TypeError('rngs is a flax RNG stream; seed torch with torch.manual_seed instead')
        device = resolve_device(device)
        codebook_dim = int(math.log2(codebook_size))

        requires_projection = codebook_dim != dim
        self.project_in = nn.Linear(dim, codebook_dim, device=device) if requires_projection else None
        self.project_out = nn.Linear(codebook_dim, dim, device=device) if requires_projection else None
        self.has_projections = requires_projection
        self.num_quantizers = num_quantizers

        layers = []
        for ind in range(num_quantizers):
            layers.append(LFQ(dim=codebook_dim, codebook_scale=2 ** -ind,
                              soft_clamp_input_value=soft_clamp_input_value, device=device, **kwargs))
            if exists(soft_clamp_input_value):
                soft_clamp_input_value *= 0.5
        self.layers = nn.ModuleList(layers)
        if any(lfq.has_projections for lfq in self.layers):
            raise ValueError('the layers of a ResidualLFQ take codebook_dim inputs and have no projections')

        self.quantize_dropout = quantize_dropout and num_quantizers > 1
        if quantize_dropout_cutoff_index < 0:
            raise ValueError('quantize_dropout_cutoff_index must be >= 0')
        self.quantize_dropout_cutoff_index = quantize_dropout_cutoff_index
        self.quantize_dropout_multiple_of = quantize_dropout_multiple_of
        self.generator = attach_stream(self, device)

    @property
    def codebooks(self) -> torch.Tensor:
        return torch.stack([layer.codebook for layer in self.layers])

    def get_codes_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """(b, ..., q) indices, -1 where dropped -> (num_quantizers, b, ..., d) codes."""
        lead_shape = indices.shape[:-1]
        quantize_dim = indices.shape[-1]
        ind = indices.reshape(indices.shape[0], -1, quantize_dim).long()

        if quantize_dim < self.num_quantizers:
            if not self.quantize_dropout:
                raise ValueError('quantize dropout must be greater than 0 if you wish to '
                                 'reconstruct from a signal with less fine quantizations')
            ind = torch.nn.functional.pad(ind, (0, self.num_quantizers - quantize_dim), value=-1)

        dropout_mask = ind == -1
        ind = ind.masked_fill(dropout_mask, 0)
        codebooks = self.codebooks                                         # (q, K, d)
        all_codes = torch.stack([codebooks[q][ind[..., q]] for q in range(self.num_quantizers)])
        all_codes = all_codes.masked_fill(dropout_mask.movedim(-1, 0)[..., None], 0.0)
        return all_codes.reshape(self.num_quantizers, *lead_shape, -1)

    def get_output_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        summed = self.get_codes_from_indices(indices).sum(0)
        if self.project_out is not None:
            summed = self.project_out(summed)
        return summed

    def draw_dropout_index(self) -> torch.Tensor:
        return quantize_dropout_index(self.generator, self.quantize_dropout_cutoff_index, self.num_quantizers,
                                      self.quantize_dropout_multiple_of)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None, return_all_codes: bool = False,
                rand_quantize_dropout_index: int | torch.Tensor | None = None):
        if self.project_in is not None:
            x = self.project_in(x.to(self.project_in.weight.dtype))

        quantized_out = torch.zeros_like(x, dtype=torch.float32)
        residual = x.float()
        all_losses = []
        all_indices = []

        dropout_index = None
        if self.training and self.quantize_dropout:
            dropout_index = (torch.as_tensor(rand_quantize_dropout_index, device=x.device)
                             if rand_quantize_dropout_index is not None else self.draw_dropout_index())

        for quantizer_index, layer in enumerate(self.layers):
            quantized, indices, loss = layer(residual, mask=mask)
            quantized = quantized.float()
            if dropout_index is not None:
                keep = quantizer_index <= dropout_index
                quantized = torch.where(keep, quantized, 0.0)
                indices = torch.where(keep, indices, -1)
                loss = torch.where(keep, loss, 0.0)
            residual = residual - quantized.detach()
            quantized_out = quantized_out + quantized
            all_indices.append(indices)
            all_losses.append(loss)

        quantized_out = quantized_out.to(x.dtype)
        if self.project_out is not None:
            quantized_out = self.project_out(quantized_out)

        ret = (quantized_out, torch.stack(all_indices, -1), torch.stack(all_losses, -1))
        if not return_all_codes:
            return ret
        return (*ret, self.get_codes_from_indices(ret[1]))


class GroupedResidualLFQ(nn.Module):
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
        self.rvqs = nn.ModuleList(
            ResidualLFQ(dim=dim // groups, device=device, **kwargs) for _ in range(groups)
        )

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

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None, return_all_codes: bool = False,
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

        out = tuple(
            rvq(chunk, mask=mask, return_all_codes=return_all_codes,
                rand_quantize_dropout_index=shared_dropout_index)
            for rvq, chunk in zip(self.rvqs, chunks)
        )
        quantized, all_indices, commit_losses, *maybe_all_codes = tuple(zip(*out))
        quantized = torch.cat(quantized, dim=self.split_dim)
        all_indices = torch.stack(all_indices)
        commit_losses = torch.stack(commit_losses)
        return (quantized, all_indices, commit_losses, *maybe_all_codes)
