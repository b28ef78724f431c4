"""ResidualSimVQ (counterpart of vqtpu/composite/residual_sim_vq.py).

A residual stack of SimVQ layers: each quantizes what the layers before it
left, `residual - quantized.detach()`. Quantize dropout as in the JAX
package: in training every layer runs (on the card one selection kernel
launch a layer, and `code_sums` a layer in the backward), and the layers
after the drawn index give zeros, index -1 and loss 0. The index comes from
`self.generator`, or from `rand_quantize_dropout_index` when the caller
gives it. With the layers' `code_axis`, decoding inside a bound mesh
gathers each row from the rank that owns it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.sampling import attach_stream, quantize_dropout_index
from ..core.utils import first, resolve_device
from ..parallel.shard import sharded_gather_codes
from ..quantizers.sim_vq import SimVQ


class ResidualSimVQ(nn.Module):
    def __init__(
        self,
        *,
        dim: int,
        num_quantizers: int,
        codebook_size: int,
        heads: int = 1,
        quantize_dropout: bool = False,
        quantize_dropout_cutoff_index: int = 0,
        quantize_dropout_multiple_of: int = 1,
        channel_first: bool = False,
        rotation_trick: bool = True,
        rngs=None,
        device: str | torch.device | None = None,
        **sim_vq_kwargs,
    ):
        """`device` as for SimVQ; `rngs` must be None (seed torch with
        torch.manual_seed). The dropout draws come from `self.generator`, on
        the module's device, seeded from torch's global generator."""
        super().__init__()
        if rngs is not None:
            raise TypeError('rngs is a flax RNG stream; seed torch with torch.manual_seed instead')
        if heads != 1:
            raise ValueError('residual vq is not compatible with multi-headed codes')
        if quantize_dropout_cutoff_index < 0:
            raise ValueError('quantize_dropout_cutoff_index must be >= 0')
        device = resolve_device(device)
        self.channel_first = channel_first
        self.num_quantizers = num_quantizers
        self.layers = nn.ModuleList([
            SimVQ(dim=dim, codebook_size=codebook_size, rotation_trick=rotation_trick,
                  channel_first=channel_first, device=device, **sim_vq_kwargs)
            for _ in range(num_quantizers)
        ])
        self.quantize_dropout = quantize_dropout and num_quantizers > 1
        self.quantize_dropout_cutoff_index = quantize_dropout_cutoff_index
        self.quantize_dropout_multiple_of = quantize_dropout_multiple_of
        self.generator = attach_stream(self, device)

    @property
    def codebook_size(self) -> int:
        return first(self.layers).codebook_size

    @property
    def codebook_dim(self) -> int:
        return first(self.layers).codebook_dim

    @property
    def codebooks(self) -> torch.Tensor:
        """(q, c, dim): every layer's implicit codebook."""
        return torch.stack([layer.codebook for layer in self.layers])

    def get_codes_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """(b, ..., q') indices, q' <= q -> (q, b, ..., dim) codes (channel
        first: (q, b, dim, ...)); -1 entries, and the layers past q', give
        zero vectors."""
        lead_shape, quantize_dim = indices.shape[:-1], indices.shape[-1]
        ind = indices.reshape(indices.shape[0], -1, quantize_dim)
        if quantize_dim < self.num_quantizers:
            if not self.quantize_dropout:
                raise ValueError('quantize dropout must be greater than 0 if you wish to '
                                 'reconstruct from a signal with less fine quantizations')
            pad = ind.new_full((*ind.shape[:2], self.num_quantizers - quantize_dim), -1)
            ind = torch.cat([ind, pad], dim=-1)
        dropout_mask = ind == -1
        ind = ind.masked_fill(dropout_mask, 0).long()
        codebooks = self.codebooks
        layer0 = first(self.layers)
        if layer0._code_parallel():
            # row-sharded frozen codebooks: each row from the rank that owns it
            all_codes = torch.stack([sharded_gather_codes(codebooks[i], ind[..., i], layer0.code_axis)
                                     for i in range(self.num_quantizers)])
        else:
            all_codes = torch.stack([codebooks[i][ind[..., i]] for i in range(self.num_quantizers)])
        all_codes = all_codes.masked_fill(dropout_mask.movedim(-1, 0)[..., None], 0.0)
        all_codes = all_codes.reshape(self.num_quantizers, *lead_shape, -1)
        if self.channel_first:
            all_codes = all_codes.movedim(-1, 2)
        return all_codes

    def get_output_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        return self.get_codes_from_indices(indices).sum(0)

    def draw_dropout_index(self) -> torch.Tensor:
        """A layer index in [cutoff, q), rounded up to a multiple of
        `quantize_dropout_multiple_of` less one."""
        return quantize_dropout_index(self.generator, self.quantize_dropout_cutoff_index, self.num_quantizers,
                                      self.quantize_dropout_multiple_of)

    def forward(
        self,
        x: torch.Tensor,
        return_all_codes: bool = False,
        rand_quantize_dropout_index: int | torch.Tensor | None = None,
    ):
        """x -> (quantized, indices (..., q) int32, losses (q,)), and the
        codes of every layer with `return_all_codes`."""
        quantized_out = torch.zeros_like(x)
        residual = x
        all_losses, all_indices = [], []

        dropout_index = None
        if self.training and self.quantize_dropout:
            dropout_index = (torch.as_tensor(rand_quantize_dropout_index, device=x.device)
                             if rand_quantize_dropout_index is not None else self.draw_dropout_index())

        for quantizer_index, sim_vq in enumerate(self.layers):
            quantized, indices, loss = sim_vq(residual)
            if dropout_index is not None:
                # zeros that stay in the graph, as the JAX package's where()
                keep = quantizer_index <= dropout_index
                quantized = torch.where(keep, quantized, 0.0)
                indices = torch.where(keep, indices, -1)
                loss = torch.where(keep, loss, 0.0)
            residual = residual - quantized.detach()
            quantized_out = quantized_out + quantized
            all_indices.append(indices)
            all_losses.append(loss)

        ret = (quantized_out, torch.stack(all_indices, dim=-1), torch.stack(all_losses, dim=-1))
        if not return_all_codes:
            return ret
        return (*ret, self.get_codes_from_indices(ret[1]))
