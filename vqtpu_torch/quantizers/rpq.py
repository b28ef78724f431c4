"""RandomProjectionQuantizer (counterpart of vqtpu/quantizers/rpq.py).

BEST-RQ (https://arxiv.org/abs/2202.01855): frozen xavier-normal random
projections, one per codebook head, a LayerNorm without scale or bias on
the input, and a cosine-similarity VectorQuantize with a codebook per head
that stays in eval mode for good. Returns the indices, or the cross
entropy against given indices. On the card the forward is one launch of
the selection kernel over all heads; the cross entropy (`indices=`) takes
the distance path and launches none.

The LayerNorm's epsilon is flax's 1e-6. flax computes the variance as
E[x^2] - E[x]^2 and torch as E[(x - E[x])^2], so the two normalize to
within f32 rounding of each other, not bit for bit.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.utils import resolve_device
from .vq import VectorQuantize


class RandomProjectionQuantizer(nn.Module):
    def __init__(
        self,
        *,
        dim: int,
        codebook_size: int,
        codebook_dim: int,
        num_codebooks: int = 1,
        norm: bool = True,
        rngs=None,
        device: str | torch.device | None = None,
        **kwargs,
    ):
        """`device` as for VectorQuantize; `rngs` must be None (the
        projections come from torch's global generator). `kwargs` go to the
        VectorQuantize."""
        super().__init__()
        if rngs is not None:
            raise TypeError('rngs is a flax RNG stream; seed torch with torch.manual_seed instead')
        device = resolve_device(device)
        self.num_codebooks = num_codebooks
        # xavier-normal: std = sqrt(2 / (fan_in + fan_out))
        std = (2.0 / (dim + codebook_dim)) ** 0.5
        self.register_buffer('rand_projs', torch.randn(num_codebooks, dim, codebook_dim, device=device) * std)
        self.norm = nn.LayerNorm(dim, eps=1e-6, elementwise_affine=False, device=device) if norm else None
        self.vq = VectorQuantize(
            dim=codebook_dim * num_codebooks,
            heads=num_codebooks,
            codebook_size=codebook_size,
            use_cosine_sim=True,
            separate_codebook_per_head=True,
            device=device,
            **kwargs,
        ).eval()

    def train(self, mode: bool = True):
        super().train(mode)
        # the VectorQuantize stays frozen
        self.vq.eval()
        return self

    def forward(self, x: torch.Tensor, indices: torch.Tensor | None = None):
        """(b, n, dim) -> indices (b, n, num_codebooks) int32, or with
        `indices` the cross entropy of the distances against them."""
        if self.norm is not None:
            x = self.norm(x)
        # a bf16 or fp16 input meets the f32 projections in f32, as JAX promotes it
        x = torch.einsum('bnd,hde->bnhe', x.to(self.rand_projs.dtype), self.rand_projs)
        x = x.reshape(*x.shape[:2], -1)
        # (quantized, indices, loss), or (quantized, cross entropy) with indices
        return self.vq(x, indices=indices)[1]
