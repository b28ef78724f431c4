"""Convolutional autoencoder around a quantizer (counterpart of
vqtpu/models/autoencoder.py).

Tensors are NHWC at the public boundary, as in the JAX package; the
convolutions run in PyTorch's NCHW inside. flax's `Conv(padding='SAME')`
with a 3x3 kernel is `padding=1`, its 2x2 VALID max pool is
`F.max_pool2d(2)`, and `jax.nn.gelu` is the tanh approximation.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..core.utils import resolve_device


def _upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """(b, c, h, w) nearest-neighbour 2x upsample."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class ConvEncoder(nn.Module):
    """(b, h, w, in_ch) -> (b, h/4, w/4, dim)."""

    def __init__(self, dim: int = 32, in_channels: int = 1, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.conv1 = nn.Conv2d(in_channels, 16, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(16, dim, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(self.conv1(x), 2)
        x = F.gelu(x, approximate='tanh')
        x = F.max_pool2d(self.conv2(x), 2)
        return x.permute(0, 2, 3, 1)


class ConvDecoder(nn.Module):
    """(b, h/4, w/4, dim) -> (b, h, w, out_ch)."""

    def __init__(self, dim: int = 32, out_channels: int = 1, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.conv1 = nn.Conv2d(dim, 16, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(16, out_channels, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _upsample_nearest_2x(x.permute(0, 3, 1, 2))
        x = F.gelu(self.conv1(x), approximate='tanh')
        x = _upsample_nearest_2x(x)
        return self.conv2(x).permute(0, 2, 3, 1)


class SimpleQuantizeAutoEncoder(nn.Module):
    """conv encoder -> quantizer (on flattened tokens) -> conv decoder.

    The quantizer is called as `quantizer(tokens, **kwargs)`, or through
    `quantizer_call(quantizer, tokens, **kwargs)`; its first output is the
    quantized tokens and any further outputs are passed through.
    """

    def __init__(
        self,
        quantizer: nn.Module,
        dim: int = 32,
        in_channels: int = 1,
        quantizer_call: Callable | None = None,
        *,
        device=None,
    ):
        super().__init__()
        self.encoder = ConvEncoder(dim, in_channels, device=device)
        self.quantizer = quantizer
        self.decoder = ConvDecoder(dim, in_channels, device=device)
        self.quantizer_call = quantizer_call

    def forward(self, x: torch.Tensor, **kwargs):
        z = self.encoder(x)                                  # (b, h', w', d)
        b, h, w, d = z.shape
        tokens = z.reshape(b, h * w, d)
        if self.quantizer_call is not None:
            out = self.quantizer_call(self.quantizer, tokens, **kwargs)
        else:
            out = self.quantizer(tokens, **kwargs)
        quantized, *rest = out
        recon = self.decoder(quantized.reshape(b, h, w, d))
        return (recon, *rest)
