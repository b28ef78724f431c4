"""Input layout normalization (counterpart of vqtpu/core/layout.py).

Every quantizer works on (batch, tokens, dim). Channel-first sequences,
image feature maps and 3D feature maps are flattened to that layout by
`to_tokens`, and the returned `TokenLayout` restores value-shaped and
index-shaped outputs.
"""

from __future__ import annotations

from dataclasses import dataclass
import math

import torch


@dataclass(frozen=True)
class TokenLayout:
    """How an input was flattened to (b, n, d). `spatial` holds the
    flattened middle dims (in channel-last order); `moved_channel` is True
    when dim was originally axis 1."""

    batch: int
    spatial: tuple[int, ...]
    dim: int
    moved_channel: bool

    @property
    def num_tokens(self) -> int:
        return math.prod(self.spatial) if self.spatial else 1

    def restore(self, t: torch.Tensor) -> torch.Tensor:
        """(b, n, *rest) values -> the original layout; when the channel was
        moved last, the final feature axis moves back to axis 1."""
        out = t.reshape(self.batch, *self.spatial, *t.shape[2:])
        if self.moved_channel:
            out = out.movedim(-1, 1)
        return out

    def restore_indices(self, t: torch.Tensor) -> torch.Tensor:
        """(b, n, *extra) indices -> (b, *spatial, *extra)."""
        return t.reshape(self.batch, *self.spatial, *t.shape[2:])


def to_tokens(
    x: torch.Tensor,
    *,
    channel_first: bool = False,
    image_fmap: bool = False,
    fmap_3d: bool = False,
) -> tuple[torch.Tensor, TokenLayout]:
    """Normalize x to (b, n, d).

    - default: x is (b, ..., d);
    - channel_first: x is (b, d, *spatial); the channel moves last and the
      spatial dims flatten;
    - image_fmap / fmap_3d: channel_first for (b, c, h, w) / (b, c, d, h, w),
      with the rank checked.
    """
    if image_fmap:
        if x.ndim != 4:
            raise ValueError(f'image fmap must be (b, c, h, w), got {tuple(x.shape)}')
        channel_first = True
    if fmap_3d:
        if x.ndim != 5:
            raise ValueError(f'3d fmap must be (b, c, d, h, w), got {tuple(x.shape)}')
        channel_first = True

    if channel_first:
        x = x.movedim(1, -1)
        batch, *spatial, dim = x.shape
        layout = TokenLayout(batch, tuple(spatial), dim, moved_channel=True)
        return x.reshape(batch, layout.num_tokens, dim), layout

    if x.ndim < 3:
        raise ValueError(f'channel-last input must be (b, ..., d), got {tuple(x.shape)}')
    batch, *spatial, dim = x.shape
    layout = TokenLayout(batch, tuple(spatial), dim, moved_channel=False)
    return x.reshape(batch, layout.num_tokens, dim), layout
