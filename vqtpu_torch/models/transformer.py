"""A small pre-norm transformer encoder, the FVQ `vq_bridge` over a
codebook (counterpart of vqtpu/models/transformer.py).

Plain torch, no kernel: the JAX package leaves this to XLA. The numerics
follow flax's modules: LayerNorm with epsilon 1e-6, `jax.nn.gelu`'s tanh
approximation, and flax's MultiHeadAttention (queries scaled by
1/sqrt(head_dim) before the dot product, softmax over the keys). The
attention projections are `nn.Linear`s over all heads at once; flax keeps
their kernels as (in, heads, head_dim) and (heads, head_dim, out), which
`load_vqtpu_state` folds into the Linear weights by the rules that
`HeadsIn` and `HeadsOut` declare.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.utils import resolve_device


class HeadsIn(nn.Linear):
    """A query, key or value projection: (..., dim) -> (..., heads *
    head_dim). flax's kernel (in, heads, head_dim) and bias (heads,
    head_dim) are this Linear's weight and bias with the heads folded."""

    flax_leaf_rules = {'kernel': ('weight', lambda a: a.reshape(a.shape[0], -1).T),
                       'bias': ('bias', lambda a: a.reshape(-1))}


class HeadsOut(nn.Linear):
    """The attention's output projection: (..., heads * head_dim) -> (...,
    out). flax's kernel is (heads, head_dim, out)."""

    flax_leaf_rules = {'kernel': ('weight', lambda a: a.reshape(-1, a.shape[-1]).T), 'bias': ('bias', None)}


class MultiHeadAttention(nn.Module):
    """Self-attention of flax's `nnx.MultiHeadAttention(num_heads=heads,
    in_features=dim)` without a mask or dropout."""

    def __init__(self, dim: int, heads: int, *, device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        if dim % heads:
            raise ValueError(f'dim {dim} is not a multiple of heads {heads}')
        self.heads = heads
        self.query = HeadsIn(dim, dim, device=device)
        self.key = HeadsIn(dim, dim, device=device)
        self.value = HeadsIn(dim, dim, device=device)
        self.out = HeadsOut(dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *lead, n, dim = x.shape
        head_dim = dim // self.heads

        def split(t):
            return t.reshape(*lead, n, self.heads, head_dim)

        q = split(self.query(x)) / math.sqrt(head_dim)
        k = split(self.key(x))
        v = split(self.value(x))
        weights = torch.einsum('...qhd,...khd->...hqk', q, k).softmax(-1)
        out = torch.einsum('...hqk,...khd->...qhd', weights, v)
        return self.out(out.reshape(*lead, n, dim))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 4, ff_mult: int = 4, *,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.attn = MultiHeadAttention(dim, heads, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.ff1 = nn.Linear(dim, dim * ff_mult, device=device)
        self.ff2 = nn.Linear(dim * ff_mult, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ff2(F.gelu(self.ff1(self.norm2(x)), approximate='tanh'))


class MiniEncoder(nn.Module):
    """Pre-norm encoder with learned memory tokens, a vq_bridge: maps a
    (h, c, d) codebook to a transformed (h, c, d) codebook, the memory
    tokens prepended to each head's codes and dropped after the blocks.
    `input_dim` other than `dim` adds bias-free in and out projections, so
    the transformer runs wider than the codebook (the FVQ example's vq_dim
    256 over a codebook dim of 32)."""

    def __init__(
        self,
        dim: int,
        depth: int = 1,
        heads: int = 4,
        num_memory_tokens: int = 2,
        input_dim: int | None = None,
        *,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.memory_tokens = nn.Parameter(torch.randn(num_memory_tokens, dim, device=device) * 0.02)
        self.blocks = nn.ModuleList(EncoderBlock(dim, heads, device=device) for _ in range(depth))
        self.num_memory_tokens = num_memory_tokens
        if input_dim is not None and input_dim != dim:
            self.proj_in = nn.Linear(input_dim, dim, bias=False, device=device)
            self.proj_out = nn.Linear(dim, input_dim, bias=False, device=device)
        else:
            self.proj_in = None
            self.proj_out = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., n, d) -> (..., n, d)."""
        lead = x.shape[:-2]
        n, d_in = x.shape[-2:]
        x = x.reshape(-1, n, d_in)
        if self.proj_in is not None:
            x = self.proj_in(x)
        mem = self.memory_tokens[None].expand(x.shape[0], -1, -1)
        x = torch.cat((mem, x), dim=1)
        for block in self.blocks:
            x = block(x)
        x = x[:, self.num_memory_tokens:]
        if self.proj_out is not None:
            x = self.proj_out(x)
        return x.reshape(*lead, n, -1)
