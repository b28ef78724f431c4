"""Codebook usage metrics (counterpart of vqtpu/core/metrics.py):
perplexity and utilization of a batch of indices or of the EMA cluster
sizes. Perplexity is the parity metric of the repo's baseline."""

from __future__ import annotations

import torch


def index_histogram(
    indices: torch.Tensor,
    codebook_size: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """(codebook_size,) float32 counts of each code in `indices` (any shape;
    -1 marks padding and is not counted)."""
    flat = indices.reshape(-1).long()
    valid = flat >= 0
    if mask is not None:
        valid = valid & mask.reshape(-1).bool()
    # 0/1 weights: every partial count is an exact integer in float32
    return torch.bincount(
        torch.where(valid, flat, 0), weights=valid.float(), minlength=codebook_size
    ).float()


def perplexity_from_histogram(counts: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """exp(entropy) of the code distribution over the last axis: 1 when
    collapsed, codebook_size when usage is uniform."""
    total = counts.sum(-1, keepdim=True).clamp_min(eps)
    probs = counts / total
    entropy = -(probs * probs.clamp_min(eps).log()).sum(-1)
    return entropy.exp()


def codebook_perplexity(
    indices: torch.Tensor, codebook_size: int, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Perplexity of the code distribution in a batch of indices."""
    return perplexity_from_histogram(index_histogram(indices, codebook_size, mask))


def codebook_utilization(
    indices: torch.Tensor, codebook_size: int, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Fraction of codes hit at least once in the batch."""
    return (index_histogram(indices, codebook_size, mask) > 0).float().mean()


def ema_perplexity(cluster_size: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Perplexity of the EMA cluster sizes, (c,) or (h, c), over the last
    axis."""
    return perplexity_from_histogram(cluster_size, eps)


def ema_utilization(cluster_size: torch.Tensor, threshold: float = 1e-3) -> torch.Tensor:
    """Fraction of codes whose EMA cluster size exceeds `threshold`."""
    return (cluster_size > threshold).float().mean()
