"""K-means codebook initialization (counterpart of vqtpu/codebook/kmeans.py,
without its data-parallel `sync_axis` and row-sharded `code_axis`).

Lloyd's algorithm over the first training batch: a fixed number of
iterations, masked tokens excluded from assignments and counts. Each step
assigns with the JAX package's formulation, argmax of -cdist_sq (euclidean)
or of x.e (cosine), and sums with `code_statistics_plain`.
"""

from __future__ import annotations

import torch

from ..core.sampling import masked_sample_vectors
from ..core.utils import cdist_sq, l2norm
from ..kernels.train_fused import code_statistics_plain


def sample_means(
    generator: torch.Generator,
    samples: torch.Tensor,
    mask: torch.Tensor | None,
    num_clusters: int,
) -> torch.Tensor:
    """The initial means: (h, n, d) -> (h, num_clusters, d), rows drawn with
    replacement from each head's unmasked tokens."""
    return torch.stack([
        masked_sample_vectors(generator, s, None if mask is None else mask[i], num_clusters)
        for i, s in enumerate(samples)
    ])


def kmeans(
    generator: torch.Generator,
    samples: torch.Tensor,
    num_clusters: int,
    num_iters: int = 10,
    use_cosine_sim: bool = False,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, n, d) samples -> (means (h, c, d), bins (h, c))."""
    h = samples.shape[0]
    samples = samples.float()
    means = sample_means(generator, samples, mask, num_clusters)
    weights = None if mask is None else mask.float()

    bins = torch.zeros(h, num_clusters, device=samples.device)
    for _ in range(num_iters):
        if use_cosine_sim:
            dists = samples @ means.transpose(-1, -2)
        else:
            dists = -cdist_sq(samples, means)
        buckets = dists.argmax(-1)                                # (h, n)
        bins, new_means = code_statistics_plain(samples, buckets, num_clusters, weights)

        zero_mask = bins == 0
        new_means = new_means / torch.where(zero_mask, 1.0, bins)[..., None]
        if use_cosine_sim:
            new_means = l2norm(new_means)
        means = torch.where(zero_mask[..., None], means, new_means)
    return means, bins
