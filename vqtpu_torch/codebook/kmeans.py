"""K-means codebook initialization (counterpart of vqtpu/codebook/kmeans.py,
without its row-sharded `code_axis`).

Lloyd's algorithm over the first training batch: a fixed number of
iterations, masked tokens excluded from assignments and counts. Each step
assigns with the JAX package's formulation, argmax of -cdist_sq (euclidean)
or of x.e (cosine), and sums with `code_statistics_plain`.

Data parallel (`sync_axis`): each rank draws a fixed-size candidate buffer
from its own tokens, the buffers are pooled with `all_gather`, and every
rank draws the initial means from the pool with the same generator state,
so the ranks agree without a host round trip; the bins and sums of each
step are psum'd over the axis.
"""

from __future__ import annotations

import torch

from ..core.sampling import masked_sample_vectors
from ..core.utils import cdist_sq, l2norm
from ..kernels.train_fused import code_statistics_plain
from ..parallel import collectives


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


def pool_candidates(generator: torch.Generator, local: torch.Tensor, sync_axis: str | None) -> torch.Tensor:
    """(h, num, d) candidates of this rank -> (h, num, d) drawn with
    replacement from every rank's, the same rows on every rank (each rank's
    generator in the same state); the identity without `sync_axis`."""
    if sync_axis is None:
        return local
    pooled = collectives.all_gather(local, sync_axis, concat_axis=1)      # (h, world * num, d)
    return torch.stack([masked_sample_vectors(generator, p, None, local.shape[1]) for p in pooled])


def kmeans(
    generator: torch.Generator,
    samples: torch.Tensor,
    num_clusters: int,
    num_iters: int = 10,
    use_cosine_sim: bool = False,
    mask: torch.Tensor | None = None,
    sync_axis: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, n, d) samples -> (means (h, c, d), bins (h, c)); with
    `sync_axis`, over the tokens of every rank."""
    h = samples.shape[0]
    samples = samples.float()
    means = pool_candidates(generator, sample_means(generator, samples, mask, num_clusters), sync_axis)
    weights = None if mask is None else mask.float()

    bins = torch.zeros(h, num_clusters, device=samples.device)
    for _ in range(num_iters):
        if use_cosine_sim:
            dists = samples @ means.transpose(-1, -2)
        else:
            dists = -cdist_sq(samples, means)
        buckets = dists.argmax(-1)                                # (h, n)
        bins, new_means = code_statistics_plain(samples, buckets, num_clusters, weights)
        bins = collectives.psum(bins, sync_axis)
        new_means = collectives.psum(new_means, sync_axis)

        zero_mask = bins == 0
        new_means = new_means / torch.where(zero_mask, 1.0, bins)[..., None]
        if use_cosine_sim:
            new_means = l2norm(new_means)
        means = torch.where(zero_mask[..., None], means, new_means)
    return means, bins
