"""K-means codebook initialization (counterpart of vqtpu/codebook/kmeans.py).

Lloyd's algorithm over the first training batch: a fixed number of
iterations, masked tokens excluded from assignments and counts. Each step
assigns with the JAX package's formulation, argmax of -cdist_sq (euclidean)
or of x.e (cosine), and sums with `code_statistics_plain`.

Data parallel (`sync_axis`): each rank draws a fixed-size candidate buffer
from its own tokens, the buffers are pooled with `all_gather`, and every
rank draws the initial means from the pool with the same stream state,
so the ranks agree without a host round trip; the bins and sums of each
step are psum'd over the axis.

Row-sharded (`code_axis`): each rank draws and updates only its window of
the centroids. The initial draw is the global index vector, drawn with the
stream every rank of the axis holds in the same state, of which each
rank keeps its window (what the unsharded draw gives those rows); with
`sync_axis` each slot also draws the data rank it comes from, and the
candidates are summed over the data axis from that rank alone. Each step
assigns with `parallel.shard.sharded_nearest_code` (the selection kernel
on the rank's rows on the card) and sums with `code_sums`, every token of
another rank's centroids sent to a dump row.

`torch.ops.vqtpu.kmeans` is `kmeans` as a custom op keyed by a stream
state (`RandomStream.split`) that returns at once when its `skip` flag is
set: until a codebook has seen a forward, its init calls it with its
`initted` flag (a loaded codebook may be initted already), the JAX
package's `lax.cond` as a select. A compiled step then holds one opaque
call in place of the unrolled Lloyd loop, which it would trace and compile
in every layer that shares the codebook, and no `torch.cond`: inductor
and AOTAutograd (torch 2.11) did not cache a graph that held one, so such
a step compiled anew, for minutes, in every process. After that forward
the codebook skips the op (`Codebook.init_embed_`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.sampling import RandomStream, masked_sample_indices, masked_sample_vectors, randint
from ..core.utils import cdist_sq, l2norm
from ..kernels.train_fused import code_statistics_plain, code_sums
from ..parallel import collectives


def sample_means(
    generator: RandomStream,
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


def sharded_draw(
    generator: RandomStream,
    samples: torch.Tensor,
    mask: torch.Tensor | None,
    num: int,
    code_axis: str,
    sync_axis: str | None,
) -> torch.Tensor:
    """This rank's window of a draw of `num` rows of (n, d) `samples` (the
    rows where `mask` is True) for a codebook sharded over `code_axis`:
    (num / axis size, d). The global index vector comes from `generator`;
    with `sync_axis`, each slot's data rank is drawn too, and a slot takes
    its row from that rank's samples (a psum over the data axis)."""
    world = collectives.axis_size(code_axis)
    c_local = num // world
    row0 = collectives.axis_index(code_axis) * c_local
    idx = masked_sample_indices(generator, samples.shape[0], mask, num, samples.device)
    cand = samples.index_select(0, idx[row0:row0 + c_local])
    if sync_axis is None:
        return cand
    src = randint(generator, collectives.axis_size(sync_axis), num, samples.device)[row0:row0 + c_local]
    mine = (src == collectives.axis_index(sync_axis))[:, None]
    return collectives.psum(torch.where(mine, cand, 0.0), sync_axis)


def pool_candidates(generator: RandomStream, local: torch.Tensor, sync_axis: str | None) -> torch.Tensor:
    """(h, num, d) candidates of this rank -> (h, num, d) drawn with
    replacement from every rank's, the same rows on every rank (each rank's
    stream in the same state); the identity without `sync_axis`."""
    if sync_axis is None:
        return local
    pooled = collectives.all_gather(local, sync_axis, concat_axis=1)      # (h, world * num, d)
    return torch.stack([masked_sample_vectors(generator, p, None, local.shape[1]) for p in pooled])


def kmeans(
    generator: RandomStream,
    samples: torch.Tensor,
    num_clusters: int,
    num_iters: int = 10,
    use_cosine_sim: bool = False,
    mask: torch.Tensor | None = None,
    sync_axis: str | None = None,
    code_axis: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, n, d) samples -> (means (h, c, d), bins (h, c)); with
    `sync_axis`, over the tokens of every rank; with `code_axis` (bound),
    this rank's window of the centroids, (h, c_local, d) and (h, c_local)."""
    from ..parallel.shard import local_or_dump, sharded_nearest_code

    h = samples.shape[0]
    samples = samples.float()
    if code_axis is not None:
        means = torch.stack([
            sharded_draw(generator, s, None if mask is None else mask[i], num_clusters, code_axis, sync_axis)
            for i, s in enumerate(samples)
        ])
    else:
        means = pool_candidates(generator, sample_means(generator, samples, mask, num_clusters), sync_axis)
    c_rows = means.shape[1]
    weights = None if mask is None else mask.float()
    metric = 'cosine' if use_cosine_sim else 'euclidean'

    bins = torch.zeros(h, c_rows, device=samples.device)
    for _ in range(num_iters):
        if code_axis is not None:
            row0 = collectives.axis_index(code_axis) * c_rows
            buckets = torch.stack([
                local_or_dump(sharded_nearest_code(s, m, code_axis, metric), c_rows, row0)
                for s, m in zip(samples, means)
            ])
            bins, new_means = code_sums(samples.contiguous(), buckets, c_rows + 1,
                                        None if weights is None else weights.contiguous())
            bins, new_means = bins[:, :c_rows], new_means[:, :c_rows]
        else:
            if use_cosine_sim:
                dists = samples @ means.transpose(-1, -2)
            else:
                dists = -cdist_sq(samples, means)
            buckets = dists.argmax(-1)                            # (h, n)
            bins, new_means = code_statistics_plain(samples, buckets, num_clusters, weights)
        bins = collectives.psum(bins, sync_axis)
        new_means = collectives.psum(new_means, sync_axis)

        zero_mask = bins == 0
        new_means = new_means / torch.where(zero_mask, 1.0, bins)[..., None]
        if use_cosine_sim:
            new_means = l2norm(new_means)
        means = torch.where(zero_mask[..., None], means, new_means)
    return means, bins


@torch.library.custom_op('vqtpu::kmeans', mutates_args=())
def kmeans_op(
    samples: torch.Tensor, key: torch.Tensor, num_clusters: int, num_iters: int, use_cosine_sim: bool,
    mask: Optional[torch.Tensor], sync_axis: Optional[str], code_axis: Optional[str], skip: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`kmeans` drawing from a stream with the state `key` (left as it
    is), as an op: (means, bins), both float32; when the 0-d bool `skip`
    is set (read on the host), ones of their shapes and no work."""
    if bool(skip):
        return _ones_like_result(samples, num_clusters, code_axis)
    return kmeans(RandomStream(key.clone()), samples, num_clusters, num_iters=num_iters,
                  use_cosine_sim=use_cosine_sim, mask=mask, sync_axis=sync_axis, code_axis=code_axis)


def _ones_like_result(samples, num_clusters, code_axis, make=torch.Tensor.new_ones):
    h, _, d = samples.shape
    rows = num_clusters // collectives.axis_size(code_axis)
    return make(samples, (h, rows, d), dtype=torch.float32), make(samples, (h, rows), dtype=torch.float32)


@kmeans_op.register_fake
def _(samples, key, num_clusters, num_iters, use_cosine_sim, mask, sync_axis, code_axis, skip):
    return _ones_like_result(samples, num_clusters, code_axis, torch.Tensor.new_empty)
