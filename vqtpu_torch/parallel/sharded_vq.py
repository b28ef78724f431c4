"""A functional EMA engine for row-sharded codebooks (counterpart of
vqtpu/parallel/sharded_vq.py).

Called with a mesh bound, by every rank of the `code` axis with the same
tokens (and, with a data axis, by each data rank with its own):

  - `sharded_quantize`: the nearest code of the whole codebook
    (`shard.sharded_nearest_code`: the selection kernel on the rank's rows,
    the winners reduced over `code`) and its row from the rank that owns it
    (`shard.sharded_gather_codes`);
  - `ShardedCodebookState` / `sharded_ema_update`: EMA statistics kept
    with the rows. Each rank sums the tokens of its own codes with
    `code_sums` (the fused train kernel's statistics passes on the card),
    every token of another rank's codes sent to a dump row c_local that is
    dropped; the sums psum over `data`, and the laplace smoothing takes the
    total mass of every rank's rows (psum over `code`), so the state
    matches the unsharded engine's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.train_fused import code_sums
from . import collectives
from .shard import code_row0, local_or_dump, sharded_gather_codes, sharded_nearest_code


class ShardedCodebookState(NamedTuple):
    """Row-sharded EMA codebook state: the rank's rows."""
    embed: torch.Tensor          # (c_local, d)
    embed_avg: torch.Tensor      # (c_local, d)
    cluster_size: torch.Tensor   # (c_local,)


def init_sharded_codebook(embed_shard: torch.Tensor) -> ShardedCodebookState:
    return ShardedCodebookState(
        embed=embed_shard,
        embed_avg=embed_shard.float().clone(),
        cluster_size=torch.ones(embed_shard.shape[0], device=embed_shard.device),
    )


def sharded_quantize(
    x: torch.Tensor, embed_shard: torch.Tensor, code_axis: str, metric: str = 'euclidean',
) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, d) tokens against the rank's (c_local, d) rows -> (global int32
    indices, quantized rows, bit-equal to codebook rows)."""
    idx = sharded_nearest_code(x, embed_shard, code_axis, metric)
    return idx, sharded_gather_codes(embed_shard, idx, code_axis)


@torch.no_grad()
def sharded_ema_update(
    state: ShardedCodebookState,
    x: torch.Tensor,
    global_idx: torch.Tensor,
    *,
    code_axis: str,
    data_axis: str | None = None,
    decay: float = 0.99,
    eps: float = 1e-5,
) -> ShardedCodebookState:
    """One EMA update of row-sharded state (track -> ema -> laplace
    normalize, as Codebook.update_codebook). x: (n, d) this data rank's
    tokens; global_idx: (n,) their global codes. Statistics psum over
    `data_axis` (None: no data parallelism); the laplace denominator psums
    the cluster mass over `code_axis`."""
    c_local = state.embed.shape[0]
    local = local_or_dump(global_idx, c_local, code_row0(code_axis, c_local))
    bins, embed_sum = code_sums(x.float().contiguous(), local.contiguous(), c_local + 1)
    bins = collectives.psum(bins[:c_local], data_axis)
    embed_sum = collectives.psum(embed_sum[:c_local], data_axis)

    # the lerp form of the unsharded engine (Codebook._ema_inplace)
    cluster_size = state.cluster_size + (bins - state.cluster_size) * (1.0 - decay)
    embed_avg = state.embed_avg + (embed_sum - state.embed_avg) * (1.0 - decay)

    c_global = c_local * collectives.axis_size(code_axis)
    total = collectives.psum(cluster_size.sum(), code_axis)
    smoothed = (cluster_size + eps) / (total + c_global * eps) * total
    embed = embed_avg / smoothed[:, None]
    return ShardedCodebookState(embed=embed.to(state.embed.dtype), embed_avg=embed_avg,
                                cluster_size=cluster_size)
