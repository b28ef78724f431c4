"""The codebook (counterpart of vqtpu/codebook/codebook.py).

Holds the codebook state as buffers with the JAX package's names and shapes
(embed (h, c, d), embed_avg, cluster_size, initted, accum_cluster_size,
accum_embed_avg) and runs the eval forward: nearest-code selection and the
exact row lookup, on the exact or the bf16 tier. The training forward (EMA
statistics, kmeans init, dead-code expiry) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..core.utils import l2norm, pack_tokens, resolve_device, uniform_init
from ..kernels.distance import (
    gather_codes_per_head, nearest_code, nearest_code_xla, quantize_lookup,
)


def not_ported(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f'{feature} is not ported to vqtpu_torch yet (only the eval forward is)'
    )


class Codebook(nn.Module):
    """Euclidean or cosine codebook; eval forward only."""

    def __init__(
        self,
        dim: int,
        codebook_size: int,
        *,
        num_codebooks: int = 1,
        kmeans_init: bool = False,
        kmeans_iters: int = 10,
        sync_kmeans: bool = True,
        decay: float = 0.8,
        eps: float = 1e-5,
        threshold_ema_dead_code: float = 2,
        reset_cluster_size: float | None = None,
        sync_axis: str | None = None,
        learnable_codebook: bool = False,
        gumbel_sample_fn: Callable | None = None,
        sample_codebook_temp: float = 1.0,
        ema_update: bool = True,
        manual_ema_update: bool = False,
        affine_param: bool = False,
        sync_affine_param: bool = False,
        affine_param_batch_decay: float = 0.99,
        affine_param_codebook_decay: float = 0.9,
        use_cosine_sim: bool = False,
        vq_bridge: Callable | None = None,
        use_pallas: bool = True,
        stat_precision: str = 'highest',
        code_axis: str | None = None,
        quantize_tier: str = 'exact',
        train_fused: str = 'auto',
        device: str | torch.device | None = None,
    ):
        super().__init__()
        for feature, used in (
            ('sync_axis', sync_axis is not None),
            ('code_axis', code_axis is not None),
            ('learnable_codebook', learnable_codebook),
            ('affine_param', affine_param),
            ('vq_bridge', vq_bridge is not None),
        ):
            if used:
                raise not_ported(feature)
        if quantize_tier not in ('exact', 'bf16'):
            raise ValueError(f"quantize_tier must be 'exact' or 'bf16', got {quantize_tier!r}")
        device = resolve_device(device)

        # the settings only the training forward reads (decay, eps, kmeans
        # iterations, dead-code threshold, EMA and affine options, sampling,
        # stat_precision, train_fused) are accepted for the JAX signature and
        # not used until that forward is ported
        self.dim = dim
        self.codebook_size = codebook_size
        self.num_codebooks = num_codebooks
        self.kmeans_init = kmeans_init
        self.use_cosine_sim = use_cosine_sim
        self.use_pallas = use_pallas
        self.quantize_tier = quantize_tier

        shape = (num_codebooks, codebook_size, dim)
        if kmeans_init:
            embed = torch.zeros(shape, device=device)
        else:
            embed = uniform_init(shape, device)
            if use_cosine_sim:
                embed = l2norm(embed)

        self.register_buffer('embed', embed)
        self.register_buffer('embed_avg', embed.clone())
        self.register_buffer('cluster_size', torch.ones(shape[:2], device=device))
        self.register_buffer('initted', torch.tensor(not kmeans_init, device=device))
        self.register_buffer('accum_cluster_size', torch.zeros(shape[:2], device=device))
        self.register_buffer('accum_embed_avg', torch.zeros(shape, device=device))

    def transform_input(self, x: torch.Tensor) -> torch.Tensor:
        return l2norm(x) if self.use_cosine_sim else x

    def forward(
        self,
        x: torch.Tensor,
        *,
        sample_codebook_temp: float | None = None,
        mask: torch.Tensor | None = None,
        freeze_codebook: bool = False,
        codebook_transform_fn: Callable | None = None,
        ema_update_weight=None,
        accum_ema_update: bool = False,
        ema_update: bool | None = None,
        topk: int | None = None,
        update_usage: bool = True,
        need_distances: bool = True,
        stochastic: bool = False,
        straight_through_onehot: bool = False,
        dist_precision=None,
    ) -> tuple[torch.Tensor, torch.Tensor, None]:
        """Quantize (h?, b, n, d) tokens -> (quantize, indices int32, None).

        Eval only. `mask` only weights training statistics, so it has no
        effect here; the quantizer applies it to the outputs. Arguments that
        only the training forward reads (sample_codebook_temp,
        freeze_codebook, ema_update_weight, accum_ema_update, ema_update,
        update_usage, dist_precision) are accepted and have no effect.
        """
        if self.training:
            raise not_ported(
                'the training-mode forward (EMA update, kmeans init, '
                'dead-code expiry); call .eval()'
            )
        for feature, used in (
            ('need_distances=True (the distance-materializing path)', need_distances),
            ('topk=', topk is not None),
            ('codebook_transform_fn=', codebook_transform_fn is not None),
            ('stochastic sampling', stochastic),
            ('gumbel straight-through sampling', straight_through_onehot),
        ):
            if used:
                raise not_ported(feature)
        if self.kmeans_init and not bool(self.initted):
            raise not_ported('kmeans_init on a codebook that was never initialised')

        needs_codebook_dim = x.ndim < 4
        x = x.float()
        if needs_codebook_dim:
            x = x[None]
        flatten, unpack = pack_tokens(x)                          # (h, N, d)
        flatten = flatten.contiguous()
        embed = self.embed
        if embed.shape[0] != flatten.shape[0]:
            raise ValueError(
                f'{flatten.shape[0]} head groups of tokens for '
                f'{embed.shape[0]} codebooks'
            )
        metric = 'cosine' if self.use_cosine_sim else 'euclidean'

        if self.quantize_tier == 'bf16':
            embed_ind, quantize = quantize_lookup(flatten, embed, metric, tier='bf16')
        else:
            if self.use_pallas:
                embed_ind = nearest_code(flatten, embed, metric)
            else:
                embed_ind = nearest_code_xla(flatten, embed, metric)
            quantize = gather_codes_per_head(embed, embed_ind)

        quantize = unpack(quantize)
        embed_ind = unpack(embed_ind)
        if needs_codebook_dim:
            quantize = quantize[0]
            embed_ind = embed_ind[0]
        return quantize, embed_ind, None
