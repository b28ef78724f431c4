"""The EMA codebook (counterpart of vqtpu/codebook/codebook.py).

Holds the codebook state as buffers with the JAX package's names and shapes
(embed (h, c, d), embed_avg, cluster_size, initted, accum_cluster_size,
accum_embed_avg) and runs both forwards:

- eval: nearest-code selection and the exact row lookup, on the exact or
  the bf16 tier;
- training: the same selection and lookup, then the EMA update in the JAX
  package's order, track -> ema -> expire, with kmeans init on the first
  batch. With `train_fused='on'` selection, lookup and batch statistics run
  in one fused kernel (`fused_train_quantize`); otherwise ('auto', 'off')
  the selection kernel with its row copy (`quantize_lookup`) and
  `code_statistics_plain`.

Buffers are updated in place under `torch.no_grad()` from detached tensors,
so no graph is kept on them from step to step. Random draws (kmeans init,
dead-code replacement) come from `self.generator`, a `torch.Generator` on
the module's device seeded from torch's global generator at construction.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..core.sampling import masked_sample_vectors
from ..core.utils import (
    append_dims_to, default, l2norm, laplace_smoothing, pack_tokens, resolve_device, uniform_init,
)
from ..kernels.distance import (
    gather_codes_per_head, nearest_code_xla, quantize_lookup,
)
from ..kernels.train_fused import code_statistics_plain, fused_train_quantize
from . import kmeans as kmeans_module


def not_ported(feature: str) -> NotImplementedError:
    return NotImplementedError(f'{feature} is not ported to vqtpu_torch yet')


def _expand_mask(mask: torch.Tensor, num_heads: int, num_tokens: int) -> torch.Tensor:
    """(b, n) -> (h, N) with N = b * inner * n, tiling over any head factor
    folded into the token axis."""
    b, n = mask.shape
    inner = num_tokens // (b * n)
    m = mask[:, None, :].expand(b, inner, n).reshape(1, num_tokens)
    return m.expand(num_heads, num_tokens)


def _prepare_ema_weight(weight, like: torch.Tensor):
    """An ema_update_weight (None, scalar, (c,) or (h, c)) broadcast against
    `like` ((h, c) or (h, c, d))."""
    if weight is None:
        return 1.0
    weight = torch.as_tensor(weight, dtype=torch.float32, device=like.device)
    if weight.ndim == 0:
        return weight
    if weight.ndim == 1:
        weight = weight[None, :]
    if tuple(weight.shape) != tuple(like.shape[:2]):
        raise ValueError(
            f'ema weight shape {tuple(weight.shape)} must match (heads, codebook_size) '
            f'{tuple(like.shape[:2])}'
        )
    return append_dims_to(weight, like.ndim)


class Codebook(nn.Module):
    """Euclidean or cosine codebook with EMA statistics, kmeans init and
    dead-code expiry."""

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
        """`use_pallas=False` selects with the JAX package's XLA formulation
        in plain torch instead of the kernels. `sync_kmeans`,
        `gumbel_sample_fn` and `sample_codebook_temp` belong to paths not
        ported yet and are accepted for the JAX signature."""
        super().__init__()
        for feature, used in (
            ('sync_axis', sync_axis is not None),
            ('code_axis', code_axis is not None),
            ('learnable_codebook', learnable_codebook),
            ('affine_param', affine_param),
            ('vq_bridge', vq_bridge is not None),
            (f'stat_precision={stat_precision!r} (only the exact f32 statistics are)',
             stat_precision != 'highest'),
        ):
            if used:
                raise not_ported(feature)
        if quantize_tier not in ('exact', 'bf16'):
            raise ValueError(f"quantize_tier must be 'exact' or 'bf16', got {quantize_tier!r}")
        if train_fused not in ('auto', 'on', 'off'):
            raise ValueError(f"train_fused must be 'auto', 'on' or 'off', got {train_fused!r}")
        device = resolve_device(device)

        self.dim = dim
        self.codebook_size = codebook_size
        self.num_codebooks = num_codebooks
        self.decay = decay
        self.eps = eps
        self.ema_update = ema_update
        self.manual_ema_update = manual_ema_update
        self.kmeans_init = kmeans_init
        self.kmeans_iters = kmeans_iters
        self.use_cosine_sim = use_cosine_sim
        self.use_pallas = use_pallas
        self.quantize_tier = quantize_tier
        self.train_fused = train_fused
        self.threshold_ema_dead_code = threshold_ema_dead_code
        self.has_dead_code_replacement = threshold_ema_dead_code > 0
        self.reset_cluster_size = default(reset_cluster_size, threshold_ema_dead_code)

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

        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(torch.randint(0, 2**62, (), dtype=torch.int64)))

    def transform_input(self, x: torch.Tensor) -> torch.Tensor:
        return l2norm(x) if self.use_cosine_sim else x

    def _train_fused_active(self) -> bool:
        """'on' takes the fused kernel; 'auto' keeps the JAX package's
        meaning, the unfused composition, as does 'off'."""
        return self.train_fused == 'on'

    # -- kmeans init ---------------------------------------------------------

    @torch.no_grad()
    def init_embed_(self, flatten: torch.Tensor, mask: torch.Tensor | None = None):
        """First-batch kmeans init; a no-op once `initted` is set."""
        if bool(self.initted):
            return
        embed, cluster_size = kmeans_module.kmeans(
            self.generator, flatten.detach(), self.codebook_size,
            num_iters=self.kmeans_iters, use_cosine_sim=self.use_cosine_sim, mask=mask,
        )
        embed_sum = embed * cluster_size[..., None]
        self.embed.copy_(self._normalized_embed(embed_sum, cluster_size))
        self.embed_avg.copy_(embed_sum)
        self.cluster_size.copy_(cluster_size)
        self.initted.fill_(True)

    # -- EMA update machinery ------------------------------------------------

    def _normalized_embed(self, embed_avg: torch.Tensor, cluster_size: torch.Tensor) -> torch.Tensor:
        smoothed = laplace_smoothing(cluster_size, self.codebook_size, self.eps)
        smoothed = smoothed * cluster_size.sum(-1, keepdim=True)
        embed_normalized = embed_avg / smoothed[..., None]
        if self.use_cosine_sim:
            embed_normalized = l2norm(embed_normalized)
        return embed_normalized

    @torch.no_grad()
    def update_ema(self):
        """embed <- laplace-smoothed embed_avg / cluster_size."""
        self.embed.copy_(self._normalized_embed(self.embed_avg, self.cluster_size))

    def _ema_inplace(self, name: str, accum_name: str, new: torch.Tensor, weight):
        """old <- lerp(old, new + pending accum, (1 - decay) * weight); drains
        the accumulator."""
        var = getattr(self, name)
        accum = getattr(self, accum_name)
        new = new + accum
        accum.zero_()
        var.copy_(var + (new - var) * ((1.0 - self.decay) * weight))

    @torch.no_grad()
    def track_cluster_size_and_embed_avg(
        self,
        flatten: torch.Tensor,
        embed_ind: torch.Tensor,
        mask: torch.Tensor | None = None,
        ema_update_weight=None,
        accum_ema_update: bool = False,
    ):
        """Fold this batch's cluster sizes and embedding sums into the EMA
        statistics, from (h, N) tokens and their indices; tokens where
        `mask` (h, N) is False count for nothing."""
        weights = None if mask is None else mask.float()
        bins, embed_sum = code_statistics_plain(
            flatten.detach().float(), embed_ind, self.codebook_size, weights
        )
        self._apply_batch_stats(bins, embed_sum, ema_update_weight, accum_ema_update)

    @torch.no_grad()
    def _apply_batch_stats(
        self,
        cluster_size: torch.Tensor,
        embed_sum: torch.Tensor,
        ema_update_weight=None,
        accum_ema_update: bool = False,
    ):
        """Fold (h, c) counts and (h, c, d) sums into the EMA state, or into
        the accumulators when `accum_ema_update`."""
        if callable(ema_update_weight):
            ema_update_weight = ema_update_weight(embed_sum, cluster_size)

        if accum_ema_update:
            self.accum_cluster_size.add_(cluster_size)
            self.accum_embed_avg.add_(embed_sum)
            return

        w_cs = _prepare_ema_weight(ema_update_weight, self.cluster_size)
        w_ea = _prepare_ema_weight(ema_update_weight, self.embed_avg)
        self._ema_inplace('cluster_size', 'accum_cluster_size', cluster_size, w_cs)
        self._ema_inplace('embed_avg', 'accum_embed_avg', embed_sum, w_ea)

    # -- dead code expiry ----------------------------------------------------

    @torch.no_grad()
    def replace(
        self,
        batch_samples: torch.Tensor,
        batch_mask: torch.Tensor,
        seq_mask: torch.Tensor | None = None,
    ):
        """Replace the codes flagged in `batch_mask` (h, c) with vectors drawn
        from the batch. As in the JAX package a candidate is drawn for every
        slot and merged with `where`, so no host sync decides the draw."""
        if self.use_cosine_sim:
            batch_samples = l2norm(batch_samples)
        batch_samples = batch_samples.detach().float()
        h = batch_samples.shape[0]
        sampled = torch.stack([
            masked_sample_vectors(
                self.generator, batch_samples[i],
                None if seq_mask is None else seq_mask[i], self.codebook_size,
            )
            for i in range(h)
        ])
        if seq_mask is not None:
            has_valid = seq_mask.any(-1)[:, None]
        else:
            has_valid = torch.ones(h, 1, dtype=torch.bool, device=batch_mask.device)
        replace_mask = batch_mask & has_valid                          # (h, c)

        self.embed.copy_(torch.where(replace_mask[..., None], sampled, self.embed))
        self.cluster_size.copy_(
            torch.where(replace_mask, self.reset_cluster_size, self.cluster_size))
        self.embed_avg.copy_(torch.where(
            replace_mask[..., None], sampled * self.reset_cluster_size, self.embed_avg))

    @torch.no_grad()
    def expire_codes_(self, batch_samples: torch.Tensor, seq_mask: torch.Tensor | None = None):
        if not self.has_dead_code_replacement or not self.training:
            return
        expired = self.cluster_size < self.threshold_ema_dead_code
        batch_samples = batch_samples.reshape(batch_samples.shape[0], -1, batch_samples.shape[-1])
        self.replace(batch_samples, batch_mask=expired, seq_mask=seq_mask)

    # -- codebook update orchestration -----------------------------------------

    @torch.no_grad()
    def update_codebook(
        self,
        flatten: torch.Tensor,
        embed_ind: torch.Tensor,
        mask: torch.Tensor | None = None,
        ema_update_weight=None,
        accum_ema_update: bool = False,
        ema_update: bool | None = None,
    ):
        """track -> ema -> expire, from (h, N) tokens and their indices."""
        ema_update = default(ema_update, self.ema_update)
        if not ema_update and not self.has_dead_code_replacement:
            return
        self.track_cluster_size_and_embed_avg(
            flatten, embed_ind, mask, ema_update_weight, accum_ema_update
        )
        self._after_batch_stats(flatten, mask, accum_ema_update, ema_update)

    @torch.no_grad()
    def update_codebook_from_stats(
        self,
        flatten: torch.Tensor,
        cluster_size: torch.Tensor,
        embed_sum: torch.Tensor,
        mask: torch.Tensor | None = None,
        ema_update_weight=None,
        accum_ema_update: bool = False,
        ema_update: bool | None = None,
    ):
        """update_codebook for batch statistics already computed (by the
        fused kernel); the same track -> ema -> expire order."""
        ema_update = default(ema_update, self.ema_update)
        if not ema_update and not self.has_dead_code_replacement:
            return
        self._apply_batch_stats(cluster_size, embed_sum, ema_update_weight, accum_ema_update)
        self._after_batch_stats(flatten, mask, accum_ema_update, ema_update)

    def _after_batch_stats(self, flatten, mask, accum_ema_update, ema_update):
        if accum_ema_update:
            return
        if ema_update and not self.manual_ema_update:
            self.update_ema()
        self.expire_codes_(flatten, seq_mask=mask)

    @torch.no_grad()
    def update_indices(
        self,
        x: torch.Tensor,
        embed_ind: torch.Tensor,
        mask: torch.Tensor | None = None,
        ema_update_weight=None,
        accum_ema_update: bool = False,
        ema_update: bool | None = None,
    ):
        """EMA update from indices chosen elsewhere (after a beam search).
        Indices of -1 count for nothing."""
        x = x.float()
        if x.ndim < 4:
            x = x[None]
            embed_ind = embed_ind[None]
        flatten, _ = pack_tokens(x)
        ind = embed_ind.reshape(x.shape[0], -1)
        if mask is not None:
            mask = _expand_mask(mask, flatten.shape[0], flatten.shape[1])
        ema_update = default(ema_update, self.ema_update)
        if not ema_update and not self.has_dead_code_replacement:
            return
        # dropped indices leave the statistics, not the expiry's sample mask
        kept = ind >= 0
        self.track_cluster_size_and_embed_avg(
            flatten, ind.clamp_min(0), kept if mask is None else mask & kept,
            ema_update_weight, accum_ema_update,
        )
        self._after_batch_stats(flatten, mask, accum_ema_update, ema_update)

    update_ema_indices = update_indices

    # -- forward ---------------------------------------------------------------

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

        The quantized rows are detached codebook rows: the EMA codebook
        takes no gradient. In training mode (and with `update_usage`, and
        without `freeze_codebook`) the batch updates the EMA state; `mask`
        (b, n) weights those statistics. `sample_codebook_temp` and
        `dist_precision` only act on the distance-materializing paths,
        which are not ported yet.
        """
        for feature, used in (
            ('need_distances=True (the distance-materializing path)', need_distances),
            ('topk=', topk is not None),
            ('codebook_transform_fn=', codebook_transform_fn is not None),
            ('stochastic sampling', stochastic),
            ('gumbel straight-through sampling', straight_through_onehot),
        ):
            if used:
                raise not_ported(feature)
        ema_update = default(ema_update, self.ema_update)

        needs_codebook_dim = x.ndim < 4
        x = x.float()
        if needs_codebook_dim:
            x = x[None]
        flatten, unpack = pack_tokens(x)                          # (h, N, d)
        flatten = flatten.detach().contiguous()
        h, num_tokens = flatten.shape[:2]
        if self.embed.shape[0] != h:
            raise ValueError(f'{h} head groups of tokens for {self.embed.shape[0]} codebooks')
        flat_mask = None if mask is None else _expand_mask(mask, h, num_tokens)

        if self.kmeans_init:
            # as in the JAX package, in either mode: a no-op once initted
            self.init_embed_(flatten, mask=flat_mask)

        embed = self.embed
        metric = 'cosine' if self.use_cosine_sim else 'euclidean'
        update = self.training and update_usage and not freeze_codebook
        fused_stats = None

        if update and self.use_pallas and self._train_fused_active():
            weights = None if flat_mask is None else flat_mask.float().contiguous()
            embed_ind, quantize, bins, esum = fused_train_quantize(
                flatten, embed, metric, weights
            )
            fused_stats = (bins, esum)
        elif not self.training and self.quantize_tier == 'bf16':
            embed_ind, quantize = quantize_lookup(flatten, embed, metric, tier='bf16')
        elif self.use_pallas:
            # on the card, selection and row copy in one kernel launch
            embed_ind, quantize = quantize_lookup(flatten, embed, metric)
        else:
            embed_ind = nearest_code_xla(flatten, embed, metric)
            quantize = gather_codes_per_head(embed, embed_ind)

        if update:
            if fused_stats is not None:
                self.update_codebook_from_stats(
                    flatten, *fused_stats, mask=flat_mask, ema_update_weight=ema_update_weight,
                    accum_ema_update=accum_ema_update, ema_update=ema_update,
                )
            else:
                self.update_codebook(
                    flatten, embed_ind, mask=flat_mask, ema_update_weight=ema_update_weight,
                    accum_ema_update=accum_ema_update, ema_update=ema_update,
                )

        quantize = unpack(quantize)
        embed_ind = unpack(embed_ind)
        if needs_codebook_dim:
            quantize = quantize[0]
            embed_ind = embed_ind[0]
        return quantize, embed_ind, None
