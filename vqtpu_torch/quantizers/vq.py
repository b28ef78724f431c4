"""VectorQuantize (counterpart of vqtpu/quantizers/vq.py).

The constructor takes the JAX module's kwargs. This port runs the eval
(serving) forward and the EMA training forward: projections, heads with
shared or separate codebooks, cosine similarity, channel-first / image / 3D
feature-map layouts, masks and lengths, both quantize tiers, decoding from
indices; in training the EMA codebook update (kmeans init, dead-code
expiry, accumulated and weighted EMA, the fused train kernel under
`train_fused='on'`), the rotation trick or straight-through gradient, and
the MSE commitment loss. The distance-materializing features, the
learnable-codebook family and distributed codebooks raise
NotImplementedError that names them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn

from ..codebook.codebook import Codebook, not_ported
from ..core.layout import to_tokens
from ..core.ste import rotate_to, straight_through
from ..core.utils import (
    append_dims_to, default, exists, lens_to_mask, masked_mean, resolve_device,
)
from ..kernels.distance import gather_codes


class LossBreakdown(NamedTuple):
    commitment: torch.Tensor
    codebook_diversity: torch.Tensor
    orthogonal_reg: torch.Tensor
    inplace_optimize: torch.Tensor


class VectorQuantize(nn.Module):
    def __init__(
        self,
        dim: int,
        codebook_size: int,
        codebook_dim: int | None = None,
        heads: int = 1,
        separate_codebook_per_head: bool = False,
        decay: float = 0.8,
        eps: float = 1e-5,
        freeze_codebook: bool = False,
        kmeans_init: bool = False,
        kmeans_iters: int = 10,
        sync_kmeans: bool = True,
        use_cosine_sim: bool = False,
        layernorm_after_project_in: bool = False,
        threshold_ema_dead_code: float = 0,
        channel_last: bool = True,
        accept_image_fmap: bool = False,
        accept_3d_fmap: bool = False,
        commitment_weight: float = 1.0,
        commitment_use_cross_entropy_loss: bool = False,
        orthogonal_reg_weight: float = 0.0,
        orthogonal_reg_active_codes_only: bool = False,
        orthogonal_reg_max_codes: int | None = None,
        codebook_diversity_loss_weight: float = 0.0,
        codebook_diversity_temperature: float = 100.0,
        stochastic_sample_codes: bool = False,
        sample_codebook_temp: float = 1.0,
        approx_topk: bool = False,
        straight_through: bool = False,
        rotation_trick: bool | None = None,
        directional_reparam: bool = False,
        directional_reparam_variance: float = 5e-3,
        sync_axis: str | None = None,
        sync_codebook: bool | str | None = None,
        code_axis: str | None = None,
        sync_affine_param: bool = False,
        ema_update: bool | None = None,
        vq_bridge: Callable | None = None,
        manual_ema_update: bool = False,
        learnable_codebook: bool | None = None,
        in_place_codebook_optimizer=None,
        manual_in_place_optimizer_update: bool = False,
        affine_param: bool = False,
        affine_param_batch_decay: float = 0.99,
        affine_param_codebook_decay: float = 0.9,
        sync_update_v: float = 0.0,
        return_zeros_for_masked_padding: bool = True,
        route_gradients_to_input: bool = True,
        use_pallas: bool = True,
        stat_precision: str = 'highest',
        quantize_tier: str = 'exact',
        train_fused: str = 'auto',
        rngs=None,
        device: str | torch.device | None = None,
    ):
        """`device`: where the module lives; the CUDA card when None (raises
        if there is none), or 'cpu'. `rngs` is kept for the JAX signature
        and must be None: initial values come from torch's global generator
        (seed it with torch.manual_seed). `use_pallas=False` selects the
        JAX package's XLA formulation (`nearest_code_xla`) in plain torch
        instead of the kernel."""
        super().__init__()
        if rngs is not None:
            raise TypeError(
                'rngs is a flax RNG stream; seed torch with torch.manual_seed instead'
            )
        learnable_codebook = default(
            learnable_codebook, directional_reparam or vq_bridge is not None
        )
        for feature, used in (
            ('sync_axis', sync_axis is not None),
            ('sync_codebook', bool(sync_codebook)),
            ('code_axis', code_axis is not None),
            ('vq_bridge', vq_bridge is not None),
            ('directional_reparam (DiVeQ, a learnable codebook)', directional_reparam),
            ('learnable_codebook', learnable_codebook),
            ('orthogonal_reg_weight (it makes the codebook learnable)', orthogonal_reg_weight > 0),
            ('affine_param', affine_param),
            ('in_place_codebook_optimizer', in_place_codebook_optimizer is not None),
            ('stochastic_sample_codes (stochastic sampling)', stochastic_sample_codes),
            ('straight_through (gumbel sampling)', straight_through),
            ('commitment_use_cross_entropy_loss (needs distances)', commitment_use_cross_entropy_loss),
            ('codebook_diversity_loss_weight (needs distances)', codebook_diversity_loss_weight > 0),
        ):
            if used:
                raise not_ported(feature)
        if quantize_tier not in ('exact', 'bf16'):
            raise ValueError(f"quantize_tier must be 'exact' or 'bf16', got {quantize_tier!r}")
        device = resolve_device(device)

        self.dim = dim
        self.heads = heads
        self.separate_codebook_per_head = separate_codebook_per_head
        self.codebook_size = codebook_size
        self.quantize_tier = quantize_tier

        codebook_dim = default(codebook_dim, dim)
        codebook_input_dim = codebook_dim * heads
        self.has_projections = codebook_input_dim != dim
        if self.has_projections:
            self.project_in_linear = nn.Linear(dim, codebook_input_dim, device=device)
            # flax's LayerNorm epsilon
            self.project_in_norm = (
                nn.LayerNorm(codebook_input_dim, eps=1e-6, device=device)
                if layernorm_after_project_in else None
            )
            self.project_out_linear = nn.Linear(codebook_input_dim, dim, device=device)
        else:
            self.project_in_linear = None
            self.project_in_norm = None
            self.project_out_linear = None

        self.use_cosine_sim = use_cosine_sim
        self.accept_image_fmap = accept_image_fmap
        self.accept_3d_fmap = accept_3d_fmap
        self.channel_last = channel_last
        self.return_zeros_for_masked_padding = return_zeros_for_masked_padding

        self.has_commitment_loss = commitment_weight > 0.0
        self.commitment_weight = commitment_weight
        self.rotation_trick = default(rotation_trick, dim > 1)
        self.route_gradients_to_input = route_gradients_to_input
        self.freeze_codebook = freeze_codebook

        # orthogonal_reg_active_codes_only, orthogonal_reg_max_codes,
        # codebook_diversity_temperature, sample_codebook_temp, approx_topk,
        # directional_reparam_variance, sync_affine_param, the affine decays,
        # sync_update_v and manual_in_place_optimizer_update belong to
        # features not ported yet and are accepted for the JAX signature
        self._codebook = Codebook(
            dim=codebook_dim,
            num_codebooks=heads if separate_codebook_per_head else 1,
            codebook_size=codebook_size,
            kmeans_init=kmeans_init,
            kmeans_iters=kmeans_iters,
            decay=decay,
            eps=eps,
            threshold_ema_dead_code=threshold_ema_dead_code,
            ema_update=default(ema_update, True),
            manual_ema_update=manual_ema_update,
            use_cosine_sim=use_cosine_sim,
            use_pallas=use_pallas,
            stat_precision=stat_precision,
            quantize_tier=quantize_tier,
            train_fused=train_fused,
            device=device,
        )

    # -- small helpers ---------------------------------------------------------

    @property
    def ema_update(self) -> bool:
        return self._codebook.ema_update

    @property
    def codebook(self) -> torch.Tensor:
        codebook = self._codebook.embed
        return codebook if self.separate_codebook_per_head else codebook[0]

    @codebook.setter
    def codebook(self, codes: torch.Tensor):
        if not self.separate_codebook_per_head:
            codes = codes[None]
        self._codebook.embed.copy_(codes)

    def project_in(self, x: torch.Tensor) -> torch.Tensor:
        if self.project_in_linear is None:
            return x
        # a bf16 input meets f32 weights in f32, as JAX promotes it
        x = self.project_in_linear(x.to(self.project_in_linear.weight.dtype))
        if self.project_in_norm is not None:
            x = self.project_in_norm(x)
        return x

    def project_out(self, x: torch.Tensor) -> torch.Tensor:
        if self.project_out_linear is None:
            return x
        return self.project_out_linear(x.to(self.project_out_linear.weight.dtype))

    def maybe_split_heads_from_input(self, x: torch.Tensor) -> torch.Tensor:
        """(b, n, h*d) -> (h, b, n, d) for separate codebooks or
        (1, b*h, n, d) for a shared codebook."""
        if self.heads == 1:
            return x
        b, n, _ = x.shape
        h = self.heads
        x = x.reshape(b, n, h, -1)
        if self.separate_codebook_per_head:
            return x.permute(2, 0, 1, 3)
        return x.permute(0, 2, 1, 3).reshape(1, b * h, n, -1)

    def _merge_heads(self, quantize: torch.Tensor, batch: int) -> torch.Tensor:
        h = self.heads
        if self.separate_codebook_per_head:
            q = quantize.permute(1, 2, 0, 3)                        # (b, n, h, d)
            return q.reshape(*q.shape[:2], -1)
        q = quantize[0].reshape(batch, h, *quantize.shape[2:])
        q = q.permute(0, 2, 1, 3)
        return q.reshape(*q.shape[:2], -1)

    def _reshape_indices_from_heads(self, embed_ind: torch.Tensor, batch: int) -> torch.Tensor:
        if self.separate_codebook_per_head:
            return embed_ind.movedim(0, -1)                         # (b, n, h)
        ind = embed_ind[0].reshape(batch, self.heads, *embed_ind.shape[2:])
        return ind.movedim(1, -1)

    def _normalize_input_layout(self, x: torch.Tensor):
        """x -> ((b, n, d) tokens, TokenLayout)."""
        return to_tokens(
            x,
            channel_first=not self.channel_last,
            image_fmap=self.accept_image_fmap,
            fmap_3d=self.accept_3d_fmap,
        )

    def codebook_input(self, tokens: torch.Tensor) -> torch.Tensor:
        """(b, n, dim) tokens -> what the codebook quantizes: projected,
        split into heads ((h, b, n, d) or (1, b*h, n, d)) and, for cosine
        similarity, l2-normalized."""
        x = self.project_in(tokens)
        x = self.maybe_split_heads_from_input(x)
        return self._codebook.transform_input(x)

    # -- decode paths ------------------------------------------------------------

    def get_codes_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """Indices -> codebook vectors. As in the JAX package, an index in
        [-c, -1] counts from the end of the codebook; others outside [0, c)
        raise IndexError."""
        codebook = self.codebook
        if self.quantize_tier == 'bf16':
            codebook = codebook.to(torch.bfloat16)
        c = self.codebook_size
        if bool(((indices < -c) | (indices >= c)).any()):
            raise IndexError(f'code indices must lie in [-{c}, {c})')
        indices = torch.where(indices < 0, indices + c, indices)
        is_multiheaded = codebook.ndim > 2

        if not is_multiheaded and self.heads > 1:
            # shared codebook: (b, ..., h) -> (b, ..., h*d)
            codes = gather_codes(codebook, indices)
            codes = codes.reshape(*codes.shape[:-2], -1)
        elif not is_multiheaded:
            codes = gather_codes(codebook, indices)
        else:
            lead_shape = indices.shape[:-1]
            h = indices.shape[-1]
            ind = indices.reshape(indices.shape[0], -1, h).permute(0, 2, 1)   # (b, h, n)
            codes = torch.stack(
                [gather_codes(codebook[i], ind[:, i]) for i in range(h)], dim=1
            )                                                                # (b, h, n, d)
            codes = codes.permute(0, 2, 1, 3).reshape(*lead_shape, -1)

        if not self.channel_last or self.accept_image_fmap or self.accept_3d_fmap:
            codes = codes.movedim(-1, 1)
        return codes

    def get_output_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        codes = self.get_codes_from_indices(indices)
        if not self.channel_last or self.accept_image_fmap or self.accept_3d_fmap:
            codes = codes.movedim(1, -1)
            codes = self.project_out(codes)
            return codes.movedim(-1, 1)
        return self.project_out(codes)

    # -- external state updates ---------------------------------------------------

    def update_indices(
        self,
        x: torch.Tensor,
        indices: torch.Tensor,
        mask: torch.Tensor | None = None,
        ema_update_weight=None,
        accum_ema_update: bool = False,
        ema_update: bool | None = None,
    ):
        """EMA update of the codebook from indices chosen elsewhere (after a
        beam search); an index of -1 counts for nothing."""
        if x.ndim == 2:
            x = x[:, None, :]
            indices = indices[:, None]
        x, _ = self._normalize_input_layout(x)
        with torch.no_grad():
            x = self.codebook_input(x)
        if self.heads > 1:
            b = indices.shape[0]
            if self.separate_codebook_per_head:
                indices = indices.movedim(-1, 0)                      # (h, b, n)
            else:
                ind = indices.reshape(b, -1, self.heads)
                indices = ind.permute(0, 2, 1).reshape(1, -1, ind.shape[1])  # (1, b*h, n)
        if self.accept_image_fmap:
            indices = (indices.reshape(indices.shape[0], -1, *indices.shape[3:])
                       if indices.ndim > 3 else indices.reshape(indices.shape[0], -1))
        if self.accept_3d_fmap:
            indices = indices.reshape(indices.shape[0], -1)
        self._codebook.update_indices(
            x, indices, mask=mask, ema_update_weight=ema_update_weight,
            accum_ema_update=accum_ema_update, ema_update=ema_update,
        )

    update_ema_indices = update_indices

    def expire_codes_(self, x: torch.Tensor):
        """Replace the codes whose EMA cluster size fell below the dead-code
        threshold with vectors of `x`, given in codebook space."""
        x = self._codebook.transform_input(x)
        x = self.maybe_split_heads_from_input(x)
        self._codebook.expire_codes_(x)

    # -- forward -------------------------------------------------------------------

    def forward(
        self,
        x: torch.Tensor,
        indices: torch.Tensor | None = None,
        mask: torch.Tensor | None = None,
        lens: torch.Tensor | None = None,
        topk: int | None = None,
        sample_codebook_temp: float | None = None,
        freeze_codebook: bool | None = None,
        return_loss_breakdown: bool = False,
        codebook_transform_fn: Callable | None = None,
        ema_update_weight=None,
        accum_ema_update: bool = False,
        ema_update: bool | None = None,
        dist_precision=None,
    ):
        """x -> (quantized, indices int32, loss).

        In training mode the EMA codebook takes this batch's statistics (not
        with `freeze_codebook`), the quantized output carries the rotation
        trick's gradient to x (or the straight-through one with
        rotation_trick=False), and the loss is the weighted MSE commitment
        loss; in eval the loss is 0. Masked positions (`mask`, or `lens` as
        lengths) return zeros, or the input with
        return_zeros_for_masked_padding=False, and index -1, and add nothing
        to the statistics or the loss. sample_codebook_temp and
        dist_precision only act on distance-materializing paths, which are
        not ported.
        """
        for feature, used in (
            ('indices= (cross-entropy loss against given codes)', exists(indices)),
            ('topk= (beam candidates)', exists(topk)),
            ('codebook_transform_fn= (implicit codebooks)', exists(codebook_transform_fn)),
        ):
            if used:
                raise not_ported(feature)

        orig_input = x
        orig_dtype = x.dtype
        freeze_codebook = default(freeze_codebook, self.freeze_codebook)

        if exists(mask) and exists(lens):
            raise ValueError('pass mask or lens, not both')
        if exists(lens):
            mask = lens_to_mask(lens, x.shape[1])

        only_one = x.ndim == 2
        if only_one:
            if exists(mask):
                raise ValueError('a mask needs a token axis')
            x = x[:, None, :]
        if exists(mask) and (self.accept_image_fmap or self.accept_3d_fmap):
            raise ValueError('masks are not supported on feature maps')

        batch = x.shape[0]
        tokens, layout = self._normalize_input_layout(x)
        x = self.codebook_input(tokens)

        quantize, embed_ind, _ = self._codebook(
            x, mask=mask, freeze_codebook=freeze_codebook,
            ema_update_weight=ema_update_weight, accum_ema_update=accum_ema_update,
            ema_update=ema_update, need_distances=False,
        )

        commit_loss = torch.zeros((), dtype=torch.float32, device=quantize.device)
        loss = commit_loss
        if self.training:
            x32 = x.float()
            commit_quantize = quantize.detach()
            if self.route_gradients_to_input:
                if self.rotation_trick:
                    quantize = rotate_to(x32, quantize)
                else:
                    quantize = straight_through(x32, quantize)

            if self.has_commitment_loss:
                if exists(mask):
                    # as in the JAX package: against the unprojected input
                    # when its shape allows, else the codebook-space input
                    target = (
                        orig_input.float()
                        if commit_quantize.shape[-1] == orig_input.shape[-1] and self.heads == 1
                        else x32
                    )
                    err = (commit_quantize - target) ** 2
                    loss_mask = mask
                    if self.heads > 1:
                        c, bh, n = err.shape[:3]
                        hh = bh // mask.shape[0]
                        loss_mask = mask[None, :, None, :].expand(c, mask.shape[0], hh, n)
                        loss_mask = loss_mask.reshape(c, bh, n)
                    commit_loss = masked_mean(err, loss_mask)
                else:
                    commit_loss = ((commit_quantize - x32) ** 2).mean()
                loss = commit_loss * self.commitment_weight

        if self.heads > 1:
            embed_ind = self._reshape_indices_from_heads(embed_ind, batch)
            quantize = self._merge_heads(quantize, batch)
        embed_ind = layout.restore_indices(embed_ind)

        quantize = layout.restore(self.project_out(quantize))
        if only_one:
            quantize = quantize[:, 0]
            embed_ind = embed_ind[:, 0]
        quantize = quantize.to(orig_dtype)

        if exists(mask):
            if self.return_zeros_for_masked_padding:
                masked_out_value = torch.zeros_like(orig_input)
            else:
                masked_out_value = orig_input
            if not self.channel_last:
                qmask = mask[:, None, :]        # quantize is (b, d, n)
            else:
                qmask = append_dims_to(mask, quantize.ndim)
            quantize = torch.where(qmask, quantize, masked_out_value.to(quantize.dtype))
            embed_ind = torch.where(
                append_dims_to(mask, embed_ind.ndim), embed_ind, -1
            )

        if not return_loss_breakdown:
            return quantize, embed_ind, loss
        zero = torch.zeros((), dtype=torch.float32, device=quantize.device)
        return quantize, embed_ind, loss, LossBreakdown(commit_loss, zero, zero, zero)
