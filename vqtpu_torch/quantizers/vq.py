"""VectorQuantize (counterpart of vqtpu/quantizers/vq.py).

The constructor takes the JAX module's kwargs. This port runs the eval
(serving) forward and the training forward: projections, heads with
shared or separate codebooks, cosine similarity, channel-first / image / 3D
feature-map layouts, masks and lengths, both quantize tiers, decoding from
indices; in training the EMA codebook update (kmeans init, dead-code
expiry, accumulated and weighted EMA, the fused train kernel under
`train_fused='on'`, the affine re-parameterization `affine_param`), the
rotation trick, straight-through or DiVeQ (`directional_reparam`) gradient,
`sync_update_v`, and the MSE commitment loss. The distance-materializing
features run too: stochastic codes, gumbel straight-through
(`straight_through`), the cross-entropy commitment loss, the codebook
diversity loss, `indices=` (cross entropy against given codes), `topk=`
candidates and `codebook_transform_fn=`.

The learnable family: `learnable_codebook` (the codebook a parameter that
the commitment loss trains), `vq_bridge` (a module over the whole codebook,
FVQ), the orthogonal regularization (`orthogonal_reg_weight`, over all
codes, the active ones or `orthogonal_reg_max_codes` of them) and the
in-place codebook optimizer.

Data parallel: `sync_axis` (or `sync_codebook`: a string names the axis,
True means 'data') psums the codebook's statistics over a mesh axis (see
`codebook.Codebook`), with kmeans init (`sync_kmeans`) and the affine batch
moments (`sync_affine_param`); the in-place optimizer's gradients are
averaged over it (`pmean`).

Row-sharded codebooks: `code_axis` names the mesh axis the codebook's rows
shard over (see `codebook.Codebook` and `parallel.tp`). Decoding inside a
bound mesh gathers rows from their owners, and the orthogonal loss runs
through the (d, d) gram of the normalized rows, psum'd over the axis, so no
(c, c) matrix and no gather of the codebook is formed;
`orthogonal_reg_max_codes` is refused with `code_axis`, as in the JAX
package.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import partial
from typing import Callable, NamedTuple

import torch
from torch import nn

from ..codebook.codebook import Codebook
from ..core import sampling
from ..core.layout import to_tokens
from ..core.optim import optimizer_update
from ..core.sampling import gumbel_sample
from ..core.ste import (
    directional_reparam as directional_reparam_estimator, rotate_to,
    straight_through as straight_through_estimator,
)
from ..core.utils import (
    append_dims_to, default, entropy, exists, l2norm, lens_to_mask, masked_mean, matmul_tf32,
    orthogonal_loss_fn, resolve_device,
)
from ..kernels.distance import gather_codes as _gather_codes
from ..parallel import collectives
from ..parallel.collectives import pmean
from ..parallel.shard import code_row0, sharded_gather_codes


class LossBreakdown(NamedTuple):
    commitment: torch.Tensor
    codebook_diversity: torch.Tensor
    orthogonal_reg: torch.Tensor
    inplace_optimize: torch.Tensor


def _cross_entropy_ignore_index(
    logits: torch.Tensor, targets: torch.Tensor, ignore_index: int = -1
) -> torch.Tensor:
    """Mean cross entropy of (..., c) logits against (...) targets over the
    entries whose target is not `ignore_index`."""
    valid = targets != ignore_index
    safe_targets = torch.where(valid, targets, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe_targets[..., None])[..., 0]
    return masked_mean(nll, valid)


def orthogonal_reg_code_ids(
    generator: sampling.RandomStream, codebook_size: int, max_codes: int,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """The `max_codes` codes the orthogonal loss keeps: a uniform random
    subset, or, given the (c,) bool `active` codes, the active codes first
    (a gumbel top-k biased to them, the JAX package's static-shape draw).
    The draws come from `core.sampling.random_permutation` and
    `gumbel_noise`, looked up at call time."""
    device = generator.device
    if active is None:
        return sampling.random_permutation(generator, codebook_size, device=device)[:max_codes]
    scores = torch.where(active, 0.0, -1e9) + sampling.gumbel_noise(generator, (codebook_size,), device=device)
    return sampling.topk_first(scores, max_codes)[1].long()


@contextmanager
def _state_discarded(module: nn.Module):
    """Undo, on exit, every change made inside to `module`'s buffers, its
    random stream's state (`rng_state`) among them, and to the host mirror
    of its `initted` flag."""
    buffers = dict(module.named_buffers())
    saved = {name: b.clone() for name, b in buffers.items()}
    on_host = getattr(module, 'initted_on_host', None)
    try:
        yield
    finally:
        with torch.no_grad():
            for name, b in buffers.items():
                b.copy_(saved[name])
        if on_host is not None:
            module.initted_on_host = on_host


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
        instead of the kernel.

        `in_place_codebook_optimizer`: a callable that takes the codebook's
        parameters (`embed` and the bridge's) and returns a
        `torch.optim.Optimizer` over them, as in upstream lucidrains (the
        JAX package takes an optax transformation). It is called once, here.
        Each training forward then takes one step of it on the MSE between
        the quantized rows and the (detached) input and quantizes again;
        with `manual_in_place_optimizer_update` the step's gradients
        accumulate until `update_in_place_optimizer()`. The step leaves the
        `.grad` of every codebook parameter as it found it, so the outer
        backward sees only its own gradient; unlike the JAX package's, the
        outer gradient is not differentiated through the inner step.

        `stat_precision`: see Codebook ('highest', 'high' or 'default')."""
        super().__init__()
        if rngs is not None:
            raise TypeError(
                'rngs is a flax RNG stream; seed torch with torch.manual_seed instead'
            )
        # sync_codebook: a string names the data axis, True means 'data'
        if isinstance(sync_codebook, str):
            sync_axis = sync_codebook
        elif sync_codebook:
            sync_axis = default(sync_axis, 'data')
        if code_axis is not None and orthogonal_reg_weight > 0.0 and orthogonal_reg_max_codes is not None:
            raise ValueError('orthogonal_reg_max_codes is not supported with row-sharded (code_axis) codebooks: '
                             'the sharded loss runs through the (d, d) gram and needs no code subsampling')
        # the interdependent defaults, as in the JAX package
        ema_update = default(ema_update, not directional_reparam and vq_bridge is None)
        learnable_codebook = default(learnable_codebook, directional_reparam or vq_bridge is not None)
        rotation_trick = default(rotation_trick, not directional_reparam and dim > 1)
        for refused, message in (
            (use_cosine_sim and learnable_codebook,
             'cosine sim distance codebook not compatible with learnable codebook yet'),
            (sum(map(bool, (straight_through, rotation_trick, directional_reparam))) > 1,
             'straight_through (gumbel), rotation_trick and directional_reparam exclude each other; '
             'pass rotation_trick=False'),
            (directional_reparam and threshold_ema_dead_code == 0,
             'periodic dead code replacement should be enabled when directional reparam method is turned on'),
            (straight_through and learnable_codebook,
             'gumbel straight through not allowed when learning the codebook'),
            (ema_update and learnable_codebook, 'learnable codebook not compatible with EMA update'),
            (vq_bridge is not None and not learnable_codebook, 'vq_bridge needs a learnable codebook'),
            (vq_bridge is not None and ema_update, 'vq_bridge is not compatible with EMA update'),
            (not 0 <= sync_update_v <= 1.0, 'sync_update_v must lie in [0, 1]'),
            (sync_update_v > 0.0 and not learnable_codebook, 'learnable codebook must be turned on'),
        ):
            if refused:
                raise ValueError(message)
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

        self.has_commitment_loss = commitment_weight > 0.0 and not directional_reparam
        self.commitment_weight = commitment_weight
        self.commitment_use_cross_entropy_loss = commitment_use_cross_entropy_loss
        self.has_codebook_diversity_loss = codebook_diversity_loss_weight > 0.0
        self.codebook_diversity_loss_weight = codebook_diversity_loss_weight
        self.codebook_diversity_temperature = codebook_diversity_temperature
        self.rotation_trick = rotation_trick
        self.straight_through_gumbel = straight_through
        self.stochastic_sample_codes = stochastic_sample_codes
        self.route_gradients_to_input = route_gradients_to_input
        self.freeze_codebook = freeze_codebook
        self.learnable_codebook = learnable_codebook
        self.directional_reparam = directional_reparam
        self.directional_reparam_variance = directional_reparam_variance
        self.sync_update_v = sync_update_v
        self.sync_axis = sync_axis
        self.code_axis = code_axis
        self.has_codebook_orthogonal_loss = orthogonal_reg_weight > 0.0
        self.orthogonal_reg_weight = orthogonal_reg_weight
        self.orthogonal_reg_active_codes_only = orthogonal_reg_active_codes_only
        self.orthogonal_reg_max_codes = orthogonal_reg_max_codes

        self._codebook = Codebook(
            dim=codebook_dim,
            num_codebooks=heads if separate_codebook_per_head else 1,
            codebook_size=codebook_size,
            kmeans_init=kmeans_init,
            kmeans_iters=kmeans_iters,
            sync_kmeans=sync_kmeans,
            decay=decay,
            eps=eps,
            threshold_ema_dead_code=threshold_ema_dead_code,
            # the orthogonal loss makes the codebook a parameter, beside the EMA
            learnable_codebook=self.has_codebook_orthogonal_loss or learnable_codebook,
            ema_update=ema_update,
            manual_ema_update=manual_ema_update,
            vq_bridge=vq_bridge,
            affine_param=affine_param,
            affine_param_batch_decay=affine_param_batch_decay,
            affine_param_codebook_decay=affine_param_codebook_decay,
            sync_axis=sync_axis,
            code_axis=code_axis,
            sync_affine_param=sync_affine_param,
            sample_codebook_temp=sample_codebook_temp,
            gumbel_sample_fn=partial(gumbel_sample, stochastic=stochastic_sample_codes,
                                     straight_through=straight_through, approx_topk=approx_topk),
            use_cosine_sim=use_cosine_sim,
            use_pallas=use_pallas,
            stat_precision=stat_precision,
            quantize_tier=quantize_tier,
            train_fused=train_fused,
            device=device,
        )

        self.in_place_codebook_optimizer = (
            None if in_place_codebook_optimizer is None
            else in_place_codebook_optimizer(list(self._codebook.parameters()))
        )
        self.manual_in_place_optimizer_update = manual_in_place_optimizer_update
        # the inner step's gradients that wait for update_in_place_optimizer
        self._pending_inner_grads = (
            [torch.zeros_like(p) for p in self._codebook.parameters()]
            if in_place_codebook_optimizer is not None and manual_in_place_optimizer_update else None
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
        with torch.no_grad():
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
        raise IndexError (compiled: a device-side assertion). Inside a mesh binding `code_axis` the rows come
        from the ranks that own them."""
        codebook = self.codebook
        if self.quantize_tier == 'bf16':
            codebook = codebook.to(torch.bfloat16)
        c = self.codebook_size
        outside = ((indices < -c) | (indices >= c)).any()
        if torch.compiler.is_compiling():
            # a compiled decode checks on the device, with no host read
            torch._assert_async(~outside, f'code indices must lie in [-{c}, {c})')
        elif bool(outside):
            raise IndexError(f'code indices must lie in [-{c}, {c})')
        indices = torch.where(indices < 0, indices + c, indices)
        is_multiheaded = codebook.ndim > 2
        if self._codebook._code_parallel():
            gather_codes = partial(sharded_gather_codes, axis=self.code_axis)
        else:
            gather_codes = _gather_codes

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

    # -- the in-place codebook optimizer ------------------------------------------

    def _step_in_place_optimizer(self, grads: list[torch.Tensor]):
        """One step of the in-place optimizer on `grads`, one a codebook
        parameter, averaged over the data axis; the parameters' `.grad` are
        left as they were."""
        optimizer_update(self.in_place_codebook_optimizer, [pmean(g, self.sync_axis) for g in grads])

    def update_in_place_optimizer(self):
        """Take the in-place optimizer's step on the gradients accumulated
        since the last call (manual mode), and clear them."""
        if self.in_place_codebook_optimizer is None or self._pending_inner_grads is None:
            return
        self._step_in_place_optimizer([g.clone() for g in self._pending_inner_grads])
        for g in self._pending_inner_grads:
            g.zero_()

    def _inner_codebook_step(self, x: torch.Tensor, mask, codebook_kwargs: dict) -> torch.Tensor:
        """The gradient of MSE(quantized, x) with respect to the codebook's
        parameters, from a forward whose changes to the codebook's state
        (its buffers, its random stream's among them) are discarded, as the
        JAX package discards them; then the optimizer's step
        (`core.optim.optimizer_update`, which a compiled step traces), or
        the gradients added to the pending ones in manual mode. Returns the
        MSE."""
        params = list(self._codebook.parameters())
        target = x.detach().float()
        with torch.enable_grad(), _state_discarded(self._codebook):
            q, _, _ = self._codebook(target, **{**codebook_kwargs, 'update_usage': False})
            err = (q - target) ** 2
            loss = err.mean() if mask is None else masked_mean(err, self._loss_mask(err, mask))
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if self.manual_in_place_optimizer_update:
            for pending, g in zip(self._pending_inner_grads, grads):
                pending.add_(g)
        else:
            self._step_in_place_optimizer(grads)
        return loss.detach()

    # -- losses --------------------------------------------------------------------

    def _loss_mask(self, err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """A (b, n) mask broadcast against the codebook's (h, B, n, ...)
        tokens with heads, the head factor of B = b * h repeating each
        position's entry; the mask itself without heads."""
        if self.heads == 1:
            return mask
        c, bh, n = err.shape[:3]
        hh = bh // mask.shape[0]
        return mask[None, :, None, :].expand(c, mask.shape[0], hh, n).reshape(c, bh, n)

    def _orthogonal_reg_loss(self, embed_ind: torch.Tensor) -> torch.Tensor:
        """Eq. (2) of https://arxiv.org/abs/2112.00384 on the codebook as the
        forward left it (after its EMA update): over all codes, over the
        codes in `embed_ind` (`orthogonal_reg_active_codes_only`), and over
        `orthogonal_reg_max_codes` codes drawn by `orthogonal_reg_code_ids`
        when the codebook has more."""
        codebook = self._codebook.embed_after_forward()              # (h, c, d)
        if self._codebook._code_parallel():
            return self._orthogonal_reg_loss_sharded(codebook, embed_ind)
        h, c, _ = codebook.shape
        active = None
        if self.orthogonal_reg_active_codes_only:
            if self.heads > 1 and self.separate_codebook_per_head:
                raise ValueError('orthogonal regularization for only active codes not compatible '
                                 'with multi-headed with separate codebooks yet')
            active = torch.zeros(c, dtype=torch.bool, device=codebook.device)
            active[embed_ind.reshape(-1).long()] = True
        max_codes = self.orthogonal_reg_max_codes
        if max_codes is not None and c > max_codes:
            ids = orthogonal_reg_code_ids(self._codebook.generator, c, max_codes, active)
            codebook = codebook[:, ids]
            if active is not None:
                active = active[ids]
        if active is None:
            return orthogonal_loss_fn(codebook)
        # eq. (2) over the active rows and columns only, at a static shape
        normed = l2norm(codebook) * active[None, :, None]
        with matmul_tf32(codebook.device, allow=False):
            cosine_sim = normed @ normed.transpose(-1, -2)
        n_active = active.sum().float().clamp_min(1.0)
        return (cosine_sim ** 2).sum() / (h * n_active ** 2) - (1.0 / n_active)

    def _orthogonal_reg_loss_sharded(self, codebook: torch.Tensor, embed_ind: torch.Tensor) -> torch.Tensor:
        """Eq. (2) over a row-sharded codebook: sum_ij (n_i . n_j)^2 is the
        squared Frobenius norm of the (d, d) gram N^T N, a sum over code
        rows, so each rank adds its rows' gram and one psum_exact over the
        code axis gives the whole codebook's (the loss's gradient reaches
        each rank's own rows). With active codes only, every rank builds
        the same global mask from the (replicated) global indices and keeps
        its window."""
        axis = self.code_axis
        h, c_local, _ = codebook.shape
        normed = l2norm(codebook)
        if self.orthogonal_reg_active_codes_only:
            if self.heads > 1 and self.separate_codebook_per_head:
                raise ValueError('orthogonal regularization for only active codes not compatible '
                                 'with multi-headed with separate codebooks yet')
            active = torch.zeros(self.codebook_size, dtype=torch.bool, device=codebook.device)
            active[embed_ind.reshape(-1).long()] = True
            row0 = code_row0(axis, c_local)
            normed = normed * active[row0:row0 + c_local][None, :, None]
            n = active.sum().float().clamp_min(1.0)
        else:
            n = torch.tensor(float(self.codebook_size), device=codebook.device)
        with matmul_tf32(codebook.device, allow=False):
            gram = collectives.psum_exact(normed.transpose(-1, -2) @ normed, axis)     # (h, d, d)
        return (gram ** 2).sum() / (h * n ** 2) - (1.0 / n)

    def _calculate_ce_loss(self, distances: torch.Tensor, codes: torch.Tensor, batch: int) -> torch.Tensor:
        """Cross entropy between the distance logits (h, B, n, c) and code
        indices ((b, n), or (b, n, h) with heads); -1 entries are ignored."""
        if self.heads == 1:
            logits = distances[0]                                     # (b, n, c)
        elif self.separate_codebook_per_head:
            logits = distances.permute(1, 2, 0, 3)                    # (b, n, h, c)
        else:
            d0 = distances[0].reshape(batch, self.heads, *distances.shape[2:])
            logits = d0.permute(0, 2, 1, 3)                           # (b, n, h, c)
        return _cross_entropy_ignore_index(logits, codes)

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
        with `freeze_codebook` or `topk`), the in-place optimizer takes its
        step, the quantized output carries the rotation trick's gradient to
        x (or the straight-through one with rotation_trick=False, or
        DiVeQ's), and the loss is the weighted commitment loss (MSE, or
        cross entropy against the chosen codes; through it a learnable
        codebook learns) plus the weighted codebook diversity and
        orthogonal losses; in eval the loss is 0. Masked positions
        (`mask`, or `lens` as lengths) return zeros, or the input with
        return_zeros_for_masked_padding=False, and index -1, and add nothing
        to the statistics or the loss.

        `indices=` returns (quantized, cross entropy of the distances
        against those codes, -1 ignored) instead. `topk=k` returns k
        candidates: quantized (..., k, dim), indices and loss (..., k), the
        loss a per-candidate MSE against the input in eval and training.
        For a (b, n, d) input the JAX package returns batch element 0's
        candidates only, (n, k, d); this returns all of them, (b, n, k, d).
        `codebook_transform_fn(embed)` gives a per-token codebook (1, b, n,
        c, d). `dist_precision` is the JAX package's TPU precision knob:
        the distances are full f32 here whatever it says.
        """
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

        return_loss = exists(indices)
        batch = x.shape[0]
        tokens, layout = self._normalize_input_layout(x)
        x = self.codebook_input(tokens)

        need_distances = (
            return_loss
            or topk is not None
            or codebook_transform_fn is not None
            or (self.training and self.has_codebook_diversity_loss)
            or (self.training and self.has_commitment_loss and self.commitment_use_cross_entropy_loss)
            or (self.training and self.stochastic_sample_codes)
            or (self.training and self.straight_through_gumbel)
        )
        # the codebook sees (b, N) tokens: extra token dims (a beam's
        # candidates) share their position's mask
        codebook_mask = mask
        if exists(mask) and tokens.shape[1] != mask.shape[1]:
            codebook_mask = mask[:, :, None].expand(*mask.shape, tokens.shape[1] // mask.shape[1])
            codebook_mask = codebook_mask.reshape(batch, -1)

        codebook_kwargs = dict(
            sample_codebook_temp=sample_codebook_temp, mask=codebook_mask,
            freeze_codebook=freeze_codebook, codebook_transform_fn=codebook_transform_fn,
            ema_update_weight=ema_update_weight, accum_ema_update=accum_ema_update,
            ema_update=ema_update if ema_update is None else (ema_update and topk is None),
            topk=topk, need_distances=need_distances, stochastic=self.stochastic_sample_codes,
            straight_through_onehot=self.straight_through_gumbel, dist_precision=dist_precision,
        )
        quantize, embed_ind, distances = self._codebook(x, **codebook_kwargs)

        zero = torch.zeros((), dtype=torch.float32, device=quantize.device)
        inplace_optimize_loss = zero
        if self.in_place_codebook_optimizer is not None and self.training and not freeze_codebook:
            # one step on the codebook, then quantize again
            inplace_optimize_loss = self._inner_codebook_step(x, codebook_mask, codebook_kwargs)
            quantize, embed_ind, distances = self._codebook(x, **codebook_kwargs, update_usage=False)
        if distances is not None and self.heads == 1 and not layout.moved_channel:
            # the JAX package's layout: a channel-last input keeps its token dims
            distances = distances.reshape(1, batch, *layout.spatial, distances.shape[-1])

        commit_loss = codebook_diversity_loss = orthogonal_reg_loss = zero
        x32 = x.float()
        if self.training:
            # a learnable codebook learns from the commitment loss
            learning = self.learnable_codebook and not freeze_codebook
            commit_quantize = quantize if learning else quantize.detach()
            xq = x32 if topk is None else x32[..., None, :].expand(*x32.shape[:-1], topk, x32.shape[-1])
            if self.route_gradients_to_input:
                if self.rotation_trick:
                    quantize = rotate_to(xq, quantize)
                elif self.directional_reparam:
                    quantize = directional_reparam_estimator(
                        xq, quantize, self.directional_reparam_variance, generator=self._codebook.generator)
                else:
                    quantize = straight_through_estimator(xq, quantize)
            if self.sync_update_v > 0.0:
                # (21) of https://minyoungg.github.io/vqtorch/assets/draft_050523.pdf
                quantize = quantize + self.sync_update_v * (quantize - quantize.detach())

        if return_loss:
            ce = self._calculate_ce_loss(distances, indices, batch)
            return self._finalize_quantize(quantize, batch, layout, only_one, orig_dtype), ce

        if self.heads > 1:
            embed_ind = self._reshape_indices_from_heads(embed_ind, batch)
        embed_ind = layout.restore_indices(embed_ind)

        def candidate_mse(q):
            """(b, N, k, d) candidates -> (b, *spatial, k) MSE against the
            unprojected input, 0 at masked positions."""
            target = tokens.float()[..., None, :].expand(q.shape)
            mse = layout.restore_indices(((q.float() - target) ** 2).mean(-1))
            if exists(mask):
                mse = torch.where(append_dims_to(mask, mse.ndim), mse, 0.0)
            return mse

        loss = zero
        if not self.training and topk is not None and self.has_commitment_loss:
            # per-candidate MSE, so that an eval beam search can score its beams
            loss = candidate_mse(quantize) * self.commitment_weight

        if self.training:
            if self.has_codebook_diversity_loss:
                prob = torch.softmax(distances * self.codebook_diversity_temperature, dim=-1)
                avg_prob = prob.reshape(-1, *prob.shape[-2:]).mean(0)
                codebook_diversity_loss = -entropy(avg_prob).mean()
                loss = loss + codebook_diversity_loss * self.codebook_diversity_loss_weight

            if self.has_commitment_loss:
                if self.commitment_use_cross_entropy_loss:
                    ce_indices = embed_ind
                    if exists(mask):
                        ce_mask = mask[..., None] if self.heads > 1 else mask
                        ce_indices = torch.where(ce_mask, ce_indices, -1)
                    commit_loss = self._calculate_ce_loss(distances, ce_indices, batch)
                elif topk is not None:
                    commit_loss = candidate_mse(commit_quantize)
                elif exists(mask):
                    # as in the JAX package: against the unprojected input
                    # when its shape allows, else the codebook-space input
                    target = (
                        orig_input.float()
                        if commit_quantize.shape[-1] == orig_input.shape[-1] and self.heads == 1
                        else x32
                    )
                    err = (commit_quantize - target) ** 2
                    commit_loss = masked_mean(err, self._loss_mask(err, mask))
                else:
                    commit_loss = ((commit_quantize - x32) ** 2).mean()
                loss = loss + commit_loss * self.commitment_weight

            if self.has_codebook_orthogonal_loss:
                orthogonal_reg_loss = self._orthogonal_reg_loss(embed_ind)
                loss = loss + orthogonal_reg_loss * self.orthogonal_reg_weight

        quantize = self._finalize_quantize(quantize, batch, layout, only_one, orig_dtype)
        if only_one:
            embed_ind = embed_ind[:, 0]

        if exists(mask):
            if self.return_zeros_for_masked_padding:
                masked_out_value = torch.zeros_like(orig_input)
            else:
                masked_out_value = orig_input
            if not self.channel_last:
                qmask = mask[:, None, :]        # quantize is (b, d, n)
            else:
                qmask = append_dims_to(mask, quantize.ndim)
            if quantize.ndim > masked_out_value.ndim:                 # topk candidates
                masked_out_value = masked_out_value[..., None, :].expand(quantize.shape)
            quantize = torch.where(qmask, quantize, masked_out_value.to(quantize.dtype))
            embed_ind = torch.where(
                append_dims_to(mask, embed_ind.ndim), embed_ind, -1
            )

        if not return_loss_breakdown:
            return quantize, embed_ind, loss
        return quantize, embed_ind, loss, LossBreakdown(
            commit_loss, codebook_diversity_loss, orthogonal_reg_loss, inplace_optimize_loss)

    def _finalize_quantize(self, quantize, batch, layout, only_one, orig_dtype):
        """Merge heads, project out, restore the input's layout and dtype."""
        if self.heads > 1:
            quantize = self._merge_heads(quantize, batch)
        quantize = layout.restore(self.project_out(quantize))
        if only_one:
            quantize = quantize[:, 0]
        return quantize.to(orig_dtype)
