"""ResidualVQ and GroupedResidualVQ (counterpart of
vqtpu/composite/residual_vq.py).

A stack of VectorQuantize layers, each quantizing what the layers before it
left (SoundStream's residual quantization), with:

- per-layer codebook sizes (`codebook_size` a tuple);
- a shared codebook: every layer holds the same Codebook module, its EMA
  deferred to one update after the stack and its dead codes expired once
  over every layer's input;
- quantize dropout as the JAX package does it: in training every layer
  runs, and the layers after a drawn index give zeros, index -1, loss 0 and
  EMA weight 0. The draw comes from `self.generator`, or from
  `rand_quantize_dropout_index` when the caller gives it;
- beam search over code combinations (`beam_size`, `eval_beam_size`): each
  layer offers `beam_size` candidates per beam through VectorQuantize's
  `topk=`, scored by their per-candidate loss, and the beams are pruned back
  to `beam_size` with the JAX package's tie order (the lower index first),
  then the best beam (the first on ties) is taken; in training the EMA
  update replays each layer's input with the chosen indices;
- `quant_grad_frac`: the share of the gradient that flows from a layer's
  output into the next layer's residual;
- QINCo (`implicit_neural_codebook`, https://arxiv.org/abs/2401.14732):
  layers 2..N quantize against a per-token codebook, an MLP of their
  learnable codebook and the sum of the layers before them
  (`codebook_transform_fn`), in a forward, a beam search and the decode;
- DiVeQ (`diveq`): learnable codebooks whose rows take the full gradient
  (no commitment loss, no estimator per layer), and one directional
  reparameterization of the summed output against the input.

Each layer runs VectorQuantize's path: on the card one selection kernel
launch (K1) per layer in eval and in a learnable (DiVeQ) training step, one
fused train kernel launch (K4) per layer in an EMA training step, and the
distance-materializing path (no kernel) for beam search, stochastic codes
and QINCo.
"""

from __future__ import annotations

import math
from collections.abc import Sequence
from functools import partial

import torch
from torch import nn

from ..core.sampling import topk_first
from ..core.ste import directional_reparam, frac_gradient
from ..core.utils import cast_tuple, default, exists, first, resolve_device
from ..quantizers.vq import VectorQuantize


class _SiluBlock(nn.Module):
    def __init__(self, dim: int, dim_hidden: int, *, device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        self.lin1 = nn.Linear(dim, dim_hidden, device=device)
        self.lin2 = nn.Linear(dim_hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(nn.functional.silu(self.lin1(x)))


class MLP(nn.Module):
    """QINCo's implicit-neural-codebook MLP: (codes, condition) ->
    per-token codes, proj_in of the concatenation [condition, code], then
    `depth` residual SiLU blocks, and an l2 norm with `l2norm_output`."""

    def __init__(self, dim: int, dim_hidden: int | None = None, depth: int = 4,
                 l2norm_output: bool = False, *, device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        dim_hidden = default(dim_hidden, dim)
        self.proj_in = nn.Linear(2 * dim, dim, device=device)
        self.layers = nn.ModuleList(_SiluBlock(dim, dim_hidden, device=device) for _ in range(depth))
        self.l2norm_output = l2norm_output

    def forward(self, codes: torch.Tensor, *, condition: torch.Tensor) -> torch.Tensor:
        """codes (h, c, d) or (c, d), condition (b, ..., d) -> (h, b, n, c,
        d), or (b, n, c, d) for (c, d) codes, n the product of the
        condition's middle dims.

        proj_in is applied as the sum of its two halves, the condition's
        per token and the codes' once, which equals the product with the
        (b, n, c, 2d) concatenation the JAX package forms, to f32 rounding,
        without it."""
        one_headed = codes.ndim == 2
        if one_headed:
            codes = codes[None]
        d = codes.shape[-1]
        cond = condition.reshape(condition.shape[0], -1, condition.shape[-1])
        w_cond, w_codes = self.proj_in.weight.split(d, dim=1)
        from_cond = cond @ w_cond.T                                          # (b, n, d)
        from_codes = codes @ w_codes.T + self.proj_in.bias                   # (h, c, d)
        x = from_cond[None, :, :, None, :] + from_codes[:, None, None, :, :]
        for block in self.layers:
            x = block(x) + x
        if self.l2norm_output:
            x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-6)
        return x[0] if one_headed else x


def _batch_select(t: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Select along the beam axis: t (..., j, *rest), indices (..., k) ->
    (..., k, *rest)."""
    axis = indices.ndim - 1
    rest = t.shape[axis + 1:]
    index = indices.long().reshape(*indices.shape, *(1,) * len(rest)).expand(*indices.shape, *rest)
    return t.gather(axis, index)


class ResidualVQ(nn.Module):
    def __init__(
        self,
        *,
        dim: int,
        num_quantizers: int | None = None,
        codebook_size: int | tuple[int, ...],
        codebook_dim: int | None = None,
        shared_codebook: bool = False,
        diveq: bool = False,
        heads: int = 1,
        quantize_dropout: bool = False,
        quantize_dropout_cutoff_index: int = 0,
        quantize_dropout_multiple_of: int = 1,
        accept_image_fmap: bool = False,
        implicit_neural_codebook: bool = False,
        mlp_kwargs: dict | None = None,
        beam_size: int | None = None,
        eval_beam_size: int | None = None,
        beam_score_quantizer_weights: Sequence[float] | None = None,
        beam_score_precision='deterministic',
        quant_grad_frac: float = 0.0,
        rngs=None,
        device: str | torch.device | None = None,
        **vq_kwargs,
    ):
        """`device` as for VectorQuantize; `rngs` must be None (seed torch
        with torch.manual_seed). Other kwargs go to every layer; `mlp_kwargs`
        to QINCo's MLPs (dim_hidden, depth).
        `beam_score_precision` is the JAX package's TPU precision knob for
        the beam's distances; here they are always full f32 (the 'deterministic'
        setting), and the value is kept for the signature."""
        super().__init__()
        if rngs is not None:
            raise TypeError('rngs is a flax RNG stream; seed torch with torch.manual_seed instead')
        if heads != 1:
            raise ValueError('residual vq is not compatible with multi-headed codes')
        if num_quantizers is None and not isinstance(codebook_size, tuple):
            raise ValueError('give num_quantizers, or codebook_size as a tuple of per-layer sizes')
        device = resolve_device(device)

        codebook_dim = default(codebook_dim, dim)
        self.codebook_dim = codebook_dim
        requires_projection = codebook_dim != dim
        self.project_in = nn.Linear(dim, codebook_dim, device=device) if requires_projection else None
        self.project_out = nn.Linear(codebook_dim, dim, device=device) if requires_projection else None
        self.has_projections = requires_projection
        self.accept_image_fmap = accept_image_fmap

        self.implicit_neural_codebook = implicit_neural_codebook
        if implicit_neural_codebook:
            vq_kwargs.update(learnable_codebook=True, ema_update=False)
        if shared_codebook:
            vq_kwargs.update(manual_ema_update=True, manual_in_place_optimizer_update=True)
        # DiVeQ (figure 1, https://openreview.net/forum?id=KRVnpTbx7R)
        self.diveq = diveq
        if diveq:
            vq_kwargs.update(ema_update=False, learnable_codebook=True, route_gradients_to_input=False,
                             commitment_weight=0.0)

        codebook_sizes = cast_tuple(codebook_size, num_quantizers)
        num_quantizers = default(num_quantizers, len(codebook_sizes))
        if len(codebook_sizes) != num_quantizers:
            raise ValueError(f'{len(codebook_sizes)} codebook sizes for {num_quantizers} quantizers')
        self.num_quantizers = num_quantizers
        self.codebook_sizes = codebook_sizes
        self.uniform_codebook_size = len(set(codebook_sizes)) == 1

        self.layers = nn.ModuleList(
            VectorQuantize(dim=codebook_dim, codebook_size=size, codebook_dim=codebook_dim,
                           accept_image_fmap=accept_image_fmap, device=device, **vq_kwargs)
            for size in codebook_sizes
        )

        self.quantize_dropout = quantize_dropout and num_quantizers > 1
        if quantize_dropout_cutoff_index < 0:
            raise ValueError('quantize_dropout_cutoff_index must be >= 0')
        self.quantize_dropout_cutoff_index = quantize_dropout_cutoff_index
        self.quantize_dropout_multiple_of = quantize_dropout_multiple_of
        self.vq_is_ema_updating = first(self.layers).ema_update
        self.quant_grad_frac = quant_grad_frac if not diveq else 1.0

        if eval_beam_size is not None and beam_size is None:
            raise ValueError('eval_beam_size needs beam_size')
        self.beam_size = beam_size
        self.eval_beam_size = default(eval_beam_size, beam_size)
        weights = default(beam_score_quantizer_weights, [1.0] * num_quantizers)
        if len(weights) != num_quantizers:
            raise ValueError(f'{len(weights)} beam score weights for {num_quantizers} quantizers')
        self.beam_score_weights = tuple(float(w) for w in weights)
        self.beam_score_precision = beam_score_precision

        # QINCo's MLPs, for layers 2..N
        self.mlps = nn.ModuleList(
            MLP(dim=codebook_dim, l2norm_output=first(self.layers).use_cosine_sim, device=device,
                **(mlp_kwargs or {}))
            for _ in range(num_quantizers - 1)
        ) if implicit_neural_codebook else None

        # a shared codebook: every layer holds the one Codebook module, and
        # its in-place optimizer
        self.shared_codebook = shared_codebook
        if shared_codebook:
            if not self.uniform_codebook_size:
                raise ValueError('a shared codebook needs one codebook size for every layer')
            shared = first(self.layers)._codebook
            shared_opt = first(self.layers).in_place_codebook_optimizer
            for vq in self.layers[1:]:
                vq._codebook = shared
                vq.in_place_codebook_optimizer = shared_opt

        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(torch.randint(0, 2**62, (), dtype=torch.int64)))

    # -- properties -------------------------------------------------------------

    @property
    def codebook_size(self) -> int:
        return self.layers[0].codebook_size

    @property
    def codebooks(self):
        """(q, c, d), or a tuple of (c_i, d) when the sizes differ."""
        codebooks = [layer._codebook.embed[0] for layer in self.layers]
        if not self.uniform_codebook_size:
            return tuple(codebooks)
        return torch.stack(codebooks)

    def _layer_mlps(self) -> tuple:
        """Each layer's QINCo MLP, None for the first layer and without
        QINCo."""
        return (None, *self.mlps) if self.implicit_neural_codebook else (None,) * self.num_quantizers

    # -- decode -------------------------------------------------------------------

    def get_codes_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """(b, ..., q) indices -> (num_quantizers, b, ..., d) codes; -1
        entries (quantize dropout) decode to zero vectors, and fewer than
        num_quantizers layers of indices are padded with -1."""
        lead_shape = indices.shape[:-1]
        quantize_dim = indices.shape[-1]
        ind = indices.reshape(indices.shape[0], -1, quantize_dim).long()
        if quantize_dim < self.num_quantizers:
            if not self.quantize_dropout:
                raise ValueError('quantize dropout must be greater than 0 if you wish to '
                                 'reconstruct from a signal with less fine quantizations')
            ind = nn.functional.pad(ind, (0, self.num_quantizers - quantize_dim), value=-1)

        dropout_mask = ind == -1
        ind = ind.masked_fill(dropout_mask, 0)
        bf16_tier = self.layers[0].quantize_tier == 'bf16'
        all_codes = []
        quantized_out = 0.0
        for q, (codes, mlp) in enumerate(zip(self.codebooks, self._layer_mlps())):
            layer_ind = ind[..., q]                                         # (b, n)
            if mlp is not None:
                # QINCo: the row of the per-token codebook of this layer
                transformed = mlp(codes, condition=quantized_out)           # (b, n, c, d)
                pick = layer_ind[..., None, None].expand(*layer_ind.shape, 1, transformed.shape[-1])
                layer_codes = transformed.gather(-2, pick)[..., 0, :]
            else:
                if bf16_tier:
                    # the bf16 tier quantizes to the bf16-rounded rows
                    codes = codes.to(torch.bfloat16).float()
                layer_codes = codes[layer_ind]
            all_codes.append(layer_codes)
            quantized_out = quantized_out + layer_codes
        all_codes = torch.stack(all_codes)                                  # (q, b, n, d)
        all_codes = all_codes.masked_fill(dropout_mask.movedim(-1, 0)[..., None], 0.0)
        return all_codes.reshape(self.num_quantizers, *lead_shape, -1)

    def get_output_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """The decoded output: the layers' codes summed in layer order, as
        the forward sums them (so an eval forward's output comes back bit
        for bit), then projected out."""
        codes = self.get_codes_from_indices(indices)
        summed = codes[0]
        for layer_codes in codes[1:]:
            summed = summed + layer_codes
        if self.project_out is not None:
            summed = self.project_out(summed)
        return summed

    # -- dropout index ------------------------------------------------------------

    def draw_dropout_index(self) -> int:
        """A layer index uniform in [cutoff, num_quantizers), rounded up to
        the configured multiple (minus one)."""
        idx = int(torch.randint(self.quantize_dropout_cutoff_index, self.num_quantizers, (),
                                generator=self.generator, device=self.generator.device))
        mult = self.quantize_dropout_multiple_of
        if mult != 1:
            idx = min(math.ceil((idx + 1) / mult) * mult - 1, self.num_quantizers - 1)
        return idx

    # -- forward --------------------------------------------------------------------

    def forward(
        self,
        x: torch.Tensor,
        mask: torch.Tensor | None = None,
        indices: torch.Tensor | Sequence[torch.Tensor] | None = None,
        return_all_codes: bool = False,
        sample_codebook_temp: float | None = None,
        freeze_codebook: bool = False,
        beam_size: int | None = None,
        rand_quantize_dropout_index: int | torch.Tensor | None = None,
    ):
        """x -> (quantized, indices (..., q) int32, losses (q,) or (..., q)),
        and the codes (q, ..., d) with `return_all_codes`.

        `indices=` (given codes, (..., q), or a sequence of per-layer
        (...) tensors stacked on the last dim) returns (quantized, the sum
        of the layers' cross-entropy losses). `beam_size` overrides the
        module's for this call; a beam search returns the losses as a
        per-layer mean over the (unmasked) positions."""
        return_loss = exists(indices)
        beam_size = default(beam_size, self.beam_size if self.training else self.eval_beam_size)
        is_beam_search = exists(beam_size) and beam_size > 1

        if self.project_in is not None:
            x = self.project_in(x)
        if self.accept_image_fmap and return_loss:
            raise ValueError('indices= is not supported on image feature maps')
        if isinstance(indices, (list, tuple)):
            indices = torch.stack(tuple(indices), dim=-1)

        dropout_index = None
        if self.training and self.quantize_dropout and not return_loss:
            dropout_index = (int(rand_quantize_dropout_index) if rand_quantize_dropout_index is not None
                             else self.draw_dropout_index())

        if is_beam_search:
            return self._forward_beam(x, mask, beam_size, sample_codebook_temp, freeze_codebook,
                                      dropout_index, return_all_codes)

        quantized_out = torch.zeros_like(x)
        residual = x
        all_indices, all_losses, ce_losses, layer_inputs = [], [], [], []

        for quantizer_index, (vq, mlp) in enumerate(zip(self.layers, self._layer_mlps())):
            keep = dropout_index is None or quantizer_index <= dropout_index
            layer_inputs.append(residual)
            out = vq(
                residual, mask=mask,
                indices=indices[..., quantizer_index] if return_loss else None,
                sample_codebook_temp=sample_codebook_temp, freeze_codebook=freeze_codebook,
                codebook_transform_fn=None if mlp is None else partial(mlp, condition=quantized_out),
                ema_update_weight=None if dropout_index is None else float(keep),
            )
            if return_loss:
                quantized, ce_loss = out
                ce_losses.append(ce_loss)
            else:
                quantized, embed_indices, loss = out
                if not keep:
                    quantized = torch.zeros_like(quantized)
                    embed_indices = torch.full_like(embed_indices, -1)
                    loss = torch.zeros_like(loss)
                all_indices.append(embed_indices)
                all_losses.append(loss)
            residual = residual - frac_gradient(quantized, self.quant_grad_frac)
            quantized_out = quantized_out + quantized

        if self.training and self.shared_codebook and not return_loss:
            # the deferred EMA once, then expiry over every layer's input
            codebook = first(self.layers)._codebook
            if self.vq_is_ema_updating:
                codebook.update_ema()
                first(self.layers).update_in_place_optimizer()
            if self.accept_image_fmap:
                pool = torch.cat([t.movedim(1, -1).reshape(t.shape[0], -1, t.shape[1]) for t in layer_inputs], 1)
            else:
                pool = torch.cat([t.reshape(t.shape[0], -1, t.shape[-1]) for t in layer_inputs], 1)
            codebook.expire_codes_(codebook.transform_input(pool)[None])

        if self.diveq:
            quantized_out = directional_reparam(x, quantized_out, generator=self.generator)
        if self.project_out is not None:
            quantized_out = self.project_out(quantized_out)
        if return_loss:
            return quantized_out, sum(ce_losses)

        all_indices = torch.stack(all_indices, -1)
        ret = (quantized_out, all_indices, torch.stack(all_losses, -1))
        if not return_all_codes:
            return ret
        return (*ret, self.get_codes_from_indices(all_indices))

    def _forward_beam(self, x, mask, beam_size, sample_codebook_temp, freeze_codebook, dropout_index,
                      return_all_codes):
        """Beam search over code combinations. Each layer expands the j
        beams into j * beam_size candidates (VectorQuantize's topk=), scores
        them by the running score minus the weighted candidate loss, and
        keeps the best beam_size, the lower index first among equal scores
        (as lax.top_k does)."""
        prec = x.shape[:-1]
        d = x.shape[-1]
        k = beam_size

        residual = x[..., None, :]                                        # (..., 1, d)
        quantized_out = torch.zeros_like(residual)
        search_scores = torch.zeros(*prec, 1, dtype=x.dtype, device=x.device)
        all_indices = torch.full((*prec, 1, 0), -1, dtype=torch.int32, device=x.device)
        all_losses = torch.zeros(*prec, 1, 0, dtype=torch.float32, device=x.device)
        all_residuals = torch.zeros(*prec, 1, 0, d, dtype=x.dtype, device=x.device)

        for quantizer_index, (vq, mlp) in enumerate(zip(self.layers, self._layer_mlps())):
            all_residuals = torch.cat((all_residuals, residual[..., None, :]), -2)   # (..., j, L+1, d)
            quantized, embed_indices, loss = vq(
                residual, mask=mask, sample_codebook_temp=sample_codebook_temp,
                freeze_codebook=freeze_codebook, topk=k, dist_precision=self.beam_score_precision,
                codebook_transform_fn=None if mlp is None else partial(mlp, condition=quantized_out),
            )                                  # quantized (..., j, k, d); indices, loss (..., j, k)
            if dropout_index is not None and quantizer_index > dropout_index:
                quantized = torch.zeros_like(quantized)
                embed_indices = torch.full_like(embed_indices, -1)
                loss = torch.zeros_like(loss)

            j = search_scores.shape[-1]
            layers_so_far = all_indices.shape[-1]
            scores = (search_scores[..., :, None] - loss * self.beam_score_weights[quantizer_index])
            scores = scores.reshape(*prec, j * k)
            residual_exp = (residual[..., :, None, :] - frac_gradient(quantized, self.quant_grad_frac))
            residual_exp = residual_exp.reshape(*prec, j * k, d)
            quantized_out_exp = (quantized_out[..., :, None, :] + quantized).reshape(*prec, j * k, d)
            indices_exp = torch.cat((
                all_indices[..., :, None, :].expand(*prec, j, k, layers_so_far),
                embed_indices[..., None],
            ), -1).reshape(*prec, j * k, -1)
            losses_exp = torch.cat((
                all_losses[..., :, None, :].expand(*prec, j, k, layers_so_far),
                loss[..., None].float(),
            ), -1).reshape(*prec, j * k, -1)
            residuals_exp = all_residuals[..., :, None, :, :].expand(*prec, j, k, layers_so_far + 1, d)
            residuals_exp = residuals_exp.reshape(*prec, j * k, layers_so_far + 1, d)

            if j * k > k:
                search_scores, select = topk_first(scores, k)
                residual, quantized_out, all_indices, all_losses, all_residuals = (
                    _batch_select(t, select)
                    for t in (residual_exp, quantized_out_exp, indices_exp, losses_exp, residuals_exp)
                )
            else:
                search_scores, residual, quantized_out = scores, residual_exp, quantized_out_exp
                all_indices, all_losses, all_residuals = indices_exp, losses_exp, residuals_exp

        # the best beam, the first on ties
        best = search_scores.argmax(-1)[..., None]
        quantized_out = _batch_select(quantized_out, best)[..., 0, :]
        all_indices = _batch_select(all_indices, best)[..., 0, :]
        all_losses = _batch_select(all_losses, best)[..., 0, :]
        all_residuals = _batch_select(all_residuals, best)[..., 0, :, :]

        # the loss: a mean per layer over the (unmasked) positions
        num_quant = self.num_quantizers
        if mask is not None:
            m = mask[..., None].to(all_losses.dtype)
            all_losses = ((all_losses * m).reshape(-1, num_quant).sum(0)
                          / mask.sum().to(all_losses.dtype).clamp_min(1e-4))
        else:
            all_losses = all_losses.reshape(-1, num_quant).mean(0)

        if self.training:
            # the EMA update replays each layer's input with the chosen
            # indices; a dropped layer's -1 counts for nothing
            for q, vq in enumerate(self.layers):
                vq.update_indices(all_residuals[..., q, :], all_indices[..., q], mask=mask)
            if self.shared_codebook:
                shared_layer = first(self.layers)
                if self.vq_is_ema_updating:
                    shared_layer._codebook.update_ema()
                    shared_layer.update_in_place_optimizer()
                shared_layer.expire_codes_(x)

        if self.diveq:
            quantized_out = directional_reparam(x, quantized_out, generator=self.generator)
        if self.project_out is not None:
            quantized_out = self.project_out(quantized_out)
        ret = (quantized_out, all_indices, all_losses)
        if not return_all_codes:
            return ret
        return (*ret, self.get_codes_from_indices(all_indices))


class GroupedResidualVQ(nn.Module):
    """Feature-dim groups, one ResidualVQ each, sharing one quantize-dropout
    index."""

    def __init__(self, *, dim: int, groups: int = 1, accept_image_fmap: bool = False, rngs=None,
                 device: str | torch.device | None = None, **kwargs):
        super().__init__()
        if rngs is not None:
            raise TypeError('rngs is a flax RNG stream; seed torch with torch.manual_seed instead')
        if dim % groups:
            raise ValueError(f'dim {dim} is not a multiple of groups {groups}')
        self.dim = dim
        self.groups = groups
        self.accept_image_fmap = accept_image_fmap
        self.rvqs = nn.ModuleList(
            ResidualVQ(dim=dim // groups, accept_image_fmap=accept_image_fmap, device=device, **kwargs)
            for _ in range(groups)
        )

    @property
    def codebooks(self) -> torch.Tensor:
        return torch.stack([rvq.codebooks for rvq in self.rvqs])

    @property
    def split_dim(self) -> int:
        return 1 if self.accept_image_fmap else -1

    def get_codes_from_indices(self, indices):
        return torch.stack([rvq.get_codes_from_indices(chunk) for rvq, chunk in zip(self.rvqs, indices)])

    def get_output_from_indices(self, indices):
        outputs = [rvq.get_output_from_indices(chunk) for rvq, chunk in zip(self.rvqs, indices)]
        return torch.cat(outputs, dim=self.split_dim)

    def forward(self, x: torch.Tensor, indices=None, return_all_codes: bool = False,
                sample_codebook_temp: float | None = None, freeze_codebook: bool = False,
                mask: torch.Tensor | None = None,
                rand_quantize_dropout_index: int | torch.Tensor | None = None):
        """x -> (quantized, indices (g, ..., q), losses (g, q)), and the codes
        with `return_all_codes`; with `indices` (one per group) ->
        (quantized, the sum of the groups' cross-entropy losses).
        `rand_quantize_dropout_index`: the dropout index all groups share;
        drawn from the first group's generator when None."""
        split_dim = self.split_dim
        if x.shape[split_dim] != self.dim:
            raise ValueError(f'expected dim {self.dim} on axis {split_dim}, got {tuple(x.shape)}')
        chunks = x.chunk(self.groups, dim=split_dim)

        indices = default(indices, ())
        return_ce_loss = len(indices) > 0
        if return_ce_loss and len(indices) != self.groups:
            raise ValueError(f'{len(indices)} index groups for {self.groups} groups')

        shared_dropout_index = None
        if self.training and first(self.rvqs).quantize_dropout and not return_ce_loss:
            shared_dropout_index = (rand_quantize_dropout_index if rand_quantize_dropout_index is not None
                                    else first(self.rvqs).draw_dropout_index())

        out = tuple(
            rvq(chunk, indices=indices[g] if return_ce_loss else None, return_all_codes=return_all_codes,
                sample_codebook_temp=sample_codebook_temp, mask=mask, freeze_codebook=freeze_codebook,
                rand_quantize_dropout_index=shared_dropout_index)
            for g, (rvq, chunk) in enumerate(zip(self.rvqs, chunks))
        )
        out = tuple(zip(*out))
        if return_ce_loss:
            quantized, ce_losses = out
            return torch.cat(quantized, dim=split_dim), sum(ce_losses)

        quantized, all_indices, commit_losses, *maybe_all_codes = out
        return (torch.cat(quantized, dim=split_dim), torch.stack(all_indices), torch.stack(commit_losses),
                *maybe_all_codes)
