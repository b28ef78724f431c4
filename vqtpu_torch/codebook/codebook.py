"""The codebook (counterpart of vqtpu/codebook/codebook.py).

Holds the codebook state with the JAX package's names and shapes (embed
(h, c, d), embed_avg, cluster_size, initted, accum_cluster_size,
accum_embed_avg, and with `affine_param` the batch and codebook means and
variances with their `*_initted` flags) and runs both forwards:

- eval: nearest-code selection and the exact row lookup, on the exact or
  the bf16 tier;
- training: the same selection and lookup, then the EMA update in the JAX
  package's order, track -> ema -> expire, with kmeans init on the first
  batch. With `train_fused='on'`, or 'auto' on the card, selection, lookup
  and batch statistics run in one fused kernel (`fused_train_quantize`);
  otherwise ('off', or 'auto' on the CPU) the selection kernel with its row
  copy (`quantize_lookup`) and `code_statistics_plain`;
- the distance-materializing path, for callers that need the (N, c)
  distances (cross-entropy and diversity losses), stochastic or gumbel
  straight-through sampling, top-k candidates or a per-token codebook
  (`codebook_transform_fn`): -cdist (euclidean) or the cosine dot in plain
  torch, full f32 on the card whatever the TF32 setting, then
  `gumbel_sample_fn`; rows by gather in eval and by the differentiable
  one-hot product in training. The JAX package computes this path outside
  any Pallas kernel too.

A learnable codebook (`learnable_codebook=True`) keeps `embed` as an
`nn.Parameter`: its looked-up rows carry their gradient to it (on the card
the selection kernel picks the rows, and the backward sums their gradients
by code in `kernels.train_fused.code_sums`), and the fused train kernel is
never taken for it. `vq_bridge` (a module or function) maps the whole
codebook before selection, and `affine_param` maps it to the batch's
running mean and variance (https://arxiv.org/abs/2203.01941); both belong
to learnable or EMA codebooks as in the JAX package.

Data parallel (`sync_axis`, a mesh axis name; see `parallel.collectives`):
the batch's counts and sums are psum'd over the axis before the EMA fold,
whichever route computed them (the fused kernel's per-rank `bins`/`esum`
or the plain statistics); kmeans init (with `sync_kmeans`) pools its
candidates and psums its bins and sums; the affine batch moments psum
with `sync_affine_param`; dead-code expiry pools every rank's candidate
rows and draws the same replacement on every rank. The ranks' state stays
bit-identical when they start identical, their random streams among them.

Row-sharded (`code_axis`, a mesh axis name; see `parallel.tp`): at rest the
codebook holds all its rows; inside a bound mesh that has the axis, its
per-code leaves (`_code_sharded_leaves`) hold the rank's window of rows and
every method works on them. Selection is `parallel.shard.sharded_nearest_code`
(the selection kernel on the rank's rows, the winners reduced over the
axis), rows come from their owner (`sharded_gather_codes`, on the bf16 tier
`sharded_quantize_lookup_bf16`), the fused train kernel is not taken, and
the statistics of the rank's rows are summed by `code_sums` (the fused
kernel's statistics passes on the card), every token of another rank's
codes sent to a dump row. The laplace total, the affine codebook moments
and kmeans' assignments cross the axis; kmeans and expiry draw the global
index vector with the stream every rank holds alike and keep their
window. The distance path computes the rank's columns and all-gathers
them. A leaf with the wrong row count for where it runs raises.

Buffers (and the EMA's writes to a learnable `embed`) are updated in place
under `torch.no_grad()` from detached tensors, so no graph is kept on them
from step to step. Random draws (kmeans init, dead-code replacement) come
from `self.generator`, the module's random stream
(`core.sampling.RandomStream`), whose state is its buffer `rng_state`,
seeded from torch's global generator at construction.
"""

from __future__ import annotations

import importlib
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..core.sampling import attach_stream, gumbel_sample, masked_sample_vectors
from ..core.utils import (
    append_dims_to, cdist, default, f32_core, l2norm, laplace_smoothing, matmul_tf32, pack_tokens,
    resolve_device, uniform_init,
)
from ..kernels.distance import (
    gather_codes, gather_codes_per_head, nearest_code_xla, quantize_lookup,
)
from ..kernels.train_fused import code_statistics_plain, code_sums, fused_train_quantize, lookup_with_code_grad
from ..parallel import collectives
from ..parallel.collectives import psum
from ..parallel.shard import (
    code_row0, local_onehot_from_global, local_or_dump, sharded_gather_codes, sharded_nearest_code,
    sharded_quantize_lookup_bf16, slice_local_cols,
)
from ..parallel.tp import check_code_rows

# the module: the package binds the name `kmeans` to the function
kmeans_module = importlib.import_module('.kmeans', __package__)


# stat_precision: the JAX package's matmul precision of the statistics.
# 'highest' sums in f32; 'high' and 'default' mean TF32 products on a GPU
STAT_PRECISIONS = ('highest', 'high', 'default')


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

    # the per-code leaves and the position of their code-row dim from the
    # end, sharded over `code_axis` (parallel.tp)
    _code_sharded_leaves = {'embed': 2, 'embed_avg': 2, 'accum_embed_avg': 2, 'cluster_size': 1,
                            'accum_cluster_size': 1}

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
        in plain torch instead of the kernels. `gumbel_sample_fn` (default
        `core.sampling.gumbel_sample`) picks codes from the distances on the
        distance-materializing path, with `self.generator` for its noise
        and `sample_codebook_temp` as its temperature.

        `stat_precision`, the JAX package's precision of the matmul that
        sums the batch statistics into the EMA state: 'highest' (the
        default) sums exact f32 rows by code, on the card in the fused
        kernel or `index_put_`; 'high' and 'default' form the one-hot
        product, which on the card runs in TF32 (what both mean for JAX on
        a GPU; f32 on the CPU) and keeps off the fused kernel, as in JAX.

        `sync_axis` names the data-parallel mesh axis (None: one replica);
        `sync_kmeans` and `sync_affine_param` say whether kmeans init and
        the affine batch moments sync over it too. `code_axis` names the
        mesh axis the codebook's rows shard over (None: not sharded)."""
        super().__init__()
        if code_axis is not None and vq_bridge is not None:
            raise ValueError('vq_bridge transforms the whole codebook jointly and cannot run on row-sharded state')
        stat_precision = str(stat_precision).lower()
        if stat_precision not in STAT_PRECISIONS:
            raise ValueError(f'stat_precision must be one of {STAT_PRECISIONS}, got {stat_precision!r}')
        if affine_param and use_cosine_sim:
            raise ValueError('affine param is only compatible with euclidean codebook')
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
        self.stat_precision = stat_precision
        self.learnable_codebook = learnable_codebook
        self.sync_axis = sync_axis
        self.code_axis = code_axis
        self.sync_kmeans = sync_kmeans
        self.sync_affine_param = sync_affine_param
        self.vq_bridge = vq_bridge
        self.affine_param = affine_param
        self.affine_param_batch_decay = affine_param_batch_decay
        self.affine_param_codebook_decay = affine_param_codebook_decay
        # (h, c) rows that the last forward which updated usage overwrote
        # (None: none); see embed_after_forward
        self.rewritten_rows = None
        self.gumbel_sample_fn = default(gumbel_sample_fn, gumbel_sample)
        self.sample_codebook_temp = sample_codebook_temp
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

        if learnable_codebook:
            self.embed = nn.Parameter(embed)
        else:
            self.register_buffer('embed', embed)
        self.register_buffer('embed_avg', embed.clone())
        self.register_buffer('cluster_size', torch.ones(shape[:2], device=device))
        self.register_buffer('initted', torch.tensor(not kmeans_init, device=device))
        # `initted` as this module's last forward left it, mirrored on the
        # host (False: not known, read the buffer); see init_embed_
        self.initted_on_host = False
        self.register_buffer('accum_cluster_size', torch.zeros(shape[:2], device=device))
        self.register_buffer('accum_embed_avg', torch.zeros(shape, device=device))
        if affine_param:
            stat_shape = (num_codebooks, 1, dim)
            for which in ('batch', 'codebook'):
                self.register_buffer(f'{which}_mean', torch.zeros(stat_shape, device=device))
                self.register_buffer(f'{which}_variance', torch.ones(stat_shape, device=device))
                self.register_buffer(f'{which}_mean_initted', torch.tensor(False, device=device))
                self.register_buffer(f'{which}_variance_initted', torch.tensor(False, device=device))

        self.generator = attach_stream(self, device)

    def transform_input(self, x: torch.Tensor) -> torch.Tensor:
        return l2norm(x) if self.use_cosine_sim else x

    def _code_parallel(self) -> bool:
        """Whether the codebook works on a row shard: inside a bound mesh
        that has `code_axis` (its leaves must then hold the rank's rows;
        outside, all rows)."""
        return self.code_axis is not None and check_code_rows(self, self.embed.shape[-2])

    def _code_row0(self) -> int:
        return code_row0(self.code_axis, self.embed.shape[-2])

    def _train_fused_active(self, device_type: str) -> bool:
        """Whether a training forward on tensors of `device_type` takes the
        fused kernel. 'on': always. 'off': never, the composition (the
        selection kernel with its row copy, then `code_statistics_plain`).
        'auto': the fused kernel on the card ('cuda'); elsewhere the
        composition, which is the JAX package's 'auto' on every device.

        On the card the fused step is the faster on both codebooks that
        chip_smoke.py's train_times phase measures (an H100 80GB HBM3 at
        700 W, n = 2^20, c = 512, d = 256): it runs the composition's own
        selection kernel, and its statistics do not follow the largest
        cluster as index_put_'s do."""
        if self.train_fused == 'auto':
            return device_type == 'cuda'
        return self.train_fused == 'on'

    def _embed_value(self) -> torch.Tensor:
        """The codebook this forward selects from. A learnable one, while
        gradients are recorded, as a copy that carries the gradient to
        `embed`: the forward may overwrite `embed` in place after selecting
        (the EMA update, expired codes), and a graph that kept `embed`
        itself would then refuse its backward."""
        if self.learnable_codebook and torch.is_grad_enabled():
            return self.embed.clone()
        return self.embed

    def _mark_rewritten(self, rows: torch.Tensor | None = None):
        """Record that the forward overwrote codebook rows: `rows` (h, c),
        or all of them."""
        if rows is None:
            rows = torch.ones(self.embed.shape[:2], dtype=torch.bool, device=self.embed.device)
        self.rewritten_rows = rows if self.rewritten_rows is None else self.rewritten_rows | rows

    def embed_after_forward(self) -> torch.Tensor:
        """The codebook as the last forward that updated usage left it. The
        rows it overwrote (the EMA update, kmeans init, expired codes) take
        no gradient; the others carry it to a learnable `embed`. That is the
        JAX package's rule: there a write inside the forward replaces the
        parameter's traced value with a constant."""
        embed = self.embed
        if self.rewritten_rows is None:
            return embed
        if bool(self.rewritten_rows.all()):
            return embed.detach()
        return torch.where(self.rewritten_rows[..., None], embed.detach(), embed)

    # -- affine statistics ---------------------------------------------------

    @torch.no_grad()
    def _update_with_decay(self, name: str, new_value: torch.Tensor, decay: float):
        var = getattr(self, name)
        flag = getattr(self, name + '_initted')
        var.copy_(torch.where(flag, var * decay + new_value * (1.0 - decay), new_value))
        flag.fill_(True)

    @torch.no_grad()
    def update_affine(self, flatten: torch.Tensor, embed: torch.Tensor, mask: torch.Tensor | None = None):
        """Fold the codebook's per-dim mean and variance over its codes (in
        training) and the batch's over its tokens where `mask` (h, N) is
        True (in either mode, as in the JAX package) into their EMAs."""
        embed = embed.detach().reshape(embed.shape[0], -1, embed.shape[-1])
        if self.training:
            decay = self.affine_param_codebook_decay
            if self._code_parallel():
                # the moments over every rank's rows: partial sums psum'd
                # over the code axis, divided by the whole codebook's size
                c_mean = psum(embed.sum(-2, keepdim=True), self.code_axis) / self.codebook_size
                c_var = psum(((embed - c_mean) ** 2).sum(-2, keepdim=True), self.code_axis) / self.codebook_size
            else:
                c_mean, c_var = embed.mean(-2, keepdim=True), embed.var(-2, keepdim=True, unbiased=False)
            self._update_with_decay('codebook_mean', c_mean, decay)
            self._update_with_decay('codebook_variance', c_var, decay)
        sync = self.sync_axis if self.sync_affine_param else None
        if mask is not None:
            w = mask.float()[..., None]                                 # (h, N, 1)
            count = w.sum(-2, keepdim=True)
            batch_sum = (flatten * w).sum(-2, keepdim=True)
        else:
            w = None
            count = torch.full((flatten.shape[0], 1, 1), float(flatten.shape[1]), device=flatten.device)
            batch_sum = flatten.sum(-2, keepdim=True)
        count = psum(count, sync).clamp_min(1.0)
        batch_mean = psum(batch_sum, sync) / count
        sq = (flatten - batch_mean) ** 2
        var_numer = psum((sq if w is None else sq * w).sum(-2, keepdim=True), sync)
        self._update_with_decay('batch_mean', batch_mean, self.affine_param_batch_decay)
        self._update_with_decay('batch_variance', var_numer / count, self.affine_param_batch_decay)

    def _affine_stds(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The codebook's and the batch's std per dim, (h, 1, d) each."""
        return (torch.sqrt(self.codebook_variance.clamp_min(1e-5)),
                torch.sqrt(self.batch_variance.clamp_min(1e-5)))

    def _affine_scale(self) -> torch.Tensor:
        """s = codebook std / batch std, per dim (h, 1, d)."""
        codebook_std, batch_std = self._affine_stds()
        return codebook_std / batch_std

    def _affine_to_batch(self, embed: torch.Tensor) -> torch.Tensor:
        codebook_std, batch_std = self._affine_stds()
        return (embed - self.codebook_mean) * (batch_std / codebook_std) + self.batch_mean

    def _affine_to_codebook(self, flatten: torch.Tensor) -> torch.Tensor:
        return (flatten - self.batch_mean) * self._affine_scale() + self.codebook_mean

    # -- kmeans init ---------------------------------------------------------

    @torch.no_grad()
    def init_embed_(self, flatten: torch.Tensor, mask: torch.Tensor | None = None):
        """First-batch kmeans init, the JAX package's `lax.cond` on the
        `initted` flag: kmeans' (embed, embed_avg, cluster_size) while the
        flag is False, the codebook's own after. The kmeans key is split off
        the stream on every call, as `self.rngs.kmeans()` is, so the stream
        advances whether or not init runs. Once a forward has passed here
        the flag is True, and `initted_on_host` says so: later calls return
        with no work and no host read, and a compiled step, which guards on
        that attribute, compiles once more without kmeans. Until then kmeans
        runs in the op `vqtpu::kmeans`, which reads the flag (a loaded
        codebook may be initted already) and returns at once when it is
        set, and a select; the rows are marked rewritten where it ran."""
        key = self.generator.split()
        if self.initted_on_host:
            return
        initted = self.initted.clone()
        means, bins = kmeans_module.kmeans_op(
            flatten.detach().contiguous(), key, self.codebook_size, self.kmeans_iters, self.use_cosine_sim, mask,
            self.sync_axis if self.sync_kmeans else None, self.code_axis if self._code_parallel() else None,
            initted)
        embed_sum = means * bins[..., None]
        self.embed.copy_(torch.where(initted, self.embed, self._normalized_embed(embed_sum, bins)))
        self.embed_avg.copy_(torch.where(initted, self.embed_avg, embed_sum))
        self.cluster_size.copy_(torch.where(initted, self.cluster_size, bins))
        self.initted.fill_(True)
        self._mark_rewritten((~initted).expand(self.embed.shape[:2]))
        self.initted_on_host = True

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a loaded `initted` may be False: the next forward reads it
        self.initted_on_host = False
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    # -- EMA update machinery ------------------------------------------------

    def _normalized_embed(self, embed_avg: torch.Tensor, cluster_size: torch.Tensor) -> torch.Tensor:
        if self._code_parallel():
            # the laplace total is the mass of every rank's rows
            total = psum(cluster_size.sum(-1, keepdim=True), self.code_axis)
            smoothed = (cluster_size + self.eps) / (total + self.codebook_size * self.eps) * total
        else:
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
        self._mark_rewritten()

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
        `mask` (h, N) is False count for nothing. With `affine_param` the
        tokens are first mapped to the codebook's statistics."""
        flatten = flatten.detach().float()
        if self._code_parallel():
            # the rank's rows: codes of other ranks go to a dump row c_local
            c_local, row0 = self.embed.shape[-2], self._code_row0()
            if self.stat_precision != 'highest':
                onehot = local_onehot_from_global(embed_ind, c_local, row0)
                bins, embed_sum = self._onehot_statistics(flatten, onehot, mask)
            else:
                if self.affine_param:
                    flatten = self._affine_to_codebook(flatten)
                weights = None if mask is None else mask.float().contiguous()
                local = local_or_dump(embed_ind, c_local, row0).contiguous()
                bins, embed_sum = code_sums(flatten.contiguous(), local, c_local + 1, weights)
                bins, embed_sum = bins[:, :c_local], embed_sum[:, :c_local]
        elif self.stat_precision != 'highest':
            onehot = F.one_hot(embed_ind.long(), self.codebook_size).float()
            bins, embed_sum = self._onehot_statistics(flatten, onehot, mask)
        else:
            if self.affine_param:
                flatten = self._affine_to_codebook(flatten)
            weights = None if mask is None else mask.float()
            bins, embed_sum = code_statistics_plain(flatten, embed_ind, self.codebook_size, weights)
        self._apply_batch_stats(bins, embed_sum, ema_update_weight, accum_ema_update)

    @torch.no_grad()
    def _apply_batch_stats(
        self,
        cluster_size: torch.Tensor,
        embed_sum: torch.Tensor,
        ema_update_weight=None,
        accum_ema_update: bool = False,
    ):
        """psum this rank's (h, c) counts and (h, c, d) sums over the data
        axis, then fold them into the EMA state, or into the accumulators
        when `accum_ema_update`."""
        cluster_size = psum(cluster_size, self.sync_axis)
        embed_sum = psum(embed_sum, self.sync_axis)
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
        slot and merged with `where`, so no host sync decides the draw. With
        `sync_axis` the candidates are drawn from every rank's (pooled with
        `all_gather`), and a head is skipped only when no rank has a valid
        token, so that every replica replaces the same rows."""
        if self.use_cosine_sim:
            batch_samples = l2norm(batch_samples)
        batch_samples = batch_samples.detach().float()
        h = batch_samples.shape[0]
        if self._code_parallel():
            # the rank's window of the global draw, never (c, d) candidates
            sampled = torch.stack([
                kmeans_module.sharded_draw(
                    self.generator, batch_samples[i], None if seq_mask is None else seq_mask[i],
                    self.codebook_size, self.code_axis, self.sync_axis,
                )
                for i in range(h)
            ])
        else:
            sampled = torch.stack([
                masked_sample_vectors(
                    self.generator, batch_samples[i],
                    None if seq_mask is None else seq_mask[i], self.codebook_size,
                )
                for i in range(h)
            ])
            sampled = kmeans_module.pool_candidates(self.generator, sampled, self.sync_axis)
        if seq_mask is not None:
            has_valid = psum(seq_mask.any(-1)[:, None].float(), self.sync_axis) > 0
        else:
            has_valid = torch.ones(h, 1, dtype=torch.bool, device=batch_mask.device)
        replace_mask = batch_mask & has_valid                          # (h, c)

        self.embed.copy_(torch.where(replace_mask[..., None], sampled, self.embed))
        self._mark_rewritten(replace_mask)
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

    @f32_core
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
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
        """Quantize (h?, b, n, d) tokens -> (quantize, indices int32,
        distances or None).

        With `need_distances=False` and none of `topk`, `stochastic` (in
        training), `straight_through_onehot` or `codebook_transform_fn`, the
        kernels select and look up without forming the distances, and the
        third value is None. Otherwise the distances (h, b, n, c) are the
        third value (with the head dim even for a (b, n, d) input, as in the
        JAX package), `topk=k` adds a candidate dim k before d in quantize
        and last in the indices, and `codebook_transform_fn(embed)` gives a
        per-token codebook (h, b, n, c, d).

        The quantized rows are codebook rows (after `vq_bridge` and the
        affine map): an EMA codebook's are detached, a learnable one's carry
        their gradient to `embed` and the bridge (not on the bf16 tier). In
        training the distance path looks them up by the one-hot product,
        which also carries the gumbel straight-through gradient to the
        distances. In training mode (and with `update_usage`, without
        `freeze_codebook` and without `topk`) the batch updates the EMA
        state and expires dead codes; `mask` (b, n) weights those
        statistics. With `affine_param` every forward also folds the batch's
        mean and variance into their EMAs (and in training the codebook's).
        `dist_precision` is the JAX package's matmul precision knob: the
        distances here are always full f32. The whole forward (kmeans init,
        selection, the EMA update and expiry) runs on f32 tokens with
        autocast off (`core.utils.f32_core`), whatever the caller's
        autocast, as the JAX package forces its core to f32.
        """
        ema_update = default(ema_update, self.ema_update)
        sample_codebook_temp = default(sample_codebook_temp, self.sample_codebook_temp)

        needs_codebook_dim = x.ndim < 4
        x = x.float()
        if needs_codebook_dim:
            x = x[None]
        tokens, unpack = pack_tokens(x)                           # (h, N, d)
        flatten = tokens.detach().contiguous()
        h, num_tokens = flatten.shape[:2]
        if self.embed.shape[0] != h:
            raise ValueError(f'{h} head groups of tokens for {self.embed.shape[0]} codebooks')
        flat_mask = None if mask is None else _expand_mask(mask, h, num_tokens)
        if update_usage:
            self.rewritten_rows = None

        if self.kmeans_init:
            # as in the JAX package, in either mode: a no-op once initted
            self.init_embed_(flatten, mask=flat_mask)
        if self.affine_param:
            self.update_affine(flatten, self.embed, mask=flat_mask)

        embed = self._embed_value()
        if self.vq_bridge is not None:
            embed = self.vq_bridge(embed).contiguous()
        if self.affine_param:
            embed = self._affine_to_batch(embed)
        metric = 'cosine' if self.use_cosine_sim else 'euclidean'
        update = self.training and update_usage and not freeze_codebook
        use_stochastic = (self.training and stochastic and sample_codebook_temp is not None
                          and sample_codebook_temp > 0)
        fast_path = (not need_distances and not use_stochastic and not straight_through_onehot
                     and topk is None and codebook_transform_fn is None)
        batch_stats = None
        dist = embed_onehot = None
        code_parallel = self._code_parallel()

        if not fast_path:
            embed_ind, quantize, dist, embed_onehot = self._distance_select(
                tokens, embed, sample_codebook_temp, topk, codebook_transform_fn)
            if code_parallel:
                # as in the JAX package, the statistics of a row shard come
                # from the indices, not the sampler's one-hot
                embed_onehot = None
        elif code_parallel:
            embed_ind, quantize = self._sharded_select(flatten, embed, metric)
        elif update and self._fused_train_eligible() and self._train_fused_active(flatten.device.type):
            weights = None if flat_mask is None else flat_mask.float().contiguous()
            embed_ind, quantize, bins, esum = fused_train_quantize(
                flatten, embed, metric, weights
            )
            if self.affine_param:
                # the kernel summed raw x; the map to the codebook's
                # statistics, x s + t per dim, distributes over the sums
                # exactly: sum w (x s + t) = s (sum w x) + t (sum w)
                scale = self._affine_scale()
                esum = scale * esum + bins[..., None] * (self.codebook_mean - self.batch_mean * scale)
            batch_stats = (bins, esum)
        elif not self.training and self.quantize_tier == 'bf16':
            embed_ind, quantize = quantize_lookup(flatten, embed.detach(), metric, tier='bf16')
        elif self.use_pallas and embed.requires_grad:
            # the selection kernel's rows, whose backward sums by code
            embed_ind, quantize = lookup_with_code_grad(flatten, embed, metric)
        elif self.use_pallas:
            # on the card, selection and row copy in one kernel launch
            embed_ind, quantize = quantize_lookup(flatten, embed, metric)
        else:
            embed_ind = nearest_code_xla(flatten, embed.detach(), metric)
            quantize = gather_codes_per_head(embed, embed_ind)

        if update and topk is None:
            if embed_onehot is not None:
                # as in the JAX package: the sampler's one-hot, whose
                # straight-through form is 1 or 0 only to within an ulp
                batch_stats = self._onehot_statistics(flatten, embed_onehot, flat_mask)
            if batch_stats is not None:
                self.update_codebook_from_stats(
                    flatten, *batch_stats, mask=flat_mask, ema_update_weight=ema_update_weight,
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
        return quantize, embed_ind, None if dist is None else unpack(dist)

    def _sharded_select(self, flatten, embed, metric):
        """The fast path on a row shard: (h, N) global indices and their
        rows, per head; the bf16 tier in eval, else the selection kernel on
        the rank's rows and the rows from their owners (carrying their
        gradient to a learnable shard)."""
        if not self.training and self.quantize_tier == 'bf16':
            out = [sharded_quantize_lookup_bf16(flatten[i], embed[i], self.code_axis, metric)
                   for i in range(flatten.shape[0])]
        else:
            out = []
            for i in range(flatten.shape[0]):
                idx = sharded_nearest_code(flatten[i], embed[i], self.code_axis, metric)
                out.append((idx, sharded_gather_codes(embed[i], idx, self.code_axis)))
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    def _fused_train_eligible(self) -> bool:
        """Whether the fused train kernel may take this codebook's training
        forward, as in the JAX package: its rows carry no gradient (no
        learnable codebook, no bridge), and its statistics are the exact
        ones."""
        return (self.use_pallas and not self.learnable_codebook and self.vq_bridge is None
                and self.stat_precision == 'highest')

    @torch.no_grad()
    def _onehot_statistics(self, flatten, embed_onehot, mask):
        """(h, N, d) tokens and their (h, N, c) one-hot -> (bins (h, c), esum
        (h, c, d)), tokens where `mask` (h, N) is False counting for
        nothing, mapped first to the codebook's statistics with
        `affine_param`; the product in full f32, or TF32 on the card with a
        `stat_precision` other than 'highest'."""
        w = embed_onehot.detach().float()
        if mask is not None:
            w = w * mask[..., None]
        if self.affine_param:
            flatten = self._affine_to_codebook(flatten)
        with matmul_tf32(flatten.device, allow=self.stat_precision != 'highest'):
            return w.sum(1), w.transpose(1, 2) @ flatten

    def _distance_select(self, tokens, embed, temperature, topk, codebook_transform_fn):
        """The distance-materializing path: (h, N, d) tokens (carrying their
        gradient) -> (indices (h, N[, k]) int32, rows (h, N[, k], d),
        distances (h, N, c), the sampler's one-hot (h, N[, k], c)).

        Distances are -cdist (euclidean) or the dot (cosine), against the
        codebook or the per-token codebook of `codebook_transform_fn`; the
        codes come from `gumbel_sample_fn`. Rows: in eval an exact gather
        (the JAX package's one-hot product at HIGHEST is the same values);
        in training the one-hot product in full f32, which is exact for a
        0/1 one-hot and differentiable through a straight-through one."""
        h, num_tokens, d = tokens.shape
        # the graph keeps the codebook as it was: the EMA update writes the
        # buffer in place before the backward pass
        embed = embed.clone()
        transformed = None
        code_parallel = self._code_parallel()
        if code_parallel:
            # a rank's distances are its columns: its share of the tokens'
            # gradient is partial, and the psum in the backward sums it
            tokens = collectives.psum_in_bwd(tokens, self.code_axis)
        with matmul_tf32(tokens.device, allow=False):
            if codebook_transform_fn is not None:
                transformed = codebook_transform_fn(embed)               # (h, b, n, c, d)
                transformed = transformed.reshape(h, num_tokens, *transformed.shape[-2:])
                if self.use_cosine_sim:
                    transformed = l2norm(transformed)
                    dist = (transformed @ tokens[..., None])[..., 0]      # (h, N, c)
                else:
                    diff = tokens[..., None, :] - transformed
                    dist = -torch.sqrt((diff ** 2).sum(-1).clamp_min(1e-12))
            elif self.use_cosine_sim:
                dist = tokens @ embed.transpose(-1, -2)
            else:
                dist = -cdist(tokens, embed)
            if code_parallel:
                # every rank's columns, in code order; the backward hands
                # each rank its own columns' cotangent
                dist = collectives.all_gather_exact(dist, self.code_axis, concat_axis=2)

            embed_ind, embed_onehot = self.gumbel_sample_fn(
                self.generator, dist, temperature=temperature, training=self.training, topk=topk,
            )
            c = dist.shape[-1]
            if code_parallel:
                quantize = self._sharded_distance_rows(embed, transformed, embed_ind, embed_onehot)
            elif transformed is not None:
                if self.training:
                    onehot = embed_onehot.reshape(h, num_tokens, -1, c)
                    quantize = onehot @ transformed                       # (h, N, K, d)
                else:
                    ind = embed_ind.reshape(h, num_tokens, -1, 1).long().expand(-1, -1, -1, d)
                    quantize = transformed.gather(2, ind)
                quantize = quantize.reshape(*embed_ind.shape, d)
            elif self.training:
                onehot = embed_onehot.reshape(h, -1, c)
                quantize = (onehot @ embed).reshape(*embed_ind.shape, d)
            else:
                quantize = torch.stack([gather_codes(embed[i], embed_ind[i]) for i in range(h)])
        return embed_ind, quantize, dist, embed_onehot

    def _sharded_distance_rows(self, embed, transformed, embed_ind, embed_onehot):
        """The distance path's rows on a row shard: each rank contributes
        its own codes' rows and psum_exact sums them. In training through the
        rank's columns of the sampler's one-hot (`slice_local_cols`, whose
        backward gives the one-hot its full cotangent); in eval through the
        one-hot of the indices over the rank's window, or the row gather."""
        h, num_tokens = embed_ind.shape[:2]
        c_local = embed.shape[-2]
        d = embed.shape[-1]
        if self.training:
            onehot = slice_local_cols(embed_onehot, c_local, self.code_axis)
        elif transformed is None:
            return torch.stack([sharded_gather_codes(embed[i], embed_ind[i], self.code_axis) for i in range(h)])
        else:
            onehot = local_onehot_from_global(embed_ind, c_local, self._code_row0())
        if transformed is not None:
            local = onehot.reshape(h, num_tokens, -1, c_local) @ transformed      # (h, N, K, d)
        else:
            local = onehot.reshape(h, -1, c_local) @ embed
        return collectives.psum_exact(local, self.code_axis).reshape(*embed_ind.shape, d)
