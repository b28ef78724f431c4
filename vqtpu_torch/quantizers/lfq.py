"""LFQ, lookup-free (sign) quantization (counterpart of vqtpu/quantizers/lfq.py).

Each dimension quantizes to {-scale, +scale} by its sign, and in training an
entropy aux loss pushes each token's code distribution to be confident and
the batch's code usage to be uniform. The constructor takes the JAX
module's kwargs (spherical / BSQ codes, several codebooks, per-layer
codebook_scale, soft input clamp, cosine-sim projection, orthogonal
rotation, fractional per-sample entropy, the softplus variant and the
commitment loss).

The entropy statistics take one of three routes over the implicit codebook
of K = 2^codebook_dim codes:

  - dense: the (tokens, codebooks, K) softmax, for K up to 2^16;
  - streamed: the codes in chunks, an online logsumexp and a second pass,
    each chunk's body under torch.utils.checkpoint (chunked when K > 2^16
    or `entropy_chunk_size` asks for it);
  - fused: `kernels.lfq_entropy.lfq_entropy_stats`, one call per codebook,
    the hand-written Hopper kernels on the card.

`entropy_fused='auto'` takes the fused route when the tensors are on the
card, the statistics are chunked and the sweeps take the codebook
(codebook_dim <= 24); 'on' and 'off' force it (`entropy_route`). Masked tokens
are weighted out, never dropped, as in the JAX package.

Data parallel (`sync_axis`, a mesh axis name; see `parallel.collectives`):
the batch's average code distribution is psum'd over the axis, its
numerator and its token weight, through the differentiable `psum` (whose
backward sums the cotangent), on every route. On the fused route the
sweeps run per rank on the rank's tokens, and the psum sits between their
statistics and the codebook entropy, so the backward sweeps see the
gradient of the global distribution. The per-sample entropy stays a mean
over the rank's tokens, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.layout import to_tokens
from ..core.sampling import attach_stream, gumbel_noise
from ..core.utils import (
    default, entropy as entropy_fn, f32_core, l2norm, random_orthogonal, resolve_device, rotate,
)
from ..kernels.lfq_entropy import MAX_DIM, code_magnitude, lfq_entropy_stats
from ..parallel.collectives import psum


def entropy_route(mode: str, device_type: str, codebook_dim: int, chunk: int | None) -> str:
    """The route of the entropy statistics of a 2^codebook_dim-code LFQ with
    `entropy_fused=mode` on tensors of `device_type`, chunked in `chunk`
    codes (None: not chunked): 'fused', 'streamed' or 'dense'.

    'on' takes the fused sweeps; on the card they take 1 <= codebook_dim <=
    MAX_DIM, so a wider codebook raises there. 'auto' takes them when the
    tensors are on the card ('cuda'), the statistics are chunked and the
    sweeps take the codebook, and otherwise the streamed route when chunked
    (as the JAX package's 'auto' does on a device without the sweeps), else
    the dense one. 'off' never takes them."""
    chunked = chunk is not None and chunk < 1 << codebook_dim
    if mode == 'on':
        if device_type == 'cuda' and codebook_dim > MAX_DIM:
            raise ValueError(f"entropy_fused='on': the sweeps take 1 <= d <= {MAX_DIM} on the card, "
                             f'got codebook_dim {codebook_dim}')
        return 'fused'
    if mode == 'auto' and device_type == 'cuda' and chunked and codebook_dim <= MAX_DIM:
        return 'fused'
    return 'streamed' if chunked else 'dense'


class Return(NamedTuple):
    quantized: torch.Tensor
    indices: torch.Tensor
    entropy_aux_loss: torch.Tensor


class LossBreakdown(NamedTuple):
    per_sample_entropy: torch.Tensor
    batch_entropy: torch.Tensor
    commitment: torch.Tensor


class CosineSimLinear(nn.Module):
    """Linear layer over l2-normalized input and weight columns; the weight
    is (dim_in, dim_out), as in the JAX package. `device` as for LFQ: the
    CUDA card when None (raises if there is none), or 'cpu'."""

    def __init__(self, dim_in: int, dim_out: int, scale: float = 1.0, *, device=None):
        super().__init__()
        self.scale = scale
        self.weight = nn.Parameter(torch.randn(dim_in, dim_out, device=resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = l2norm(x)
        w = self.weight
        w = w / torch.linalg.vector_norm(w, dim=0, keepdim=True).clamp_min(1e-12)
        return (x @ w) * self.scale


class LFQ(nn.Module):
    def __init__(
        self,
        *,
        dim: int | None = None,
        codebook_size: int | None = None,
        entropy_loss_weight: float = 0.1,
        commitment_loss_weight: float = 0.0,
        diversity_gamma: float = 1.0,
        num_codebooks: int = 1,
        keep_num_codebooks_dim: bool | None = None,
        codebook_scale: float = 1.0,
        frac_per_sample_entropy: float = 1.0,
        has_projections: bool | None = None,
        projection_has_bias: bool = True,
        soft_clamp_input_value: float | None = None,
        cosine_sim_project_in: bool = False,
        cosine_sim_project_in_scale: float | None = None,
        channel_first: bool | None = None,
        straight_through_activation=None,
        experimental_softplus_entropy_loss: bool = False,
        entropy_loss_offset: float = 5.0,
        spherical: bool = False,
        force_quantization_f32: bool = True,
        orthogonal_rotation: bool = False,
        sync_axis: str | None = None,
        entropy_chunk_size: int | None = None,
        entropy_fused: str = 'auto',
        rngs=None,
        device: str | torch.device | None = None,
    ):
        """`device`: where the module lives; the CUDA card when None (raises
        if there is none), or 'cpu'. `rngs` is kept for the JAX signature
        and must be None: parameters come from torch's global generator, and
        the draws (orthogonal rotation, the token subsample of
        `frac_per_sample_entropy < 1`) from `self.generator`, seeded from it."""
        super().__init__()
        if rngs is not None:
            raise TypeError('rngs is a flax RNG stream; seed torch with torch.manual_seed instead')
        if dim is None and codebook_size is None:
            raise ValueError('either dim or codebook_size must be specified for LFQ')
        if codebook_size is not None and not math.log2(codebook_size).is_integer():
            raise ValueError(
                f'your codebook size must be a power of 2 for lookup free quantization '
                f'(suggested {2 ** math.ceil(math.log2(codebook_size))})'
            )
        if entropy_fused not in ('auto', 'on', 'off'):
            raise ValueError(f"entropy_fused must be 'auto', 'on' or 'off', got {entropy_fused!r}")
        device = resolve_device(device)

        if codebook_size is None:
            codebook_size = 2 ** dim
        self.codebook_size = codebook_size

        codebook_dim = int(math.log2(codebook_size))
        codebook_dims = codebook_dim * num_codebooks
        dim = default(dim, codebook_dims)

        has_projections = default(has_projections, dim != codebook_dims)
        if has_projections:
            if cosine_sim_project_in:
                scale = default(cosine_sim_project_in_scale, codebook_scale)
                self.project_in = CosineSimLinear(dim, codebook_dims, scale=scale, device=device)
            else:
                self.project_in = nn.Linear(dim, codebook_dims, bias=projection_has_bias, device=device)
            self.project_out = nn.Linear(codebook_dims, dim, bias=projection_has_bias, device=device)
        else:
            self.project_in = None
            self.project_out = None
        self.has_projections = has_projections

        self.dim = dim
        self.codebook_dim = codebook_dim
        self.num_codebooks = num_codebooks

        keep_num_codebooks_dim = default(keep_num_codebooks_dim, num_codebooks > 1)
        if num_codebooks > 1 and not keep_num_codebooks_dim:
            raise ValueError('keep_num_codebooks_dim must be True with several codebooks')
        self.keep_num_codebooks_dim = keep_num_codebooks_dim
        self.channel_first = channel_first
        self.spherical = spherical

        self.generator = attach_stream(self, device)

        # powers of two, MSB first; derived, so not part of the state
        self.register_buffer(
            'bit_mask', 2 ** torch.arange(codebook_dim - 1, -1, -1, device=device), persistent=False
        )

        self.orthogonal_rotation = orthogonal_rotation
        if orthogonal_rotation:
            self.register_buffer('orthogonal_rot', random_orthogonal(codebook_dim, self.generator, device))

        if not 0 < frac_per_sample_entropy <= 1.0:
            raise ValueError(f'frac_per_sample_entropy must be in (0, 1], got {frac_per_sample_entropy}')
        self.frac_per_sample_entropy = frac_per_sample_entropy

        self.diversity_gamma = diversity_gamma
        self.entropy_loss_weight = entropy_loss_weight
        self.codebook_scale = codebook_scale
        self.commitment_loss_weight = commitment_loss_weight

        if soft_clamp_input_value is not None and soft_clamp_input_value < codebook_scale:
            raise ValueError('soft_clamp_input_value must be at least codebook_scale')
        self.soft_clamp_input_value = soft_clamp_input_value

        self.entropy_loss_offset = entropy_loss_offset
        self.straight_through_activation = default(straight_through_activation, lambda t: t)
        self.experimental_softplus_entropy_loss = experimental_softplus_entropy_loss
        self.force_quantization_f32 = force_quantization_f32

        if entropy_chunk_size is not None and not (
            math.log2(entropy_chunk_size).is_integer() and entropy_chunk_size <= codebook_size
        ):
            raise ValueError(f'entropy_chunk_size must be a power of two <= codebook_size, got {entropy_chunk_size}')
        self.entropy_chunk_size = entropy_chunk_size
        self.entropy_fused = entropy_fused
        self.sync_axis = sync_axis

    # -- bit codec (derived constants, never stored) -------------------------

    def bits_to_codes(self, bits: torch.Tensor) -> torch.Tensor:
        return bits * self.codebook_scale * 2 - self.codebook_scale

    def maybe_l2norm(self, t: torch.Tensor) -> torch.Tensor:
        if not self.spherical:
            return t
        return l2norm(t) * self.codebook_scale

    def _bits(self, indices: torch.Tensor) -> torch.Tensor:
        return ((indices[..., None] & self.bit_mask) != 0).float()

    @property
    def codebook(self) -> torch.Tensor:
        """All 2^d sign patterns as code vectors, recomputed on demand."""
        return self.bits_to_codes(self._bits(torch.arange(self.codebook_size, device=self.bit_mask.device)))

    @property
    def dtype(self):
        return torch.float32

    def indices_to_codes(self, indices: torch.Tensor, project_out: bool = True) -> torch.Tensor:
        is_img_or_video = indices.ndim >= (3 + int(self.keep_num_codebooks_dim))
        should_transpose = default(self.channel_first, is_img_or_video)

        if not self.keep_num_codebooks_dim:
            indices = indices[..., None]

        codes = self.maybe_l2norm(self.bits_to_codes(self._bits(indices.long())))
        if self.orthogonal_rotation:
            codes = rotate(codes, self.orthogonal_rot.T)
        codes = codes.reshape(*codes.shape[:-2], -1)

        if project_out and self.project_out is not None:
            codes = self.project_out(codes)
        if should_transpose:
            codes = codes.movedim(-1, 1)
        return codes

    # -- entropy machinery -----------------------------------------------------

    def subsample_tokens(self, weights: torch.Tensor, num_sampled: int) -> torch.Tensor:
        """`num_sampled` token positions, uniform over the tokens of nonzero
        weight: the top scores of Gumbel noise drawn from `self.generator`."""
        noise = gumbel_noise(self.generator, (weights.shape[0],), weights.device)
        scores = torch.where(weights > 0, 0.0, -1e9) + noise
        return scores.topk(num_sampled).indices

    @f32_core
    def _entropy_terms(self, original_input, inv_temperature, mask):
        """Per-sample entropy (mean over tokens) and batch codebook entropy
        of (b, n, c, d) f32 inputs; masked tokens weigh 0. The products with
        the codes run with autocast off."""
        flat = original_input.reshape(-1, *original_input.shape[-2:])      # (N, c, d)
        num_tokens = flat.shape[0]
        if mask is not None:
            weights = mask.reshape(-1).float()
        else:
            weights = torch.ones(num_tokens, device=flat.device)

        if self.frac_per_sample_entropy < 1.0:
            num_sampled = max(int(num_tokens * self.frac_per_sample_entropy), 1)
            sel = self.subsample_tokens(weights, num_sampled)
            flat = flat[sel]
            weights = weights[sel]

        denom = weights.sum().clamp_min(1e-6)

        chunk = self.entropy_chunk_size
        if chunk is None and self.codebook_size > (1 << 16):
            chunk = 1 << 14
        route = entropy_route(self.entropy_fused, flat.device.type, self.codebook_dim, chunk)
        if route == 'fused':
            ent_sum, avg_prob_num = self._fused_entropy_stats(flat, weights, inv_temperature)
        elif route == 'streamed':
            ent_sum, avg_prob_num = self._streamed_entropy_stats(flat, weights, inv_temperature, chunk)
        else:
            codebook = self.maybe_l2norm(self.codebook)                   # (K, d)
            distance = -2 * torch.einsum('ncd,kd->nck', flat, codebook)
            prob = torch.softmax(-distance * inv_temperature, dim=-1)
            ent_sum = (entropy_fn(prob, eps=1e-5) * weights[:, None]).sum()
            avg_prob_num = (prob * weights[:, None, None]).sum(0)

        per_sample_entropy = ent_sum / (denom * flat.shape[1])
        # the batch's average distribution, differentiably psum'd over the replicas
        avg_prob = psum(avg_prob_num, self.sync_axis) / psum(denom, self.sync_axis)   # (c, K)
        codebook_entropy = entropy_fn(avg_prob, eps=1e-5).mean()
        return per_sample_entropy, codebook_entropy

    def _fused_entropy_stats(self, flat, weights, inv_temperature):
        """The statistics through `lfq_entropy_stats`, one call per codebook;
        any number of tokens, no padding. The sweeps compute in f32, as the
        TPU kernels do whatever the input type."""
        v = code_magnitude(self.codebook_dim, float(self.codebook_scale), self.spherical)
        ent_sum = flat.new_zeros((), dtype=torch.float32)
        rows = []
        for ci in range(flat.shape[1]):
            ent, avgp = lfq_entropy_stats(flat[:, ci].float().contiguous(), weights, k=self.codebook_size,
                                          v=v, inv_temp=float(inv_temperature))
            ent_sum = ent_sum + (ent * weights).sum()
            rows.append(avgp)
        return ent_sum, torch.stack(rows)

    def _chunk_codes(self, start: int, size: int, device) -> torch.Tensor:
        """Code vectors of rows [start, start + size) of the implicit codebook."""
        idx = torch.arange(start, start + size, device=device)
        return self.maybe_l2norm(self.bits_to_codes(self._bits(idx)))

    def _streamed_entropy_stats(self, flat, weights, inv_temperature, chunk):
        """The statistics with the implicit codebook streamed in `chunk`-code
        pieces: pass A an online logsumexp, pass B each chunk's probabilities
        against the final logZ, the entropy sum and the (c, K) batch
        numerator. Each chunk's body runs under torch.utils.checkpoint when
        gradients are on, so the backward keeps one chunk's tensors at a time."""
        nb, c = flat.shape[:2]

        def logits_for(start):
            codes = self._chunk_codes(start, chunk, flat.device)         # (k, d)
            distance = -2 * torch.einsum('ncd,kd->nck', flat, codes)
            return -distance * inv_temperature                            # (N, c, k)

        def pass_a(m, s, start):
            logits = logits_for(start)
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
            return m_new, s

        def pass_b(log_z, start):
            prob = torch.exp(logits_for(start) - log_z[..., None])
            ent = (entropy_fn(prob, eps=1e-5) * weights[:, None]).sum()
            return ent, (prob * weights[:, None, None]).sum(0)              # (c, k)

        def run(fn, *args):
            if torch.is_grad_enabled():
                return checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        starts = range(0, self.codebook_size, chunk)
        m = torch.full((nb, c), float('-inf'), device=flat.device)
        s = torch.zeros(nb, c, device=flat.device)
        for start in starts:
            m, s = run(pass_a, m, s, start)
        log_z = m + torch.log(s)

        ent_sum = flat.new_zeros(())
        avg_chunks = []
        for start in starts:
            ent, avg = run(pass_b, log_z, start)
            ent_sum = ent_sum + ent
            avg_chunks.append(avg)
        return ent_sum, torch.cat(avg_chunks, -1)

    # -- forward -----------------------------------------------------------------

    def forward(self, x: torch.Tensor, inv_temperature: float = 100.0,
                return_loss_breakdown: bool = False, mask: torch.Tensor | None = None):
        is_img_or_video = x.ndim >= 4
        should_transpose = default(self.channel_first, is_img_or_video)
        if should_transpose:
            x, layout = to_tokens(x, channel_first=True)

        if x.shape[-1] != self.dim:
            raise ValueError(f'expected dimension of {self.dim} but received {x.shape[-1]}')

        if self.project_in is not None:
            # a bf16 or fp16 input meets the f32 weights in f32, as JAX promotes it
            x = self.project_in(x.to(self.project_in.weight.dtype))

        if self.soft_clamp_input_value is not None:
            clamp = self.soft_clamp_input_value
            x = torch.tanh(x / clamp) * clamp

        b, n = x.shape[:2]
        x = x.reshape(b, n, self.num_codebooks, self.codebook_dim)

        # a mask may be per batch entry (b,) or per token (b, n)
        if mask is not None:
            mask = mask.bool()
            if mask.ndim == 1:
                mask = mask[:, None].expand(b, n)

        if self.orthogonal_rotation:
            x = rotate(x, self.orthogonal_rot)

        x = self.maybe_l2norm(x)

        orig_dtype = x.dtype
        if self.force_quantization_f32:
            x = x.float()
        original_input = x

        # sign quantization
        codebook_value = torch.full_like(x, self.codebook_scale)
        quantized = torch.where(x > 0, codebook_value, -codebook_value)
        indices = ((quantized > 0).int() * self.bit_mask.int()).sum(-1).int()   # (b, n, c)
        quantized = self.maybe_l2norm(quantized)

        # straight-through gradients, through an optional activation
        if self.training:
            x = self.straight_through_activation(x)
            x = x + (quantized - x).detach()
        else:
            x = quantized

        zero = torch.zeros((), device=x.device)
        if self.training:
            per_sample_entropy, codebook_entropy = self._entropy_terms(original_input, inv_temperature, mask)
            entropy_aux_loss = per_sample_entropy - self.diversity_gamma * codebook_entropy
        else:
            entropy_aux_loss = per_sample_entropy = codebook_entropy = zero

        if self.training and self.experimental_softplus_entropy_loss:
            # softplus as log(1 + e^t) at every t, as jax.nn.softplus computes it
            entropy_aux_loss = torch.logaddexp(entropy_aux_loss + self.entropy_loss_offset, zero)

        if self.training and self.commitment_loss_weight > 0.0:
            commit = (original_input - quantized.detach()) ** 2
            if mask is not None:
                w = mask.float()[..., None, None]
                commit_loss = (commit * w).sum() / (w.sum() * commit.shape[-1] * commit.shape[-2]).clamp_min(1e-6)
            else:
                commit_loss = commit.mean()
        else:
            commit_loss = zero

        x = x.to(orig_dtype)
        if self.orthogonal_rotation:
            x = rotate(x, self.orthogonal_rot.T)
        x = x.reshape(b, n, -1)
        if self.project_out is not None:
            x = self.project_out(x)

        if should_transpose:
            x = layout.restore(x)
            indices = layout.restore_indices(indices)
        if not self.keep_num_codebooks_dim:
            indices = indices[..., 0]

        aux_loss = entropy_aux_loss * self.entropy_loss_weight + commit_loss * self.commitment_loss_weight

        ret = Return(x, indices, aux_loss)
        if not return_loss_breakdown:
            return ret
        return ret, LossBreakdown(per_sample_entropy, codebook_entropy, commit_loss)
