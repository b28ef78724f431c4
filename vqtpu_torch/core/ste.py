"""Gradient estimators (counterpart of vqtpu/core/ste.py).

Each keeps the forward value of the quantized output and reroutes its
gradient to the input, with `detach` where the JAX package writes
`stop_gradient`.
"""

from __future__ import annotations

import math

import torch

from . import sampling
from .utils import l2norm, safe_div


def straight_through(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Forward = tgt, backward = identity to src."""
    return src + (tgt - src).detach()


def round_ste(z: torch.Tensor) -> torch.Tensor:
    """Round half to even with straight-through gradients. The forward
    value is round(z) exactly: round(z) - z is exact in floating point, and
    so is adding it back."""
    return z + (torch.round(z) - z).detach()


def floor_ste(z: torch.Tensor) -> torch.Tensor:
    """Floor with straight-through gradients; the forward value is floor(z)
    exactly, as for round_ste."""
    return z + (torch.floor(z) - z).detach()


def frac_gradient(t: torch.Tensor, frac: float) -> torch.Tensor:
    """Let only `frac` of the gradient flow through `t`."""
    if frac <= 0:
        return t.detach()
    if frac >= 1:
        return t
    return frac * t + (1.0 - frac) * t.detach()


def _efficient_rotation_trick_transform(
    u: torch.Tensor, q: torch.Tensor, e: torch.Tensor
) -> torch.Tensor:
    """Section 4.2 of https://arxiv.org/abs/2410.06424: reflect e through the
    plane defined by the unit vectors u and q, all (b, d):

        e - 2 (e.w) w + 2 (e.u) q,   w = l2norm(u + q)

    The JAX package writes the two rank-one terms as batched (1, d) x (d, 1)
    matrix products; here they are row-wise dot products, the same values
    without a batched matmul (which TF32 would round on the card)."""
    w = l2norm(u + q, dim=1).detach()
    u = u.detach()
    q = q.detach()
    ew = (e * w).sum(-1, keepdim=True)
    eu = (e * u).sum(-1, keepdim=True)
    return e - 2 * (ew * w) + 2 * (eu * q)


def rotate_to(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Rotation-trick gradient estimator (https://arxiv.org/abs/2410.06424).

    The forward value equals tgt up to rounding; the backward pass sees tgt
    as a detached rotation and scaling of src, so the gradient rotates back
    onto src."""
    lead_shape = src.shape[:-1]
    d = src.shape[-1]
    src_f = src.reshape(-1, d)
    tgt_f = tgt.reshape(-1, d)

    norm_src = torch.linalg.vector_norm(src_f, dim=-1, keepdim=True)
    norm_tgt = torch.linalg.vector_norm(tgt_f, dim=-1, keepdim=True)

    rotated_tgt = _efficient_rotation_trick_transform(
        safe_div(src_f, norm_src),
        safe_div(tgt_f, norm_tgt),
        src_f,
    )
    rotated = rotated_tgt * safe_div(norm_tgt, norm_src).detach()
    return rotated.reshape(*lead_shape, d)


def directional_reparam(
    src: torch.Tensor,
    tgt: torch.Tensor,
    noise_variance: float = 5e-3,
    *,
    generator: sampling.RandomStream | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """DiVeQ's directional reparameterization (figure 1 of
    https://openreview.net/forum?id=KRVnpTbx7R): src plus the error
    direction tgt - src, noised, unit-normalized and detached, scaled by the
    error's norm, which carries the gradient to both src and tgt.

    The standard normal noise is `noise` when given (of tgt's shape), else
    drawn from the stream `generator` by `core.sampling.normal_noise`, which is looked
    up at call time."""
    error_dir = tgt - src
    error_dir_norm = torch.linalg.vector_norm(error_dir, dim=-1, keepdim=True)
    if noise is None:
        noise = sampling.normal_noise(generator, error_dir.shape, device=error_dir.device)
    noised_dir = error_dir + math.sqrt(noise_variance) * noise.to(error_dir.dtype)
    unit_noised_dir = l2norm(noised_dir).detach()
    return src + unit_noised_dir * error_dir_norm
