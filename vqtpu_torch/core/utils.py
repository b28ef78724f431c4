"""Core tensor helpers of the PyTorch port (counterpart of vqtpu/core/utils.py).

Plain functions over torch tensors. `resolve_device` is the port's one rule
for where an entry point runs: on the CUDA card unless the caller asks for
the CPU, and never quietly on the CPU when the card is missing.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Callable

import torch


def exists(val: Any) -> bool:
    return val is not None


def default(val, d):
    return val if val is not None else d


def first(it):
    return it[0]


def cast_tuple(t, length: int = 1) -> tuple:
    return t if isinstance(t, tuple) else ((t,) * length)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `device`, or the CUDA card when it
    is None. Raises when CUDA is asked for (or defaulted to) and there is no
    CUDA device; pass `device='cpu'` to run on the CPU."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'vqtpu_torch runs on a CUDA device by default and none is '
            "available; pass device='cpu' to run on the CPU"
        )
    return device


def random_orthogonal(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """A Haar-random (n, n) orthogonal matrix: QR of a Gaussian matrix with
    the signs of R's diagonal folded into Q."""
    q, r = torch.linalg.qr(torch.randn(n, n, generator=generator, device=device))
    return q * torch.sign(torch.diagonal(r))[None, :]


def l2norm(t: torch.Tensor, dim: int = -1, eps: float = 1e-6) -> torch.Tensor:
    """L2-normalize along `dim`; the norm is clamped from below at `eps`."""
    norm = torch.linalg.vector_norm(t, ord=2, dim=dim, keepdim=True)
    return t / norm.clamp_min(eps)


def safe_div(num: torch.Tensor, den: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return num / den.clamp_min(eps)


def log(t: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return torch.log(t.clamp_min(eps))


def entropy(prob: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Shannon entropy along the last dim: -sum p log max(p, eps)."""
    return (-prob * log(prob, eps=eps)).sum(-1)


def laplace_smoothing(
    x: torch.Tensor, n_categories: int, eps: float = 1e-5, dim: int = -1
) -> torch.Tensor:
    denom = x.sum(dim=dim, keepdim=True)
    return (x + eps) / (denom + n_categories * eps)


def batched_bincount(x: torch.Tensor, *, minlength: int) -> torch.Tensor:
    """(h, n) int indices in [0, minlength) -> (h, minlength) float32
    counts."""
    offsets = torch.arange(x.shape[0], device=x.device)[:, None] * minlength
    flat = (x.long() + offsets).reshape(-1)
    counts = torch.bincount(flat, minlength=x.shape[0] * minlength)
    return counts.reshape(x.shape[0], minlength).float()


def append_dims_to(t: torch.Tensor, ndims: int) -> torch.Tensor:
    if t.ndim > ndims:
        raise ValueError(f'tensor has {t.ndim} dims, more than {ndims}')
    return t.reshape(*t.shape, *((1,) * (ndims - t.ndim)))


def cdist_sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean pairwise distances (..., i, d) x (..., j, d) ->
    (..., i, j) via the expansion ||x||^2 - 2 x y^T + ||y||^2, in float32."""
    x = x.float()
    y = y.float()
    x2 = (x ** 2).sum(-1)
    y2 = (y ** 2).sum(-1)
    xy = x @ y.transpose(-1, -2)
    return x2[..., :, None] - 2.0 * xy + y2[..., None, :]


def cdist(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Euclidean pairwise distances with a floor: sqrt(max(cdist_sq, eps))."""
    return torch.sqrt(cdist_sq(x, y).clamp_min(eps))


@contextmanager
def matmul_tf32(device: torch.device, allow: bool):
    """Run the float32 matrix products inside in TF32 when `allow` (10
    mantissa bits a product, f32 sums: what the JAX package's DEFAULT and
    HIGH matmul precisions mean on a GPU), else in full f32, on a CUDA
    device, whatever `torch.backends.cuda.matmul.allow_tf32` (or
    `torch.set_float32_matmul_precision('high')`) says outside. Full f32 is
    what selection needs: a TF32 product would round the operands to 10
    mantissa bits and move near-tied rankings. A no-op on the CPU, whose f32
    products are f32."""
    if device.type != 'cuda' or torch.backends.cuda.matmul.allow_tf32 == allow:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = not allow


def orthogonal_loss_fn(t: torch.Tensor) -> torch.Tensor:
    """Eq. (2) of https://arxiv.org/abs/2112.00384 over (h, n, d) codebooks:
    the mean squared cosine similarity of every pair of rows of a head
    (each row with itself included), less 1/n, averaged over the heads. The
    products run in full f32 on the card."""
    h, n = t.shape[:2]
    normed = l2norm(t)
    with matmul_tf32(t.device, allow=False):
        cosine_sim = normed @ normed.transpose(-1, -2)
    return (cosine_sim ** 2).sum() / (h * n ** 2) - (1.0 / n)


def lens_to_mask(lens: torch.Tensor, max_length: int) -> torch.Tensor:
    """(b,) lengths -> (b, max_length) boolean mask."""
    seq = torch.arange(max_length, device=lens.device)
    return seq[None, :] < lens[:, None]


def masked_mean(
    t: torch.Tensor, mask: torch.Tensor | None, eps: float = 1e-6
) -> torch.Tensor:
    """Mean of `t` over elements where `mask` is True; `mask` broadcasts
    from the leading dims of `t`."""
    if mask is None:
        return t.mean()
    weights = append_dims_to(mask, t.ndim).to(t.dtype).expand(t.shape)
    return (t * weights).sum() / weights.sum().clamp_min(eps)


def uniform_init(shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """Kaiming-uniform values over the trailing fan-in dims (the JAX
    package's codebook init), drawn from torch's global generator."""
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
    bound = math.sqrt(6.0 / fan_in)
    return torch.empty(shape, device=device).uniform_(-bound, bound)


def pack_tokens(
    x: torch.Tensor,
) -> tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """Flatten (h, ..., d) -> (h, N, d); returns the flat tensor and an
    `unpack(t)` that restores the middle dims on any tensor whose leading
    dim is h and whose trailing dims may differ from d."""
    lead, middle, dim = x.shape[0], tuple(x.shape[1:-1]), x.shape[-1]
    n = math.prod(middle) if middle else 1
    flat = x.reshape(lead, n, dim)

    def unpack(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(t.shape[0], *middle, *t.shape[2:])

    return flat, unpack
