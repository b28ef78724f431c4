"""Row sampling with an explicit generator (counterpart of
vqtpu/core/sampling.py).

Each function takes a `torch.Generator` on the device of the samples. The
two frameworks cannot share a random stream, so the tests hand both sides
the same indices by replacing these functions. `gumbel_noise` is the draw of
`gumbel_sample` (the code sampler of the distance-materializing path, which
looks it up at call time, as the JAX package's does) and of LFQ's token
subsample, `bernoulli_and_uniform` the draw of FSQ's noise dropout,
`normal_noise` the draw of DiVeQ (`core.ste.directional_reparam`) and
`random_permutation` that of the orthogonal loss's code subset
(VectorQuantize's `orthogonal_reg_max_codes`).
"""

from __future__ import annotations

import torch


def gumbel_noise(generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log u) for u uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(u.clamp(tiny, 1.0 - 2 ** -24)))


def normal_noise(generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """Standard normal noise of `shape`."""
    return torch.randn(shape, generator=generator, device=device)


def random_permutation(generator: torch.Generator, n: int, device=None) -> torch.Tensor:
    """A uniform random permutation of range(n), int64."""
    return torch.randperm(n, generator=generator, device=device)


def topk_first(t: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last dim, in descending order, and
    their int32 indices; among equal values the lower index comes first, as
    `jax.lax.top_k` orders them (torch.topk promises no order among equal
    values, so this takes a stable descending sort)."""
    values, indices = torch.sort(t, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k].to(torch.int32)


def one_hot_float(indices: torch.Tensor, size: int, dtype=torch.float32) -> torch.Tensor:
    """(...) int indices in [0, size) -> (..., size) one-hot of `dtype`."""
    out = torch.zeros(*indices.shape, size, dtype=dtype, device=indices.device)
    return out.scatter_(-1, indices.long()[..., None], 1.0)


def gumbel_sample(
    generator: torch.Generator | None,
    logits: torch.Tensor,
    temperature: float = 1.0,
    stochastic: bool = False,
    straight_through: bool = False,
    training: bool = True,
    topk: int | None = None,
    approx_topk: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Select codes from (..., c) logits -> (int32 indices, one-hot).

    - argmax, first index on ties (eval, or not stochastic);
    - gumbel-perturbed, logits / temperature + gumbel_noise, when
      `training and stochastic and temperature > 0` (the noise comes from
      `generator`, through this module's `gumbel_noise`);
    - `topk=k`: the k best, lower index first among equal values, as
      indices (..., k) and one-hot (..., k, c);
    - `straight_through` (in training, temperature > 0): one-hot + pi -
      pi.detach() with pi = softmax(logits / temperature), whose value is
      the one-hot and whose gradient is the softmax's.

    `approx_topk` is accepted for the JAX signature, where it selects
    `lax.approx_max_k`, a TPU reduction; here top-k is always exact.
    """
    size = logits.shape[-1]
    if training and stochastic and temperature > 0:
        noise = gumbel_noise(generator, logits.shape, device=logits.device).to(logits.dtype)
        sampling_logits = logits / temperature + noise
    else:
        sampling_logits = logits

    if topk is not None:
        _, ind = topk_first(sampling_logits, topk)
    else:
        ind = sampling_logits.argmax(-1).to(torch.int32)
    one_hot = one_hot_float(ind, size, logits.dtype)

    if not straight_through or temperature <= 0.0 or not training:
        return ind, one_hot
    pi = torch.softmax(logits / temperature, dim=-1)
    if topk is not None:
        pi = pi[..., None, :]
    return ind, one_hot + pi - pi.detach()


def bernoulli_and_uniform(generator: torch.Generator, p: float, shape, dtype=torch.float32,
                          device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A boolean mask, True with probability p, and uniform [0, 1) values of
    `dtype`, both of `shape`."""
    mask = torch.rand(shape, generator=generator, device=device) < p
    return mask, torch.rand(shape, generator=generator, dtype=dtype, device=device)


def sample_vectors(generator: torch.Generator, samples: torch.Tensor, num: int) -> torch.Tensor:
    """`num` rows of (n, d): without replacement when n >= num, with
    replacement otherwise."""
    n = samples.shape[0]
    if n >= num:
        indices = torch.randperm(n, generator=generator, device=samples.device)[:num]
    else:
        indices = torch.randint(0, n, (num,), generator=generator, device=samples.device)
    return samples.index_select(0, indices)


def batched_sample_vectors(
    generator: torch.Generator, samples: torch.Tensor, num: int
) -> torch.Tensor:
    """(h, n, d) -> (h, num, d), an independent draw per head."""
    return torch.stack([sample_vectors(generator, s, num) for s in samples])


def masked_sample_indices(
    generator: torch.Generator, n: int, mask: torch.Tensor | None, num: int,
    device: torch.device | None = None,
) -> torch.Tensor:
    """`num` row indices in [0, n), with replacement, uniform over the rows
    where `mask` is True; uniform over all rows when `mask` is None or has
    no True row (callers skip the draw's use then)."""
    if mask is None:
        return torch.randint(0, n, (num,), generator=generator, device=device)
    weights = mask.reshape(-1).float()
    # no host sync: an all-False mask draws from all rows
    weights = torch.where(weights.sum() > 0, weights, torch.ones_like(weights))
    return torch.multinomial(weights, num, replacement=True, generator=generator)


def masked_sample_vectors(
    generator: torch.Generator, samples: torch.Tensor, mask: torch.Tensor | None, num: int
) -> torch.Tensor:
    """`num` rows of (n, d) `samples`, drawn with replacement from the rows
    where `mask` is True (see masked_sample_indices)."""
    indices = masked_sample_indices(generator, samples.shape[0], mask, num, samples.device)
    return samples.index_select(0, indices)
