"""Row sampling with an explicit generator (counterpart of
vqtpu/core/sampling.py).

Each function takes a `torch.Generator` on the device of the samples. The
two frameworks cannot share a random stream, so the tests hand both sides
the same indices by replacing these functions. The gumbel sampler of the
distance-materializing path is not ported yet; `gumbel_noise` is the draw
LFQ's token subsample uses, `bernoulli_and_uniform` the draw of FSQ's
noise dropout.
"""

from __future__ import annotations

import torch


def gumbel_noise(generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log u) for u uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(u.clamp(tiny, 1.0 - 2 ** -24)))


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
