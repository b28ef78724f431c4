"""Random draws from a counter-based stream (counterpart of
vqtpu/core/sampling.py and of flax's `nnx.Rngs` streams).

`RandomStream` is the port's `nnx.Rngs` stream: a threefry-2x32 key and a
64-bit counter, held as an int64 (3,) tensor. A module's stream keeps that
tensor as a buffer of the module (`rng_state`, made by `attach_stream`
and seeded from torch's global generator at construction), so
`state_dict`, `Module.to`, `load_state_dict` and the replicas of the data-
and tensor-parallel trainers carry it with the parameters, and a module
built on the CPU and moved to the card draws on the card. Word i of a draw
is the first output word of threefry-2x32 (JAX's, 20 rounds) on the key
and the block (counter + i), made by the op `vqtpu::random_words`; the
draw adds its size to the counter in place. The arithmetic is integer
arithmetic in int64 torch ops on the state's device, so the CPU and the
card give the same bits, eagerly and inside a `torch.compile` graph,
which holds the op and the counter's update (it cannot trace a
`torch.Generator`).

Each draw function takes the stream first. The two frameworks cannot
share a stream, so the tests hand both sides the same values by replacing
these functions, which every caller looks up at call time: `gumbel_noise`
is the draw of `gumbel_sample` (the code sampler of the
distance-materializing path) and of LFQ's token subsample,
`bernoulli_and_uniform` the draw of FSQ's noise dropout, `normal_noise`
that of DiVeQ (`core.ste.directional_reparam`) and of the random
rotations, `random_permutation` that of the orthogonal loss's code subset
(VectorQuantize's `orthogonal_reg_max_codes`), `uniform_noise` the two
draws of FSP's perturbation, `bernoulli` BinaryMapper's bits,
`masked_sample_indices` and `masked_sample_vectors` kmeans' and dead-code
expiry's rows, and `quantize_dropout_index` the residual stacks' dropout
layer.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_M32 = 0xFFFFFFFF
# threefry-2x32's rotations, alternating by group of four rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
STATE_BUFFER = 'rng_state'


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """JAX's threefry-2x32 block function (20 rounds) on int64 tensors that
    hold uint32 values: key (k0, k1), blocks (x0, x1) -> (y0, y1). Every
    intermediate stays below 2^62, so int64 neither wraps nor goes
    negative."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def seed_state(seed: int, device=None) -> torch.Tensor:
    """A stream's state for `seed` (a non-negative int below 2^64): the key
    (seed's low and high 32 bits), counter 0."""
    return torch.tensor([seed & _M32, (seed >> 32) & _M32, 0], dtype=torch.int64, device=device)


class RandomStream:
    """A counter-based random stream (see the module doc). Its state is the
    int64 (3,) tensor (key0, key1, counter): its own, or the buffer `name`
    of the module `owner`, read at each draw (so it follows the module's
    `.to` and `load_state_dict`). `manual_seed`, `get_state`, `set_state`
    and `device` are `torch.Generator`'s methods of those names."""

    def __init__(self, state: torch.Tensor | None = None, *, owner: nn.Module | None = None,
                 name: str = STATE_BUFFER):
        if (state is None) == (owner is None):
            raise ValueError('a stream holds its own state or reads its owner\'s buffer, not both')
        self._state, self._owner, self._name = state, owner, name

    @property
    def state(self) -> torch.Tensor:
        return self._state if self._owner is None else getattr(self._owner, self._name)

    @property
    def device(self) -> torch.device:
        return self.state.device

    def manual_seed(self, seed: int) -> 'RandomStream':
        with torch.no_grad():
            self.state.copy_(seed_state(int(seed)))
        return self

    def get_state(self) -> torch.Tensor:
        return self.state.detach().clone()

    def set_state(self, state: torch.Tensor) -> None:
        with torch.no_grad():
            self.state.copy_(state)

    def bits(self, n: int) -> torch.Tensor:
        """n random 32-bit words as int64 in [0, 2^32), on the stream's
        device (`random_words`); the counter advances by n."""
        state = self.state
        words = torch.ops.vqtpu.random_words(state, n)
        with torch.no_grad():
            state[2:].add_(n)
        return words

    def split(self) -> torch.Tensor:
        """A new stream's state, keyed by the next two words of this stream,
        counter 0, as `nnx.Rngs` splits a key off a stream; this stream's
        counter advances by 2."""
        key = self.bits(2)
        return torch.cat((key, torch.zeros_like(key[:1])))


def _words(state: torch.Tensor, n: int) -> torch.Tensor:
    """The first output words of the blocks state[2] .. state[2] + n - 1 under
    the key state[:2]."""
    block = state[2] + torch.arange(n, dtype=torch.int64, device=state.device)
    return threefry2x32(state[0], state[1], block & _M32, (block >> 32) & _M32)[0]


def _words_sized(state: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return _words(state, like.shape[0])


# inductor stores a pointwise chain only once its op count passes this
# (30 by default) and re-traces the chain for each of its uses until then,
# which the twenty threefry rounds, each reading both words of the one
# before, make exponential: the words compile in seconds at 8, in minutes at 30
_REALIZE_OPCOUNT = 8
_fused_words = None


@torch.library.custom_op('vqtpu::random_words', mutates_args=(), device_types='cpu')
def random_words(state: torch.Tensor, n: int) -> torch.Tensor:
    """`n` words of the stream with state `state` (left as it is), int64 in
    [0, 2^32), as an op. The CPU takes `_words`'s int64 ops. The card takes
    the same function compiled once a process (inductor, `n` dynamic) into
    fused kernels: eagerly the ops are about 170 elementwise launches a
    draw, and a compiled step sees one opaque call here, where inductor
    would otherwise compile every draw's rounds into the step anew."""
    return _words(state, n)


@random_words.register_kernel('cuda')
def _(state, n):
    global _fused_words
    if _fused_words is None:
        _fused_words = torch.compile(_words_sized, dynamic=True, fullgraph=True)
    with torch._inductor.config.patch(realize_opcount_threshold=_REALIZE_OPCOUNT):
        return _fused_words(state, torch.empty(n, device='meta'))


@random_words.register_fake
def _(state, n):
    return state.new_empty((n,))


def attach_stream(module: nn.Module, device=None) -> RandomStream:
    """Register `module`'s stream state as its buffer `rng_state`, seeded
    from torch's global generator, and return the stream over it."""
    seed = int(torch.randint(0, 2 ** 62, (), dtype=torch.int64))
    module.register_buffer(STATE_BUFFER, seed_state(seed, device))
    return RandomStream(owner=module)


def new_stream(seed: int, device=None) -> RandomStream:
    """A stream with its own state, seeded `seed`, on `device`."""
    return RandomStream(seed_state(seed, device))


def _to(t: torch.Tensor, device) -> torch.Tensor:
    """A draw made on its stream's device, on `device` (where it was made
    when None)."""
    return t if device is None else t.to(device)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _uniform(generator: RandomStream, shape, dtype=torch.float32) -> torch.Tensor:
    """Uniform [0, 1) values of `shape` and `dtype` on the stream's device:
    the top p bits of each word times 2^-p, p the dtype's significand width
    (24 for float32, at most 32), so the largest value stays below 1 in the
    dtype."""
    p = min(32, round(-math.log2(torch.finfo(dtype).eps)) + 1)
    words = generator.bits(_numel(shape)) >> (32 - p)
    exact = torch.float32 if p <= 24 else torch.float64
    return (words.to(exact) * 2.0 ** -p).to(dtype).reshape(tuple(shape))


def randint(generator: RandomStream, high, num: int, device=None) -> torch.Tensor:
    """`num` int64 values uniform in [0, high) (an int, or an int64 tensor
    on the stream's device, below 2^31): floor(word * high / 2^32)."""
    return _to((generator.bits(num) * high) >> 32, device)


def _open_uniform64(generator: RandomStream, shape) -> torch.Tensor:
    """float64 values in (0, 1): each word's top 24 bits plus a half, over
    2^24."""
    words = generator.bits(_numel(shape)) >> 8
    return ((words.to(torch.float64) + 0.5) * 2.0 ** -24).reshape(tuple(shape))


def gumbel_noise(generator: RandomStream, shape, device=None) -> torch.Tensor:
    """Standard Gumbel noise of `shape`, float32: -log(-log u) for u in
    (0, 1), computed in float64 and rounded once, so that the CPU's and
    the card's libraries, which may differ in the last bit of a float64
    log, round to the same float32."""
    return _to((-torch.log(-torch.log(_open_uniform64(generator, shape)))).float(), device)


def normal_noise(generator: RandomStream, shape, device=None) -> torch.Tensor:
    """Standard normal noise of `shape`, float32: sqrt(2) erfinv(2u - 1) for
    u in (0, 1), in float64 rounded once (as `gumbel_noise`)."""
    return _to((2.0 ** 0.5 * torch.erfinv(2.0 * _open_uniform64(generator, shape) - 1.0)).float(), device)


def uniform_noise(generator: RandomStream, shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform [0, 1) values of `shape`."""
    return _to(_uniform(generator, shape, dtype), device)


def bernoulli(generator: RandomStream, prob: torch.Tensor) -> torch.Tensor:
    """A boolean tensor of `prob`'s shape, each entry True with its
    probability."""
    return _to(_uniform(generator, prob.shape, prob.dtype), prob.device) < prob


def random_permutation(generator: RandomStream, n: int, device=None) -> torch.Tensor:
    """A uniform random permutation of range(n), int64: a stable argsort of
    n random words, as `jax.random.permutation` sorts random keys."""
    return _to(torch.argsort(generator.bits(n), stable=True), device)


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
    generator: RandomStream | None,
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


def quantize_dropout_index(generator: RandomStream, cutoff: int, num_quantizers: int,
                           multiple_of: int = 1) -> torch.Tensor:
    """The residual stacks' quantize-dropout draw, a 0-d int64 tensor on the
    stream's device: a layer index uniform in [cutoff, num_quantizers),
    rounded up to a multiple of `multiple_of` less one (at most the last
    layer), as the JAX package's traced `_draw_dropout_index`."""
    idx = cutoff + randint(generator, num_quantizers - cutoff, 1)[0]
    if multiple_of != 1:
        idx = (((idx + multiple_of) // multiple_of) * multiple_of - 1).clamp_max(num_quantizers - 1)
    return idx


def bernoulli_and_uniform(generator: RandomStream, p: float, shape, dtype=torch.float32,
                          device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A boolean mask, True with probability p, and uniform [0, 1) values of
    `dtype`, both of `shape`."""
    mask = _to(_uniform(generator, shape), device) < p
    return mask, _to(_uniform(generator, shape, dtype), device)


def sample_vectors(generator: RandomStream, samples: torch.Tensor, num: int) -> torch.Tensor:
    """`num` rows of (n, d): without replacement when n >= num, with
    replacement otherwise."""
    n = samples.shape[0]
    if n >= num:
        indices = random_permutation(generator, n)[:num]
    else:
        indices = randint(generator, n, num)
    return samples.index_select(0, indices.to(samples.device))


def batched_sample_vectors(
    generator: RandomStream, samples: torch.Tensor, num: int
) -> torch.Tensor:
    """(h, n, d) -> (h, num, d), an independent draw per head."""
    return torch.stack([sample_vectors(generator, s, num) for s in samples])


def masked_sample_indices(
    generator: RandomStream, n: int, mask: torch.Tensor | None, num: int,
    device: torch.device | None = None,
) -> torch.Tensor:
    """`num` row indices in [0, n), with replacement, uniform over the rows
    where `mask` is True; uniform over all rows when `mask` is None or has
    no True row (callers skip the draw's use then). An inverse CDF in
    integers, with no host sync: the r-th True row for r uniform below
    their count, found by `searchsorted` in the mask's cumulative sum."""
    if mask is None:
        return randint(generator, n, num, device)
    cum = torch.cumsum(mask.reshape(-1).to(device=generator.device, dtype=torch.int64), 0)
    # an all-False mask draws from all rows
    any_row = cum[-1:] > 0
    cum = torch.where(any_row, cum, torch.arange(1, n + 1, device=cum.device))
    r = randint(generator, cum[-1:], num)
    return torch.searchsorted(cum, r, right=True).to(mask.device)


def masked_sample_vectors(
    generator: RandomStream, samples: torch.Tensor, mask: torch.Tensor | None, num: int
) -> torch.Tensor:
    """`num` rows of (n, d) `samples`, drawn with replacement from the rows
    where `mask` is True (see masked_sample_indices)."""
    indices = masked_sample_indices(generator, samples.shape[0], mask, num, samples.device)
    return samples.index_select(0, indices)
