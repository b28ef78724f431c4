"""The port's random stream (vqtpu_torch.core.sampling.RandomStream, the
counterpart of flax's `nnx.Rngs` stream), on the CPU.

  - The block function is JAX's threefry-2x32, word for word.
  - A draw gives the same bits eagerly and inside `torch.compile(...,
    fullgraph=True)` graphs under `aot_eager` and `inductor` (the
    integer-valued draws and the uniforms equal; gumbel and normal noise,
    which pass through float64 log and erfinv, within 4 ulps of their size,
    the compiled libm against the eager one), and the module's counter
    advances alike; the words' function compiled by inductor (with dynamic
    sizes, as the card's `vqtpu::random_words` compiles it) gives the
    eager words.
  - The counter advances by the number of values drawn, a split by two.
  - The state is the module's buffer `rng_state`: `state_dict` saves and
    restores it, `Module.to` moves it (a float dtype cast leaves it int64),
    and two modules seeded alike draw alike.
  - Uniform moments within 5 sigma at 2^20 draws; every permutation is a
    permutation; masked draws land on True rows only, and on every row when
    none is True; the quantize-dropout index is a 0-d tensor that covers
    exactly the layers it may pick for each multiple.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng
from torch import nn

from vqtpu_torch.core import sampling
from vqtpu_torch.core.sampling import RandomStream, attach_stream, new_stream

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

N = 1 << 20


class _Owner(nn.Module):
    def __init__(self):
        super().__init__()
        self.generator = attach_stream(self)
        self.register_buffer('w', torch.zeros(3))


def _draw_all(g: RandomStream, mask: torch.Tensor) -> dict:
    """One of every draw of core.sampling from `g`, in a fixed order."""
    return dict(
        bits=g.bits(37),
        uniform=sampling.uniform_noise(g, (5, 7)),
        uniform_bf16=sampling.uniform_noise(g, (9,), dtype=torch.bfloat16),
        gumbel=sampling.gumbel_noise(g, (6, 4)),
        normal=sampling.normal_noise(g, (11,)),
        bernoulli=sampling.bernoulli(g, torch.full((13,), 0.3)),
        permutation=sampling.random_permutation(g, 17),
        mask_and_uniform=torch.stack(sampling.bernoulli_and_uniform(g, 0.4, (8,))),
        rows=sampling.randint(g, 23, 10),
        masked=sampling.masked_sample_indices(g, mask.numel(), mask, 12),
        unmasked=sampling.masked_sample_indices(g, 29, None, 12),
        dropout=sampling.quantize_dropout_index(g, 1, 8, 3),
        split=g.split(),
    )


def _ulps_close(got, want, ulps=4):
    want = want.double()
    tol = ulps * torch.finfo(torch.float32).eps * want.abs().clamp_min(1.0)
    return bool(((got.double() - want).abs() <= tol).all())


def test_threefry_is_jax_threefry_2x32():
    rng = np.random.default_rng(0)
    key = rng.integers(0, 2 ** 32, 2, dtype=np.uint32)
    blocks = rng.integers(0, 2 ** 32, (2, 64), dtype=np.uint32)
    want = np.asarray(prng.threefry_2x32(jnp.asarray(key), jnp.asarray(blocks.reshape(-1))))
    y0, y1 = sampling.threefry2x32(torch.tensor(int(key[0])), torch.tensor(int(key[1])),
                                   torch.from_numpy(blocks[0].astype(np.int64)),
                                   torch.from_numpy(blocks[1].astype(np.int64)))
    np.testing.assert_array_equal(np.concatenate([y0.numpy(), y1.numpy()]).astype(np.uint32), want)


@pytest.mark.parametrize('backend', ['aot_eager', 'inductor'])
def test_compiled_draws_equal_eager(backend):
    mask = torch.zeros(31, dtype=torch.bool)
    mask[[2, 3, 19]] = True
    torch.manual_seed(0)
    eager, compiled = _Owner(), _Owner()
    compiled.load_state_dict(eager.state_dict())
    torch._dynamo.reset()
    try:
        with torch._inductor.config.patch(compile_threads=1, realize_opcount_threshold=sampling._REALIZE_OPCOUNT):
            words = torch.compile(sampling._words_sized, backend=backend, dynamic=True, fullgraph=True)
            state = torch.tensor([0x9E3779B9, 0x7F4A7C15, (1 << 32) - 5])
            for n in (1, 2, 37, 1000):
                assert torch.equal(words(state, torch.empty(n, device='meta')), sampling._words(state, n)), n
            fn = torch.compile(lambda m: _draw_all(m.generator, mask), backend=backend, fullgraph=True)
            for _ in range(2):
                want = _draw_all(eager.generator, mask)
                got = fn(compiled)
                assert torch.equal(compiled.rng_state, eager.rng_state)
                for key, w in want.items():
                    g = got[key]
                    assert g.dtype == w.dtype and g.shape == w.shape, key
                    if key in ('gumbel', 'normal'):
                        assert _ulps_close(g, w), key
                    else:
                        assert torch.equal(g, w), key
    finally:
        torch._dynamo.reset()


def test_counter_advances_by_the_draw_count():
    g = new_stream(11)
    assert g.get_state().tolist() == [11, 0, 0]
    sampling.uniform_noise(g, (3, 5))
    assert int(g.get_state()[2]) == 15
    sampling.random_permutation(g, 7)
    sampling.masked_sample_indices(g, 10, torch.ones(10, dtype=torch.bool), 4)
    sampling.quantize_dropout_index(g, 0, 4)
    assert int(g.get_state()[2]) == 15 + 7 + 4 + 1
    key = g.split()
    assert int(g.get_state()[2]) == 29 and key.dtype == torch.int64 and int(key[2]) == 0
    # the key of a split is not the stream's
    assert not torch.equal(key[:2], g.get_state()[:2])


def test_state_is_a_buffer_saved_and_restored_by_state_dict():
    torch.manual_seed(1)
    m = _Owner()
    assert m.rng_state.dtype == torch.int64 and 'rng_state' in m.state_dict()
    saved = {k: v.clone() for k, v in m.state_dict().items()}
    first = sampling.uniform_noise(m.generator, (100,))
    assert int(m.rng_state[2]) == 100
    m.load_state_dict(saved)
    assert torch.equal(sampling.uniform_noise(m.generator, (100,)), first)
    # a float cast leaves the state alone; the stream reads the buffer anew
    m.double()
    assert m.rng_state.dtype == torch.int64 and m.generator.device == m.rng_state.device
    m.generator.set_state(saved['rng_state'])
    assert torch.equal(m.generator.get_state(), saved['rng_state'])
    assert torch.equal(sampling.uniform_noise(m.generator, (100,)), first)


def test_two_modules_seeded_alike_draw_alike():
    torch.manual_seed(5)
    a = _Owner()
    torch.manual_seed(5)
    b = _Owner()
    c = _Owner()
    assert torch.equal(a.rng_state, b.rng_state) and not torch.equal(a.rng_state, c.rng_state)
    assert torch.equal(sampling.gumbel_noise(a.generator, (64,)), sampling.gumbel_noise(b.generator, (64,)))
    b.generator.manual_seed(123)
    a.generator.manual_seed(123)
    assert torch.equal(sampling.random_permutation(a.generator, 50), sampling.random_permutation(b.generator, 50))


def test_uniform_moments_within_five_sigma():
    u = sampling.uniform_noise(new_stream(2), (N,)).double()
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # mean 1/2 with sd sqrt(1/12 / N); variance 1/12 with sd sqrt(1/180 / N)
    assert abs(float(u.mean()) - 0.5) < 5 * (1 / 12 / N) ** 0.5
    assert abs(float(u.var()) - 1 / 12) < 5 * (1 / 180 / N) ** 0.5
    z = sampling.normal_noise(new_stream(3), (N,)).double()
    assert abs(float(z.mean())) < 5 / N ** 0.5 and abs(float(z.var()) - 1.0) < 5 * (2 / N) ** 0.5


@pytest.mark.parametrize('n', [1, 2, 7, 256, 1000])
def test_every_permutation_is_a_permutation(n):
    g = new_stream(n)
    seen = set()
    for _ in range(20):
        p = sampling.random_permutation(g, n)
        assert p.dtype == torch.int64 and sorted(p.tolist()) == list(range(n))
        seen.add(tuple(p.tolist()))
    assert len(seen) == (1 if n == 1 else 20 if n > 3 else len(seen))


def test_masked_draws_land_on_true_rows():
    g = new_stream(4)
    mask = torch.zeros(40, dtype=torch.bool)
    mask[[0, 5, 6, 39]] = True
    idx = sampling.masked_sample_indices(g, 40, mask, 4000)
    assert set(idx.tolist()) == {0, 5, 6, 39}
    counts = torch.bincount(idx, minlength=40)[[0, 5, 6, 39]].double()
    assert float(((counts - 1000) ** 2 / 1000).sum()) < 20        # chi-square, 3 degrees of freedom
    # no True row: every row
    idx = sampling.masked_sample_indices(g, 40, torch.zeros(40, dtype=torch.bool), 4000)
    assert set(idx.tolist()) == set(range(40))
    rows = sampling.masked_sample_vectors(g, torch.arange(80.0).reshape(40, 2), mask, 50)
    assert set(rows[:, 0].tolist()) <= {0.0, 10.0, 12.0, 78.0}


@pytest.mark.parametrize('cutoff,q,multiple', [(0, 8, 1), (2, 8, 1), (1, 8, 3), (0, 7, 2), (3, 4, 4)])
def test_dropout_index_is_a_tensor_covering_its_layers(cutoff, q, multiple):
    g = new_stream(cutoff * 100 + q * 10 + multiple)
    draws = [sampling.quantize_dropout_index(g, cutoff, q, multiple) for _ in range(400)]
    assert all(d.ndim == 0 and d.dtype == torch.int64 for d in draws)
    want = {min(-(-(i + 1) // multiple) * multiple - 1, q - 1) for i in range(cutoff, q)}
    assert {int(d) for d in draws} == want
