"""The port's code sampler (vqtpu_torch.core.sampling.gumbel_sample) against
the JAX package's (vqtpu.core.sampling.gumbel_sample), on the CPU.

The two frameworks cannot share a random stream, so the noise is injected:
both modules' `gumbel_noise`, which `gumbel_sample` looks up at call time,
are replaced for the test by functions that return the same numpy draw.
Indices are held equal exactly (ties included: the lower index first, as
jnp.argmax and lax.top_k order them), the one-hot by value exactly, and the
straight-through one-hot (one-hot + pi - pi, within an ulp of the one-hot;
torch's softmax and XLA's differ by an ulp) by value and by its gradient
with respect to the logits, both to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vqtpu.core.sampling as jsampling
import vqtpu_torch.core.sampling as tsampling

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

SHAPE = (3, 40, 24)


@pytest.fixture
def same_noise(monkeypatch):
    """Both samplers draw the noise in `noise['value']`."""
    noise = {'value': None}
    monkeypatch.setattr(jsampling, 'gumbel_noise', lambda key, shape, dtype=jnp.float32: jnp.asarray(noise['value']))
    monkeypatch.setattr(tsampling, 'gumbel_noise', lambda gen, shape, device=None: torch.from_numpy(noise['value']))
    return noise


def _logits(seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        # few distinct values, so that most rows hold ties at the top
        return rng.integers(0, 4, SHAPE).astype(np.float32)
    return rng.standard_normal(SHAPE, dtype=np.float32)


MODES = {
    'eval': dict(training=False, stochastic=True),
    'argmax': dict(training=True),
    'stochastic': dict(training=True, stochastic=True, temperature=0.7),
    'zero_temperature': dict(training=True, stochastic=True, straight_through=True, temperature=0.0),
    'topk': dict(training=True, topk=4),
    'stochastic_topk': dict(training=True, stochastic=True, temperature=0.5, topk=3),
    'straight_through': dict(training=True, straight_through=True, temperature=0.9),
    'straight_through_stochastic': dict(training=True, stochastic=True, straight_through=True, temperature=1.3),
    'straight_through_topk': dict(training=True, straight_through=True, temperature=1.0, topk=2),
    'eval_topk': dict(training=False, topk=5, straight_through=True),
}


@pytest.mark.parametrize('ties', (False, True), ids=('distinct', 'ties'))
@pytest.mark.parametrize('mode', sorted(MODES))
def test_gumbel_sample_matches_jax(mode, ties, same_noise):
    kw = MODES[mode]
    logits = _logits(1, ties)
    same_noise['value'] = np.random.default_rng(2).gumbel(size=SHAPE).astype(np.float32)
    g = np.random.default_rng(3).standard_normal(
        (*SHAPE[:-1], kw['topk'], SHAPE[-1]) if 'topk' in kw else SHAPE, dtype=np.float32)

    def jax_sample(lg):
        ind, oh = jsampling.gumbel_sample(jax.random.PRNGKey(0), lg, **kw)
        return (oh * g).sum(), (ind, oh)
    (_, (jind, joh)), jgrad = jax.value_and_grad(jax_sample, has_aux=True)(jnp.asarray(logits))

    tl = torch.from_numpy(logits).requires_grad_()
    ind, oh = tsampling.gumbel_sample(tsampling.new_stream(0), tl, **kw)
    relaxed = kw.get('straight_through') and kw['training'] and kw.get('temperature', 1.0) > 0

    assert ind.dtype == torch.int32 and tuple(ind.shape) == jind.shape
    np.testing.assert_array_equal(ind.numpy(), np.asarray(jind))
    assert oh.requires_grad == bool(relaxed)
    if not relaxed:
        np.testing.assert_array_equal(oh.numpy(), np.asarray(joh))
        assert not np.asarray(jgrad).any()
        return
    np.testing.assert_allclose(oh.detach().numpy(), np.asarray(joh), rtol=0, atol=1e-6)
    (oh * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-6)


def test_topk_first_orders_ties_as_lax_top_k():
    t = np.random.default_rng(4).integers(0, 3, (64, 50)).astype(np.float32)
    for k in (1, 7, 50):
        want_v, want_i = jax.lax.top_k(jnp.asarray(t), k)
        v, i = tsampling.topk_first(torch.from_numpy(t), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))


def test_approx_topk_is_exact_top_k():
    """The port takes approx_topk=True as exact top-k. lax.approx_max_k is a
    TPU reduction; on the CPU it returns lax.top_k's indices, so the port
    agrees with the JAX package there, at a (512, 1024) input."""
    x = np.random.default_rng(5).standard_normal((512, 1024), dtype=np.float32)
    _, approx = jax.lax.approx_max_k(jnp.asarray(x), 4, recall_target=0.95)
    _, exact = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(np.asarray(approx), np.asarray(exact))
    ind, _ = tsampling.gumbel_sample(None, torch.from_numpy(x), training=False, topk=4, approx_topk=True)
    np.testing.assert_array_equal(ind.numpy(), np.asarray(approx))


def test_gumbel_noise_draws_from_the_generator():
    gen = tsampling.new_stream(6)
    a = tsampling.gumbel_noise(gen, (1000,))
    b = tsampling.gumbel_noise(tsampling.new_stream(6), (1000,))
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    # the standard Gumbel distribution: mean 0.5772 (Euler-Mascheroni), var pi^2 / 6
    big = tsampling.gumbel_noise(gen, (200_000,)).double()
    assert abs(float(big.mean()) - 0.5772) < 0.02 and abs(float(big.var()) - np.pi ** 2 / 6) < 0.05


# each draw of core.sampling, with a stream and the device where the draw is used
DRAWS = {
    'gumbel_noise': lambda g, dev: tsampling.gumbel_noise(g, (5,), device=dev),
    'normal_noise': lambda g, dev: tsampling.normal_noise(g, (5,), device=dev),
    'uniform_noise': lambda g, dev: tsampling.uniform_noise(g, (5,), device=dev),
    'bernoulli': lambda g, dev: tsampling.bernoulli(g, torch.full((5,), 0.3, device=dev)),
    'random_permutation': lambda g, dev: tsampling.random_permutation(g, 7, device=dev),
    'bernoulli_and_uniform': lambda g, dev: torch.stack(tsampling.bernoulli_and_uniform(g, 0.3, (5,), device=dev)),
    'masked_sample_indices': lambda g, dev: tsampling.masked_sample_indices(g, 9, None, 4, device=dev),
    'sample_vectors': lambda g, dev: tsampling.sample_vectors(g, torch.ones(9, 2, device=dev), 4),
    'sample_vectors_with_replacement': lambda g, dev: tsampling.sample_vectors(g, torch.ones(3, 2, device=dev), 4),
}


@pytest.mark.parametrize('draw', sorted(DRAWS))
def test_draws_are_made_on_the_generators_device(draw):
    """A draw is made on its stream's device and moved to where it is used
    ('meta' stands in for the card: a draw made there would leave the CPU
    stream where it was); the stream advances alike."""
    on_cpu, elsewhere = tsampling.new_stream(3), tsampling.new_stream(3)
    want = DRAWS[draw](on_cpu, 'cpu')
    got = DRAWS[draw](elsewhere, 'meta')
    assert got.device.type == 'meta' and got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(on_cpu.get_state(), elsewhere.get_state())
    assert not torch.equal(on_cpu.get_state(), tsampling.new_stream(3).get_state())
