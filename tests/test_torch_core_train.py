"""The port's training helpers (vqtpu_torch.core: ste, utils, metrics,
sampling) against the JAX package's, on the CPU: values, and for the
gradient estimators the vector-Jacobian products (jax.vjp against
torch.autograd.grad) with the same cotangent. Tolerance 1e-6: the same f32
arithmetic in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vqtpu.core.metrics as jmetrics
import vqtpu.core.ste as jste
import vqtpu.core.utils as ju
import vqtpu_torch.core.metrics as tmetrics
import vqtpu_torch.core.sampling as tsampling
import vqtpu_torch.core.ste as tste
import vqtpu_torch.core.utils as tu

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-6, atol=1e-6)


def _vjp_both(jfn, tfn, args, cot):
    """Value and VJP of jfn / tfn at the same numpy args and cotangent."""
    jout, jvjp = jax.vjp(jfn, *map(jnp.asarray, args))
    jgrads = jvjp(jnp.asarray(cot))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    tout = tfn(*targs)
    if tout.requires_grad:
        tgrads = torch.autograd.grad(tout, targs, torch.from_numpy(cot), allow_unused=True)
    else:                                                     # fully detached
        tgrads = [None] * len(targs)
    return (np.asarray(jout), [np.asarray(g) for g in jgrads],
            tout.detach().numpy(), [None if g is None else g.numpy() for g in tgrads])


@pytest.mark.parametrize('fn', ('rotate_to', 'straight_through', 'frac_gradient'))
def test_gradient_estimators_match_jax(fn):
    rng = np.random.default_rng(0)
    src = rng.standard_normal((3, 7, 16), dtype=np.float32)
    tgt = rng.standard_normal((3, 7, 16), dtype=np.float32)
    src[0, 0] = 0.0                                           # the safe_div clamp
    cot = rng.standard_normal((3, 7, 16), dtype=np.float32)
    if fn == 'frac_gradient':
        for frac in (0.0, 0.3, 1.0):
            jout, jg, tout, tg = _vjp_both(
                lambda t: jste.frac_gradient(t, frac), lambda t: tste.frac_gradient(t, frac), [src], cot)
            np.testing.assert_allclose(tout, jout, **TOL)
            np.testing.assert_allclose(np.zeros_like(src) if tg[0] is None else tg[0], jg[0], **TOL)
        return
    jout, jg, tout, tg = _vjp_both(getattr(jste, fn), getattr(tste, fn), [src, tgt], cot)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
    # the forward value is the target, up to the rotation's rounding (the
    # zero source row rotates to zero in both packages)
    np.testing.assert_allclose(tout[1:], tgt[1:], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tg[0], jg[0], rtol=1e-5, atol=1e-6)
    # no gradient reaches the target
    assert tg[1] is None or not tg[1].any()
    assert not np.asarray(jg[1]).any()


@pytest.mark.parametrize('fn', ('safe_div', 'laplace_smoothing', 'batched_bincount'))
def test_utils_match_jax(fn):
    rng = np.random.default_rng(1)
    if fn == 'safe_div':
        num = rng.standard_normal((4, 5), dtype=np.float32)
        den = np.abs(rng.standard_normal((4, 5), dtype=np.float32))
        den[0, 0] = 0.0
        got = tu.safe_div(torch.from_numpy(num), torch.from_numpy(den))
        want = ju.safe_div(jnp.asarray(num), jnp.asarray(den))
    elif fn == 'laplace_smoothing':
        x = rng.random((3, 9), dtype=np.float32) * 10
        got = tu.laplace_smoothing(torch.from_numpy(x), 9)
        want = ju.laplace_smoothing(jnp.asarray(x), 9)
    else:
        x = rng.integers(0, 11, (3, 50))
        got = tu.batched_bincount(torch.from_numpy(x), minlength=11)
        want = ju.batched_bincount(jnp.asarray(x), minlength=11)
        assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('masked', (False, True))
def test_metrics_match_jax(masked):
    rng = np.random.default_rng(2)
    idx = rng.integers(-1, 16, (4, 30)).astype(np.int32)
    mask = rng.random((4, 30)) < 0.7 if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    for name in ('index_histogram', 'codebook_perplexity', 'codebook_utilization'):
        got = getattr(tmetrics, name)(torch.from_numpy(idx), 16, tmask)
        want = getattr(jmetrics, name)(jnp.asarray(idx), 16, jmask)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=name)
    cluster_size = rng.random((2, 16), dtype=np.float32)
    cluster_size[0, :3] = 0.0
    for name in ('ema_perplexity', 'ema_utilization'):
        got = getattr(tmetrics, name)(torch.from_numpy(cluster_size))
        want = getattr(jmetrics, name)(jnp.asarray(cluster_size))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=name)


def test_sampling_draws_rows_of_the_batch():
    gen = tsampling.new_stream(0)
    samples = torch.arange(40, dtype=torch.float32).reshape(20, 2)
    mask = torch.zeros(20, dtype=torch.bool)
    mask[[3, 11]] = True
    rows = tsampling.masked_sample_vectors(gen, samples, mask, 50)
    assert rows.shape == (50, 2) and set(rows[:, 0].tolist()) <= {6.0, 22.0}
    # an all-False mask draws from every row
    rows = tsampling.masked_sample_vectors(gen, samples, torch.zeros(20, dtype=torch.bool), 200)
    assert len(set(rows[:, 0].tolist())) > 10
    assert tsampling.masked_sample_indices(gen, 20, None, 7).shape == (7,)
    # without replacement when there are enough rows, with it otherwise
    rows = tsampling.sample_vectors(gen, samples, 20)
    assert sorted(rows[:, 0].tolist()) == samples[:, 0].tolist()
    assert tsampling.sample_vectors(gen, samples[:3], 8).shape == (8, 2)
    assert tsampling.batched_sample_vectors(gen, samples.reshape(2, 10, 2), 4).shape == (2, 4, 2)
    # the same generator state draws the same rows
    a = tsampling.masked_sample_indices(tsampling.new_stream(5), 20, mask, 9)
    b = tsampling.masked_sample_indices(tsampling.new_stream(5), 20, mask, 9)
    assert torch.equal(a, b)
