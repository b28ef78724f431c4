"""The port's FSQ (vqtpu_torch) against the JAX package's (vqtpu.quantizers),
on the CPU, with the JAX state carried over by load_vqtpu_state.

Tolerances, and why:
  - where no transcendental and no matrix product is in play (the
    preserve-symmetry, hard-clamp bound on an unprojected input), codes and
    indices are equal bit for bit: both sides round the same IEEE
    operations in the same order;
  - elsewhere XLA's f32 tanh and atanh on the CPU are approximations that
    differ from torch's by an ulp, and the two frameworks' projections sum
    in other orders. Values agree within 1e-6, and indices agree except on
    tokens whose float64 bracket argument lies within 1e-6 of a bin edge
    (`_edge_tokens`); such tokens are counted, and must be few;
  - bf16 outputs agree within one bf16 ulp of their values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu.quantizers.fsq as jfsq
import vqtpu_torch
import vqtpu_torch.quantizers.fsq as tfsq
from vqtpu_torch import load_vqtpu_state

from torch_parity import assert_grads_close, jax_state, one_torch_thread  # noqa: F401  (autouse)

# share of tokens allowed within 1e-6 of a bin edge (the inputs are N(0, 1))
MAX_EDGE_SHARE = 1e-2


def _pair(**kw):
    jm = jfsq.FSQ(**kw, rngs=nnx.Rngs(0))
    tm = tfsq.FSQ(**kw, device='cpu')
    load_vqtpu_state(tm, jax_state(jm))
    return jm, tm


def _pre_quantize(tm, x: torch.Tensor) -> np.ndarray:
    """The (b, n, c, d) values the port's FSQ bounds, in float64."""
    if x.ndim >= 4 or tm.channel_first:
        x = x.movedim(1, -1)
        x = x.reshape(x.shape[0], -1, x.shape[-1])
    with torch.no_grad():
        z = tm.project_in(x) if tm.project_in is not None else x
        z = z.reshape(z.shape[0], z.shape[1], tm.num_codebooks, tm.codebook_dim)
        if tm.orthogonal_rotation:
            z = z @ tm.orthogonal_rot
    return z.double().numpy()


def _edge_tokens(tm, z: np.ndarray) -> np.ndarray:
    """(b, n, c) True where some dim's float64 bracket argument lies within
    1e-6 of a bin edge: an integer for the floor of the symmetric bound, a
    half-integer for the rounding of the other."""
    levels = np.asarray(tm.levels, np.float64)
    if tm.preserve_symmetry:
        bounded = np.clip(z, -1, 1) if tm.bound_hard_clamp else np.tanh(z)
        arg = (levels - 1) * (bounded + 1) / 2 + 0.5
        dist = np.abs(arg - np.round(arg))
    else:
        half_l = (levels - 1) * (1 + 1e-3) / 2
        offset = np.where(levels % 2 == 0, 0.5, 0.0)
        if tm.bound_hard_clamp:
            arg = np.clip(z + offset / half_l, -1, 1) * half_l - offset
        else:
            arg = np.tanh(z + np.arctanh(offset / half_l)) * half_l - offset
        dist = np.abs(arg - (np.floor(arg) + 0.5))
    return (dist < 1e-6).any(-1)


def _assert_indices_edge_equal(tm, x, idx, jidx):
    """Indices equal but on edge tokens, whose count must be small; returns
    (edge tokens, disagreements)."""
    edge = _edge_tokens(tm, _pre_quantize(tm, x)).reshape(idx.shape)
    differ = idx != jidx
    assert not (differ & ~edge).any(), f'{int((differ & ~edge).sum())} indices differ off a bin edge'
    assert edge.sum() <= MAX_EDGE_SHARE * edge.size, (int(edge.sum()), edge.size)
    return edge, differ


def _value_mask(tm, same: np.ndarray, shape) -> np.ndarray:
    """Per-token flags of the index layout spread over the value layout."""
    if tm.num_codebooks > 1:                       # (b, n, c) -> (b, n, c * d)
        return np.repeat(same, tm.codebook_dim, axis=-1)
    if len(shape) >= 4 or tm.channel_first:        # values keep the channel on axis 1
        return np.broadcast_to(same[:, None], shape)
    return np.broadcast_to(same[..., None], shape)


CONFIGS = {
    # (kwargs, input shape, exact): exact = no transcendental, no projection
    'sym_hard': (dict(levels=[8, 5, 5, 5], preserve_symmetry=True, bound_hard_clamp=True), (1, 512, 4), True),
    'sym_tanh': (dict(levels=[8, 5, 5, 5], preserve_symmetry=True), (1, 512, 4), False),
    'asym_hard': (dict(levels=[8, 5, 5, 5], bound_hard_clamp=True), (1, 512, 4), False),
    'asym_tanh': (dict(levels=[8, 5, 5, 5]), (1, 512, 4), False),
    'levels_2_sym_hard': (dict(levels=[2, 3, 7], preserve_symmetry=True, bound_hard_clamp=True), (2, 100, 3), True),
    'no_indices': (dict(levels=[8, 5, 5, 5], return_indices=False), (1, 512, 4), False),
    'image_dim16': (dict(levels=[8, 6, 5], dim=16), (2, 16, 8, 8), False),
    'channel_first_seq': (dict(levels=[8, 6, 5], dim=12, channel_first=True, projection_has_bias=False),
                          (2, 12, 20), False),
    'two_codebooks': (dict(levels=[8, 5, 5], num_codebooks=2), (1, 64, 6), False),
    'rotation': (dict(levels=[5, 5, 5, 5], orthogonal_rotation=True), (1, 128, 4), False),
}


@pytest.mark.parametrize('name', CONFIGS)
def test_fsq_eval_matches_jax(name):
    kw, shape, exact = CONFIGS[name]
    jm, tm = _pair(**kw)
    jm.eval()
    tm.eval()
    x = np.random.default_rng(0).standard_normal(shape, dtype=np.float32)
    jq, jidx = jm(jnp.asarray(x))
    with torch.no_grad():
        q, idx = tm(torch.from_numpy(x))
    jq = np.asarray(jq)
    assert q.shape == jq.shape and q.dtype == torch.float32
    if not kw.get('return_indices', True):
        assert idx is None and jidx is None
        np.testing.assert_allclose(q.numpy(), jq, rtol=0, atol=1e-6)
        return
    jidx = np.asarray(jidx)
    assert idx.dtype == torch.int32 and idx.shape == jidx.shape
    if exact:
        np.testing.assert_array_equal(idx.numpy(), jidx)
        np.testing.assert_array_equal(q.numpy(), jq)
    else:
        edge, differ = _assert_indices_edge_equal(tm, torch.from_numpy(x), idx.numpy(), jidx)
        # values: within 1e-6 on every token whose indices agree
        same = _value_mask(tm, ~differ, q.shape)
        np.testing.assert_allclose(q.numpy()[same], jq[same], rtol=0, atol=1e-6)
    # the port's own round trip: exact without projections or rotation, as in the JAX tests
    with torch.no_grad():
        decoded = tm.indices_to_codes(idx)
    if tm.has_projections or tm.orthogonal_rotation:
        np.testing.assert_allclose(decoded.numpy(), q.numpy(), rtol=0, atol=1e-5)
    else:
        assert torch.equal(decoded, q)
    np.testing.assert_allclose(decoded.numpy(), np.asarray(jm.indices_to_codes(jnp.asarray(idx.numpy()))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize('allowed', (('float32', 'bfloat16'), ('float32', 'float64')),
                         ids=('bf16_allowed', 'bf16_forced_f32'))
def test_fsq_bf16_matches_jax(allowed):
    jm, tm = _pair(levels=[8, 5, 5], allowed_dtypes=allowed)
    x = np.random.default_rng(1).standard_normal((2, 64, 3), dtype=np.float32)
    xb = torch.from_numpy(x).bfloat16()
    jq, jidx = jm(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    q, idx = tm(xb)
    assert q.dtype == torch.bfloat16 and jq.dtype == jnp.bfloat16
    edge, differ = _assert_indices_edge_equal(tm, xb.float(), idx.numpy(), np.asarray(jidx))
    same = _value_mask(tm, ~differ, q.shape)
    # one bf16 ulp of values up to 1
    np.testing.assert_allclose(q.float().numpy()[same], np.asarray(jq.astype(jnp.float32))[same],
                               rtol=0, atol=2 ** -8)


@pytest.mark.parametrize('levels,preserve_symmetry', (([8, 5, 5], False), ([8, 6, 5], True), ([2, 4, 3], True)))
def test_fsq_codec_round_trips_over_the_codebook(levels, preserve_symmetry):
    jm, tm = _pair(levels=levels, preserve_symmetry=preserve_symmetry)
    codebook = tm.implicit_codebook
    assert codebook.shape == (tm.codebook_size, len(levels))
    np.testing.assert_array_equal(codebook.numpy(), np.asarray(jm.implicit_codebook))
    every = torch.arange(tm.codebook_size)
    assert torch.equal(tm.codes_to_indices(codebook), every.int())
    assert torch.equal(tm.indices_to_codes(tm.codes_to_indices(codebook)), codebook)
    np.testing.assert_array_equal(tm.indices_to_level_indices(every).numpy(),
                                  np.asarray(jm.indices_to_level_indices(jnp.arange(tm.codebook_size))))


def test_fsq_straight_through_gradients_match_jax():
    jm, tm = _pair(levels=[8, 5, 5, 5], dim=32)
    x = np.random.default_rng(2).standard_normal((1, 64, 32), dtype=np.float32)

    def loss_fn(m, xs):
        out, _ = m(xs)
        return (out ** 2).sum()
    jg, jgx = nnx.grad(loss_fn, argnums=(0, 1))(jm, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out, idx = tm(tx)
    (out ** 2).sum().backward()
    _, jidx = jm(jnp.asarray(x))
    _, differ = _assert_indices_edge_equal(tm, torch.from_numpy(x), idx.numpy(), np.asarray(jidx))
    assert not differ.any(), 'a flipped index changes the gradient; pick another seed'
    assert bool(torch.isfinite(tx.grad).all()) and bool((tx.grad != 0).any())
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0, atol=1e-5 * np.abs(np.asarray(jgx)).max())
    assert_grads_close(tm, jax.tree.map(np.asarray, nnx.to_pure_dict(jg)), rtol=1e-5, atol=1e-5)


def test_fsq_noise_dropout_matches_jax_with_the_same_draws(monkeypatch):
    kw = dict(levels=[8, 5, 5], preserve_symmetry=True, bound_hard_clamp=True, noise_dropout=0.5)
    jm, tm = _pair(**kw)
    x = np.random.default_rng(3).standard_normal((1, 128, 3), dtype=np.float32)
    rng = np.random.default_rng(4)
    mask = rng.random((1, 128, 1, 3)) < 0.5
    uniform = rng.random((1, 128, 1, 3), dtype=np.float32)
    monkeypatch.setattr(jax.random, 'bernoulli', lambda key, p, shape: jnp.asarray(mask))
    monkeypatch.setattr(jax.random, 'uniform', lambda key, shape, dtype: jnp.asarray(uniform, dtype))
    seen = {}

    def draw(generator, p, shape, dtype=torch.float32, device=None):
        seen.update(p=p, shape=tuple(shape), dtype=dtype)
        return torch.from_numpy(mask), torch.from_numpy(uniform).to(dtype)
    monkeypatch.setattr(tfsq, 'bernoulli_and_uniform', draw)
    jm.train()
    tm.train()
    jq, jidx = jm(jnp.asarray(x))
    q, idx = tm(torch.from_numpy(x))
    assert seen == dict(p=0.5, shape=(1, 128, 1, 3), dtype=torch.float32)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(q.detach().numpy(), np.asarray(jq))
    # the noise moves the training output and leaves the eval output clean
    tm.eval()
    with torch.no_grad():
        clean, clean_idx = tm(torch.from_numpy(x))
    assert torch.equal(clean_idx, idx) and not torch.equal(clean, q.detach())
    assert torch.equal(tm.indices_to_codes(clean_idx), clean)


def test_fsq_noise_draw_from_the_generator():
    tm = tfsq.FSQ(levels=[8, 5, 5], preserve_symmetry=True, noise_dropout=0.5, device='cpu').train()
    x = torch.randn(1, 128, 3)
    a, _ = tm(x)
    b, _ = tm(x)
    assert not torch.equal(a, b)
    assert float(a.abs().max()) <= 1.0


def test_fsq_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match='preserve_symmetry'):
        tfsq.FSQ(levels=[2, 5], device='cpu')
    with pytest.raises(ValueError, match='noise_dropout'):
        tfsq.FSQ(levels=[8, 5], noise_dropout=0.1, device='cpu')
    with pytest.raises(TypeError, match='rngs'):
        tfsq.FSQ(levels=[8, 5], rngs=object(), device='cpu')
    with pytest.raises(ValueError, match='dimension'):
        tfsq.FSQ(levels=[8, 5], device='cpu')(torch.zeros(1, 4, 3))
    assert vqtpu_torch.FSQ is tfsq.FSQ and vqtpu_torch.quantizers.FSQ is tfsq.FSQ
