"""The port's RandomProjectionQuantizer (vqtpu_torch) against the JAX module
(vqtpu), on the CPU, from the same state (load_vqtpu_state).

Indices are held per head to the float64 tie rule
(torch_parity.assert_indices_tie_equal) on the port's codebook-space input:
flax's LayerNorm takes the variance as E[x^2] - E[x]^2, torch as
E[(x - E[x])^2], so the normalized inputs agree to 1e-6 (checked here), not
bit for bit. The cross entropy against given indices to rtol 1e-5. The
inner VectorQuantize stays in eval under .train(): its codebook does not
move.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu
import vqtpu_torch
from vqtpu_torch import load_vqtpu_state

from torch_parity import assert_indices_tie_equal, jax_state, one_torch_thread  # noqa: F401  (autouse)

DIM, CODES, CODE_DIM = 24, 32, 8


def _pair(num_codebooks, norm=True):
    kw = dict(dim=DIM, codebook_size=CODES, codebook_dim=CODE_DIM, num_codebooks=num_codebooks, norm=norm)
    jm = vqtpu.RandomProjectionQuantizer(**kw, rngs=nnx.Rngs(0))
    tm = vqtpu_torch.RandomProjectionQuantizer(**kw, device='cpu')
    load_vqtpu_state(tm, jax_state(jm))
    return jm, tm


def _x(seed=0):
    return np.random.default_rng(seed).standard_normal((2, 30, DIM), dtype=np.float32) * 2.0 + 0.5


def _codebook_space(tm, x):
    """The (h, N, d) tokens the port's codebook quantizes, and its codebooks."""
    with torch.no_grad():
        t = tm.norm(torch.from_numpy(x)) if tm.norm is not None else torch.from_numpy(x)
        t = torch.einsum('bnd,hde->bnhe', t, tm.rand_projs).reshape(*t.shape[:2], -1)
        xc = tm.vq.codebook_input(t)
    return xc.reshape(xc.shape[0], -1, xc.shape[-1]), tm.vq._codebook.embed


@pytest.mark.parametrize('num_codebooks,norm', [(1, True), (2, True), (2, False)])
def test_indices_match_jax(num_codebooks, norm):
    jm, tm = _pair(num_codebooks, norm)
    x = _x()
    jidx = np.asarray(jm(jnp.asarray(x)))
    with torch.no_grad():
        tidx = tm(torch.from_numpy(x))
    # one head keeps no head axis, as in the JAX package
    assert tidx.dtype == torch.int32 and tidx.shape == jidx.shape == (2, 30) + ((num_codebooks,) * (num_codebooks > 1))
    xc, embed = _codebook_space(tm, x)
    assert_indices_tie_equal(xc, embed, 'cosine', jidx.reshape(-1, num_codebooks).T, tidx.reshape(-1, num_codebooks).T)


def test_layernorm_matches_flax():
    jm, tm = _pair(2)
    x = _x(1)
    with torch.no_grad():
        got = tm.norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.norm(jnp.asarray(x))), rtol=0, atol=1e-6)


@pytest.mark.parametrize('num_codebooks', [1, 2])
def test_cross_entropy_against_indices_matches_jax(num_codebooks):
    jm, tm = _pair(num_codebooks)
    x = _x(2)
    idx = np.random.default_rng(3).integers(-1, CODES, (2, 30) + ((num_codebooks,) * (num_codebooks > 1)))
    idx = idx.astype(np.int32)
    want = np.asarray(jm(jnp.asarray(x), indices=jnp.asarray(idx)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), indices=torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_vq_stays_frozen_in_training():
    jm, tm = _pair(2)
    tm.train()
    assert tm.training and not tm.vq.training and not tm.vq._codebook.training
    before = tm.vq._codebook.embed.clone()
    with torch.no_grad():
        idx = tm(torch.from_numpy(_x(4)))
    assert torch.equal(before, tm.vq._codebook.embed)
    jm.train()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jm(jnp.asarray(_x(4)))))
