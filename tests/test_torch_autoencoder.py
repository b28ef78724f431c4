"""The port's SimpleQuantizeAutoEncoder eval forward (vqtpu_torch) against
the JAX flagship model (vqtpu), on the CPU, with the JAX model's state
carried over by load_vqtpu_state.

Tolerances: the encoder and decoder alone to atol 1e-5, the reconstruction
through the whole model to atol 1e-4, since the convolutions sum in another
order than XLA's and the decoder carries the encoder's rounding further.
Indices are held to the tie rule (torch_parity)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu
import vqtpu.models as jmodels
import vqtpu_torch
from vqtpu_torch import load_vqtpu_state
from vqtpu_torch.models import ConvDecoder, ConvEncoder

from torch_parity import assert_indices_tie_equal, jax_state, one_torch_thread  # noqa: F401  (autouse)


def _flagship(seed=0):
    rngs = nnx.Rngs(seed)
    jm = jmodels.SimpleQuantizeAutoEncoder(
        vqtpu.VectorQuantize(dim=32, codebook_size=256, rngs=rngs), dim=32, rngs=rngs,
    ).eval()
    tm = vqtpu_torch.SimpleQuantizeAutoEncoder(
        vqtpu_torch.VectorQuantize(dim=32, codebook_size=256, device='cpu'), dim=32, device='cpu',
    ).eval()
    load_vqtpu_state(tm, jax_state(jm))
    return jm, tm


def test_autoencoder_eval_matches_jax():
    jm, tm = _flagship()
    x = np.random.default_rng(0).random((8, 28, 28, 1), dtype=np.float32)
    jrecon, jidx, jloss = jm(jnp.asarray(x))
    tx = torch.from_numpy(x)
    with torch.no_grad():
        recon, idx, loss = tm(tx)
        z = tm.encoder(tx)
    jrecon, jidx = np.array(jrecon), np.array(jidx)
    assert recon.shape == (8, 28, 28, 1) and idx.shape == (8, 49) and idx.dtype == torch.int32
    assert torch.isfinite(recon).all() and float(loss) == float(jloss) == 0.0

    embed = tm.quantizer._codebook.embed
    assert_indices_tie_equal(z.reshape(1, -1, 32), embed, 'euclidean', idx, jidx)
    # images whose every index agrees reconstruct alike
    same = (idx.numpy() == jidx).all(-1)
    assert same.sum() >= 6
    np.testing.assert_allclose(recon.numpy()[same], jrecon[same], atol=1e-4, rtol=0)


@pytest.mark.parametrize('part', ('encoder', 'decoder'))
def test_conv_parts_match_jax(part):
    rngs = nnx.Rngs(1)
    rng = np.random.default_rng(1)
    if part == 'encoder':
        jpart = jmodels.autoencoder.ConvEncoder(32, 1, rngs=rngs)
        tpart = ConvEncoder(32, 1, device='cpu')
        x = rng.random((3, 28, 28, 1), dtype=np.float32)
    else:
        jpart = jmodels.autoencoder.ConvDecoder(32, 1, rngs=rngs)
        tpart = ConvDecoder(32, 1, device='cpu')
        x = rng.standard_normal((3, 7, 7, 32), dtype=np.float32)
    load_vqtpu_state(tpart, jax_state(jpart))
    want = np.asarray(jpart(jnp.asarray(x)))
    with torch.no_grad():
        got = tpart(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_autoencoder_training_forward_not_ported():
    _, tm = _flagship()
    tm.train()
    with pytest.raises(NotImplementedError, match='training-mode forward'):
        tm(torch.zeros(2, 28, 28, 1))
    with pytest.raises(KeyError, match='decoder'):
        load_vqtpu_state(tm, {k: v for k, v in jax_state(_flagship()[0]).items() if k != 'decoder'})
