"""The port's Sequential (vqtpu_torch) against the JAX module (vqtpu), on
the CPU, from the same state (load_vqtpu_state): a convolutional encoder,
one quantizer and a decoder. The chain's output, the quantizer's extra
outputs and the gradients to rtol 1e-4, atol 1e-5 (f32 rounding through
two convolutions on either side of the quantizer); indices equal (SimVQ's
picks here have no near-tie)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu
import vqtpu.composite.sequential as jseq
import vqtpu_torch
import vqtpu_torch.composite.sequential as tseq
from vqtpu.models.autoencoder import ConvDecoder as JDecoder, ConvEncoder as JEncoder
from vqtpu_torch import load_vqtpu_state
from vqtpu_torch.models.autoencoder import ConvDecoder, ConvEncoder

from torch_parity import assert_grads_close, jax_state, one_torch_thread  # noqa: F401  (autouse)

DIM = 8
TOL = dict(rtol=1e-4, atol=1e-5)
QUANTIZERS = {
    'sim_vq': (lambda r: vqtpu.SimVQ(dim=DIM, codebook_size=16, rngs=r),
               lambda: vqtpu_torch.SimVQ(dim=DIM, codebook_size=16, device='cpu'), {}),
    # quantize_rate 1: no perturbation draw (tests/test_torch_fsp.py injects those)
    'fsp': (lambda r: vqtpu.FSP([5, 4], dim=DIM, quantize_rate=1.0, rngs=r),
            lambda: vqtpu_torch.FSP([5, 4], dim=DIM, quantize_rate=1.0, device='cpu'), {'eps': 1e-6}),
}


def test_quantizer_classes_are_the_jax_ones():
    assert [k.__name__ for k in tseq.QUANTIZE_KLASSES] == [k.__name__ for k in jseq.QUANTIZE_KLASSES]


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('name', sorted(QUANTIZERS))
def test_chain_matches_jax(name, train):
    jq, tq, fkw = QUANTIZERS[name]
    r = nnx.Rngs(0)
    jm = vqtpu.Sequential(JEncoder(DIM, rngs=r), jq(r), JDecoder(DIM, rngs=r))
    tm = vqtpu_torch.Sequential(ConvEncoder(DIM, device='cpu'), tq(), ConvDecoder(DIM, device='cpu'))
    load_vqtpu_state(tm, jax_state(jm))
    if not train:
        jm.eval()
        tm.eval()
    rng = np.random.default_rng(1)
    x = rng.random((3, 8, 8, 1), dtype=np.float32)
    g = rng.standard_normal((3, 8, 8, 1), dtype=np.float32)

    def loss_fn(m, x):
        out = m(x, **fkw)
        return (out[0] * g).sum() + out[2], out
    (_, jout), jgrads = nnx.jit(nnx.value_and_grad(loss_fn, has_aux=True))(jm, jnp.asarray(x))
    tout = tm(torch.from_numpy(x), **fkw)
    ((tout[0] * torch.from_numpy(g)).sum() + tout[2]).backward()
    assert len(tout) == len(jout)
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    for got, want in zip((tout[0], tout[2]), (jout[0], jout[2])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # in eval SimVQ's rows do not depend on x: JAX gives the encoder zeros, torch no gradient
    assert_grads_close(tm, jax.tree.map(np.asarray, nnx.to_pure_dict(jgrads)), **TOL, none_is_zero=True)


@pytest.mark.parametrize('count', [0, 2])
def test_exactly_one_quantizer(count):
    fns = [ConvEncoder(DIM, device='cpu')] + [vqtpu_torch.FSQ([5, 4], dim=DIM, device='cpu') for _ in range(count)]
    with pytest.raises(ValueError, match='exactly one quantizer'):
        vqtpu_torch.Sequential(*fns)
