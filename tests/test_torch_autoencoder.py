"""The port's SimpleQuantizeAutoEncoder (vqtpu_torch), eval forward and one
training step, against the JAX flagship model (vqtpu), on the CPU, with
the JAX model's state carried over by load_vqtpu_state.

Tolerances: the encoder and decoder alone to atol 1e-5, the reconstruction
through the whole model to atol 1e-4, since the convolutions sum in another
order than XLA's and the decoder carries the encoder's rounding further.
Indices are held to the tie rule (torch_parity)."""

import jax
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

from torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    assert_grads_close, assert_indices_tie_equal, jax_state, one_torch_thread, torch_layout_grads,
)


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
    """The training forward is ported (test_autoencoder_training_step_matches_jax),
    and the quantizer's forward kwargs pass through the model: a per-token
    codebook, and given codes, which return (reconstruction, cross
    entropy) (held against the JAX package in test_torch_vq_distances.py);
    a state that lacks a part is refused."""
    _, tm = _flagship()
    tm.train()
    x = torch.zeros(2, 28, 28, 1)
    recon, idx, loss = tm(x, codebook_transform_fn=lambda e: e[:, None, None].expand(1, 2, 49, *e.shape[1:]))
    assert recon.shape == x.shape and idx.shape == (2, 49) and float(loss.detach()) >= 0.0
    recon, ce = tm(x, indices=torch.zeros(2, 49, dtype=torch.long))
    assert recon.shape == x.shape and bool(torch.isfinite(ce))
    with pytest.raises(KeyError, match='decoder'):
        load_vqtpu_state(tm, {k: v for k, v in jax_state(_flagship()[0]).items() if k != 'decoder'})


ALPHA = 10.0   # examples/autoencoder.py's commitment weight in the loss


def test_autoencoder_training_step_matches_jax():
    """One training step of the flagship from the same weights: the loss of
    examples/autoencoder.py, the EMA state after the step and every
    parameter's gradient (rtol 1e-4: the convolutions sum in another order
    than XLA's, and the backward pass carries that through the decoder and
    the rotation trick into the encoder)."""
    jm, tm = _flagship()
    jm.train()
    tm.train()
    x = np.random.default_rng(5).random((8, 28, 28, 1), dtype=np.float32)

    def loss_fn(m, x):
        out, indices, cmt_loss = m(x)
        rec = jnp.abs(jnp.clip(out, -1, 1) - x).mean()
        return rec + ALPHA * cmt_loss, (rec, cmt_loss, indices)
    (jloss, (jrec, jcmt, jidx)), jgrads = nnx.value_and_grad(loss_fn, has_aux=True)(jm, jnp.asarray(x))

    tx = torch.from_numpy(x)
    recon, idx, cmt_loss = tm(tx)
    rec = (recon.clamp(-1, 1) - tx).abs().mean()
    loss = rec + ALPHA * cmt_loss
    loss.backward()

    with torch.no_grad():
        z = tm.encoder(tx)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(float(rec.detach()), float(jrec), rtol=1e-5)
    np.testing.assert_allclose(float(cmt_loss.detach()), float(jcmt), rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert torch.isfinite(z).all()

    jcb, tcb = jm.quantizer._codebook, tm.quantizer._codebook
    np.testing.assert_array_equal(tcb.cluster_size.numpy(), np.asarray(jcb.cluster_size[...]))
    for name in ('embed_avg', 'embed'):
        np.testing.assert_allclose(getattr(tcb, name).numpy(), np.asarray(getattr(jcb, name)[...]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    grads = jax.tree.map(np.asarray, nnx.to_pure_dict(jgrads))
    assert_grads_close(tm, grads, rtol=1e-4, atol=1e-7)


def _lfq_flagship(seed=0):
    """examples/autoencoder_lfq.py's model with entropy_fused='on', so that
    the entropy statistics run through the fused sweeps (the port's plain
    sweeps here, the JAX Pallas kernels in interpret mode)."""
    kw = dict(dim=32, codebook_size=256, entropy_loss_weight=0.02, diversity_gamma=1.0, entropy_fused='on')
    rngs = nnx.Rngs(seed)
    jm = jmodels.SimpleQuantizeAutoEncoder(vqtpu.LFQ(**kw, rngs=rngs), dim=32, rngs=rngs)
    tm = vqtpu_torch.SimpleQuantizeAutoEncoder(vqtpu_torch.LFQ(**kw, device='cpu'), dim=32, device='cpu')
    load_vqtpu_state(tm, jax_state(jm))
    return jm, tm


def test_lfq_autoencoder_training_step_matches_jax():
    """One training step of the LFQ flagship from the same weights, with
    examples/autoencoder_lfq.py's loss |clip(out) - x|.mean() + 10 aux:
    indices equal, the loss and its terms within 1e-4 relative (the aux
    loss at inv_temperature 100, tests/test_lfq.py's bound), and every
    parameter's gradient within 1e-3 of its largest entry (the saturated
    softmax's gradient noise, 5e-4 absolute per token, reaches the encoder
    through the projection)."""
    jm, tm = _lfq_flagship()
    jm.train()
    tm.train()
    x = np.random.default_rng(6).random((8, 28, 28, 1), dtype=np.float32)

    def loss_fn(m, x):
        out, indices, aux = m(x)
        rec = jnp.abs(jnp.clip(out, -1, 1) - x).mean()
        return rec + ALPHA * aux, (rec, aux, indices)
    step = nnx.jit(nnx.value_and_grad(loss_fn, has_aux=True))
    (jloss, (jrec, jaux, jidx)), jgrads = step(jm, jnp.asarray(x))

    tx = torch.from_numpy(x)
    recon, idx, aux = tm(tx)
    rec = (recon.clamp(-1, 1) - tx).abs().mean()
    loss = rec + ALPHA * aux
    loss.backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(float(rec.detach()), float(jrec), rtol=1e-4)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    want = torch_layout_grads(tm, jax.tree.map(np.asarray, nnx.to_pure_dict(jgrads)))
    params = dict(tm.named_parameters())
    assert sorted(want) == sorted(params)
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0, atol=1e-3 * np.abs(want[name]).max(),
                                   err_msg=name)


def test_fsq_autoencoder_training_step_matches_jax():
    """One training step of examples/autoencoder_fsq.py's model (FSQ levels
    (8, 6, 5) behind projections of dim 32) from the same weights, with its
    loss |clip(out, -1, 1) - x|.mean(): indices equal, the loss within 1e-5
    relative and every gradient within 1e-4 relative (the convolutions sum
    in another order than XLA's), as the VectorQuantize flagship's step."""
    rngs = nnx.Rngs(0)
    jm = jmodels.SimpleQuantizeAutoEncoder(vqtpu.FSQ([8, 6, 5], dim=32, rngs=rngs), dim=32, rngs=rngs)
    tm = vqtpu_torch.SimpleQuantizeAutoEncoder(vqtpu_torch.FSQ([8, 6, 5], dim=32, device='cpu'), dim=32,
                                               device='cpu')
    load_vqtpu_state(tm, jax_state(jm))
    jm.train()
    tm.train()
    x = np.random.default_rng(7).random((8, 28, 28, 1), dtype=np.float32)

    def loss_fn(m, x):
        out, indices = m(x)
        return jnp.abs(jnp.clip(out, -1, 1) - x).mean(), indices
    (jloss, jidx), jgrads = nnx.value_and_grad(loss_fn, has_aux=True)(jm, jnp.asarray(x))

    tx = torch.from_numpy(x)
    recon, idx = tm(tx)
    loss = (recon.clamp(-1, 1) - tx).abs().mean()
    loss.backward()
    assert idx.dtype == torch.int32 and idx.shape == (8, 49)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert_grads_close(tm, jax.tree.map(np.asarray, nnx.to_pure_dict(jgrads)), rtol=1e-4, atol=1e-7)
