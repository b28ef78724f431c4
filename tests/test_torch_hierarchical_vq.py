"""The port's HierarchicalVQ (vqtpu_torch) against the JAX module (vqtpu),
on the CPU, from the same state (load_vqtpu_state).

The JAX package pools with two matrix products and upsamples with
jax.image.resize; the port takes F.adaptive_avg_pool2d and
F.interpolate(mode='bilinear', align_corners=False). Both are held to the
JAX ops here, edges included, to atol 1e-6 (the pooling sums in another
order). Each scale's indices are held to the float64 tie rule
(torch_parity.assert_indices_tie_equal) on that scale's own input in the
port; the reconstruction, the loss and the gradients to rtol 1e-5, atol
1e-5 (f32 rounding through the pooling, the bilinear weights and the 3x3
convolutions over four scales), the EMA state after the step to rtol 1e-5,
atol 1e-5.

kmeans init and dead-code expiry draw random rows; as in
tests/test_torch_vq_train.py both frameworks' draw functions are replaced
by ones that take the same rows.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

import vqtpu
import vqtpu.codebook.codebook as jcodebook
import vqtpu_torch
import vqtpu_torch.codebook.codebook as tcodebook
from vqtpu.composite.hierarchical_vq import adaptive_avg_pool_2d
from vqtpu_torch import load_vqtpu_state

from torch_parity import assert_grads_close, assert_indices_tie_equal, jax_state, one_torch_thread  # noqa: F401

jkmeans = importlib.import_module('vqtpu.codebook.kmeans')
tkmeans = importlib.import_module('vqtpu_torch.codebook.kmeans')

DIM, CODES, SCALES, SIDE = 8, 16, (1, 2, 4), 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def injected_draws(monkeypatch):
    """Both frameworks take the same rows wherever they would draw."""
    def rows(n, num):
        return np.random.default_rng(100 + n).integers(0, n, num)

    monkeypatch.setattr(jkmeans, 'sample_means',
                        lambda key, s, mask, num, *a, **k: jnp.take(s, rows(s.shape[1], num), axis=1))
    monkeypatch.setattr(tkmeans, 'sample_means',
                        lambda gen, s, mask, num: s[:, torch.from_numpy(rows(s.shape[1], num))])
    monkeypatch.setattr(jcodebook, 'masked_sample_vectors',
                        lambda key, s, mask, num: jnp.take(s, rows(s.shape[0], num), axis=0))
    monkeypatch.setattr(tcodebook, 'masked_sample_vectors',
                        lambda gen, s, mask, num: s[torch.from_numpy(rows(s.shape[0], num))])


@pytest.mark.parametrize('size,out', [(4, 1), (4, 2), (7, 2), (7, 4), (8, 3), (5, 5)])
def test_adaptive_pool_matches_jax(size, out):
    x = np.random.default_rng(size * out).standard_normal((2, 3, size, size), dtype=np.float32)
    got = F.adaptive_avg_pool2d(torch.from_numpy(x), (out, out)).numpy()
    np.testing.assert_allclose(got, np.asarray(adaptive_avg_pool_2d(jnp.asarray(x), (out, out))), rtol=0, atol=1e-6)


@pytest.mark.parametrize('size,out', [(1, 7), (2, 7), (4, 7), (3, 8), (2, 4)])
def test_bilinear_upsample_matches_jax(size, out):
    x = np.random.default_rng(size + out).standard_normal((2, 3, size, size), dtype=np.float32)
    got = F.interpolate(torch.from_numpy(x), size=(out, out), mode='bilinear', align_corners=False).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, out, out), method='bilinear'))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the edges: the outermost output pixels take the edge input pixel's value
    np.testing.assert_allclose(got[..., 0, 0], x[..., 0, 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[..., -1, -1], x[..., -1, -1], rtol=0, atol=1e-6)


def _pair(**kw):
    kw = dict(dim=DIM, codebook_size=CODES, scales=SCALES, accept_image_fmap=True, kmeans_iters=3, **kw)
    jm = vqtpu.HierarchicalVQ(**kw, rngs=nnx.Rngs(0))
    tm = vqtpu_torch.HierarchicalVQ(**kw, device='cpu')
    load_vqtpu_state(tm, jax_state(jm))
    return jm, tm


def _x(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((3, DIM, SIDE, SIDE), dtype=np.float32), \
        rng.standard_normal((3, DIM, SIDE, SIDE), dtype=np.float32) * 0.1


def _capture_scale_inputs(tm):
    """Each scale's (1, N, d) codebook-space input and the codebook it met."""
    seen = []

    def hook(module, args, kwargs):
        with torch.no_grad():
            tokens = args[0].detach().movedim(1, -1).reshape(1, -1, DIM)
        seen.append((tokens, module._codebook.embed.detach().clone()))
    return seen, tm.vq.register_forward_pre_hook(hook, with_kwargs=True)


def _assert_scale_indices(seen, jidx, tidx):
    for (xin, embed), ji, ti in zip(seen, jidx, tidx):
        assert ti.dtype == torch.int32 and tuple(ti.shape) == np.asarray(ji).shape
        assert_indices_tie_equal(xin, embed, 'euclidean', np.asarray(ji), ti)


@pytest.mark.parametrize('share_quant_resi', [1, 0, 2])
def test_eval_forward_matches_jax(share_quant_resi, injected_draws):
    jm, tm = _pair(share_quant_resi=share_quant_resi)
    assert tm._phi_of_scale == jm._phi_of_scale
    jm.eval()
    tm.eval()
    x, _ = _x(0)
    # the first forward runs kmeans init in either mode; the second is a pure eval
    jforward = nnx.jit(lambda m, x: m(x))
    jforward(jm, jnp.asarray(x))
    with torch.no_grad():
        tm(torch.from_numpy(x))
    seen, handle = _capture_scale_inputs(tm)
    jrec, jidx, jloss = jforward(jm, jnp.asarray(x))
    with torch.no_grad():
        trec, tidx, tloss = tm(torch.from_numpy(x))
    handle.remove()
    _assert_scale_indices(seen, jidx, tidx)
    np.testing.assert_allclose(trec.numpy(), np.asarray(jrec), **TOL)
    assert float(tloss) == float(jloss) == 0.0
    with torch.no_grad():
        dec = tm.get_output_from_indices(tidx)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jm.get_output_from_indices(tuple(jnp.asarray(i.numpy())
                                                                                      for i in tidx))), **TOL)
    np.testing.assert_allclose(dec.numpy(), trec.numpy(), **TOL)


@pytest.mark.parametrize('route', ['off', 'on'])
def test_training_step_matches_jax(route, injected_draws):
    jm, tm = _pair(train_fused=route)
    x0, _ = _x(1)
    jm(jnp.asarray(x0))                   # kmeans init on the first forward
    tm(torch.from_numpy(x0))
    x, g = _x(2)
    seen, handle = _capture_scale_inputs(tm)

    def loss_fn(m, x):
        rec, idx, loss = m(x)
        return (rec * g).sum() + loss, (rec, idx, loss)
    (_, (jrec, jidx, jloss)), (jgrads, jgx) = nnx.jit(nnx.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
        jm, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    trec, tidx, tloss = tm(tx)
    ((trec * torch.from_numpy(g)).sum() + tloss).backward()
    handle.remove()
    _assert_scale_indices(seen, jidx, tidx)
    np.testing.assert_allclose(trec.detach().numpy(), np.asarray(jrec), **TOL)
    np.testing.assert_allclose(tloss.detach().numpy(), np.asarray(jloss), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    assert_grads_close(tm, jax.tree.map(np.asarray, nnx.to_pure_dict(jgrads)), **TOL)
    jcb, tcb = jm.vq._codebook, tm.vq._codebook
    np.testing.assert_array_equal(tcb.cluster_size.numpy() > 0, np.asarray(jcb.cluster_size[...]) > 0)
    for name in ('cluster_size', 'embed_avg', 'embed'):
        np.testing.assert_allclose(getattr(tcb, name).numpy(), np.asarray(getattr(jcb, name)[...]), **TOL,
                                   err_msg=name)


def test_constructor_checks():
    with pytest.raises(ValueError, match='accept_image_fmap'):
        vqtpu_torch.HierarchicalVQ(dim=DIM, codebook_size=CODES, scales=SCALES, device='cpu')
    with pytest.raises(ValueError, match='ascending'):
        vqtpu_torch.HierarchicalVQ(dim=DIM, codebook_size=CODES, scales=(2, 1), accept_image_fmap=True,
                                   device='cpu')
