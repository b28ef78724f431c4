"""The port's FSP (vqtpu_torch) against the JAX module (vqtpu), on the CPU,
from the same state (load_vqtpu_state).

Every CDF activation, with and without its inverse on the decode. The
bins (indices and level indices) equal JAX's; the output, the moment loss,
its statistics and the gradients to rtol 1e-5, atol 1e-5 (XLA's f32
transcendental functions on the CPU differ from torch's by an ulp or two,
and the inverse CDFs steepen near 0 and 1). The perturbation's two uniform
draws are injected: `jax.random.uniform` and
`vqtpu_torch.core.sampling.uniform_noise` are replaced by the same numpy
draws, in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu
import vqtpu_torch
import vqtpu_torch.core.sampling as tsampling
from vqtpu_torch import load_vqtpu_state

from torch_parity import assert_grads_close, jax_state, one_torch_thread  # noqa: F401  (autouse)

LEVELS, DIM = [8, 6, 5], 12
TOL = dict(rtol=1e-5, atol=1e-5)
ACTS = ('tanh', 'sigmoid', 'normal', 'laplace', 'cauchy')


@pytest.fixture
def injected_uniforms(monkeypatch):
    """The n-th uniform draw of either framework is numpy's draw n."""
    calls = {'jax': 0, 'torch': 0}

    def draw(side, shape):
        calls[side] += 1
        return np.random.default_rng(1000 + calls[side]).random(tuple(shape), dtype=np.float32)

    monkeypatch.setattr(jax.random, 'uniform', lambda key, shape=(), dtype=jnp.float32, *a, **k:
                        jnp.asarray(draw('jax', shape), dtype))
    monkeypatch.setattr(tsampling, 'uniform_noise', lambda gen, shape, dtype=torch.float32, device=None:
                        torch.from_numpy(draw('torch', shape)).to(dtype))
    return calls


def _pair(**kw):
    jm = vqtpu.FSP(LEVELS, **kw, rngs=nnx.Rngs(0))
    tm = vqtpu_torch.FSP(LEVELS, **kw, device='cpu')
    load_vqtpu_state(tm, jax_state(jm))
    return jm, tm


def _x(shape=(4, 25, DIM), seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape, dtype=np.float32), rng.standard_normal(shape, dtype=np.float32) * 0.1


def _run(jm, tm, x, g):
    def loss_fn(m, x):
        q, idx, loss, info = m(x)
        return (q * g).sum() + loss, (q, idx, loss, info)
    (_, (jq, jidx, jloss, jinfo)), (jgrads, jgx) = nnx.jit(nnx.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
        jm, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tq, tidx, tloss, tinfo = tm(tx)
    ((tq * torch.from_numpy(g)).sum() + tloss).backward()
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tinfo['level_indices'].numpy(), np.asarray(jinfo['level_indices']))
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(tloss.detach().numpy(), np.asarray(jloss), **TOL)
    for name, value in tinfo['norm_info'].items():
        np.testing.assert_allclose(value.detach().numpy(), np.asarray(jinfo['norm_info'][name]), **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    assert_grads_close(tm, jax.tree.map(np.asarray, nnx.to_pure_dict(jgrads)), **TOL)
    return tinfo, jinfo, tidx


@pytest.mark.parametrize('need_inv_act', [False, True])
@pytest.mark.parametrize('act_name', ACTS)
def test_eval_matches_jax(act_name, need_inv_act):
    jm, tm = _pair(dim=DIM, act_name=act_name, need_inv_act=need_inv_act, quantize_rate=0.5,
                   vector_norm='kurt')
    jm.eval()
    tm.eval()
    x, g = _x(seed=ACTS.index(act_name))
    _, _, tidx = _run(jm, tm, x, g)
    with torch.no_grad():
        codes = tm.indices_to_codes(tidx)
    np.testing.assert_allclose(codes.numpy(), np.asarray(jm.indices_to_codes(jnp.asarray(tidx.numpy()))), **TOL)


@pytest.mark.parametrize('act_name,need_inv_act', [('tanh', False), ('sigmoid', True), ('normal', True)])
def test_perturbed_training_step_matches_jax(act_name, need_inv_act, injected_uniforms):
    jm, tm = _pair(dim=DIM, act_name=act_name, need_inv_act=need_inv_act, quantize_rate=0.5)
    tinfo, jinfo, _ = _run(jm, tm, *_x(seed=7))
    assert injected_uniforms == {'jax': 2, 'torch': 2}
    np.testing.assert_allclose(float(tinfo['p_accept_prob']), float(jinfo['p_accept_prob']), rtol=1e-6)


def test_no_projection_channel_first_matches_jax(injected_uniforms):
    jm, tm = _pair(channel_first=True, quantize_rate=0.25, vector_norm='var')
    assert tm.project_in is None
    x, g = _x((2, 3, 5, 7), seed=8)
    _, _, tidx = _run(jm, tm, x, g)
    assert tidx.shape == (2, 5, 7) and tidx.dtype == torch.int32
    with torch.no_grad():
        codes = tm.indices_to_codes(tidx)
    np.testing.assert_allclose(codes.numpy(), np.asarray(jm.indices_to_codes(jnp.asarray(tidx.numpy()))), **TOL)


def test_sync_axis_and_bad_arguments_raise():
    # the global-batch moments are ported (tests/test_torch_parallel.py);
    # every forward computes them, so it needs the axis bound, as in JAX
    synced = vqtpu_torch.FSP(LEVELS, sync_axis='data', device='cpu')
    assert synced.vector_norm.sync_axis == 'data'
    with pytest.raises(NameError, match="unbound axis name: 'data'"):
        synced(torch.randn(2, 3, len(LEVELS)))
    with pytest.raises(ValueError, match='quantize_rate'):
        vqtpu_torch.FSP(LEVELS, quantize_rate=1.5, device='cpu')
    with pytest.raises(ValueError, match='CDF'):
        vqtpu_torch.FSP(LEVELS, act_name='relu', device='cpu')
