"""The port's BinaryMapper (vqtpu_torch) against the JAX module (vqtpu), on
the CPU.

The Bernoulli bits are injected: `jax.random.bernoulli` and
`vqtpu_torch.core.sampling.bernoulli` are replaced by the same rule, u < p
for one numpy uniform draw u. Indices and one-hots equal JAX's; the aux
loss, the log-probabilities and the gradient reaching the logits (through
the soft-G straight-through estimator and the aux loss) to rtol 1e-5, atol
1e-6 (XLA's and torch's f32 log-sigmoid and exp).
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

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

BITS = 4
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def injected_bits(monkeypatch):
    calls = {'jax': 0, 'torch': 0}

    def u(shape):
        return np.random.default_rng(7).random(tuple(shape), dtype=np.float32)

    def jax_bernoulli(key, p, *a, **k):
        calls['jax'] += 1
        return jnp.asarray(u(p.shape)) < p

    def torch_bernoulli(gen, prob):
        calls['torch'] += 1
        return torch.from_numpy(u(prob.shape)) < prob
    monkeypatch.setattr(jax.random, 'bernoulli', jax_bernoulli)
    monkeypatch.setattr(tsampling, 'bernoulli', torch_bernoulli)
    return calls


def _pair(**kw):
    return vqtpu.BinaryMapper(bits=BITS, **kw, rngs=nnx.Rngs(0)), vqtpu_torch.BinaryMapper(bits=BITS, **kw, device='cpu')


def _logits(seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((3, 10, BITS), dtype=np.float32) * 2.0, rng.standard_normal((3, 10, 2 ** BITS),
                                                                                           dtype=np.float32)


CASES = {
    'train': (True, {}, 1),
    'train_hot': (True, {'temperature': 0.5}, 1),
    'eval_samples': (False, {}, 1),
    'eval_deterministic': (False, {'deterministic_on_eval': True}, 0),
    'train_unreduced': (True, {'reduce_aux_kl_loss': False}, 1),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_forward_and_gradient_match_jax(case, injected_bits):
    train, kw, draws = CASES[case]
    ctor = {k: v for k, v in kw.items() if k == 'deterministic_on_eval'}
    call = {k: v for k, v in kw.items() if k != 'deterministic_on_eval'}
    jm, tm = _pair(**ctor)
    if not train:
        jm.eval()
        tm.eval()
    logits, g = _logits(len(case))

    def loss_fn(m, logits):
        one_hot, idx, aux = m(logits, return_indices=True, **call)
        return (one_hot * g).sum() + aux.sum(), (one_hot, idx, aux)
    (_, (jhot, jidx, jaux)), jgrad = nnx.value_and_grad(loss_fn, argnums=1, has_aux=True)(jm, jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    thot, tidx, taux = tm(tl, return_indices=True, **call)
    loss = (thot * torch.from_numpy(g)).sum() + taux.sum()
    if loss.requires_grad:
        loss.backward()
    else:                                 # eval: no estimator, no aux loss
        tl.grad = torch.zeros_like(tl)
    assert injected_bits == {'jax': draws, 'torch': draws}
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(thot.detach().numpy(), np.asarray(jhot), **TOL)
    np.testing.assert_allclose(taux.detach().numpy(), np.asarray(jaux), **TOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgrad), **TOL)
    for name, value in (('indices', tidx), ('one_hot', thot.detach())):
        want = jm.log_prob(jnp.asarray(logits), **{name: jnp.asarray(value.numpy())}, sum_bits=name == 'indices')
        got = tm.log_prob(torch.from_numpy(logits), **{name: value}, sum_bits=name == 'indices')
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_codes_table_and_checks():
    jm, tm = _pair()
    np.testing.assert_array_equal(tm._codes_table('cpu').numpy(), np.asarray(jm._codes_table()))
    with pytest.raises(ValueError, match='last dimension'):
        tm(torch.zeros(2, BITS + 1))
    with pytest.raises(ValueError, match='either indices or one_hot'):
        tm.log_prob(torch.zeros(2, BITS))
