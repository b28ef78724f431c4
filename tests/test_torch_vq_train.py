"""The port's VectorQuantize training step (vqtpu_torch) against the JAX
module (vqtpu), on the CPU, from the same state (load_vqtpu_state).

Each case runs a few training steps on the same numpy inputs through both
modules and compares, step by step, the indices (float64 tie rule,
torch_parity.assert_indices_tie_equal), the quantized output and the loss
(rtol 1e-5, atol 1e-6: f32 rounding in the rotation trick and the
projections), the gradient reaching x (the same tolerance), and after the
steps the EMA state: cluster_size equal, embed_avg and embed to rtol 1e-6,
atol 1e-5 (f32 summation order of the statistics). Each case runs with
`train_fused='off'` and `'on'`; on the JAX side 'on' runs the Pallas kernel
in interpret mode, on the port's side the CPU takes the kernel's plain
version.

kmeans init and dead-code expiry draw random rows, and the two frameworks
cannot share a random stream, so the draws are injected: the JAX package's
`kmeans.sample_means` and `codebook.masked_sample_vectors` and their port
counterparts are replaced, for the test only, by functions that take the
same rows.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu
import vqtpu.codebook.codebook as jcodebook
import vqtpu_torch
import vqtpu_torch.codebook.codebook as tcodebook
from vqtpu_torch import load_vqtpu_state

# the module: vqtpu.codebook's own `kmeans` attribute is the function
jkmeans = importlib.import_module('vqtpu.codebook.kmeans')
tkmeans = importlib.import_module('vqtpu_torch.codebook.kmeans')

from torch_parity import assert_indices_tie_equal, jax_state, one_torch_thread  # noqa: F401  (autouse)

SHAPE = (4, 33, 32)
BASE = dict(dim=32, codebook_size=64)
ROUTES = ('off', 'on')

# the kwarg sets of tests/test_vq.py::test_train_fused_matches_module but
# affine_param, which is not ported
KWARG_SETS = {
    'ema': {},
    'cosine': {'use_cosine_sim': True},
    'heads': {'heads': 2, 'separate_codebook_per_head': True, 'codebook_dim': 16},
    'no_expiry': {'threshold_ema_dead_code': 0.0},
    'kmeans': {'kmeans_init': True, 'kmeans_iters': 3},
    'expiry': {'threshold_ema_dead_code': 2.0},
}


@pytest.fixture
def injected_draws(monkeypatch):
    """Both frameworks take the same rows wherever they would draw: row
    indices from a numpy generator seeded with draws['step'], the same for
    every head."""
    draws = {'step': 0}

    def rows(n, num):
        return np.random.default_rng(100 + draws['step']).integers(0, n, num)

    monkeypatch.setattr(jkmeans, 'sample_means',
                        lambda key, s, mask, num, *a, **k: jnp.take(s, rows(s.shape[1], num), axis=1))
    monkeypatch.setattr(tkmeans, 'sample_means',
                        lambda gen, s, mask, num: s[:, torch.from_numpy(rows(s.shape[1], num))])
    monkeypatch.setattr(jcodebook, 'masked_sample_vectors',
                        lambda key, s, mask, num: jnp.take(s, rows(s.shape[0], num), axis=0))
    monkeypatch.setattr(tcodebook, 'masked_sample_vectors',
                        lambda gen, s, mask, num: s[torch.from_numpy(rows(s.shape[0], num))])
    return draws


def _pair(kwargs, route):
    jvq = vqtpu.VectorQuantize(**kwargs, train_fused=route, rngs=nnx.Rngs(0))
    tvq = vqtpu_torch.VectorQuantize(**kwargs, train_fused=route, device='cpu').train()
    load_vqtpu_state(tvq, jax_state(jvq))
    return jvq, tvq


def _jax_step(jvq, x, g, fkw):
    """One JAX training forward with the gradient of sum(q * g) + loss with
    respect to x; the module's state updates carry out of nnx.grad."""
    def loss_fn(m, x):
        q, idx, loss = m(x, **fkw)
        return (q * g).sum() + loss, (q, idx, loss)
    (_, (q, idx, loss)), gx = nnx.value_and_grad(loss_fn, argnums=1, has_aux=True)(jvq, x)
    return np.asarray(q), np.asarray(idx), np.asarray(loss), np.asarray(gx)


def _torch_step(tvq, x, g, fkw):
    tx = torch.from_numpy(x).requires_grad_()
    q, idx, loss = tvq(tx, **fkw)
    ((q * torch.from_numpy(g)).sum() + loss).backward()
    return q.detach().numpy(), idx.numpy(), loss.detach().numpy(), tx.grad.numpy()


def _codebook_space(tvq, x):
    """(H, N, d) tokens the codebook quantized, and the codebook it used."""
    with torch.no_grad():
        xc = tvq.codebook_input(torch.from_numpy(x))
    return xc.reshape(tvq._codebook.embed.shape[0], -1, xc.shape[-1]), tvq._codebook.embed.clone()


def _flat_indices(tvq, idx):
    idx = torch.as_tensor(np.array(idx))
    if tvq.heads == 1:
        return idx.reshape(1, -1)
    return idx.reshape(-1, tvq.heads).T


def _assert_states_close(jvq, tvq):
    jcb, tcb = jvq._codebook, tvq._codebook
    np.testing.assert_array_equal(tcb.cluster_size.numpy(), np.asarray(jcb.cluster_size[...]))
    for name in ('embed_avg', 'embed', 'accum_cluster_size', 'accum_embed_avg'):
        np.testing.assert_allclose(getattr(tcb, name).numpy(), np.asarray(getattr(jcb, name)[...]),
                                   rtol=1e-6, atol=1e-5, err_msg=name)
    assert bool(tcb.initted) == bool(jcb.initted[...])


def _run_steps(kwargs, route, draws, steps=3, forward_kwargs=None):
    jvq, tvq = _pair(kwargs, route)
    metric = 'cosine' if kwargs.get('use_cosine_sim') else 'euclidean'
    for s in range(steps):
        draws['step'] = s
        rng = np.random.default_rng(s)
        x = rng.standard_normal(SHAPE, dtype=np.float32)
        g = rng.standard_normal(SHAPE, dtype=np.float32)
        jfkw, tfkw = (forward_kwargs(s, rng) if forward_kwargs else ({}, {}))
        kmeans_pending = kwargs.get('kmeans_init') and not bool(tvq._codebook.initted)
        xc, embed = _codebook_space(tvq, x)

        jq, jidx, jloss, jgx = _jax_step(jvq, jnp.asarray(x), jnp.asarray(g), jfkw)
        tq, tidx, tloss, tgx = _torch_step(tvq, x, g, tfkw)

        if kmeans_pending:
            embed = tvq._codebook.embed_before_update
        assert tidx.dtype == np.int32 and tidx.shape == jidx.shape
        assert_indices_tie_equal(xc, embed, metric, _flat_indices(tvq, tidx), _flat_indices(tvq, jidx))
        np.testing.assert_allclose(tq, jq, rtol=1e-5, atol=1e-6, err_msg=f'step {s} quantize')
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=1e-6, err_msg=f'step {s} loss')
        np.testing.assert_allclose(tgx, jgx, rtol=1e-5, atol=1e-6, err_msg=f'step {s} x.grad')
    _assert_states_close(jvq, tvq)
    return jvq, tvq


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the port codebook's calls of the fused train function."""
    calls = {'n': 0}
    fused = tcodebook.fused_train_quantize

    def counted(*args, **kwargs):
        calls['n'] += 1
        return fused(*args, **kwargs)
    monkeypatch.setattr(tcodebook, 'fused_train_quantize', counted)
    return calls


@pytest.fixture
def record_kmeans_embed(monkeypatch):
    """Keep the codebook the kmeans init produced, which the first step's
    selection used, for the tie rule."""
    init = tcodebook.Codebook.init_embed_

    def init_and_record(self, flatten, mask=None):
        init(self, flatten, mask)
        self.embed_before_update = self.embed.clone()
    monkeypatch.setattr(tcodebook.Codebook, 'init_embed_', init_and_record)


@pytest.mark.parametrize('route,device,fused', (
    ('auto', 'cuda', True), ('auto', 'cpu', False), ('on', 'cuda', True), ('on', 'cpu', True),
    ('off', 'cuda', False), ('off', 'cpu', False),
), ids=('auto_cuda', 'auto_cpu', 'on_cuda', 'on_cpu', 'off_cuda', 'off_cpu'))
def test_train_fused_route_by_device(route, device, fused, fused_calls):
    """train_fused='auto' takes the fused kernel on the card and the
    composition on the CPU; 'on' and 'off' force one or the other; a CPU
    training forward follows the rule."""
    tvq = vqtpu_torch.VectorQuantize(**BASE, train_fused=route, device='cpu').train()
    assert tvq._codebook._train_fused_active(device) == fused
    if device == 'cpu':
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(SHAPE, dtype=np.float32))
        tvq(x)
        assert fused_calls['n'] == int(fused)


@pytest.mark.parametrize('route', ROUTES)
@pytest.mark.parametrize('case', sorted(KWARG_SETS))
def test_training_steps_match_jax(case, route, injected_draws, record_kmeans_embed, fused_calls):
    _run_steps({**BASE, **KWARG_SETS[case]}, route, injected_draws)
    assert fused_calls['n'] == (3 if route == 'on' else 0)


@pytest.mark.parametrize('route', ROUTES)
def test_masked_training_matches_jax(route, injected_draws):
    def lens(s, rng):
        lengths = rng.integers(1, SHAPE[1] + 1, SHAPE[0])
        return {'lens': jnp.asarray(lengths)}, {'lens': torch.from_numpy(lengths)}
    _run_steps(BASE, route, injected_draws, forward_kwargs=lens)


@pytest.mark.parametrize('route', ROUTES)
def test_accum_ema_update_drains_like_jax(route, injected_draws):
    # two steps accumulate, the third folds the accumulators in and drains them
    def accum(s, rng):
        kw = {'accum_ema_update': s < 2}
        return kw, kw
    jvq, tvq = _run_steps(BASE, route, injected_draws, forward_kwargs=accum)
    assert float(tvq._codebook.accum_cluster_size.abs().sum()) == 0.0


@pytest.mark.parametrize('route', ROUTES)
@pytest.mark.parametrize('weight', ('scalar', 'per_code', 'callable'))
def test_ema_update_weight_matches_jax(route, weight, injected_draws):
    w = np.random.default_rng(7).random(BASE['codebook_size']).astype(np.float32)

    def weighted(s, rng):
        if weight == 'scalar':
            return {'ema_update_weight': 0.5}, {'ema_update_weight': 0.5}
        if weight == 'per_code':
            return {'ema_update_weight': jnp.asarray(w)}, {'ema_update_weight': torch.from_numpy(w)}
        return ({'ema_update_weight': lambda esum, cs: (cs > 0).astype(jnp.float32)},
                {'ema_update_weight': lambda esum, cs: (cs > 0).float()})
    _run_steps(BASE, route, injected_draws, forward_kwargs=weighted)


@pytest.mark.parametrize('route', ROUTES)
def test_freeze_codebook_leaves_state_alone(route, injected_draws, fused_calls):
    # with freeze_codebook the 'on' route takes the standard route, as in JAX
    def frozen(s, rng):
        return {'freeze_codebook': True}, {'freeze_codebook': True}
    _, tvq = _run_steps(BASE, route, injected_draws, forward_kwargs=frozen)
    _, fresh = _pair(BASE, route)
    assert fused_calls['n'] == 0
    state = tvq._codebook.state_dict()
    for k, v in fresh._codebook.state_dict().items():
        assert torch.equal(state[k], v), k


@pytest.mark.parametrize('route', ROUTES)
def test_straight_through_matches_jax(route, injected_draws):
    _run_steps({**BASE, 'rotation_trick': False}, route, injected_draws)


def test_update_indices_matches_jax(injected_draws):
    kwargs = {**BASE, 'heads': 2, 'codebook_dim': 16, 'threshold_ema_dead_code': 2.0}
    jvq, tvq = _pair(kwargs, 'off')
    rng = np.random.default_rng(3)
    x = rng.standard_normal(SHAPE, dtype=np.float32)
    idx = rng.integers(-1, BASE['codebook_size'], (*SHAPE[:2], 2)).astype(np.int32)
    mask = rng.random(SHAPE[:2]) < 0.8
    jvq.update_indices(jnp.asarray(x), jnp.asarray(idx), mask=jnp.asarray(mask))
    tvq.update_indices(torch.from_numpy(x), torch.from_numpy(idx), mask=torch.from_numpy(mask))
    _assert_states_close(jvq, tvq)
    # and the alias, without a mask
    jvq.update_ema_indices(jnp.asarray(x), jnp.asarray(idx))
    tvq.update_ema_indices(torch.from_numpy(x), torch.from_numpy(idx))
    _assert_states_close(jvq, tvq)


def test_kmeans_init_on_eval_forward_matches_jax(injected_draws):
    # as the JAX package does, the first forward initialises a kmeans_init
    # codebook in either mode, so an eval forward quantizes against the
    # kmeans means and not the zero codebook
    kwargs = {**BASE, 'kmeans_init': True, 'kmeans_iters': 2}
    jvq, tvq = _pair(kwargs, 'off')
    jvq.eval()
    tvq.eval()
    x = np.random.default_rng(4).standard_normal(SHAPE, dtype=np.float32)
    jq, jidx, _ = jvq(jnp.asarray(x))
    with torch.no_grad():
        tq, tidx, _ = tvq(torch.from_numpy(x))
    assert bool(tvq._codebook.initted) and bool(jvq._codebook.initted[...])
    assert float(tvq._codebook.embed.abs().sum()) > 0
    _assert_states_close(jvq, tvq)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-6)


def test_expire_codes_matches_jax(injected_draws):
    # a fresh codebook's cluster sizes (1.0) are all below the threshold, so
    # every code is replaced by an injected row of x; x is in codebook space
    # with its leading axis the codebook's (one codebook here)
    kwargs = {**BASE, 'threshold_ema_dead_code': 2.0, 'use_cosine_sim': True}
    jvq, tvq = _pair(kwargs, 'off')
    x = np.random.default_rng(6).standard_normal((1, 20, BASE['dim']), dtype=np.float32)
    jvq.expire_codes_(jnp.asarray(x))
    tvq.expire_codes_(torch.from_numpy(x))
    _assert_states_close(jvq, tvq)
    assert float(tvq._codebook.cluster_size.min()) == 2.0
