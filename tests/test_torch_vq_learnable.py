"""The learnable-codebook family of the port's VectorQuantize (vqtpu_torch)
against the JAX package's (vqtpu), on the CPU: the learnable codebook, the
in-place codebook optimizer (and its manual mode), the orthogonal
regularization (all codes, the active ones, a drawn subset), DiVeQ,
sync_update_v, affine_param, stat_precision and the FVQ bridge
(MiniEncoder), with the JAX state carried over by load_vqtpu_state.

Every random draw is given to both sides: DiVeQ's normal noise
(`jax.random.normal` and `vqtpu_torch.core.sampling.normal_noise`), the
orthogonal loss's code subset (`jax.random.permutation` /
`random_permutation`, and the gumbel noise of its active-code draw) and the
dead-code replacements (both `masked_sample_vectors`). Each draw depends on
its shape only, so that the jitted JAX step, which draws once while it
traces, draws what the port draws at every call.

The JAX package selects with -||x - e||^2 and the port with
x.e - ||e||^2/2, so indices are held to the float64 tie rule
(torch_parity.assert_indices_tie_equal). Outputs, losses, breakdowns, the
gradient reaching x and the codebook's (and the bridge's) gradients to
rtol 1e-5, atol 1e-5: f32 rounding in another order (the codebook gradient
sums each code's rows in token order in both, the bridge's attention and
the affine map round differently). The state after each step (codebook,
EMA and affine statistics) to rtol 1e-5, atol 1e-6. With an in-place
optimizer the JAX package differentiates the outer loss through the inner
step (a second-order term the port, as upstream, leaves out), so there the
codebook's gradient is not compared; the codebook after the steps is: SGD
exactly (the same sums by code in token order, and one multiply-add), Adam
to 1e-6 (its square root and division round differently: some 1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import vqtpu.codebook.codebook as jcodebook
import vqtpu.core.utils as jutils
import vqtpu.core.ste as jste
import vqtpu_torch.codebook.codebook as tcodebook
import vqtpu_torch.composite.residual_vq as tresidual
import vqtpu_torch.models as tmodels
import vqtpu_torch.models.transformer as ttransformer
import vqtpu_torch.core.sampling as tsampling
import torch_dist
from vqtpu import VectorQuantize as JVQ
from vqtpu.models import MiniEncoder as JMiniEncoder
from vqtpu.models import SimpleQuantizeAutoEncoder as JAutoEncoder
from vqtpu_torch import SimpleQuantizeAutoEncoder as TAutoEncoder
from vqtpu_torch import VectorQuantize as TVQ
from vqtpu_torch import load_vqtpu_state
from vqtpu_torch.core.ste import directional_reparam
from vqtpu_torch.core.utils import orthogonal_loss_fn
from vqtpu_torch.models import MiniEncoder as TMiniEncoder

from torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    assert_indices_tie_equal, jax_state, one_torch_thread, torch_layout_grads,
)

DIM, CODES = 8, 16
SHAPE = (2, 12, DIM)
TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
LEARNABLE = dict(learnable_codebook=True, ema_update=False)

# name -> constructor kwargs; every case runs two training steps
CASES = {
    'learnable': LEARNABLE,
    'learnable_straight_through': dict(LEARNABLE, rotation_trick=False),
    'learnable_heads': dict(LEARNABLE, heads=2, separate_codebook_per_head=True, codebook_dim=4),
    'learnable_mask': dict(LEARNABLE),
    'learnable_expiry': dict(LEARNABLE, threshold_ema_dead_code=1.5),
    'sync_update_v': dict(LEARNABLE, rotation_trick=False, sync_update_v=0.5),
    'diveq': dict(directional_reparam=True, threshold_ema_dead_code=1.0),
    'ortho': dict(orthogonal_reg_weight=10.0),
    'ortho_active': dict(orthogonal_reg_weight=10.0, orthogonal_reg_active_codes_only=True),
    'ortho_max_codes': dict(orthogonal_reg_weight=10.0, orthogonal_reg_max_codes=6),
    'ortho_active_max_codes': dict(orthogonal_reg_weight=10.0, orthogonal_reg_active_codes_only=True,
                                   orthogonal_reg_max_codes=6),
    'ortho_learnable': dict(LEARNABLE, orthogonal_reg_weight=10.0),
    'ortho_expiry': dict(orthogonal_reg_weight=10.0, threshold_ema_dead_code=1.5, manual_ema_update=True),
    'affine': dict(affine_param=True),
    'affine_mask': dict(affine_param=True),
    'affine_learnable': dict(LEARNABLE, affine_param=True),
    'stat_default': dict(stat_precision='default'),
    'bridge': dict(LEARNABLE, rotation_trick=False, vq_bridge='bridge'),
}
MASKED = ('learnable_mask', 'affine_mask')


def _noise(kind, shape, seed):
    rng = np.random.default_rng([seed, *shape])
    return (rng.gumbel(size=shape) if kind == 'gumbel' else rng.standard_normal(shape)).astype(np.float32)


def _rows(n, num):
    return np.random.default_rng([200, n, num]).integers(0, n, num)


@pytest.fixture
def injected_draws(monkeypatch):
    """The same draws on both sides, each a function of its shape."""
    monkeypatch.setattr(jax.random, 'normal', lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(_noise('normal', shape, 1)))
    monkeypatch.setattr(tsampling, 'normal_noise', lambda gen, shape, device=None:
                        torch.from_numpy(_noise('normal', tuple(shape), 1)))
    monkeypatch.setattr(jax.random, 'permutation', lambda key, n, *a, **k:
                        jnp.asarray(np.random.default_rng([3, n]).permutation(n)))
    monkeypatch.setattr(tsampling, 'random_permutation', lambda gen, n, device=None:
                        torch.from_numpy(np.random.default_rng([3, n]).permutation(n)))
    monkeypatch.setattr(jax.random, 'gumbel', lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(_noise('gumbel', shape, 4)))
    monkeypatch.setattr(tsampling, 'gumbel_noise', lambda gen, shape, device=None:
                        torch.from_numpy(_noise('gumbel', tuple(shape), 4)))
    monkeypatch.setattr(jcodebook, 'masked_sample_vectors', lambda key, s, mask, num:
                        jnp.take(s, _rows(s.shape[0], num), axis=0))
    monkeypatch.setattr(tcodebook, 'masked_sample_vectors', lambda gen, s, mask, num:
                        s[torch.from_numpy(_rows(s.shape[0], num))])


def _pair(kwargs, jax_opt=None, torch_opt=None):
    """The JAX VectorQuantize and the port's with its state; a 'bridge'
    vq_bridge is a MiniEncoder(dim=16, input_dim=DIM) on both sides."""
    jkw, tkw = dict(kwargs), dict(kwargs)
    if kwargs.get('vq_bridge') == 'bridge':
        jkw['vq_bridge'] = JMiniEncoder(dim=16, input_dim=DIM, depth=1, heads=4, rngs=nnx.Rngs(1))
        tkw['vq_bridge'] = TMiniEncoder(dim=16, input_dim=DIM, depth=1, heads=4, device='cpu')
    jm = JVQ(dim=DIM, codebook_size=CODES, in_place_codebook_optimizer=jax_opt, rngs=nnx.Rngs(0), **jkw)
    tm = TVQ(dim=DIM, codebook_size=CODES, in_place_codebook_optimizer=torch_opt, device='cpu', **tkw)
    load_vqtpu_state(tm, jax_state(jm))
    return jm, tm


def _jax_loss(m, x, g, mask):
    q, idx, loss, breakdown = m(x, mask=mask, return_loss_breakdown=True)
    return (q * g).sum() + loss, (q, idx, loss, breakdown)


_jax_value_and_grad = nnx.jit(nnx.value_and_grad(_jax_loss, argnums=(0, 1), has_aux=True))


def _jax_step(jm, x, g, mask):
    (_, aux), (grads, gx) = _jax_value_and_grad(
        jm, jnp.asarray(x), jnp.asarray(g), None if mask is None else jnp.asarray(mask))
    q, idx, loss, breakdown = aux
    return (np.asarray(q), np.asarray(idx), np.asarray(loss), np.asarray(breakdown), np.asarray(gx),
            jax.tree.map(np.asarray, nnx.to_pure_dict(grads)))


def _torch_step(tm, x, g, mask):
    tm.zero_grad()
    tx = torch.from_numpy(x).requires_grad_()
    q, idx, loss, breakdown = tm(tx, mask=None if mask is None else torch.from_numpy(mask),
                                 return_loss_breakdown=True)
    ((q * torch.from_numpy(g)).sum() + loss).backward()
    return (q.detach().numpy(), idx.numpy(), loss.detach().numpy(),
            np.array([float(t.detach()) for t in breakdown]), tx.grad.numpy())


def _codebook_input(tm, x):
    with torch.no_grad():
        return tm.codebook_input(torch.from_numpy(x))


def _assert_state_close(jm, tm, what):
    jcb, tcb = jm._codebook, tm._codebook
    names = ['embed', 'embed_avg', 'cluster_size']
    if tcb.affine_param:
        names += [f'{w}_{s}' for w in ('batch', 'codebook') for s in ('mean', 'variance')]
        for w in ('batch', 'codebook'):
            for s in ('mean', 'variance'):
                assert bool(getattr(tcb, f'{w}_{s}_initted')) == bool(getattr(jcb, f'{w}_{s}_initted')[...])
    for name in names:
        np.testing.assert_allclose(getattr(tcb, name).detach().numpy(), np.asarray(getattr(jcb, name)[...]),
                                   **STATE_TOL, err_msg=f'{what}: {name}')


def _assert_grads_close(tm, jgrads):
    want = torch_layout_grads(tm, jgrads)
    params = dict(tm.named_parameters())
    assert sorted(want) == sorted(params)
    for name, p in params.items():
        # a codebook the forward rewrote whole (the EMA) takes no gradient:
        # None here, zeros in JAX
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), want[name], **TOL, err_msg=name)


def _run_pair(jm, tm, case, selected_from, steps=2):
    for step in range(steps):
        rng = np.random.default_rng([7, step])
        x = rng.standard_normal(SHAPE, dtype=np.float32)
        g = rng.standard_normal(SHAPE, dtype=np.float32)
        mask = (np.arange(SHAPE[1]) < SHAPE[1] - 3 - step)[None].repeat(SHAPE[0], 0) if case in MASKED else None
        xin = _codebook_input(tm, x)
        jq, jidx, jloss, jbreak, jgx, jgrads = _jax_step(jm, x, g, mask)
        tq, tidx, tloss, tbreak, tgx = _torch_step(tm, x, g, mask)
        embed = selected_from['embed']
        assert tidx.dtype == np.int32 and tidx.shape == jidx.shape
        if tm.heads == 1:
            assert_indices_tie_equal(xin.reshape(1, -1, xin.shape[-1]), embed, 'euclidean',
                                     tidx.reshape(1, -1), jidx.reshape(1, -1))
        else:
            assert_indices_tie_equal(xin, embed, 'euclidean', np.moveaxis(tidx, -1, 0).reshape(2, -1),
                                     np.moveaxis(jidx, -1, 0).reshape(2, -1))
        np.testing.assert_allclose(tq, jq, **TOL, err_msg=f'step {step} quantized')
        np.testing.assert_allclose(tloss, jloss, **TOL, err_msg=f'step {step} loss')
        np.testing.assert_allclose(tbreak, jbreak, **TOL, err_msg=f'step {step} loss breakdown')
        np.testing.assert_allclose(tgx, jgx, **TOL, err_msg=f'step {step} x.grad')
        _assert_grads_close(tm, jgrads)
        _assert_state_close(jm, tm, f'step {step}')


@pytest.fixture(autouse=True)
def selected_from(monkeypatch):
    """Records the codebook each selection ran against (after the bridge and
    the affine map), for the tie rule."""
    seen = {}
    for name in ('quantize_lookup', 'lookup_with_code_grad'):
        def record(x, embed, *args, _fn=getattr(tcodebook, name), **kw):
            seen['embed'] = embed.detach().clone()
            return _fn(x, embed, *args, **kw)
        monkeypatch.setattr(tcodebook, name, record)
    return seen


@pytest.mark.parametrize('case', sorted(CASES))
def test_learnable_family_matches_jax(case, injected_draws, selected_from):
    jm, tm = _pair(CASES[case])
    jm.train()
    tm.train()
    _run_pair(jm, tm, case, selected_from)


OPTIMIZERS = {
    'sgd': (optax.sgd(1e-2), lambda p: torch.optim.SGD(p, lr=1e-2), 0.0),
    'adam': (optax.adam(1e-2), lambda p: torch.optim.Adam(p, lr=1e-2), 1e-6),
}


@pytest.mark.parametrize('manual', (False, True), ids=('auto', 'manual'))
@pytest.mark.parametrize('opt', sorted(OPTIMIZERS))
def test_in_place_optimizer_matches_jax(opt, manual, injected_draws):
    """Two training forwards with the in-place optimizer: the codebook after
    each step, the outputs and the gradient reaching x; in manual mode the
    steps wait for update_in_place_optimizer, called after the second."""
    jopt, topt, tol = OPTIMIZERS[opt]
    kwargs = dict(LEARNABLE, manual_in_place_optimizer_update=manual)
    jm, tm = _pair(kwargs, jopt, topt)
    jm.train()
    tm.train()
    outer = torch.full_like(tm._codebook.embed, 3.0)
    tm._codebook.embed.grad = outer.clone()
    for step in range(2):
        rng = np.random.default_rng([11, step])
        x = rng.standard_normal(SHAPE, dtype=np.float32)
        g = rng.standard_normal(SHAPE, dtype=np.float32)
        jq, jidx, jloss, jbreak, jgx, _ = _jax_step(jm, x, g, None)
        tx = torch.from_numpy(x).requires_grad_()
        tq, tidx, tloss, tbreak = tm(tx, return_loss_breakdown=True)
        # the inner step leaves the outer gradient alone
        assert torch.equal(tm._codebook.embed.grad, outer)
        ((tq * torch.from_numpy(g)).sum() + tloss).backward()
        np.testing.assert_array_equal(tidx.numpy(), jidx)
        np.testing.assert_allclose(tq.detach().numpy(), jq, **TOL, err_msg=f'step {step} quantized')
        np.testing.assert_allclose(np.array([float(t.detach()) for t in tbreak]), jbreak, **TOL)
        np.testing.assert_allclose(tx.grad.numpy(), jgx, **TOL, err_msg=f'step {step} x.grad')
        np.testing.assert_allclose(tm._codebook.embed.detach().numpy(), np.asarray(jm._codebook.embed[...]),
                                   rtol=0, atol=tol, err_msg=f'step {step} codebook')
        tm._codebook.embed.grad = outer.clone()
    if manual:
        before = tm._codebook.embed.detach().clone()
        np.testing.assert_array_equal(before.numpy(), np.asarray(jm._codebook.embed[...]))
        jm.update_in_place_optimizer()
        tm.update_in_place_optimizer()
        assert not torch.equal(tm._codebook.embed.detach(), before)
        assert torch.equal(tm._codebook.embed.grad, outer)
        np.testing.assert_allclose(tm._codebook.embed.detach().numpy(), np.asarray(jm._codebook.embed[...]),
                                   rtol=0, atol=tol, err_msg='after update_in_place_optimizer')
        assert all(not p.any() for p in tm._pending_inner_grads)


def test_orthogonal_loss_fn_matches_jax():
    t = np.random.default_rng(0).standard_normal((3, 20, 8), dtype=np.float32)
    want = np.asarray(jutils.orthogonal_loss_fn(jnp.asarray(t)))
    got = orthogonal_loss_fn(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_directional_reparam_matches_jax():
    """DiVeQ with the same noise: value and the gradient to both sides."""
    rng = np.random.default_rng(1)
    src, tgt, g = (rng.standard_normal((5, 7, 8), dtype=np.float32) for _ in range(3))
    noise = rng.standard_normal((5, 7, 8), dtype=np.float32)
    orig = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=jnp.float32: jnp.asarray(noise)
    try:
        def f(s, t):
            return (jste.directional_reparam(jax.random.key(0), s, t, 0.01) * g).sum()
        jv = np.asarray(jste.directional_reparam(jax.random.key(0), jnp.asarray(src), jnp.asarray(tgt), 0.01))
        jgs, jgt = jax.grad(f, argnums=(0, 1))(jnp.asarray(src), jnp.asarray(tgt))
    finally:
        jax.random.normal = orig
    ts = torch.from_numpy(src).requires_grad_()
    tt = torch.from_numpy(tgt).requires_grad_()
    out = directional_reparam(ts, tt, 0.01, noise=torch.from_numpy(noise))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jv, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jgs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgt), rtol=1e-5, atol=1e-6)


def test_mini_encoder_matches_jax():
    """The FVQ bridge: forward and the gradients of every parameter and of
    the input."""
    jm = JMiniEncoder(dim=16, input_dim=8, depth=2, heads=4, rngs=nnx.Rngs(2))
    tm = TMiniEncoder(dim=16, input_dim=8, depth=2, heads=4, device='cpu')
    load_vqtpu_state(tm, jax_state(jm))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, 8), dtype=np.float32)
    g = rng.standard_normal((2, 12, 8), dtype=np.float32)

    def loss(m, x):
        return (m(x) * g).sum()
    (grads, gx) = nnx.jit(nnx.grad(loss, argnums=(0, 1)))(jm, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jm(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-5)
    # the parameters' gradients sum over every token and attention pair
    # (the memory tokens' reach 70 here): rtol 2e-4
    want = torch_layout_grads(tm, jax.tree.map(np.asarray, nnx.to_pure_dict(grads)))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=2e-4, atol=1e-5, err_msg=name)


def test_fvq_autoencoder_step0_matches_jax(injected_draws):
    """examples/autoencoder_fvq.py at small width: the loss, the output and
    every parameter's gradient of the first step (the bridge behind an
    in-place SGD), then the codebook after it."""
    jbridge = JMiniEncoder(dim=16, input_dim=8, depth=1, heads=4, rngs=nnx.Rngs(3))
    tbridge = TMiniEncoder(dim=16, input_dim=8, depth=1, heads=4, device='cpu')
    kw = dict(dim=8, codebook_size=CODES, learnable_codebook=True, ema_update=False, rotation_trick=False)
    jm = JAutoEncoder(JVQ(vq_bridge=jbridge, in_place_codebook_optimizer=optax.sgd(1e-3),
                          rngs=nnx.Rngs(3), **kw), dim=8, rngs=nnx.Rngs(3))
    tm = TAutoEncoder(TVQ(vq_bridge=tbridge, in_place_codebook_optimizer=lambda p: torch.optim.SGD(p, lr=1e-3),
                          device='cpu', **kw), dim=8, device='cpu')
    load_vqtpu_state(tm, jax_state(jm))
    jm.train()
    tm.train()
    imgs = np.random.default_rng(4).random((2, 28, 28, 1), dtype=np.float32)

    def loss_fn(m, x):
        out, idx, cmt = m(x)
        return jnp.abs(jnp.clip(out, -1, 1) - x).mean() + 10.0 * cmt, (out, idx)
    (jloss, (jout, jidx)), jgrads = nnx.jit(nnx.value_and_grad(loss_fn, has_aux=True))(jm, jnp.asarray(imgs))
    out, idx, cmt = tm(torch.from_numpy(imgs))
    tloss = (out.clamp(-1, 1) - torch.from_numpy(imgs)).abs().mean() + 10.0 * cmt
    tloss.backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    jgrads = jax.tree.map(np.asarray, nnx.to_pure_dict(jgrads))
    want = torch_layout_grads(tm, jgrads)
    # the codebook and the bridge: the JAX gradient runs through the inner
    # SGD step; the rest of the model is compared
    for name, p in tm.named_parameters():
        if name.startswith('quantizer._codebook.'):
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-4, atol=1e-5, err_msg=name)
    jparams = torch_layout_grads(tm.quantizer._codebook, jax.tree.map(
        np.asarray, nnx.to_pure_dict(nnx.state(jm.quantizer._codebook, nnx.Param))))
    for name, p in tm.quantizer._codebook.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[name], rtol=1e-6, atol=1e-7, err_msg=name)


REFUSED = {
    'cosine_learnable': dict(use_cosine_sim=True, learnable_codebook=True, ema_update=False),
    'gumbel_learnable': dict(straight_through=True, rotation_trick=False, learnable_codebook=True,
                             ema_update=False),
    'ema_learnable': dict(learnable_codebook=True),
    'diveq_without_expiry': dict(directional_reparam=True),
    'sync_update_v_ema': dict(sync_update_v=0.5),
    'sync_update_v_range': dict(LEARNABLE, sync_update_v=1.5),
    'affine_cosine': dict(affine_param=True, use_cosine_sim=True),
    'bridge_ema': dict(vq_bridge=torch.nn.Identity(), ema_update=True),
}


@pytest.mark.parametrize('case', sorted(REFUSED))
def test_refused_combinations_raise_like_jax(case):
    kwargs = REFUSED[case]
    jkw = dict(kwargs)
    if 'vq_bridge' in jkw:
        jkw['vq_bridge'] = lambda e: e
    with pytest.raises(AssertionError):
        JVQ(dim=DIM, codebook_size=CODES, rngs=nnx.Rngs(0), **jkw)
    with pytest.raises(ValueError):
        TVQ(dim=DIM, codebook_size=CODES, device='cpu', **kwargs)


@pytest.mark.parametrize('feature', ('sync_axis', 'sync_codebook', 'sync_affine_param', 'code_axis'))
def test_distributed_kwargs_not_ported(feature):
    """Every distributed kwarg is ported. The row-sharded codebook (code_axis)
    of a learnable, affine VectorQuantize trains outside a mesh as the
    unsharded one does, and inside a mesh binding its axis, its leaves not
    sharded, raises (it trains sharded in tests/test_torch_tp.py). The
    data-parallel kwargs build (they train under a mesh in
    tests/test_torch_parallel.py); a training forward of a synced affine
    codebook outside a mesh raises as JAX's unbound psum does, and
    sync_affine_param without an axis syncs nothing."""
    value = {'sync_axis': 'data', 'sync_codebook': True, 'sync_affine_param': True, 'code_axis': 'code'}[feature]
    if feature == 'code_axis':
        kwargs = dict(dim=DIM, codebook_size=CODES, affine_param=True, learnable_codebook=True, ema_update=False)
        x = torch.randn(2, 4, DIM)
        torch.manual_seed(0)
        sharded = TVQ(**kwargs, code_axis='code', device='cpu').train()
        torch.manual_seed(0)
        plain = TVQ(**kwargs, device='cpu').train()
        for got, want in zip(sharded(x), plain(x)):
            assert torch.equal(got, want)
        errors = torch_dist.code_axis_at_rest_raises_in_mesh('VectorQuantize', code_axis='code', **kwargs)
        assert all(f'{CODES} codebook rows inside a mesh' in e for e in errors), errors
        return
    kwargs = dict(affine_param=True, **{feature: value})
    vq = TVQ(dim=DIM, codebook_size=CODES, device='cpu', **kwargs).train()
    x = torch.randn(2, 4, DIM)
    if feature == 'sync_affine_param':
        assert vq.sync_axis is None
        q, _, _ = vq(x)
        assert q.shape == x.shape
    else:
        assert vq._codebook.sync_axis == 'data'
        with pytest.raises(NameError, match="unbound axis name: 'data'"):
            vq(x)


BRIDGE_PARTS = {
    'MiniEncoder': lambda **kw: TMiniEncoder(dim=8, heads=2, **kw),
    'EncoderBlock': lambda **kw: tmodels.EncoderBlock(8, heads=2, **kw),
    'MultiHeadAttention': lambda **kw: ttransformer.MultiHeadAttention(8, 2, **kw),
    'qinco_MLP': lambda **kw: tresidual.MLP(dim=8, depth=1, **kw),
}


@pytest.mark.parametrize('part', sorted(BRIDGE_PARTS))
def test_bridge_and_qinco_modules_resolve_their_device(part):
    """The bridge's and QINCo's modules run where every entry point runs:
    the CUDA card when no device is given (raising without one), the CPU
    when asked."""
    build = BRIDGE_PARTS[part]
    if torch.cuda.is_available():
        assert all(p.device.type == 'cuda' for p in build().parameters())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert all(p.device.type == 'cpu' for p in build(device='cpu').parameters())
