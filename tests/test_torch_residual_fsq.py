"""The port's ResidualFSQ and GroupedResidualFSQ (vqtpu_torch) against the JAX
package's (vqtpu.composite), on the CPU, with the JAX state carried over by
load_vqtpu_state and the quantize-dropout index given to both sides.

Tolerances, and why:
  - with the soft clamp computed by XLA's tanh on both sides (the fixture
    `jax_soft_clamp`), the eval forward on either route ('off', the loop;
    'on', the plain fused version on the CPU) gives the JAX module's
    quantized values, indices and codes bit for bit: the rest of the chain
    rounds the same operations in the same order;
  - with the port's own tanh, which differs from XLA's by an ulp on about
    half of the elements (tests/test_torch_residual_fsq_fused.py), the first
    layer's indices may differ only at a bin edge (float64 bracket argument
    within 1e-6), and deeper layers, which quantize ever finer residuals, are
    held by value: within two deepest quanta, as the JAX package holds its
    fused kernel to its loop (tests/test_residual_fsq_fused.py);
  - behind projections the matrix products sum in other orders: outputs
    within 1e-4 (as tests/test_residual_fsq_fused.py:125-141), the layers at
    scale > 1e-2 equal, gradients within 1e-5 of their largest entry;
  - get_output_from_indices sums the layers in another order than the
    forward: within 1e-6, as tests/test_residual.py:238-255.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu.composite.residual_fsq as jres
import vqtpu_torch
import vqtpu_torch.composite.residual_fsq as tres
import vqtpu_torch.kernels.residual_fsq_fused as tk
import vqtpu_torch.quantizers.fsq as tfsq
from vqtpu.quantizers import FSQ as JaxFSQ
from vqtpu_torch import load_vqtpu_state

from torch_parity import assert_grads_close, jax_state, one_torch_thread  # noqa: F401  (autouse)


def _pair(cls_j, cls_t, **kw):
    jm = cls_j(**kw, rngs=nnx.Rngs(0))
    tm = cls_t(**kw, device='cpu')
    load_vqtpu_state(tm, jax_state(jm))
    return jm, tm


def _deepest_quantum(levels, q):
    lv = np.asarray(levels, np.float64)
    return float((2.0 / (lv - 1) * lv ** -(q - 1)).max())


@pytest.fixture
def jax_soft_clamp(monkeypatch):
    """The port's soft clamp, on both routes, computed by XLA's tanh."""
    def clamp_like_jax(x, clamp):
        c = jnp.asarray(clamp, jnp.float32)
        return torch.from_numpy(np.array(jnp.tanh(jnp.asarray(x.detach().numpy()) / c) * c))
    monkeypatch.setattr(tres, 'soft_clamp_plain', clamp_like_jax)
    monkeypatch.setattr(tk, 'soft_clamp_plain', clamp_like_jax)


ROUTES = ('off', 'on')


def test_eval_matches_jax_bit_for_bit_on_the_same_clamp(jax_soft_clamp):
    levels, q = [8, 5, 5, 5], 8
    jm, tm = _pair(jres.ResidualFSQ, tres.ResidualFSQ, levels=levels, num_quantizers=q)
    jm.eval()
    tm.eval()
    x = np.random.default_rng(0).standard_normal((2, 300, 4), dtype=np.float32)
    jq, jidx, jcodes = jm(jnp.asarray(x), return_all_codes=True)
    jout = np.asarray(jm.get_output_from_indices(jidx))
    for route in ROUTES:
        tm.eval_fused = route
        with torch.no_grad():
            qv, idx, codes = tm(torch.from_numpy(x), return_all_codes=True)
        assert idx.dtype == torch.int32 and idx.shape == (2, 300, q)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx), err_msg=route)
        np.testing.assert_array_equal(qv.numpy(), np.asarray(jq), err_msg=route)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes), err_msg=route)
        out = tm.get_output_from_indices(idx)
        np.testing.assert_allclose(out.numpy(), qv.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-6)


@pytest.mark.parametrize('levels,q', (([8, 5, 5, 5], 8), ([7, 5, 5, 5, 5], 6), ([8, 6, 5], 3)))
def test_eval_matches_jax_with_its_own_tanh(levels, q):
    jm, tm = _pair(jres.ResidualFSQ, tres.ResidualFSQ, levels=levels, num_quantizers=q)
    jm.eval()
    tm.eval()
    x = np.random.default_rng(1).standard_normal((2, 300, len(levels)), dtype=np.float32)
    jq, jidx = jm(jnp.asarray(x))
    jidx = np.asarray(jidx)
    jdec = np.asarray(jm.get_output_from_indices(jnp.asarray(jidx)))
    # the first layer may flip only at a bin edge of the port's clamped input
    c = np.asarray(tm.soft_clamp_input_value)
    z = np.tanh(x.astype(np.float64) / c) * c
    arg = (np.asarray(levels) - 1) * (np.clip(z, -1, 1) + 1) / 2 + 0.5
    edge = (np.abs(arg - np.round(arg)) < 1e-6).any(-1)
    tol = 2 * _deepest_quantum(levels, q)
    for route in ROUTES:
        tm.eval_fused = route
        with torch.no_grad():
            qv, idx = tm(torch.from_numpy(x))
        assert not ((idx.numpy()[..., 0] != jidx[..., 0]) & ~edge).any(), route
        assert float(np.abs(qv.numpy() - np.asarray(jq)).max()) <= tol, route
        dec = tm.get_output_from_indices(idx)
        assert float(np.abs(dec.numpy() - jdec).max()) <= tol, route


def test_channel_first_with_projection_matches_jax():
    levels, q = [8, 5, 5, 5], 4
    jm, tm = _pair(jres.ResidualFSQ, tres.ResidualFSQ, levels=levels, num_quantizers=q, dim=16,
                   is_channel_first=True)
    jm.eval()
    tm.eval()
    x = np.random.default_rng(2).standard_normal((2, 16, 8, 8), dtype=np.float32)
    jq, jidx = jm(jnp.asarray(x))
    for route in ROUTES:
        tm.eval_fused = route
        with torch.no_grad():
            qv, idx = tm(torch.from_numpy(x))
        assert qv.shape == x.shape and idx.shape == (2, q, 8, 8) == jidx.shape
        np.testing.assert_allclose(qv.numpy(), np.asarray(jq), rtol=0, atol=1e-4, err_msg=route)
        for i in range(2):  # the layers at scale > 1e-2
            np.testing.assert_array_equal(idx.numpy()[:, i], np.asarray(jidx)[:, i], err_msg=route)


def test_round_trips_through_get_output_from_indices():
    """tests/test_residual.py:238-255 on the port: eval output and the decode
    of its indices within 1e-6."""
    torch.manual_seed(0)
    x = torch.randn(1, 128, 64)
    rfsq = tres.ResidualFSQ(dim=64, levels=[8, 5, 5, 3], num_quantizers=4, device='cpu').eval()
    grfsq = tres.GroupedResidualFSQ(dim=64, levels=[8, 5, 5, 3], num_quantizers=4, groups=2, device='cpu').eval()
    with torch.no_grad():
        for model, shape in ((rfsq, (1, 128, 4)), (grfsq, (2, 1, 128, 4))):
            quantized, indices = model(x)
            assert indices.shape == shape and indices.dtype == torch.int32
            assert float((quantized - model.get_output_from_indices(indices)).abs().max()) < 1e-6


def _train_step_both(jm, tm, x, j_call=None, t_call=None):
    jm.train()
    tm.train()

    def loss_fn(m, xs):
        out, idx = m(xs, **(j_call or {}))
        return (out ** 2).mean(), (out, idx)
    (_, (jq, jidx)), (jg, jgx) = nnx.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(jm, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    q, idx = tm(tx, **(t_call or {}))
    (q ** 2).mean().backward()
    return (np.asarray(jq), np.asarray(jidx), np.asarray(jgx), jax.tree.map(np.asarray, nnx.to_pure_dict(jg))), \
        (q.detach().numpy(), idx.numpy(), tx.grad.numpy())


def _assert_step(tm, j, t, kept):
    jq, jidx, jgx, jgrads = j
    q, idx, gx = t
    np.testing.assert_array_equal(idx[..., :kept], jidx[..., :kept])
    assert (idx[..., kept:] == -1).all() and (jidx[..., kept:] == -1).all()
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gx, jgx, rtol=0, atol=1e-5 * np.abs(jgx).max())
    assert_grads_close(tm, jgrads, rtol=0, atol=1e-5 * max(np.abs(v).max() for v in jax.tree.leaves(jgrads)))


def test_quantize_dropout_training_matches_jax():
    kw = dict(levels=[8, 5, 5, 5], num_quantizers=4, dim=16, quantize_dropout=True)
    jm, tm = _pair(jres.ResidualFSQ, tres.ResidualFSQ, **kw)
    x = np.random.default_rng(3).standard_normal((2, 40, 16), dtype=np.float32)
    j, t = _train_step_both(jm, tm, x, dict(rand_quantize_dropout_index=jnp.asarray(1)),
                            dict(rand_quantize_dropout_index=1))
    _assert_step(tm, j, t, kept=2)


def test_grouped_residual_fsq_matches_jax(monkeypatch, jax_soft_clamp):
    kw = dict(dim=16, groups=2, levels=[8, 5, 5, 5], num_quantizers=3, quantize_dropout=True)
    jm, tm = _pair(jres.GroupedResidualFSQ, tres.GroupedResidualFSQ, **kw)
    monkeypatch.setattr(jres.ResidualFSQ, '_draw_dropout_index', lambda self: jnp.asarray(0))
    x = np.random.default_rng(4).standard_normal((2, 20, 16), dtype=np.float32)
    jm.train()
    tm.train()
    jq, jidx = jm(jnp.asarray(x))
    q, idx = tm(torch.from_numpy(x), rand_quantize_dropout_index=0)
    assert idx.shape == (2, 2, 20, 3) and (idx[..., 1:] == -1).all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), rtol=0, atol=1e-4)

    jm.eval()
    tm.eval()
    for route in ('off', 'on'):
        for rvq in tm.rvqs:
            rvq.eval_fused = route
        jq, jidx, jcodes = jm(jnp.asarray(x), return_all_codes=True)
        with torch.no_grad():
            q, idx, codes = tm(torch.from_numpy(x), return_all_codes=True)
            out = tm.get_output_from_indices(idx)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=1e-4)
        np.testing.assert_allclose(out.numpy(), q.numpy(), rtol=0, atol=1e-6)
        for a, b in zip(codes, jcodes):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(tm.get_codes_from_indices(idx).numpy(),
                                      np.asarray(jm.get_codes_from_indices(jidx)))
    assert vqtpu_torch.GroupedResidualFSQ is tres.GroupedResidualFSQ
    assert vqtpu_torch.composite.ResidualFSQ is tres.ResidualFSQ


def test_grouped_dropout_draw_is_shared_from_the_first_group():
    g = tres.GroupedResidualFSQ(dim=8, groups=2, levels=[5, 5, 5, 5], num_quantizers=6, quantize_dropout=True,
                                device='cpu').train()
    some_dropped = False
    for seed in range(6):
        g.rvqs[0].generator.manual_seed(seed)
        _, idx = g(torch.randn(1, 10, 8))
        dropped = (idx == -1).all(dim=(1, 2))        # (groups, q)
        assert torch.equal(dropped[0], dropped[1])
        some_dropped |= bool(dropped.any())
    assert some_dropped


def test_codes_from_indices_with_dropped_layers():
    kw = dict(levels=[8, 5, 5, 5], num_quantizers=3, quantize_dropout=True)
    jm, tm = _pair(jres.ResidualFSQ, tres.ResidualFSQ, **kw)
    idx = np.random.default_rng(5).integers(0, 1000, (2, 5, 2)).astype(np.int32)
    idx[0, :2, 1] = -1
    want = np.asarray(jm.get_codes_from_indices(jnp.asarray(idx)))
    got = tm.get_codes_from_indices(torch.from_numpy(idx))
    assert got.shape == want.shape == (3, 2, 5, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tm.codebooks.numpy(), np.asarray(jm.codebooks))
    tm.quantize_dropout = False
    with pytest.raises(ValueError, match='quantize dropout'):
        tm.get_codes_from_indices(torch.from_numpy(idx))


def test_dropout_draw_stays_in_range():
    tm = tres.ResidualFSQ(levels=[5, 5], num_quantizers=6, quantize_dropout=True, quantize_dropout_cutoff_index=2,
                          quantize_dropout_multiple_of=2, device='cpu')
    draws = {int(tm.draw_dropout_index()) for _ in range(60)}
    assert draws <= {3, 5} and draws


@pytest.mark.parametrize('levels', ([8, 5, 5, 5], [8, 6, 5], [7, 5, 5, 5, 5], [4, 4], [8, 5, 5, 3], [2, 3, 9]))
def test_scales_bit_equal_to_jax(levels):
    jm = jres.ResidualFSQ(levels=levels, num_quantizers=12, rngs=nnx.Rngs(0))
    tm = tres.ResidualFSQ(levels=levels, num_quantizers=12, device='cpu')
    assert tm._scales().dtype == torch.float32
    np.testing.assert_array_equal(tm._scales().numpy(), np.asarray(jm._scales()))


@pytest.mark.parametrize('which', ('fsq', 'residual', 'grouped'))
def test_load_vqtpu_state_carries_every_tensor(which):
    """Projections, the orthogonal rotation buffers, and the nnx.List
    children (layers, rvqs) that hold no state unless rotated."""
    if which == 'fsq':
        kw = dict(levels=[5, 5, 5, 5], dim=12, orthogonal_rotation=True)
        jm, tm = _pair(JaxFSQ, tfsq.FSQ, **kw)
    elif which == 'residual':
        kw = dict(levels=[5, 5, 5, 5], num_quantizers=3, dim=12, orthogonal_rotation=True)
        jm, tm = _pair(jres.ResidualFSQ, tres.ResidualFSQ, **kw)
    else:
        kw = dict(dim=16, groups=2, levels=[8, 5, 5, 5], num_quantizers=2)
        jm, tm = _pair(jres.GroupedResidualFSQ, tres.GroupedResidualFSQ, **kw)
    state = jax_state(jm)

    def leaves(tree, prefix=''):
        for key, value in tree.items():
            if isinstance(value, dict):
                yield from leaves(value, f'{prefix}{key}.')
            elif 'rngs' not in prefix + str(key):
                yield prefix + str(key), value
    got = tm.state_dict()
    rules = {'kernel': ('weight', np.transpose), 'bias': ('bias', None), 'orthogonal_rot': ('orthogonal_rot', None)}
    names = set()
    for path, value in leaves(state):
        *mod, leaf = path.split('.')
        name, convert = rules[leaf]
        name = '.'.join([*mod, name])
        names.add(name)
        np.testing.assert_array_equal(got[name].numpy(), convert(value) if convert else value, err_msg=name)
    # the JAX state's rngs seed the port's streams (rng_state) instead
    assert names == {k for k in got if k.rpartition('.')[2] != 'rng_state'}, (names, set(got))
    if which != 'grouped':
        assert any('orthogonal_rot' in n for n in names)
