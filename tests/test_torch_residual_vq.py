"""The port's ResidualVQ and GroupedResidualVQ (vqtpu_torch) against the JAX
package's (vqtpu.composite), on the CPU, with the JAX state carried over by
load_vqtpu_state and every random draw given to both sides: the
quantize-dropout index (`rand_quantize_dropout_index`, or JAX's
`_draw_dropout_index` replaced for the grouped stack), kmeans' initial rows
and dead-code replacements (both frameworks' `sample_means` and
`masked_sample_vectors` replaced by the same rows) and the gumbel noise
(both `gumbel_noise` replaced by the same draw). The JAX side runs
`nnx.jit` of its value_and_grad.

On the kernels' path (eval, EMA training) the JAX package selects with
-||x - e||^2 and the port with x.e - ||e||^2/2, so each layer's indices are
held to the float64 tie rule (torch_parity.assert_indices_tie_equal) on that
layer's input; on the distance path (beam search, stochastic codes) both
sides compute -cdist in f32, and the indices are held equal exactly, the
beam search's ties included. Values, losses and the gradient reaching x to
rtol 1e-5, atol 1e-5 (f32 rounding through the layers); after the training
steps the codebooks' EMA state as tests/test_torch_vq_train.py holds it.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu.codebook.codebook as jcodebook
import vqtpu.composite as jcomposite
import vqtpu.core.sampling as jsampling
import vqtpu_torch
import vqtpu_torch.codebook.codebook as tcodebook
import vqtpu_torch.core.sampling as tsampling
from vqtpu_torch import load_vqtpu_state

from torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    assert_indices_tie_equal, jax_state, one_torch_thread, torch_layout_grads,
)

jkmeans = importlib.import_module('vqtpu.codebook.kmeans')
tkmeans = importlib.import_module('vqtpu_torch.codebook.kmeans')

SHAPE = (2, 24, 16)
BASE = dict(dim=16, num_quantizers=4, codebook_size=32)
TOL = dict(rtol=1e-5, atol=1e-5)

# name -> (constructor kwargs, input shape, dropout index in training)
CASES = {
    'plain': (dict(), SHAPE, None),
    'shared': (dict(shared_codebook=True), SHAPE, None),
    'sizes': (dict(dim=16, codebook_size=(5, 16, 32), num_quantizers=None), SHAPE, None),
    'dropout': (dict(quantize_dropout=True), SHAPE, 1),
    'grad_frac': (dict(quant_grad_frac=0.5), SHAPE, None),
    'projection': (dict(codebook_dim=8), SHAPE, None),
    'cosine': (dict(use_cosine_sim=True), SHAPE, None),
    'image_fmap': (dict(accept_image_fmap=True), (2, 16, 4, 5), None),
    # kmeans over this batch makes codes of single tokens, whose residual is
    # then 0 to within rounding: the rotation trick's gradient there is
    # 1 / |residual|, so this case takes the straight-through gradient
    'shared_kmeans_stochastic': (
        dict(shared_codebook=True, kmeans_init=True, kmeans_iters=3, stochastic_sample_codes=True,
             sample_codebook_temp=0.1, threshold_ema_dead_code=2, rotation_trick=False), SHAPE, None),
}


@pytest.fixture
def injected_draws(monkeypatch):
    """kmeans' initial rows, dead-code replacements and the gumbel noise:
    the same on both sides. Each draw depends on its shape only, so that the
    jitted JAX step, which draws once while it traces, draws what the port
    draws at every call."""
    def rows(n, num, seed):
        return np.random.default_rng([seed, n, num]).integers(0, n, num)

    def noise(shape):
        return np.random.default_rng([500, *shape]).gumbel(size=shape).astype(np.float32)

    monkeypatch.setattr(jkmeans, 'sample_means', lambda key, s, mask, num, *a, **k:
                        jnp.take(s, rows(s.shape[1], num, 100), axis=1))
    monkeypatch.setattr(tkmeans, 'sample_means', lambda gen, s, mask, num:
                        s[:, torch.from_numpy(rows(s.shape[1], num, 100))])
    monkeypatch.setattr(jcodebook, 'masked_sample_vectors', lambda key, s, mask, num:
                        jnp.take(s, rows(s.shape[0], num, 200), axis=0))
    monkeypatch.setattr(tcodebook, 'masked_sample_vectors', lambda gen, s, mask, num:
                        s[torch.from_numpy(rows(s.shape[0], num, 200))])
    monkeypatch.setattr(jsampling, 'gumbel_noise', lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(noise(shape)))
    monkeypatch.setattr(tsampling, 'gumbel_noise', lambda gen, shape, device=None:
                        torch.from_numpy(noise(shape)))


def _pair(cls_j, cls_t, **kw):
    jm = cls_j(**kw, rngs=nnx.Rngs(0))
    tm = cls_t(**kw, device='cpu')
    load_vqtpu_state(tm, jax_state(jm))
    return jm, tm


def _jax_loss(m, xs, g, call_kw):
    q, idx, losses = m(xs, **call_kw)
    return (q * g).sum() + losses.sum(), (q, idx, losses)


# jitted: eager JAX compiles each op on its own, several times slower here
_jax_value_and_grad = nnx.jit(nnx.value_and_grad(_jax_loss, argnums=(0, 1), has_aux=True))


def _jax_step(jm, x, g, call_kw):
    (_, (q, idx, losses)), (grads, gx) = _jax_value_and_grad(jm, jnp.asarray(x), jnp.asarray(g), call_kw)
    return (np.asarray(q), np.asarray(idx), np.asarray(losses), np.asarray(gx),
            jax.tree.map(np.asarray, nnx.to_pure_dict(grads)))


def _torch_step(tm, x, g, call_kw):
    tx = torch.from_numpy(x).requires_grad_()
    q, idx, losses = tm(tx, **call_kw)
    total = (q * torch.from_numpy(g)).sum() + losses.sum()
    if total.requires_grad:
        total.backward()
    grad = tx.grad if tx.grad is not None else torch.zeros_like(tx)
    return q.detach().numpy(), idx.numpy(), losses.detach().numpy(), grad.numpy()


def _layer_inputs(tm, x, idx):
    """Each layer's input (its residual) in codebook space, from the port's
    indices, as (b, N, d) tokens."""
    with torch.no_grad():
        xt = torch.from_numpy(x)
        if tm.project_in is not None:
            xt = tm.project_in(xt)
        if tm.accept_image_fmap:
            xt = xt.movedim(1, -1)
        residual = xt.reshape(xt.shape[0], -1, xt.shape[-1])
        codes = tm.get_codes_from_indices(torch.from_numpy(idx))
        codes = codes.reshape(codes.shape[0], *residual.shape)
        inputs = []
        for q in range(tm.num_quantizers):
            inputs.append(residual.clone())
            residual = residual - codes[q]
    return inputs


def _assert_layers_tie_equal(tm, x, embeds, tidx, jidx):
    metric = 'cosine' if tm.layers[0].use_cosine_sim else 'euclidean'
    inputs = _layer_inputs(tm, x, tidx)
    for q, (xq, embed) in enumerate(zip(inputs, embeds)):
        if metric == 'cosine':
            xq = torch.nn.functional.normalize(xq, dim=-1, eps=1e-6)
        assert_indices_tie_equal(xq.reshape(1, -1, xq.shape[-1]), embed, metric,
                                 tidx[..., q].reshape(1, -1), jidx[..., q].reshape(1, -1))


def _assert_codebooks_close(jm, tm):
    for q, (jl, tl) in enumerate(zip(jm.layers, tm.layers)):
        jcb, tcb = jl._codebook, tl._codebook
        np.testing.assert_allclose(tcb.cluster_size.numpy(), np.asarray(jcb.cluster_size[...]),
                                   rtol=1e-6, atol=1e-6, err_msg=f'layer {q} cluster_size')
        for name in ('embed_avg', 'embed'):
            np.testing.assert_allclose(getattr(tcb, name).numpy(), np.asarray(getattr(jcb, name)[...]),
                                       rtol=1e-6, atol=1e-5, err_msg=f'layer {q} {name}')
        assert bool(tcb.initted) == bool(jcb.initted[...])


def _assert_grads_close(tm, jgrads):
    want = torch_layout_grads(tm, jgrads)
    params = dict(tm.named_parameters())
    assert sorted(want) == sorted(params)
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name], **TOL, err_msg=name)


@pytest.mark.parametrize('mode', ('train', 'eval'))
@pytest.mark.parametrize('case', sorted(CASES))
def test_residual_vq_matches_jax(case, mode, injected_draws):
    kwargs, shape, dropout_index = CASES[case]
    jm, tm = _pair(jcomposite.ResidualVQ, vqtpu_torch.ResidualVQ, **{**BASE, **kwargs})
    getattr(jm, mode)()
    getattr(tm, mode)()
    distance_path = kwargs.get('stochastic_sample_codes') and mode == 'train'
    # the JAX stack takes the index as an array (it compares it traced)
    jkw = {} if dropout_index is None else {'rand_quantize_dropout_index': jnp.int32(dropout_index)}
    tkw = {} if dropout_index is None else {'rand_quantize_dropout_index': dropout_index}
    for step in range(3 if mode == 'train' else 1):
        rng = np.random.default_rng(step)
        x = rng.standard_normal(shape, dtype=np.float32)
        g = rng.standard_normal(shape, dtype=np.float32)
        embeds = [layer._codebook.embed.clone() for layer in tm.layers]
        jq, jidx, jlosses, jgx, jgrads = _jax_step(jm, x, g, jkw)
        tq, tidx, tlosses, tgx = _torch_step(tm, x, g, tkw)
        if kwargs.get('kmeans_init') and step == 0:
            embeds = [layer._codebook.embed_before_update for layer in tm.layers]

        assert tidx.dtype == np.int32 and tidx.shape == jidx.shape
        if distance_path:
            np.testing.assert_array_equal(tidx, jidx, err_msg=f'step {step}')
        else:
            _assert_layers_tie_equal(tm, x, embeds, tidx, jidx)
        if dropout_index is not None and mode == 'train':
            assert (tidx[..., dropout_index + 1:] == -1).all() and (tidx[..., :dropout_index + 1] >= 0).all()
        np.testing.assert_allclose(tq, jq, **TOL, err_msg=f'step {step} quantized')
        np.testing.assert_allclose(tlosses, jlosses, **TOL, err_msg=f'step {step} losses')
        np.testing.assert_allclose(tgx, jgx, **TOL, err_msg=f'step {step} x.grad')
        if mode == 'train' and step == 0:
            _assert_grads_close(tm, jgrads)
    if mode == 'train':
        _assert_codebooks_close(jm, tm)
        if kwargs.get('shared_codebook'):
            assert all(layer._codebook is tm.layers[0]._codebook for layer in tm.layers)
    else:
        # decode round trip, and the codes
        with torch.no_grad():
            out = tm.get_output_from_indices(torch.from_numpy(tidx))
            q, idx, _, codes = tm(torch.from_numpy(x), return_all_codes=True)
        np.testing.assert_allclose(out.numpy(), tq.reshape(out.shape) if not tm.accept_image_fmap
                                   else tq.transpose(0, 2, 3, 1), rtol=0, atol=1e-6)
        jcodes = np.asarray(jm.get_codes_from_indices(jnp.asarray(jidx)))
        assert codes.shape == jcodes.shape
        if np.array_equal(tidx, jidx):
            np.testing.assert_array_equal(codes.numpy(), jcodes)


@pytest.fixture(autouse=True)
def record_kmeans_embed(monkeypatch):
    """Keep the codebook kmeans produced, which the first step selected
    with, for the tie rule."""
    init = tcodebook.Codebook.init_embed_

    def init_and_record(self, flatten, mask=None):
        init(self, flatten, mask)
        self.embed_before_update = self.embed.clone()
    monkeypatch.setattr(tcodebook.Codebook, 'init_embed_', init_and_record)


# -- beam search -------------------------------------------------------------------

BEAM_CASES = {
    'plain': (dict(), None),
    'weights': (dict(beam_score_quantizer_weights=[1.0, 0.5, 2.0, 1.0]), None),
    # layers after 1 dropped: every candidate of a dropped layer scores the same
    'dropped_layers': (dict(quantize_dropout=True), 1),
    # duplicate codebook rows: candidates of equal distance
    'duplicate_rows': (dict(), 'duplicate'),
    'mask': (dict(), 'mask'),
}


@pytest.mark.parametrize('mode', ('train', 'eval'))
@pytest.mark.parametrize('beam', (2, 4))
@pytest.mark.parametrize('case', sorted(BEAM_CASES))
def test_beam_search_matches_jax(case, beam, mode):
    kwargs, extra = BEAM_CASES[case]
    kw = {**BASE, **kwargs, 'beam_size': beam}
    jm, tm = _pair(jcomposite.ResidualVQ, vqtpu_torch.ResidualVQ, **kw)
    shape = SHAPE
    if extra == 'duplicate':
        state = jax_state(jm)
        for q in range(BASE['num_quantizers']):
            cb = state['layers'][q]['_codebook']
            for name in ('embed', 'embed_avg'):
                cb[name] = cb[name].copy()
                cb[name][:, 1::2] = cb[name][:, 0::2]
            jm.layers[q]._codebook.embed[...] = jnp.asarray(cb['embed'])
            jm.layers[q]._codebook.embed_avg[...] = jnp.asarray(cb['embed_avg'])
        load_vqtpu_state(tm, state)
    if extra == 'mask':
        # the JAX package's beam search takes a mask only for one batch element
        shape = (1, *SHAPE[1:])
    getattr(jm, mode)()
    getattr(tm, mode)()
    call_kw = {}
    if extra == 'mask':
        m = np.arange(shape[1]) < shape[1] - 5
        call_kw = {'mask': m[None]}
    for step in range(1):
        rng = np.random.default_rng(step)
        x = rng.standard_normal(shape, dtype=np.float32)
        g = rng.standard_normal(shape, dtype=np.float32)
        jkw = {k: jnp.asarray(v) for k, v in call_kw.items()}
        tkw = {k: torch.from_numpy(v) for k, v in call_kw.items()}
        if extra == 1 and mode == 'train':
            jkw['rand_quantize_dropout_index'] = jnp.int32(1)
            tkw['rand_quantize_dropout_index'] = 1
        jq, jidx, jlosses, jgx, _ = _jax_step(jm, x, g, jkw)
        tq, tidx, tlosses, tgx = _torch_step(tm, x, g, tkw)
        np.testing.assert_array_equal(tidx, jidx, err_msg=f'step {step} beam indices')
        np.testing.assert_allclose(tq, jq, **TOL, err_msg=f'step {step} quantized')
        np.testing.assert_allclose(tlosses, jlosses, **TOL, err_msg=f'step {step} losses')
        np.testing.assert_allclose(tgx, jgx, **TOL, err_msg=f'step {step} x.grad')
        if extra == 1 and mode == 'train':
            assert (tidx[..., 2:] == -1).all()
        if extra == 'duplicate':
            # of two equal rows the lower index wins
            assert (tidx % 2 == 0).all()
    if mode == 'train':
        _assert_codebooks_close(jm, tm)


@pytest.mark.parametrize('shared', (False, True), ids=('own', 'shared'))
def test_beam_size_one_is_the_greedy_forward(shared):
    """beam_size=1 (per module or per call) runs the greedy stack, as JAX's
    tests/test_residual.py::test_beam_size_one_matches_argmax holds it; a
    beam search never scores worse than the greedy stack."""
    torch.manual_seed(0)
    greedy = vqtpu_torch.ResidualVQ(**BASE, shared_codebook=shared, device='cpu').eval()
    beam = vqtpu_torch.ResidualVQ(**BASE, shared_codebook=shared, beam_size=1, device='cpu').eval()
    beam.load_state_dict(greedy.state_dict())
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(SHAPE, dtype=np.float32))
    with torch.no_grad():
        q1, i1, _ = greedy(x)
        q2, i2, _ = beam(x)
        q3, i3, _ = greedy(x, beam_size=1)
        q8, _, _ = greedy(x, beam_size=8)
    assert torch.equal(i1, i2) and torch.equal(q1, q2) and torch.equal(i1, i3) and torch.equal(q1, q3)
    assert float(((q8 - x) ** 2).mean()) <= float(((q1 - x) ** 2).mean()) + 1e-6


# -- the rest of the surface --------------------------------------------------------

@pytest.mark.parametrize('mode', ('train', 'eval'))
def test_residual_vq_cross_entropy_against_indices_matches_jax(mode):
    jm, tm = _pair(jcomposite.ResidualVQ, vqtpu_torch.ResidualVQ, **BASE)
    getattr(jm, mode)()
    getattr(tm, mode)()
    rng = np.random.default_rng(7)
    x = rng.standard_normal(SHAPE, dtype=np.float32)
    codes = rng.integers(0, BASE['codebook_size'], (*SHAPE[:-1], BASE['num_quantizers'])).astype(np.int32)
    codes[0, :3, 2] = -1
    jq, jce = jm(jnp.asarray(x), indices=jnp.asarray(codes))
    tq, tce = tm(torch.from_numpy(x), indices=torch.from_numpy(codes))
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(float(tce), float(jce), **TOL)
    tq2, tce2 = tm(torch.from_numpy(x), indices=list(torch.from_numpy(codes).unbind(-1)))
    assert torch.equal(tq2, tq) or mode == 'train'
    if mode == 'eval':
        assert torch.equal(tce2, tce)


def test_grouped_residual_vq_shares_the_dropout_index(monkeypatch, injected_draws):
    kw = dict(dim=32, groups=2, num_quantizers=4, codebook_size=32, quantize_dropout=True)
    jm, tm = _pair(jcomposite.GroupedResidualVQ, vqtpu_torch.GroupedResidualVQ, **kw)
    monkeypatch.setattr(jcomposite.ResidualVQ, '_draw_dropout_index', lambda self: jnp.int32(2))
    shape = (2, 24, 32)
    for mode in ('train', 'eval'):
        getattr(jm, mode)()
        getattr(tm, mode)()
        rng = np.random.default_rng(8)
        x = rng.standard_normal(shape, dtype=np.float32)
        g = rng.standard_normal(shape, dtype=np.float32)
        call_kw = {'rand_quantize_dropout_index': 2} if mode == 'train' else {}
        jq, jidx, jlosses, jgx, _ = _jax_step(jm, x, g, {})
        tq, tidx, tlosses, tgx = _torch_step(tm, x, g, call_kw)
        assert tidx.shape == jidx.shape == (2, 2, 24, 4) and tlosses.shape == jlosses.shape == (2, 4)
        for grp in range(2):
            chunk = x[..., grp * 16:(grp + 1) * 16]
            embeds = [layer._codebook.embed for layer in tm.rvqs[grp].layers]
            if mode == 'eval':
                _assert_layers_tie_equal(tm.rvqs[grp], chunk, embeds, tidx[grp], jidx[grp])
        if mode == 'train':
            assert (tidx[..., 3:] == -1).all() and (jidx[..., 3:] == -1).all()
        np.testing.assert_allclose(tq, jq, **TOL)
        np.testing.assert_allclose(tlosses, jlosses, **TOL)
        np.testing.assert_allclose(tgx, jgx, **TOL)
    with torch.no_grad():
        out = tm.get_output_from_indices(torch.from_numpy(tidx))
    np.testing.assert_allclose(out.numpy(), tq, rtol=0, atol=1e-6)
    assert tuple(tm.codebooks.shape) == tuple(np.asarray(jm.codebooks).shape)


@pytest.mark.parametrize('multiple_of', (1, 2, 3))
def test_dropout_draw_rounds_like_jax(multiple_of, monkeypatch):
    """Each index the draw can give is rounded up to the multiple as the
    JAX package rounds it."""
    kw = dict(dim=8, num_quantizers=7, codebook_size=8, quantize_dropout=True,
              quantize_dropout_cutoff_index=1, quantize_dropout_multiple_of=multiple_of)
    jm, tm = _pair(jcomposite.ResidualVQ, vqtpu_torch.ResidualVQ, **kw)
    draws = []
    for raw in range(1, 7):
        monkeypatch.setattr(jax.random, 'randint', lambda key, shape, low, high, raw=raw: jnp.int32(raw))
        # the port draws cutoff + a value uniform below num_quantizers - cutoff
        monkeypatch.setattr(tsampling, 'randint', lambda gen, high, num, device=None, raw=raw:
                            torch.tensor([raw - 1]))
        draws.append((int(tm.draw_dropout_index()), int(jm._draw_dropout_index())))
    monkeypatch.undo()
    assert all(t == j for t, j in draws), draws
    assert all(1 <= tm.draw_dropout_index() < 7 for _ in range(50))


def test_codes_from_indices_with_dropped_and_missing_layers():
    jm, tm = _pair(jcomposite.ResidualVQ, vqtpu_torch.ResidualVQ, **BASE, quantize_dropout=True)
    idx = np.random.default_rng(6).integers(0, 32, (2, 5, 4)).astype(np.int32)
    idx[..., 2:] = -1
    for ind in (idx, idx[..., :2]):
        tcodes = tm.get_codes_from_indices(torch.from_numpy(ind))
        jcodes = np.asarray(jm.get_codes_from_indices(jnp.asarray(ind)))
        np.testing.assert_array_equal(tcodes.numpy(), jcodes)
        assert not tcodes[2:].any()
    plain = vqtpu_torch.ResidualVQ(**BASE, device='cpu')
    with pytest.raises(ValueError, match='quantize dropout'):
        plain.get_codes_from_indices(torch.from_numpy(idx[..., :2]))


def test_non_uniform_codebooks_are_a_tuple():
    _, tm = _pair(jcomposite.ResidualVQ, vqtpu_torch.ResidualVQ, dim=8, codebook_size=(5, 16, 32))
    assert isinstance(tm.codebooks, tuple) and [c.shape[0] for c in tm.codebooks] == [5, 16, 32]
    with pytest.raises(ValueError, match='shared codebook'):
        vqtpu_torch.ResidualVQ(dim=8, codebook_size=(5, 16), shared_codebook=True, device='cpu')


@pytest.mark.parametrize('kwargs,feature', (
    (dict(implicit_neural_codebook=True), 'implicit_neural_codebook'),
    (dict(diveq=True), 'diveq'),
))
def test_learnable_residual_features_raise(kwargs, feature):
    """QINCo and DiVeQ are ported (held against the JAX package in
    tests/test_torch_residual_vq_qinco.py): they build and train; heads
    still raise."""
    tm = vqtpu_torch.ResidualVQ(**BASE, device='cpu', **kwargs).train()
    x = torch.randn(2, 5, BASE['dim'], requires_grad=True)
    q, idx, losses = tm(x)
    (q.sum() + losses.sum()).backward()
    assert q.shape == x.shape and idx.shape == (2, 5, BASE['num_quantizers'])
    assert all(layer._codebook.embed.grad is not None for layer in tm.layers), feature
    with pytest.raises(ValueError, match='multi-headed'):
        vqtpu_torch.ResidualVQ(**BASE, heads=2, device='cpu')


def test_load_vqtpu_state_shared_codebook():
    """flax stores a codebook that every layer shares once, under layer 0;
    the state loads, every layer sees the one codebook, and a key that is
    truly missing still raises."""
    jm = jcomposite.ResidualVQ(dim=8, num_quantizers=3, codebook_size=16, shared_codebook=True,
                               rngs=nnx.Rngs(0))
    state = jax_state(jm)
    assert set(state['layers']) == {0}
    tm = vqtpu_torch.ResidualVQ(dim=8, num_quantizers=3, codebook_size=16, shared_codebook=True, device='cpu')
    load_vqtpu_state(tm, state)
    want = np.asarray(state['layers'][0]['_codebook']['embed'])
    for layer in tm.layers:
        assert layer._codebook is tm.layers[0]._codebook
        np.testing.assert_array_equal(layer._codebook.embed.numpy(), want)

    unshared = vqtpu_torch.ResidualVQ(dim=8, num_quantizers=3, codebook_size=16, device='cpu')
    with pytest.raises(KeyError, match='layers.1'):
        load_vqtpu_state(unshared, state)
    cut = {'layers': {0: {'_codebook': {k: v for k, v in state['layers'][0]['_codebook'].items()
                                        if k != 'embed_avg'}}}}
    with pytest.raises(KeyError, match='embed_avg'):
        load_vqtpu_state(tm, cut)
