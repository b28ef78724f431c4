"""The port's LFQ (vqtpu_torch) against the JAX package's (vqtpu), on the
CPU, with the JAX module's state carried over by load_vqtpu_state.

Each entropy route is driven on both sides with the same kwargs: 'dense'
(the (tokens, K) softmax), 'streamed' (the chunked statistics,
entropy_fused='off') and 'fused' (entropy_fused='on': the JAX Pallas sweeps
in interpret mode against the port's plain sweeps). Tolerances are those of
tests/test_lfq.py: indices equal exactly; quantized outputs within 1e-6; at
inv_temperature 100 the aux loss and its breakdown within 1e-4 relative
(2e-5 absolute for the per-sample entropy, about 1e-4 there and made of
saturated probabilities) and the input gradient within 5e-4 absolute (the
softmax saturates, and the gradient is rounding noise there); at inv_temperature 1 the loss within
1e-5 relative and every gradient (input and parameters) within 2e-5 of its
largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu.quantizers.lfq as jlfq
import vqtpu_torch
import vqtpu_torch.quantizers.lfq as tlfq
from vqtpu_torch import load_vqtpu_state

from torch_parity import jax_state, one_torch_thread, torch_layout_grads  # noqa: F401  (autouse)

ROUTES = ('dense', 'streamed', 'fused')


def _route_kwargs(route, codebook_size):
    if route == 'streamed':
        return dict(entropy_chunk_size=codebook_size // 4, entropy_fused='off')
    return dict(entropy_fused='on') if route == 'fused' else {}

CONFIGS = {
    # plain sign quantization, commitment loss, a per-token mask
    'base_commit_mask_bn': dict(kw=dict(dim=8, codebook_size=2 ** 8, commitment_loss_weight=0.25),
                                shape=(2, 12, 8), mask='bn'),
    # spherical (BSQ) codes behind projections, a per-batch-entry mask
    'spherical_proj_mask_b': dict(kw=dict(dim=12, codebook_size=2 ** 8, spherical=True),
                                  shape=(3, 10, 12), mask='b'),
    # two codebooks behind a cosine-sim projection, scale 0.5
    'multi_cosine_proj': dict(kw=dict(dim=16, codebook_size=2 ** 6, num_codebooks=2,
                                      cosine_sim_project_in=True, codebook_scale=0.5),
                              shape=(2, 9, 16), mask=None),
    # orthogonal rotation, soft clamp, the softplus loss, a tanh straight-through
    'rotation_clamp_softplus_tanh': dict(kw=dict(dim=10, codebook_size=2 ** 10, orthogonal_rotation=True,
                                                 soft_clamp_input_value=1.5,
                                                 experimental_softplus_entropy_loss=True,
                                                 straight_through_activation='tanh'),
                                         shape=(2, 7, 10), mask=None),
}


def _pair(route, kw, seed=0):
    kw = dict(kw)
    act = kw.pop('straight_through_activation', None)
    kw.update(_route_kwargs(route, kw['codebook_size']))
    jm = jlfq.LFQ(**kw, straight_through_activation=jnp.tanh if act else None, rngs=nnx.Rngs(seed))
    tm = tlfq.LFQ(**kw, straight_through_activation=torch.tanh if act else None, device='cpu')
    load_vqtpu_state(tm, jax_state(jm))
    return jm, tm


def _mask(kind, shape, rng):
    if kind is None:
        return None
    if kind == 'b':
        m = np.array([True] + [False] * (shape[0] - 2) + [True])
    else:
        m = rng.random(shape[:2]) > 0.3
    return m


def _train_both(jm, tm, x, mask, inv_temp):
    """One training forward + backward of aux + mean(q^2) on each side."""
    jm.train()
    tm.train()
    jmask = None if mask is None else jnp.asarray(mask)

    def loss_fn(m, xs):
        (q, idx, aux), bd = m(xs, inv_temperature=inv_temp, return_loss_breakdown=True, mask=jmask)
        return aux + (q ** 2).mean(), (q, idx, aux, bd)
    step = nnx.jit(nnx.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))
    (jl, (jq, jidx, jaux, jbd)), (jg, jgx) = step(jm, jnp.asarray(x))

    tx = torch.from_numpy(x).requires_grad_()
    tmask = None if mask is None else torch.from_numpy(mask)
    (q, idx, aux), bd = tm(tx, inv_temperature=inv_temp, return_loss_breakdown=True, mask=tmask)
    loss = aux + q.square().mean()
    loss.backward()
    jax_side = dict(loss=float(jl), q=np.asarray(jq), idx=np.asarray(jidx), aux=float(jaux),
                    bd=[float(t) for t in jbd], gx=np.asarray(jgx),
                    grads=jax.tree.map(np.asarray, nnx.to_pure_dict(jg)))
    torch_side = dict(loss=float(loss.detach()), q=q.detach().numpy(), idx=idx.numpy(), aux=float(aux.detach()),
                      bd=[float(t.detach()) for t in bd], gx=tx.grad.numpy())
    return jax_side, torch_side


# every route on the base config; every config on the fused route, the one
# the kernels run; the streamed route also with several codebooks
TRAIN_CASES = [('base_commit_mask_bn', route) for route in ROUTES] + [
    (config, 'fused') for config in CONFIGS if config != 'base_commit_mask_bn'
] + [('multi_cosine_proj', 'streamed')]


@pytest.mark.parametrize('config,route', TRAIN_CASES)
def test_lfq_training_step_matches_jax(config, route):
    cfg = CONFIGS[config]
    rng = np.random.default_rng(len(config))
    x = rng.standard_normal(cfg['shape'], dtype=np.float32)
    mask = _mask(cfg['mask'], cfg['shape'], rng)
    jm, tm = _pair(route, cfg['kw'])

    # the default temperature: values
    j, t = _train_both(jm, tm, x, mask, 100.0)
    assert t['idx'].dtype == np.int32
    np.testing.assert_array_equal(t['idx'], j['idx'])
    np.testing.assert_allclose(t['q'], j['q'], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t['aux'], j['aux'], rtol=1e-4)
    np.testing.assert_allclose(t['bd'], j['bd'], rtol=1e-4, atol=2e-5)
    assert float(np.abs(t['gx'] - j['gx']).max()) < 5e-4

    # inv_temperature 1: loss and every gradient, tight
    for p in tm.parameters():
        p.grad = None
    j, t = _train_both(jm, tm, x, mask, 1.0)
    np.testing.assert_allclose(t['loss'], j['loss'], rtol=1e-5)
    np.testing.assert_allclose(t['gx'], j['gx'], rtol=0, atol=2e-5 * np.abs(j['gx']).max())
    want = torch_layout_grads(tm, j['grads'])
    params = dict(tm.named_parameters())
    assert sorted(want) == sorted(params)
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0, atol=2e-5 * np.abs(want[name]).max(),
                                   err_msg=name)


@pytest.mark.parametrize('config', list(CONFIGS))
def test_lfq_eval_and_codes_match_jax(config):
    cfg = CONFIGS[config]
    x = np.random.default_rng(1).standard_normal(cfg['shape'], dtype=np.float32)
    jm, tm = _pair('dense', cfg['kw'])
    jm.eval()
    tm.eval()
    jq, jidx, jaux = jm(jnp.asarray(x))
    with torch.no_grad():
        q, idx, aux = tm(torch.from_numpy(x))
        codes = tm.indices_to_codes(idx)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=1e-6)
    assert float(aux) == float(jaux) == 0.0
    assert torch.equal(codes, q)
    np.testing.assert_allclose(codes.numpy(), np.asarray(jm.indices_to_codes(jidx)), rtol=0, atol=1e-6)
    with torch.no_grad():
        raw = tm.indices_to_codes(idx, project_out=False)
    np.testing.assert_allclose(raw.numpy(), np.asarray(jm.indices_to_codes(jidx, project_out=False)),
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(tm.codebook.numpy(), np.asarray(jm.codebook))


def test_lfq_image_layout_and_round_trip():
    """A (b, c, h, w) feature map goes channel-first, as in the JAX package."""
    jm, tm = _pair('dense', dict(dim=10, codebook_size=2 ** 10, spherical=True))
    x = np.random.default_rng(2).standard_normal((1, 10, 4, 4), dtype=np.float32)
    jq, jidx, jaux = jm(jnp.asarray(x), inv_temperature=100.0)
    with torch.no_grad():
        q, idx, aux = tm(torch.from_numpy(x), inv_temperature=100.0)
    assert q.shape == x.shape and idx.shape == (1, 4, 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-4)
    tm.eval()
    with torch.no_grad():
        q, idx, _ = tm(torch.from_numpy(x))
        assert torch.equal(tm.indices_to_codes(idx), q)


@pytest.mark.parametrize('route', ('dense', 'fused'))
def test_frac_per_sample_entropy_with_the_same_draw(route, monkeypatch):
    """The token subsample is drawn from Gumbel noise; both sides get the same
    noise, so they pick the same tokens."""
    kw = dict(dim=8, codebook_size=2 ** 8, frac_per_sample_entropy=0.5, commitment_loss_weight=0.1)
    jm, tm = _pair(route, kw)
    x = np.random.default_rng(3).standard_normal((2, 16, 8), dtype=np.float32)
    mask = np.ones((2, 16), bool)
    mask[0, 10:] = False
    noise = np.random.default_rng(4).gumbel(size=32).astype(np.float32)
    monkeypatch.setattr(jax.random, 'gumbel', lambda key, shape: jnp.asarray(noise).reshape(shape))
    monkeypatch.setattr(tlfq, 'gumbel_noise', lambda gen, shape, device=None: torch.from_numpy(noise).reshape(shape))
    j, t = _train_both(jm, tm, x, mask, 1.0)
    np.testing.assert_allclose(t['aux'], j['aux'], rtol=1e-5)
    np.testing.assert_allclose(t['bd'], j['bd'], rtol=1e-5)
    np.testing.assert_allclose(t['gx'], j['gx'], rtol=0, atol=2e-5 * np.abs(j['gx']).max())


def test_subsample_draws_only_weighted_tokens():
    tm = tlfq.LFQ(dim=4, codebook_size=16, frac_per_sample_entropy=0.25, device='cpu')
    w = torch.zeros(40)
    w[[3, 7, 11, 19, 23, 31, 39, 0, 5, 9]] = 1
    sel = tm.subsample_tokens(w, 10)
    assert sorted(sel.tolist()) == sorted(torch.nonzero(w)[:, 0].tolist())
    assert len(set(tm.subsample_tokens(torch.ones(40), 10).tolist())) == 10


def test_lfq_routes_and_refusals():
    """'auto' on the CPU takes the streamed route for chunked sizes and never
    the fused one; a synced LFQ needs its axis bound in training; bad
    arguments raise."""
    tm = tlfq.LFQ(dim=18, codebook_size=2 ** 18, device='cpu')
    assert tlfq.entropy_route(tm.entropy_fused, 'cpu', tm.codebook_dim, 1 << 14) == 'streamed'
    assert tlfq.entropy_route('on', 'cpu', 8, None) == 'fused'
    assert tlfq.entropy_route('off', 'cpu', 8, 4) == 'streamed'
    # the distributed entropy is ported (tests/test_torch_parallel.py): its
    # training forward needs the axis bound, its eval forward does not
    synced = tlfq.LFQ(dim=8, codebook_size=2 ** 8, sync_axis='data', device='cpu')
    synced.eval()(torch.randn(2, 3, 8))
    with pytest.raises(NameError, match="unbound axis name: 'data'"):
        synced.train()(torch.randn(2, 3, 8))
    with pytest.raises(TypeError, match='rngs'):
        tlfq.LFQ(dim=8, codebook_size=2 ** 8, rngs=nnx.Rngs(0), device='cpu')
    with pytest.raises(ValueError, match='power of 2'):
        tlfq.LFQ(dim=8, codebook_size=100, device='cpu')
    with pytest.raises(ValueError, match="entropy_fused"):
        tlfq.LFQ(dim=8, codebook_size=2 ** 8, entropy_fused='yes', device='cpu')
    assert vqtpu_torch.LFQ is tlfq.LFQ


@pytest.mark.parametrize('mode,device,d,chunk,route', (
    ('auto', 'cuda', 18, 1 << 14, 'fused'),
    ('auto', 'cuda', 25, 1 << 14, 'streamed'),
    ('auto', 'cuda', 12, None, 'dense'),
    ('auto', 'cpu', 18, 1 << 14, 'streamed'),
    ('auto', 'cpu', 8, None, 'dense'),
    ('on', 'cuda', 24, None, 'fused'),
    ('on', 'cpu', 25, 1 << 14, 'fused'),
    ('on', 'cuda', 25, 1 << 14, ValueError),
    ('off', 'cuda', 18, 1 << 14, 'streamed'),
), ids=('auto_cuda_d18', 'auto_cuda_d25', 'auto_cuda_dense', 'auto_cpu_d18', 'auto_cpu_dense', 'on_cuda_d24',
        'on_cpu_d25', 'on_cuda_d25_raises', 'off_cuda_d18'))
def test_entropy_route_by_device_and_dim(mode, device, d, chunk, route):
    """'auto' takes the fused sweeps on the card only, for chunked statistics
    the sweeps take (d <= 24), and streams beyond them; 'on' raises where the
    sweeps cannot run; the CPU never takes them under 'auto'."""
    if route is ValueError:
        with pytest.raises(ValueError, match='1 <= d <= 24'):
            tlfq.entropy_route(mode, device, d, chunk)
    else:
        assert tlfq.entropy_route(mode, device, d, chunk) == route


def test_cosine_sim_linear_resolves_its_device():
    """CosineSimLinear runs where every entry point runs: the CUDA card when
    no device is given (raising without one), the CPU when asked."""
    if torch.cuda.is_available():
        assert tlfq.CosineSimLinear(4, 8).weight.device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlfq.CosineSimLinear(4, 8)
    layer = tlfq.CosineSimLinear(4, 8, device='cpu')
    assert layer.weight.device.type == 'cpu' and layer.weight.shape == (4, 8)
    assert vqtpu_torch.quantizers.CosineSimLinear is tlfq.CosineSimLinear


def test_cosine_sim_linear_matches_jax():
    jl = jlfq.CosineSimLinear(6, 5, scale=2.0, rngs=nnx.Rngs(0))
    tl = tlfq.CosineSimLinear(6, 5, scale=2.0, device='cpu')
    load_vqtpu_state(tl, jax_state(jl))
    x = np.random.default_rng(8).standard_normal((3, 6), dtype=np.float32)
    with torch.no_grad():
        got = tl(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
