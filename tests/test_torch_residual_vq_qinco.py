"""QINCo (`implicit_neural_codebook`) and DiVeQ (`diveq`) of the port's
ResidualVQ (vqtpu_torch) against the JAX package's (vqtpu.composite), on the
CPU, with the JAX state carried over by load_vqtpu_state (the layers'
learnable codebooks and QINCo's MLPs). The JAX side runs `nnx.jit` of its
value_and_grad.

QINCo's layers 2..N select against a per-token codebook on the distance
path, which both sides compute as -cdist in f32; the port's MLP applies its
first projection as two halves (the condition's and the codes') where the
JAX package multiplies the concatenation, so the per-token codebooks agree
to f32 rounding and the indices are held equal. DiVeQ's layers select with
the kernels' formulation, held to the float64 tie rule per layer, and its
noise is given to both sides (`jax.random.normal` and
`vqtpu_torch.core.sampling.normal_noise`, each draw a function of its
shape). Values, losses, the gradient reaching x and every parameter's
gradient to rtol 1e-5, atol 1e-5 (1e-4 relative for the MLPs' and the
codebooks' gradients, which sum over every token and code); the codes
decoded from the indices to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu.composite as jcomposite
import vqtpu_torch
import vqtpu_torch.core.sampling as tsampling
from vqtpu_torch import load_vqtpu_state

from torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    assert_indices_tie_equal, jax_state, one_torch_thread, torch_layout_grads,
)

SHAPE = (2, 6, 8)
BASE = dict(dim=8, num_quantizers=3, codebook_size=16)
TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)

# name -> (constructor kwargs, call kwargs)
CASES = {
    'qinco': (dict(implicit_neural_codebook=True, mlp_kwargs=dict(depth=2)), {}),
    'qinco_projection': (dict(implicit_neural_codebook=True, codebook_dim=4, mlp_kwargs=dict(depth=2)), {}),
    'qinco_shared_hidden': (dict(implicit_neural_codebook=True, mlp_kwargs=dict(dim_hidden=12, depth=1),
                                 rotation_trick=False), {}),
    'diveq': (dict(diveq=True), {}),
    'diveq_dropout': (dict(diveq=True, quantize_dropout=True), 'dropout'),
}


@pytest.fixture
def injected_noise(monkeypatch):
    def noise(shape):
        return np.random.default_rng([9, *shape]).standard_normal(shape).astype(np.float32)
    monkeypatch.setattr(jax.random, 'normal', lambda key, shape, dtype=jnp.float32: jnp.asarray(noise(shape)))
    monkeypatch.setattr(tsampling, 'normal_noise', lambda gen, shape, device=None:
                        torch.from_numpy(noise(tuple(shape))))


def _pair(**kw):
    jm = jcomposite.ResidualVQ(**kw, rngs=nnx.Rngs(0))
    tm = vqtpu_torch.ResidualVQ(**kw, device='cpu')
    load_vqtpu_state(tm, jax_state(jm))
    return jm, tm


def _jax_loss(m, x, g, call_kw):
    q, idx, losses = m(x, **call_kw)
    return (q * g).sum() + losses.sum(), (q, idx, losses)


_jax_value_and_grad = nnx.jit(nnx.value_and_grad(_jax_loss, argnums=(0, 1), has_aux=True))


def _steps(jm, tm, call_kw, steps, shape=SHAPE):
    for step in range(steps):
        rng = np.random.default_rng([5, step])
        x = rng.standard_normal(shape, dtype=np.float32)
        g = rng.standard_normal(shape, dtype=np.float32)
        jkw = {k: jnp.int32(v) if k == 'rand_quantize_dropout_index' else v for k, v in call_kw.items()}
        (_, (jq, jidx, jlosses)), (jgrads, jgx) = _jax_value_and_grad(jm, jnp.asarray(x), jnp.asarray(g), jkw)
        tm.zero_grad()
        embeds = [layer._codebook.embed.detach().clone() for layer in tm.layers]
        tx = torch.from_numpy(x).requires_grad_()
        tq, tidx, tlosses = tm(tx, **call_kw)
        total = (tq * torch.from_numpy(g)).sum() + tlosses.sum()
        if total.requires_grad:
            total.backward()
        yield x, embeds, (np.asarray(jq), np.asarray(jidx), np.asarray(jlosses), np.asarray(jgx),
                          jax.tree.map(np.asarray, nnx.to_pure_dict(jgrads))), (tq, tidx, tlosses, tx.grad)


@pytest.mark.parametrize('mode', ('train', 'eval'))
@pytest.mark.parametrize('case', sorted(CASES))
def test_qinco_and_diveq_match_jax(case, mode, injected_noise):
    kwargs, extra = CASES[case]
    jm, tm = _pair(**BASE, **kwargs)
    getattr(jm, mode)()
    getattr(tm, mode)()
    call_kw = {'rand_quantize_dropout_index': 1} if extra == 'dropout' and mode == 'train' else {}
    for step, (x, embeds, jout, tout) in enumerate(_steps(jm, tm, call_kw, 2 if mode == 'train' else 1)):
        jq, jidx, jlosses, jgx, jgrads = jout
        tq, tidx, tlosses, tgx = tout
        tidx = tidx.numpy()
        if kwargs.get('implicit_neural_codebook'):
            np.testing.assert_array_equal(tidx, jidx, err_msg=f'step {step}')
        else:
            # each layer against its own input: the residual of the layers before
            with torch.no_grad():
                codes = tm.get_codes_from_indices(torch.from_numpy(tidx))
            residual = torch.from_numpy(x)
            for q in range(tm.num_quantizers):
                if (tidx[..., q] >= 0).all():
                    assert_indices_tie_equal(residual.reshape(1, -1, SHAPE[-1]), embeds[q], 'euclidean',
                                             tidx[..., q].reshape(1, -1), jidx[..., q].reshape(1, -1))
                residual = residual - codes[q]
        np.testing.assert_allclose(tq.detach().numpy(), jq, **TOL, err_msg=f'step {step} quantized')
        np.testing.assert_allclose(tlosses.detach().numpy(), jlosses, **TOL, err_msg=f'step {step} losses')
        if tgx is not None:
            np.testing.assert_allclose(tgx.numpy(), jgx, **TOL, err_msg=f'step {step} x.grad')
        if mode == 'train':
            want = torch_layout_grads(tm, jgrads)
            for name, p in tm.named_parameters():
                # a dropped layer's codebook takes no gradient: None here, zeros in JAX
                got = torch.zeros_like(p) if p.grad is None else p.grad
                np.testing.assert_allclose(got.numpy(), want[name], **PARAM_TOL, err_msg=f'step {step} {name}')
    if mode == 'eval':
        # the decode runs the MLPs again on the codes before each layer
        with torch.no_grad():
            codes = tm.get_codes_from_indices(torch.from_numpy(tidx))
            out = tm.get_output_from_indices(torch.from_numpy(tidx))
        jcodes = np.asarray(jm.get_codes_from_indices(jnp.asarray(jidx)))
        np.testing.assert_allclose(codes.numpy(), jcodes, rtol=1e-5, atol=1e-5)
        if not kwargs.get('diveq'):
            # DiVeQ reparameterizes the output in eval too, as in the JAX package
            np.testing.assert_allclose(out.numpy(), tq.detach().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('mode', ('train', 'eval'))
def test_qinco_beam_search_matches_jax(mode, injected_noise):
    """QINCo under beam search at batch 1 (the JAX package's beam search
    folds the batch into the codebook's head slot): the per-token codebooks
    of every beam, the chosen indices exactly, values and x.grad."""
    jm, tm = _pair(**BASE, implicit_neural_codebook=True, mlp_kwargs=dict(depth=2), beam_size=3)
    getattr(jm, mode)()
    getattr(tm, mode)()
    for step, (x, _, jout, tout) in enumerate(_steps(jm, tm, {}, 1, shape=(1, *SHAPE[1:]))):
        jq, jidx, jlosses, jgx, _ = jout
        tq, tidx, tlosses, tgx = tout
        np.testing.assert_array_equal(tidx.numpy(), jidx, err_msg='beam indices')
        np.testing.assert_allclose(tq.detach().numpy(), jq, **TOL)
        np.testing.assert_allclose(tlosses.detach().numpy(), jlosses, **TOL)
        np.testing.assert_allclose(tgx.numpy(), jgx, **TOL)


def test_qinco_mlp_matches_jax():
    """The MLP alone, with heads and without: values and gradients."""
    jmlp = jcomposite.residual_vq.MLP(dim=8, dim_hidden=12, depth=2, l2norm_output=True, rngs=nnx.Rngs(3))
    tmlp = vqtpu_torch.composite.residual_vq.MLP(dim=8, dim_hidden=12, depth=2, l2norm_output=True,
                                                 device='cpu')
    load_vqtpu_state(tmlp, jax_state(jmlp))
    rng = np.random.default_rng(6)
    cond = rng.standard_normal((2, 3, 8), dtype=np.float32)
    for codes_shape in ((16, 8), (2, 16, 8)):
        codes = rng.standard_normal(codes_shape, dtype=np.float32)
        want = np.asarray(jmlp(jnp.asarray(codes), condition=jnp.asarray(cond)))
        got = tmlp(torch.from_numpy(codes), condition=torch.from_numpy(cond))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
