"""The port's SimVQ and ResidualSimVQ (vqtpu_torch) against the JAX modules
(vqtpu), on the CPU, from the same state (load_vqtpu_state).

Indices are held to the float64 tie rule (torch_parity.assert_indices_tie_equal)
on each layer's own input against its implicit codebook; outputs, losses
and the gradient reaching x to rtol 1e-5, atol 1e-6 (f32 rounding of the
transform and the rotation trick); the transform's gradient, which sums the
rows' gradients by code in another order, to rtol 1e-4, atol 1e-6. Decoding
from indices equals the eval output: the CPU's Linear over one row and over
c rows round alike here, so exactly (on the card: tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu
import vqtpu_torch
from vqtpu_torch import load_vqtpu_state

import torch_dist
from torch_parity import assert_grads_close, assert_indices_tie_equal, jax_state, one_torch_thread  # noqa: F401

DIM, CODES = 16, 32
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _pair(jcls, tcls, train, **kw):
    jm = jcls(**kw, rngs=nnx.Rngs(0))
    tm = tcls(**kw, device='cpu')
    load_vqtpu_state(tm, jax_state(jm))
    if not train:
        jm.eval()
        tm.eval()
    return jm, tm


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape, dtype=np.float32), rng.standard_normal(shape, dtype=np.float32) * 0.1


def _jax_grads(jm, x, g, **fkw):
    def loss_fn(m, x):
        out = m(x, **fkw)
        return (out[0] * g).sum() + out[2].sum(), out
    (_, out), (grads, gx) = nnx.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(jm, jnp.asarray(x))
    return [np.asarray(o) for o in out], np.asarray(gx), jax.tree.map(np.asarray, nnx.to_pure_dict(grads))


def _torch_grads(tm, x, g, **fkw):
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx, **fkw)
    ((out[0] * torch.from_numpy(g)).sum() + out[2].sum()).backward()
    return [o.detach().numpy() for o in out], tx.grad.numpy()


def _implicit(tm):
    with torch.no_grad():
        return tm.codebook[None]


SIMVQ_CASES = {
    'default': {},
    'straight_through': {'rotation_trick': False},
    'frozen_dim': {'frozen_codebook_dim': 8},
    'xla_select': {'use_pallas': False},
    'weights': {'input_to_quantize_commit_loss_weight': 0.5, 'commitment_weight': 2.0},
}


@pytest.mark.parametrize('case', sorted(SIMVQ_CASES))
def test_simvq_eval_matches_jax(case):
    jm, tm = _pair(vqtpu.SimVQ, vqtpu_torch.SimVQ, False, dim=DIM, codebook_size=CODES, **SIMVQ_CASES[case])
    x, _ = _inputs((3, 20, DIM))
    jq, jidx, jloss = jm(jnp.asarray(x))
    with torch.no_grad():
        tq, tidx, tloss = tm(torch.from_numpy(x))
    assert tidx.dtype == torch.int32 and float(tloss) == 0.0 == float(jloss)
    assert_indices_tie_equal(x.reshape(1, -1, DIM), _implicit(tm), 'euclidean', np.asarray(jidx), tidx)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    # eval rows are the implicit codebook's rows, and decode from indices
    np.testing.assert_array_equal(tq.numpy(), _implicit(tm)[0][tidx.long()].numpy())
    with torch.no_grad():
        np.testing.assert_array_equal(tm.indices_to_codes(tidx).numpy(), tq.numpy())
    np.testing.assert_allclose(tm.indices_to_codes(tidx).detach().numpy(),
                               np.asarray(jm.indices_to_codes(jnp.asarray(tidx.numpy()))), **TOL)


@pytest.mark.parametrize('case', sorted(SIMVQ_CASES))
def test_simvq_training_step_matches_jax(case):
    jm, tm = _pair(vqtpu.SimVQ, vqtpu_torch.SimVQ, True, dim=DIM, codebook_size=CODES, **SIMVQ_CASES[case])
    x, g = _inputs((3, 20, DIM), seed=1)
    (jq, jidx, jloss), jgx, jgrads = _jax_grads(jm, x, g)
    (tq, tidx, tloss), tgx = _torch_grads(tm, x, g)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_allclose(tq, jq, **TOL)
    np.testing.assert_allclose(tloss, jloss, **TOL)
    np.testing.assert_allclose(tgx, jgx, **TOL)
    assert_grads_close(tm, jgrads, **GRAD_TOL)


def test_simvq_channel_first_and_custom_transform():
    transform = torch.nn.Sequential(torch.nn.Linear(DIM, DIM, bias=False), torch.nn.Tanh())
    tm = vqtpu_torch.SimVQ(dim=DIM, codebook_size=CODES, codebook_transform=transform, channel_first=True,
                           device='cpu').eval()
    x = torch.randn(2, DIM, 5, 3)
    with torch.no_grad():
        q, idx, _ = tm(x)
    assert q.shape == x.shape and idx.shape == (2, 5, 3)
    with torch.no_grad():
        torch.testing.assert_close(tm.indices_to_codes(idx), q, rtol=0, atol=0)


def test_simvq_code_axis_is_not_ported():
    """code_axis is ported (tests/test_torch_tp.py): outside a mesh binding
    the axis SimVQ is the unsharded module; inside one, with its frozen
    codebook not sharded, it raises."""
    x = torch.randn(2, 5, DIM)
    torch.manual_seed(0)
    sharded = vqtpu_torch.SimVQ(dim=DIM, codebook_size=CODES, code_axis='code', device='cpu')
    torch.manual_seed(0)
    plain = vqtpu_torch.SimVQ(dim=DIM, codebook_size=CODES, device='cpu')
    for got, want in zip(sharded(x), plain(x)):
        assert torch.equal(got, want)
    errors = torch_dist.code_axis_at_rest_raises_in_mesh('SimVQ', dim=DIM, codebook_size=CODES,
                                                          code_axis='code')
    assert all(f'{CODES} codebook rows inside a mesh' in e for e in errors), errors


LAYERS = 3


def _layer_inputs(tm, x):
    """Each layer's input in the port's own forward."""
    inputs = []
    residual = torch.from_numpy(x)
    with torch.no_grad():
        for layer in tm.layers:
            inputs.append(residual.reshape(1, -1, DIM))
            q, _, _ = layer(residual)
            residual = residual - q
    return inputs


def test_residual_simvq_eval_matches_jax():
    jm, tm = _pair(vqtpu.ResidualSimVQ, vqtpu_torch.ResidualSimVQ, False,
                   dim=DIM, num_quantizers=LAYERS, codebook_size=CODES)
    x, _ = _inputs((2, 24, DIM), seed=2)
    jq, jidx, jloss = jm(jnp.asarray(x))
    with torch.no_grad():
        tq, tidx, tloss = tm(torch.from_numpy(x))
    assert tidx.shape == (2, 24, LAYERS) and tloss.shape == (LAYERS,)
    for i, (layer, xin) in enumerate(zip(tm.layers, _layer_inputs(tm, x))):
        assert_indices_tie_equal(xin, _implicit(layer), 'euclidean', np.asarray(jidx)[..., i], tidx[..., i])
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)
    with torch.no_grad():
        dec = tm.get_output_from_indices(tidx)
    np.testing.assert_allclose(dec.numpy(), tq.numpy(), **TOL)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jm.get_output_from_indices(jnp.asarray(tidx.numpy()))),
                               **TOL)


@pytest.mark.parametrize('dropout_index', [0, 1, LAYERS - 1])
def test_residual_simvq_training_step_matches_jax(dropout_index):
    jm, tm = _pair(vqtpu.ResidualSimVQ, vqtpu_torch.ResidualSimVQ, True,
                   dim=DIM, num_quantizers=LAYERS, codebook_size=CODES, quantize_dropout=True)
    x, g = _inputs((2, 24, DIM), seed=3)
    (jq, jidx, jloss), jgx, jgrads = _jax_grads(
        jm, x, g, rand_quantize_dropout_index=jnp.asarray(dropout_index))
    (tq, tidx, tloss), tgx = _torch_grads(tm, x, g, rand_quantize_dropout_index=dropout_index)
    np.testing.assert_array_equal(tidx, jidx)
    assert (tidx[..., dropout_index + 1:] == -1).all() and (tloss[dropout_index + 1:] == 0).all()
    np.testing.assert_allclose(tq, jq, **TOL)
    np.testing.assert_allclose(tloss, jloss, **TOL)
    np.testing.assert_allclose(tgx, jgx, **TOL)
    assert_grads_close(tm, jgrads, **GRAD_TOL)


def test_residual_simvq_codes_from_fewer_indices():
    jm, tm = _pair(vqtpu.ResidualSimVQ, vqtpu_torch.ResidualSimVQ, False,
                   dim=DIM, num_quantizers=LAYERS, codebook_size=CODES, quantize_dropout=True, channel_first=True)
    idx = np.random.default_rng(4).integers(-1, CODES, (2, 5, LAYERS - 1)).astype(np.int32)
    with torch.no_grad():
        got = tm.get_codes_from_indices(torch.from_numpy(idx))
    want = np.asarray(jm.get_codes_from_indices(jnp.asarray(idx)))
    assert got.shape == (LAYERS, 2, DIM, 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got[-1] == 0).all() and (got[0].movedim(1, -1)[torch.from_numpy(idx[..., 0] == -1)] == 0).all()


def test_residual_simvq_draws_its_dropout_index():
    tm = vqtpu_torch.ResidualSimVQ(dim=DIM, num_quantizers=4, codebook_size=CODES, quantize_dropout=True,
                                   quantize_dropout_cutoff_index=1, quantize_dropout_multiple_of=2, device='cpu')
    draws = {int(tm.draw_dropout_index()) for _ in range(50)}
    assert draws <= {1, 3} and draws
    with pytest.raises(ValueError, match='multi-headed'):
        vqtpu_torch.ResidualSimVQ(dim=DIM, num_quantizers=2, codebook_size=CODES, heads=2, device='cpu')
