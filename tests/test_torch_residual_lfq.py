"""The port's ResidualLFQ and GroupedResidualLFQ (vqtpu_torch) against the JAX
package's (vqtpu.composite), on the CPU, with the JAX state carried over by
load_vqtpu_state and the quantize-dropout index given to both sides.

Tolerances as tests/test_lfq.py holds the residual stack: indices equal
exactly, outputs within 1e-6, the per-layer losses within 1e-4 relative (at
inv_temperature 100, the layers' default); the input gradient within 5e-4
absolute (the saturated softmax's gradient is rounding noise there,
tests/test_lfq.py::test_lfq_fused_entropy_bwd_at_default_temp), and the
parameter gradients, which sum that noise over the tokens, within 5e-3 of
their largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu.composite.residual_lfq as jres
import vqtpu_torch
import vqtpu_torch.composite.residual_lfq as tres
from vqtpu_torch import load_vqtpu_state

from torch_parity import jax_state, one_torch_thread, torch_layout_grads  # noqa: F401  (autouse)

ROUTES = {'streamed': dict(entropy_chunk_size=2 ** 6, entropy_fused='off'), 'fused': dict(entropy_fused='on')}


def _pair(cls_j, cls_t, **kw):
    jm = cls_j(**kw, rngs=nnx.Rngs(0))
    tm = cls_t(**kw, device='cpu')
    load_vqtpu_state(tm, jax_state(jm))
    return jm, tm


def _train_both(jm, tm, x, **call_kw):
    jm.train()
    tm.train()

    def loss_fn(m, xs):
        q, idx, losses = m(xs, **call_kw)
        return losses.sum() + (q ** 2).mean(), (q, idx, losses)
    step = nnx.jit(nnx.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))
    (_, (jq, jidx, jlosses)), (jg, jgx) = step(jm, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    q, idx, losses = tm(tx, **call_kw)
    (losses.sum() + q.square().mean()).backward()
    return (np.asarray(jq), np.asarray(jidx), np.asarray(jlosses), np.asarray(jgx),
            jax.tree.map(np.asarray, nnx.to_pure_dict(jg))), (q, idx, losses, tx.grad)


def _assert_same(tm, j, t):
    jq, jidx, jlosses, jgx, jgrads = j
    q, idx, losses, gx = t
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(q.detach().numpy(), jq, rtol=0, atol=1e-6)
    np.testing.assert_allclose(losses.detach().numpy(), jlosses, rtol=1e-4, atol=1e-7)
    assert float(np.abs(gx.numpy() - jgx).max()) < 5e-4
    want = torch_layout_grads(tm, jgrads)
    params = dict(tm.named_parameters())
    assert sorted(want) == sorted(params)
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0, atol=5e-3 * np.abs(want[name]).max(),
                                   err_msg=name)


@pytest.mark.parametrize('route,dropout_index', (('fused', None), ('fused', 1), ('streamed', 1)),
                         ids=('fused-no_dropout', 'fused-dropout_after_1', 'streamed-dropout_after_1'))
def test_residual_lfq_matches_jax(route, dropout_index):
    kw = dict(dim=12, codebook_size=2 ** 8, num_quantizers=3, entropy_loss_weight=0.1,
              quantize_dropout=dropout_index is not None, soft_clamp_input_value=2.0, **ROUTES[route])
    jm, tm = _pair(jres.ResidualLFQ, tres.ResidualLFQ, **kw)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 12), dtype=np.float32)
    mask = rng.random((2, 16)) > 0.2
    call = dict(rand_quantize_dropout_index=dropout_index)
    j, t = _train_both(jm, tm, x, **call)
    _assert_same(tm, j, t)
    if dropout_index is not None:
        assert (t[1][..., dropout_index + 1:] == -1).all() and (t[2][..., dropout_index + 1:] == 0).all()

    # masked tokens in eval mode, and the decode from indices
    jm.eval()
    tm.eval()
    jq, jidx, _ = jm(jnp.asarray(x), mask=jnp.asarray(mask))
    with torch.no_grad():
        q, idx, _ = tm(torch.from_numpy(x), mask=torch.from_numpy(mask))
        out = tm.get_output_from_indices(idx)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.get_output_from_indices(jidx)), rtol=0, atol=1e-6)


def test_residual_lfq_masked_training_matches_jax():
    kw = dict(dim=8, codebook_size=2 ** 8, num_quantizers=2, entropy_loss_weight=0.1,
              commitment_loss_weight=0.25, entropy_fused='on')
    jm, tm = _pair(jres.ResidualLFQ, tres.ResidualLFQ, **kw)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, 8), dtype=np.float32)
    mask = rng.random((2, 10)) > 0.3
    jm.train()
    tm.train()
    jq, jidx, jlosses = jm(jnp.asarray(x), mask=jnp.asarray(mask))
    with torch.no_grad():
        q, idx, losses = tm(torch.from_numpy(x), mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4, atol=1e-7)


def test_codes_from_indices_with_dropped_layers():
    kw = dict(dim=8, codebook_size=2 ** 4, num_quantizers=3, quantize_dropout=True)
    jm, tm = _pair(jres.ResidualLFQ, tres.ResidualLFQ, **kw)
    idx = np.random.default_rng(2).integers(0, 16, (2, 5, 2)).astype(np.int32)
    idx[0, :2, 1] = -1
    want = np.asarray(jm.get_codes_from_indices(jnp.asarray(idx)))
    got = tm.get_codes_from_indices(torch.from_numpy(idx))
    assert got.shape == want.shape == (3, 2, 5, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(tm.get_output_from_indices(torch.from_numpy(idx)).detach().numpy(),
                               np.asarray(jm.get_output_from_indices(jnp.asarray(idx))), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tm.codebooks.numpy(), np.asarray(jm.codebooks))
    tm.quantize_dropout = False
    with pytest.raises(ValueError, match='quantize dropout'):
        tm.get_codes_from_indices(torch.from_numpy(idx))


def test_dropout_draw_stays_in_range():
    tm = tres.ResidualLFQ(dim=4, codebook_size=16, num_quantizers=6, quantize_dropout=True,
                          quantize_dropout_cutoff_index=2, quantize_dropout_multiple_of=2, device='cpu')
    draws = {int(tm.draw_dropout_index()) for _ in range(60)}
    assert draws <= {3, 5} and draws


def test_grouped_residual_lfq_matches_jax(monkeypatch):
    kw = dict(dim=16, groups=2, codebook_size=2 ** 8, num_quantizers=2, quantize_dropout=True,
              entropy_loss_weight=0.1, **ROUTES['fused'])
    jm, tm = _pair(jres.GroupedResidualLFQ, tres.GroupedResidualLFQ, **kw)
    monkeypatch.setattr(jres.ResidualLFQ, '_draw_dropout_index', lambda self: jnp.asarray(0))
    x = np.random.default_rng(3).standard_normal((2, 12, 16), dtype=np.float32)
    jm.train()
    tm.train()

    def loss_fn(m, xs):
        q, idx, losses = m(xs)
        return losses.sum() + (q ** 2).mean(), (q, idx, losses)
    step = nnx.jit(nnx.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))
    (_, (jq, jidx, jlosses)), (jg, jgx) = step(jm, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    q, idx, losses = tm(tx, rand_quantize_dropout_index=0)
    (losses.sum() + q.square().mean()).backward()
    assert idx.shape == (2, 2, 12, 2) and losses.shape == (2, 2)
    _assert_same(tm, (np.asarray(jq), np.asarray(jidx), np.asarray(jlosses), np.asarray(jgx),
                      jax.tree.map(np.asarray, nnx.to_pure_dict(jg))), (q, idx, losses, tx.grad))
    assert (idx[..., 1] == -1).all()

    tm.eval()
    jm.eval()
    jq, jidx, _, jcodes = jm(jnp.asarray(x), return_all_codes=True)
    with torch.no_grad():
        q, idx, _, codes = tm(torch.from_numpy(x), return_all_codes=True)
        out = tm.get_output_from_indices(idx)
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.get_output_from_indices(jidx)), rtol=0, atol=1e-6)
    for a, b in zip(codes, jcodes):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert vqtpu_torch.GroupedResidualLFQ is tres.GroupedResidualLFQ
