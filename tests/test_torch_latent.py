"""The port's LatentQuantize (vqtpu_torch) against the JAX module (vqtpu),
on the CPU, from the same state (load_vqtpu_state).

Indices equal JAX's but at an integer edge: the codec truncates the f32
sum of scaled codes to an int, and XLA contracts its multiply and add into
a fused multiply-add where torch rounds twice, so a code that scales to an
integer can land an ulp on either side of it; where the two indices
differ, they differ by one and the float64 sum lies within 1e-5 of an
integer. Outputs, losses and gradients to rtol 1e-5, atol 1e-6
(f32 rounding of the projections). With an in-place optimizer the JAX
package differentiates the outer loss through the inner step (a second
order term) while the port, as upstream, does not, so there the
parameters' outer gradients are not compared: their values after the inner
step are (SGD to 1e-6, Adam to 1e-5: its first step is lr * sign(g) but
where |g| is near Adam's epsilon), and the output, indices, loss and x.grad
that follow from them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import vqtpu
import vqtpu_torch
from vqtpu_torch import load_vqtpu_state

from torch_parity import assert_grads_close, jax_state, one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)
CASES = {
    'projected': dict(levels=[5, 5, 8], dim=9),
    'scalar_levels': dict(levels=4, dim=6, codebook_dim=3),
    'two_codebooks': dict(levels=[5, 6], dim=8, num_codebooks=2),
    'frozen_values': dict(levels=[5, 5, 8], dim=3, optimize_values=False),
}
OPTIMIZERS = {
    'sgd': (lambda: optax.sgd(0.1), lambda p: torch.optim.SGD(p, lr=0.1), 1e-6),
    'adam': (lambda: optax.adam(1e-2), lambda p: torch.optim.Adam(p, lr=1e-2), 1e-5),
}


def _pair(kw, optimizer=None):
    jopt, topt = (None, None) if optimizer is None else OPTIMIZERS[optimizer][:2]
    jm = vqtpu.LatentQuantize(**kw, in_place_codebook_optimizer=None if jopt is None else jopt(),
                              rngs=nnx.Rngs(0))
    tm = vqtpu_torch.LatentQuantize(**kw, in_place_codebook_optimizer=topt, device='cpu')
    load_vqtpu_state(tm, jax_state(jm))
    return jm, tm


def _x(dim, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, dim, 4, 5), dtype=np.float32) * 0.6,
            rng.standard_normal((2, dim, 4, 5), dtype=np.float32) * 0.1)


def _assert_indices_edge_equal(tm, x, tidx, jidx):
    jidx = np.asarray(jidx)
    differ = tidx.numpy() != jidx
    if not differ.any():
        return
    with torch.no_grad():
        z = torch.from_numpy(x).movedim(1, -1).reshape(x.shape[0], -1, tm.dim)
        if tm.project_in is not None:
            z = tm.project_in(z)
        codes = tm.quantize(z.reshape(*z.shape[:-1], tm.num_codebooks, tm.codebook_dim)).double()
    half = torch.tensor(tm.levels, dtype=torch.float64) // 2
    exact = ((codes * 2 * half + half) * torch.tensor(tm.basis, dtype=torch.float64)).sum(-1)
    exact = exact.reshape(tidx.shape).numpy()
    assert (np.abs(tidx.numpy() - jidx)[differ] == 1).all()
    assert (np.abs(exact - np.round(exact))[differ] < 1e-5).all(), exact[differ]


def _run(jm, tm, x, g):
    def loss_fn(m, x):
        out, idx, loss = m(x)
        return (out * g).sum() + loss, (out, idx, loss)
    (_, (jout, jidx, jloss)), (jgrads, jgx) = nnx.jit(nnx.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
        jm, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tout, tidx, tloss = tm(tx)
    ((tout * torch.from_numpy(g)).sum() + tloss).backward()
    _assert_indices_edge_equal(tm, x, tidx, jidx)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tloss.detach().numpy(), np.asarray(jloss), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    return jax.tree.map(np.asarray, nnx.to_pure_dict(jgrads)), tidx


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_forward_matches_jax(case, train):
    kw = CASES[case]
    jm, tm = _pair(kw)
    if not train:
        jm.eval()
        tm.eval()
    jgrads, tidx = _run(jm, tm, *_x(kw['dim'], seed=len(case)))
    if kw.get('optimize_values', True):
        # the level values take no gradient through the straight-through quantize
        assert_grads_close(tm, jgrads, **TOL, none_is_zero=True)
    else:
        assert not any(p.requires_grad for p in tm.values_per_latent)
    with torch.no_grad():
        codes = tm.indices_to_codes(tidx)
    np.testing.assert_allclose(codes.numpy(), np.asarray(jm.indices_to_codes(jnp.asarray(tidx.numpy()))), **TOL)
    np.testing.assert_allclose(tm.implicit_codebook.numpy(), np.asarray(jm.implicit_codebook), **TOL)


@pytest.mark.parametrize('optimizer', sorted(OPTIMIZERS))
@pytest.mark.parametrize('case', ['projected', 'two_codebooks'])
def test_in_place_optimizer_step_matches_jax(case, optimizer):
    kw = CASES[case]
    jm, tm = _pair(kw, optimizer)
    params0 = {name: p.detach().clone() for name, p in tm.named_parameters()}
    _run(jm, tm, *_x(kw['dim'], seed=3))
    atol = OPTIMIZERS[optimizer][2]
    for i, values in enumerate(tm.values_per_latent):
        np.testing.assert_allclose(values.detach().numpy(), np.asarray(jm.values_per_latent[i][...]),
                                   rtol=0, atol=atol)
        assert not torch.equal(values.detach(), params0[f'values_per_latent.{i}'])
    if tm.project_out is not None:
        np.testing.assert_allclose(tm.project_out.weight.detach().numpy(), np.asarray(jm.project_out.kernel[...]).T,
                                   rtol=0, atol=atol)
        # the inner loss does not reach project_in: its step is 0
        assert torch.equal(tm.project_in.weight.detach(), params0['project_in.weight'])


def test_eval_takes_no_inner_step():
    jm, tm = _pair(CASES['projected'], 'sgd')
    tm.eval()
    before = [v.detach().clone() for v in tm.values_per_latent]
    with torch.no_grad():
        tm(torch.from_numpy(_x(9)[0]))
    assert all(torch.equal(a, b.detach()) for a, b in zip(before, tm.values_per_latent))
