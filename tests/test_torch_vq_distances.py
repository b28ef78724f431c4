"""The port's VectorQuantize on its distance-materializing path (vqtpu_torch)
against the JAX module (vqtpu), on the CPU, from the same state
(load_vqtpu_state): stochastic codes, gumbel straight-through, the
cross-entropy commitment loss (with and without a mask), the diversity
loss, `indices=`, `topk=` and `codebook_transform_fn=`, in eval and in
training, for euclidean and cosine codebooks.

Both sides compute the distances as -cdist (or the cosine dot) in f32, so
the indices are held equal exactly; the quantized output, the loss and the
gradient reaching x to rtol 1e-5, atol 1e-6 (f32 accumulation order of the
distance product), and after the training steps the EMA state as
tests/test_torch_vq_train.py holds it. The gumbel noise is injected: both
frameworks' `gumbel_noise` are replaced by functions that return the same
numpy draw.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu
import vqtpu.core.sampling as jsampling
import vqtpu_torch
import vqtpu_torch.core.sampling as tsampling
from vqtpu_torch import load_vqtpu_state

from torch_parity import jax_state, one_torch_thread  # noqa: F401  (autouse)

SHAPE = (2, 24, 16)
# a beam search's layer input: (b, n, beams, d)
BEAM_SHAPE = (2, 12, 2, 16)
BASE = dict(dim=16, codebook_size=32)
TOL = dict(rtol=1e-5, atol=1e-6)
COND = np.random.default_rng(9).standard_normal(SHAPE, dtype=np.float32)


def _transform_jax(embed):
    return embed[:, None, None] + 0.1 * jnp.asarray(COND)[None, :, :, None, :]


def _transform_torch(embed):
    return embed[:, None, None] + 0.1 * torch.from_numpy(COND)[None, :, :, None, :]


def _mask(shape):
    lens = np.random.default_rng(11).integers(1, shape[1] + 1, (shape[0],))
    return np.arange(shape[1])[None, :] < lens[:, None]


# name -> (constructor kwargs, forward kwargs on both sides (jax, torch), steps in training)
CASES = {
    'stochastic': (dict(stochastic_sample_codes=True, sample_codebook_temp=0.5), None),
    'gumbel_straight_through': (dict(straight_through=True, rotation_trick=False, stochastic_sample_codes=True), None),
    'gumbel_straight_through_to_input': (
        dict(straight_through=True, rotation_trick=False, route_gradients_to_input=False,
             sample_codebook_temp=0.7), None),
    'ce_commitment': (dict(commitment_use_cross_entropy_loss=True, commitment_weight=0.5), None),
    'ce_commitment_mask': (dict(commitment_use_cross_entropy_loss=True), 'mask'),
    'diversity': (dict(codebook_diversity_loss_weight=0.3, codebook_diversity_temperature=10.0), None),
    'topk': (dict(), 'topk'),
    # a beam layer's (b, n, beams, d) input and (b, n) mask: the JAX
    # package's topk= cannot mask a (b, n, d) input
    'topk_mask': (dict(commitment_weight=2.0), 'topk_mask'),
    'codebook_transform_fn': (dict(), 'transform'),
}


def _forward_kwargs(kind):
    if kind is None:
        return {}, {}
    if kind == 'mask':
        m = _mask(SHAPE)
        return {'mask': jnp.asarray(m)}, {'mask': torch.from_numpy(m)}
    if kind == 'topk':
        return {'topk': 3}, {'topk': 3}
    if kind == 'topk_mask':
        m = _mask(BEAM_SHAPE)
        return {'topk': 2, 'mask': jnp.asarray(m)}, {'topk': 2, 'mask': torch.from_numpy(m)}
    return {'codebook_transform_fn': _transform_jax}, {'codebook_transform_fn': _transform_torch}


@pytest.fixture
def same_noise(monkeypatch):
    """Both frameworks draw the same gumbel noise (a draw seeded by its
    shape)."""
    def draw(shape):
        return np.random.default_rng([1000, *shape]).gumbel(size=shape).astype(np.float32)
    monkeypatch.setattr(jsampling, 'gumbel_noise', lambda key, shape, dtype=jnp.float32: jnp.asarray(draw(shape)))
    monkeypatch.setattr(tsampling, 'gumbel_noise', lambda gen, shape, device=None: torch.from_numpy(draw(shape)))


def _pair(kwargs):
    jvq = vqtpu.VectorQuantize(**kwargs, rngs=nnx.Rngs(0))
    tvq = vqtpu_torch.VectorQuantize(**kwargs, device='cpu')
    load_vqtpu_state(tvq, jax_state(jvq))
    return jvq, tvq


def _jax_step(jvq, x, g, fkw):
    """The JAX forward and the gradient of sum(q * g) + sum(loss) with
    respect to x; state updates carry out of nnx.grad."""
    def loss_fn(m, x):
        q, idx, loss, breakdown = m(x, return_loss_breakdown=True, **fkw)
        return (q * g).sum() + loss.sum(), (q, idx, loss, breakdown)
    (_, (q, idx, loss, bd)), gx = nnx.value_and_grad(loss_fn, argnums=1, has_aux=True)(jvq, x)
    return [np.asarray(t) for t in (q, idx, loss, *bd, gx)]


def _torch_step(tvq, x, g, fkw, first_only=False):
    """The port's forward and gradient, as _jax_step; with `first_only` the
    objective sees batch element 0's candidates only, as the JAX package
    returns them for a (b, n, d) input with topk=."""
    tx = torch.from_numpy(x).requires_grad_()
    q, idx, loss, bd = tvq(tx, return_loss_breakdown=True, **fkw)
    total = ((q[0] if first_only else q) * torch.from_numpy(g)).sum() + loss.sum()
    if total.requires_grad:
        total.backward()
    grad = tx.grad if tx.grad is not None else torch.zeros_like(tx)
    return [t.detach().numpy() for t in (q, idx, loss, *bd)] + [grad.numpy()]


def _assert_states_close(jvq, tvq, exact_counts=True):
    """The EMA state as tests/test_torch_vq_train.py holds it: cluster_size
    equal, unless the counts summed a straight-through one-hot, whose
    entries are 1 or 0 only to within an ulp (then to 1e-6 relative)."""
    jcb, tcb = jvq._codebook, tvq._codebook
    if exact_counts:
        np.testing.assert_array_equal(tcb.cluster_size.numpy(), np.asarray(jcb.cluster_size[...]))
    else:
        np.testing.assert_allclose(tcb.cluster_size.numpy(), np.asarray(jcb.cluster_size[...]), rtol=1e-6)
    for name in ('embed_avg', 'embed'):
        np.testing.assert_allclose(getattr(tcb, name).numpy(), np.asarray(getattr(jcb, name)[...]),
                                   rtol=1e-6, atol=1e-5, err_msg=name)


@pytest.mark.parametrize('mode', ('train', 'eval'))
@pytest.mark.parametrize('metric', ('euclidean', 'cosine'))
@pytest.mark.parametrize('case', sorted(CASES))
def test_distance_path_matches_jax(case, metric, mode, same_noise):
    kwargs, kind = CASES[case]
    jvq, tvq = _pair({**BASE, **kwargs, 'use_cosine_sim': metric == 'cosine'})
    getattr(jvq, mode)()
    getattr(tvq, mode)()
    jfkw, tfkw = _forward_kwargs(kind)
    shape = BEAM_SHAPE if kind == 'topk_mask' else SHAPE
    for step in range(2 if mode == 'train' else 1):
        rng = np.random.default_rng(step)
        x = rng.standard_normal(shape, dtype=np.float32)
        # the JAX package keeps batch element 0's candidates for a (b, n, d)
        # input with topk=; the port returns every element's
        first_only = 'topk' in jfkw and len(shape) == 3
        gshape = (*shape[:-1], jfkw['topk'], shape[-1]) if 'topk' in jfkw else shape
        g = rng.standard_normal(gshape[1:] if first_only else gshape, dtype=np.float32)
        jout = _jax_step(jvq, jnp.asarray(x), jnp.asarray(g), jfkw)
        tout = _torch_step(tvq, x, g, tfkw, first_only)
        if first_only:
            assert tout[0].shape == gshape
            tout[0] = tout[0][0]
        names = ('quantize', 'indices', 'loss', 'commitment', 'codebook_diversity', 'orthogonal_reg',
                 'inplace_optimize', 'x.grad')
        for name, t, j in zip(names, tout, jout):
            assert t.shape == j.shape, (name, t.shape, j.shape)
            if name == 'indices':
                assert t.dtype == np.int32
                np.testing.assert_array_equal(t, j, err_msg=f'step {step}')
            else:
                np.testing.assert_allclose(t, j, **TOL, err_msg=f'step {step} {name}')
    if mode == 'train':
        _assert_states_close(jvq, tvq, exact_counts=not kwargs.get('straight_through'))


@pytest.mark.parametrize('mode', ('train', 'eval'))
@pytest.mark.parametrize('metric', ('euclidean', 'cosine'))
@pytest.mark.parametrize('masked', (False, True), ids=('all', 'masked'))
def test_cross_entropy_against_given_indices_matches_jax(masked, metric, mode):
    """indices= returns (quantized, the cross entropy of the distance logits
    against the given codes), -1 codes ignored; training still updates the
    EMA codebook."""
    jvq, tvq = _pair({**BASE, 'use_cosine_sim': metric == 'cosine'})
    getattr(jvq, mode)()
    getattr(tvq, mode)()
    rng = np.random.default_rng(3)
    x = rng.standard_normal(SHAPE, dtype=np.float32)
    g = rng.standard_normal(SHAPE, dtype=np.float32)
    codes = rng.integers(0, BASE['codebook_size'], SHAPE[:-1]).astype(np.int32)
    if masked:
        codes = np.where(_mask(SHAPE), codes, -1).astype(np.int32)

    def loss_fn(m, x):
        q, ce = m(x, indices=jnp.asarray(codes))
        return (q * g).sum() + ce, (q, ce)
    (_, (jq, jce)), jgx = nnx.value_and_grad(loss_fn, argnums=1, has_aux=True)(jvq, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    q, ce = tvq(tx, indices=torch.from_numpy(codes))
    ((q * torch.from_numpy(g)).sum() + ce).backward()
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(float(ce.detach()), float(jce), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    if mode == 'train':
        _assert_states_close(jvq, tvq)


def test_topk_candidates_are_the_k_nearest_in_order():
    """topk=k gives the k nearest codes of each token in order, the first
    equal to the eval forward's pick, and rows bit-equal to the codebook."""
    _, tvq = _pair(BASE)
    tvq.eval()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(SHAPE, dtype=np.float32))
    q, idx, loss = tvq(x, topk=4)
    _, greedy, _ = tvq(x)
    assert torch.equal(idx[..., 0], greedy)
    d = torch.cdist(x.double(), tvq.codebook.double())
    picked = d.gather(-1, idx.long())
    assert bool((picked[..., 1:] >= picked[..., :-1]).all())
    assert torch.equal(q, tvq.codebook[idx.long()])
    np.testing.assert_allclose(loss.numpy(), ((q - x[..., None, :]) ** 2).mean(-1).numpy(), rtol=1e-6)
