"""The port's example trainers (vqtpu_torch.examples) against the JAX
package's (examples/), on the CPU, at batch 8.

Each of the eight autoencoders is built by its own `main` in both packages
(the JAX script's `train_loop` is replaced by one that records the model
and then runs the real loop); the port's model takes the JAX model's
initial state (load_vqtpu_state), and each loop takes one step on the same
batch: the synthetic images, the same in both (tests/test_torch_data.py),
a cached 512 of them here to keep the test short. Every random draw is
given to both sides as the zoo tests give it: dead-code replacements
(`masked_sample_vectors`), the gumbel noise of stochastic codes
(`gumbel_noise`) and FSP's uniforms (`jax.random.uniform`,
`sampling.uniform_noise`), each a function of its shape (the jitted JAX
step draws once while it traces). kmeans init (the RQ-VAE and HQ
examples) is replaced in both packages by one float64 Lloyd's from the
same rows: the background of the synthetic images makes many encoder
tokens identical, so clusters hold identical tokens, and the packages'
f32 kmeans, which sum a cluster in different orders, round such means
apart by an ulp and then break the resulting near-ties differently (3 of
392 picks and 25 of 256 codes moved in the RQ-VAE's step). The packages'
own kmeans are held to each other in tests/test_torch_vq_train.py and
the zoo tests.

Tolerances: the rec and aux losses to 1e-4 relative (atol 1e-7 for a zero
aux loss). The state after the step (parameters and EMA buffers) to 1e-4
of each tensor's largest entry, but for FVQ's codebook and bridge: the
JAX package differentiates the outer loss through the in-place SGD step
(a second-order term the port, as upstream, leaves out), and Adam's first
step moves every entry by lr = 3e-4 in the direction of its gradient's
sign whatever the gradient's size, so an entry with a small gradient may
move the other way (100 of the 8192 codebook entries here). Those are held
to 2.5 lr. The port's AdamW is held to optax.adamw(lr) on the same
gradients, the weight decay (1e-4, not torch's 1e-2) included.
"""

import importlib
import importlib.util
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import vqtpu.codebook.codebook as jcodebook
import vqtpu.core.sampling as jsampling
import vqtpu.models.data as jdata
import vqtpu_torch.codebook.codebook as tcodebook
import vqtpu_torch.core.sampling as tsampling
import vqtpu_torch.models.data as tdata
import torch_dist
from vqtpu_torch import load_vqtpu_state
from vqtpu_torch.examples import AUTOENCODERS
from vqtpu_torch.examples import common as tcommon

from torch_parity import jax_state, one_torch_thread, torch_layout_grads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, 'examples')
jkmeans = importlib.import_module('vqtpu.codebook.kmeans')
tkmeans = importlib.import_module('vqtpu_torch.codebook.kmeans')

BATCH = 8
LR = 3e-4
LOSS_TOL = dict(rtol=1e-4, atol=1e-7)
STATE_RTOL = 1e-4
# (port state name prefix, why): entries whose gradient differs in sign
# between the packages, which Adam's first step then moves either way;
# held to 2.5 lr
SIGN_FREE = {
    'autoencoder_fvq': ('quantizer._codebook.', 'the JAX gradient runs through the in-place SGD step'),
}


def _load_jax_example(name):
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)         # the scripts import `common`
    spec = importlib.util.spec_from_file_location(f'jax_example_{name}', os.path.join(EXAMPLES, f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SYNTHETIC = {}
_jax_synthetic_images = jdata._synthetic_images


@pytest.fixture
def small_synthetic(monkeypatch):
    """No dataset in either package, and 512 synthetic images, computed once
    and the same array in both."""
    def images(num=8192, size=28, seed=0):
        if seed not in _SYNTHETIC:
            _SYNTHETIC[seed] = _jax_synthetic_images(512, size, seed)
        return _SYNTHETIC[seed]
    for mod in (jdata, tdata):
        monkeypatch.setattr(mod, '_IDX_CANDIDATES', ())
        monkeypatch.setattr(mod, '_try_fashion_mnist', lambda: None)
        monkeypatch.setattr(mod, '_synthetic_images', images)


@pytest.fixture
def injected_draws(monkeypatch):
    def rows(n, num, seed):
        return np.random.default_rng([seed, n, num]).integers(0, n, num)

    def noise(shape):
        return np.random.default_rng([500, *shape]).gumbel(size=shape).astype(np.float32)

    def uniform(shape):
        return np.random.default_rng([700, *shape]).random(tuple(shape), dtype=np.float32)

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
                        torch.from_numpy(noise(tuple(shape))))
    monkeypatch.setattr(jax.random, 'uniform', lambda key, shape=(), dtype=jnp.float32, *a, **k:
                        jnp.asarray(uniform(shape), dtype))
    monkeypatch.setattr(tsampling, 'uniform_noise', lambda gen, shape, dtype=torch.float32, device=None:
                        torch.from_numpy(uniform(shape)).to(dtype))

    def lloyd64(samples, num_clusters, num_iters):
        """(h, n, d) -> f32 means (h, c, d) and bins (h, c): Lloyd's in
        float64 from the rows the injected sample_means takes, first index
        on ties, an empty cluster keeping its mean."""
        x = np.asarray(samples, np.float64)
        means = x[:, rows(x.shape[1], num_clusters, 100)]
        bins = np.zeros(means.shape[:2])
        for _ in range(num_iters):
            dists = ((x[:, :, None] - means[:, None]) ** 2).sum(-1)
            buckets = dists.argmin(-1)
            for h in range(x.shape[0]):
                bins[h] = np.bincount(buckets[h], minlength=num_clusters)
                sums = np.zeros_like(means[h])
                np.add.at(sums, buckets[h], x[h])
                means[h] = np.where(bins[h, :, None] > 0, sums / np.maximum(bins[h], 1)[:, None], means[h])
        return means.astype(np.float32), bins.astype(np.float32)

    def jax_kmeans(key, samples, num_clusters, num_iters=10, use_cosine_sim=False, mask=None, **kw):
        assert not use_cosine_sim and mask is None
        h, _, d = samples.shape
        shapes = (jax.ShapeDtypeStruct((h, num_clusters, d), jnp.float32),
                  jax.ShapeDtypeStruct((h, num_clusters), jnp.float32))
        return jax.pure_callback(lambda s: lloyd64(s, num_clusters, num_iters), shapes, jax.lax.stop_gradient(samples))

    def port_kmeans(gen, samples, num_clusters, num_iters=10, use_cosine_sim=False, mask=None, **kw):
        assert not use_cosine_sim and mask is None
        return tuple(torch.from_numpy(a) for a in lloyd64(samples.numpy(), num_clusters, num_iters))

    monkeypatch.setattr(jcodebook, 'kmeans', jax_kmeans)
    monkeypatch.setattr(tkmeans, 'kmeans', port_kmeans)


def _recording(loss_from_outputs, record, jax_side):
    def loss(outputs, x, alpha):
        total, rec, aux, indices = loss_from_outputs(outputs, x, alpha)
        if jax_side:
            jax.debug.callback(lambda r, a: record.update(rec=float(r), aux=float(a)), rec, aux)
        else:
            record.update(rec=float(rec), aux=float(aux))
        return total, rec, aux, indices
    return loss


@pytest.mark.parametrize('name', AUTOENCODERS)
def test_one_step_matches_jax(name, small_synthetic, injected_draws, monkeypatch):
    jmod = _load_jax_example(name)
    tmod = importlib.import_module(f'vqtpu_torch.examples.{name}')
    jrec, trec, seen = {}, {}, {}
    jax_train_loop = jmod.train_loop

    def jax_loop(model, **kw):
        seen['state0'] = jax_state(model)
        kw['loss_from_outputs'] = _recording(kw['loss_from_outputs'], jrec, True)
        seen['jax'] = jax_train_loop(model, **kw)
        seen['jax_kw'] = kw

    def port_loop(model, **kw):
        load_vqtpu_state(model, seen['state0'])
        kw['loss_from_outputs'] = _recording(kw['loss_from_outputs'], trec, False)
        seen['port_kw'] = kw
        return tcommon.train_loop(model, **kw)

    monkeypatch.setattr(jmod, 'train_loop', jax_loop)
    monkeypatch.setattr(tmod, 'train_loop', port_loop)
    jmod.main(train_iter=1, batch_size=BATCH)
    tm = tmod.main(train_iter=1, batch_size=BATCH, device='cpu')
    jm = seen['jax']
    assert {k: v for k, v in seen['port_kw'].items() if k not in ('loss_from_outputs', 'device', 'compiled')} == \
        {k: v for k, v in seen['jax_kw'].items() if k != 'loss_from_outputs'}

    for key in ('rec', 'aux'):
        np.testing.assert_allclose(trec[key], jrec[key], **LOSS_TOL, err_msg=key)

    # the state after the step, through the loader's layout rules
    jparams = torch_layout_grads(tm, jax.tree.map(np.asarray, nnx.to_pure_dict(nnx.state(jm, nnx.Param))))
    params = dict(tm.named_parameters())
    assert sorted(jparams) == sorted(params)
    twin = tmod.main(train_iter=0, batch_size=BATCH, device='cpu')
    jstate = jax_state(jm)
    # the in-place SGD's step count: the port keeps no in-place optimizer state
    jstate.get('quantizer', {}).pop('in_place_codebook_optimizer', None)
    load_vqtpu_state(twin, jstate)
    want = twin.state_dict()
    got = tm.state_dict()
    assert sorted(want) == sorted(got)
    sign_free = SIGN_FREE.get(name, (None,))[0]
    for key, w in want.items():
        g = got[key]
        if key.rpartition('.')[2] == 'rng_state':
            # a random stream: load_vqtpu_state keys it from the JAX state;
            # its counter counts the port's draws, not flax's stream calls
            assert torch.equal(g[:2], w[:2]), key
            continue
        if not torch.is_floating_point(w):
            assert torch.equal(g, w), key
            continue
        if key in params:
            np.testing.assert_array_equal(w.numpy(), jparams[key], err_msg=key)
        free = sign_free is not None and key.startswith(sign_free)
        atol = 2.5 * LR if free else STATE_RTOL * max(float(w.abs().max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=atol, err_msg=key)


def test_adamw_matches_optax():
    """The port's AdamW against optax.adamw(lr) on the same gradients, three
    steps, then one with a zero gradient, where only the weight decay moves
    the parameters (torch's default decay would move them 100x as far)."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32) for _ in range(3)] + [np.zeros((4, 5), np.float32)]
    tx = optax.adamw(LR)
    jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tcommon.adamw([tp], LR)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        before = tp.detach().clone()
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    # the last step had no gradient: the move is the decay (and Adam's momentum)
    assert opt.param_groups[0]['weight_decay'] == tcommon.OPTAX_ADAMW_WEIGHT_DECAY == 1e-4
    assert float((tp.detach() - before).abs().max()) < 2 * LR


@pytest.mark.parametrize('name', AUTOENCODERS)
def test_main_runs_two_steps(name, small_synthetic, capsys):
    tmod = importlib.import_module(f'vqtpu_torch.examples.{name}')
    model = tmod.main(train_iter=2, batch_size=BATCH, device='cpu')
    assert isinstance(model, torch.nn.Module) and model.training
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith('iter')]
    assert [int(line.split('|')[0].split()[1]) for line in lines] == [0, 1]
    for line in lines:
        rec = float(line.split('rec loss:')[1].split('|')[0])
        aux = float(line.split('aux loss:')[1].split('|')[0])
        assert math.isfinite(rec) and math.isfinite(aux)


def test_distributed_examples_on_two_gloo_ranks():
    """tp_large_codebook on a (1, 2) ('data', 'code') mesh and
    group_parallel_grvq on a 2-rank ('group',) mesh, one step each, in one
    world: the codebook split over the ranks, the ranks' losses alike; the
    group-parallel step equal to the serial loop and the decode round
    trip."""
    ranks = torch_dist.run_world(torch_dist.examples_body, world=2, axes=('data', 'code'), shape=(1, 2),
                                 tp_kwargs=dict(train_iter=1, num_codes=256, batch_size=BATCH),
                                 gp_kwargs=dict(steps=1, groups=2, dim=16, num_quantizers=2, codes=32, tokens=256))
    for r in ranks:
        assert r['tp']['rows_per_rank'] == 128
        assert all(r['tp']['data_replicas_identical'].values())
        assert np.isfinite(r['tp']['losses']).all() and math.isfinite(r['tp']['ema_perplexity'])
        assert r['gp']['step0'] == dict(indices_equal=True, output_equal=True, loss_equal=True)
        assert r['gp']['output_rel_err'] == r['gp']['loss_rel_err'] == 0 and not r['gp']['compiled']
        assert r['gp']['decode_max_err'] < 1e-5
    assert ranks[0]['tp']['losses'] == ranks[1]['tp']['losses']
    assert ranks[0]['gp']['losses'] == ranks[1]['gp']['losses']
