"""The port's data parallelism (vqtpu_torch.parallel, `sync_axis`) against
the JAX package's, on the CPU.

The torch side runs as two gloo ranks (tests/torch_dist.py), each
with its half of the global batch along dim 0; the JAX side runs in this
process under `shard_map` over two of its eight CPU devices, from the same
state (load_vqtpu_state); and the port runs again in this process on the
whole batch, without a mesh. Each comparison mirrors a test of
tests/test_parallel.py:

  - the VQ EMA step with kmeans init and dead-code expiry, 3 steps, on the
    'off' route and the fused route's plain version ('on' on the CPU): the
    ranks' codebooks bit-identical after every step; against JAX's DP run
    the indices (float64 tie rule), quantized output, losses and x.grad to
    rtol 1e-5, atol 1e-6 and the EMA state to rtol 1e-6, atol 1e-5 (f32
    summation order: the JAX sums run in XLA); against the port on one
    process, cluster_size equal, embed_avg and embed to rtol 1e-6, atol
    1e-5 (the two halves are summed apart, then added), the indices by the
    tie rule and the mean of the ranks' losses to rtol 1e-5. The two
    frameworks cannot share a random stream, and the DP draw (a row from
    each rank's own tokens, pooled, then a row of the pool) is not the
    single process's, so every draw is injected: each rank takes the same
    row indices of its tokens and the same picks of the pool, and the
    single process the global rows those picks land on.
  - LFQ's distributed entropy on 'off' and on the sweeps' plain version,
    at inverse temperatures 100 and 1: the mean of the ranks' aux losses
    equals the single process's to rtol 1e-5, and each rank's x.grad,
    divided by the world size (the trainer's mean), the single process's
    rows to 2e-5 of its largest entry; against JAX's DP run, the
    tolerances of tests/test_torch_lfq.py: at 1 the aux losses to rtol
    1e-5 and x.grad to 2e-5 of its largest entry, at 100 the aux losses to
    rtol 1e-4 and x.grad to 5e-4 absolute.
  - FSP's global-batch moments: the moments, the loss (rtol 1e-5, atol
    1e-6) and x.grad against the single process and JAX's DP run.
  - DataParallelTrainer: the loss falls over 20 Adam steps, the ranks'
    parameters and codebooks are bit-identical, and two runs are
    bit-identical.
  - the collectives' gradient contracts, an unbound axis and None.
  - the composites pass sync_axis to every inner quantizer; affine_param's
    synced batch moments and the in-place optimizer's averaged gradients
    keep the ranks identical and match the single process.
"""

import importlib
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist as td
import vqtpu
import vqtpu.codebook.codebook as jcodebook
import vqtpu_torch
from vqtpu.parallel import collectives as jcollectives
from vqtpu_torch import load_vqtpu_state
from vqtpu_torch.parallel import collectives

from torch_parity import assert_indices_tie_equal, jax_state, one_torch_thread  # noqa: F401  (autouse)

# the module: vqtpu.codebook's own `kmeans` attribute is the function
jkmeans = importlib.import_module('vqtpu.codebook.kmeans')

WORLD = 2
CODES = 16
# each rank holds (2, 20, 16): 40 tokens, 80 in all; the pool holds 2 x 16
SHAPE = (4, 20, 16)
N_LOCAL = SHAPE[0] // WORLD * SHAPE[1]
VQ_KW = dict(dim=16, codebook_size=CODES, decay=0.8, kmeans_init=True, kmeans_iters=3,
             threshold_ema_dead_code=2)
STEPS = 3


def jax_mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ('data',))


def step_tables(step):
    """The injected draws of a step: {rows drawn from: indices}. Each rank
    takes rows `local` of its 40 tokens, the pool's picks are `pick`, and
    the single process takes the global rows they land on."""
    rng = np.random.default_rng(100 + step)
    local = rng.integers(0, N_LOCAL, CODES)
    pick = rng.integers(0, WORLD * CODES, CODES)
    return {N_LOCAL: local, WORLD * CODES: pick, WORLD * N_LOCAL: pick // CODES * N_LOCAL + local[pick % CODES]}


def _inputs():
    xs, gs = [], []
    for s in range(STEPS):
        rng = np.random.default_rng(s)
        xs.append(rng.standard_normal(SHAPE, dtype=np.float32))
        gs.append(rng.standard_normal(SHAPE, dtype=np.float32))
    return xs, gs


def _jax_vq_dp(jvq, xs, gs, tables, monkeypatch):
    """JAX's DP run, the draws injected as the port's ranks take them."""
    cur = {}

    def sample_means(key, s, mask, num, sync_axis=None, code_axis=None):
        local = jnp.take(s, cur[s.shape[1]], axis=1)
        pooled = jcollectives.all_gather(local, sync_axis, concat_axis=1)
        return jnp.take(pooled, cur[pooled.shape[1]], axis=1)

    randint = jax.random.randint

    def pool_pick(key, shape, minval, maxval, *args, **kwargs):
        if tuple(shape) == (CODES,) and maxval == WORLD * CODES:
            return cur[WORLD * CODES]
        return randint(key, shape, minval, maxval, *args, **kwargs)

    monkeypatch.setattr(jkmeans, 'sample_means', sample_means)
    monkeypatch.setattr(jcodebook, 'masked_sample_vectors',
                        lambda key, s, mask, num: jnp.take(s, cur[s.shape[0]], axis=0))
    monkeypatch.setattr(jax.random, 'randint', pool_pick)
    graphdef, state = nnx.split(jvq)

    def body(state, x, g, local, pick):
        cur.update({N_LOCAL: local, WORLD * CODES: pick})
        m = nnx.merge(graphdef, state)

        def loss_fn(m, x):
            q, idx, loss = m(x)
            return (q * g).sum() + loss, (q, idx, loss)
        (_, (q, idx, loss)), gx = nnx.value_and_grad(loss_fn, argnums=1, has_aux=True)(m, x)
        return nnx.split(m)[1], q, idx, loss[None], gx

    step = jax.jit(jax.shard_map(
        body, mesh=jax_mesh(), in_specs=(P(), P('data'), P('data'), P(), P()),
        out_specs=(P(), P('data'), P('data'), P('data'), P('data')), check_vma=False))
    out = []
    for s in range(STEPS):
        t = tables[s]
        state, q, idx, loss, gx = step(state, jnp.asarray(xs[s]), jnp.asarray(gs[s]),
                                       jnp.asarray(t[N_LOCAL]), jnp.asarray(t[WORLD * CODES]))
        cb = nnx.merge(graphdef, state)._codebook
        out.append(dict(q=np.asarray(q), idx=np.asarray(idx), loss=np.asarray(loss), x_grad=np.asarray(gx),
                        **{k: np.asarray(getattr(cb, k)[...]) for k in ('embed', 'embed_avg', 'cluster_size')}))
    return out


def _joined(ranks, step, name):
    return np.concatenate([r[step][name] for r in ranks])


@pytest.mark.parametrize('route', ('off', 'on'))
def test_vq_ema_dp_matches_jax_and_one_process(route, monkeypatch):
    kwargs = dict(VQ_KW, train_fused=route)
    xs, gs = _inputs()
    tables = [step_tables(s) for s in range(STEPS)]
    jvq = vqtpu.VectorQuantize(**kwargs, sync_axis='data', rngs=nnx.Rngs(0))
    state = jax_state(jvq)

    ranks = td.run_world(td.vq_dp_body, kwargs=kwargs, state=state, xs=xs, gs=gs, step_tables=tables)
    one = vqtpu_torch.VectorQuantize(**kwargs, device='cpu').train()
    load_vqtpu_state(one, state)
    single = td.vq_steps(one, xs, gs, tables)
    jdp = _jax_vq_dp(jvq, xs, gs, tables, monkeypatch)

    replaced = 0
    for s in range(STEPS):
        for name in ('embed', 'embed_avg', 'cluster_size', 'embed_used'):
            np.testing.assert_array_equal(ranks[0][s][name], ranks[1][s][name], err_msg=f'step {s} {name} ranks')
        x = xs[s].reshape(1, -1, SHAPE[-1])
        idx = _joined(ranks, s, 'idx')
        assert_indices_tie_equal(x, ranks[0][s]['embed_used'], 'euclidean', idx, jdp[s]['idx'])
        assert_indices_tie_equal(x, ranks[0][s]['embed_used'], 'euclidean', idx, single[s]['idx'])
        for name in ('q', 'x_grad'):
            np.testing.assert_allclose(_joined(ranks, s, name), jdp[s][name], rtol=1e-5, atol=1e-6,
                                       err_msg=f'step {s} {name}')
        np.testing.assert_allclose([r[s]['loss'] for r in ranks], jdp[s]['loss'].reshape(-1), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(_joined(ranks, s, 'q'), single[s]['q'], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.mean([r[s]['loss'] for r in ranks]), single[s]['loss'], rtol=1e-5)
        np.testing.assert_allclose(ranks[0][s]['cluster_size'], jdp[s]['cluster_size'], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ranks[0][s]['cluster_size'], single[s]['cluster_size'])
        for name in ('embed_avg', 'embed'):
            np.testing.assert_allclose(ranks[0][s][name], jdp[s][name], rtol=1e-6, atol=1e-5,
                                       err_msg=f'step {s} {name} jax')
            np.testing.assert_allclose(ranks[0][s][name], single[s][name], rtol=1e-6, atol=1e-5,
                                       err_msg=f'step {s} {name} one process')
        replaced += int((ranks[0][s]['cluster_size'] == VQ_KW['threshold_ema_dead_code']).sum())
    assert replaced > 0, 'no code expired: the test would not exercise the pooled draw'


# the default inverse temperature, where the softmax saturates and x.grad
# is mostly rounding noise, and 1, where every entry counts
INV_TEMPS = (100.0, 1.0)


def _lfq_kwargs(route):
    kw = dict(dim=8, codebook_size=2 ** 8, spherical=True, entropy_loss_weight=0.1)
    return {**kw, 'entropy_fused': 'on', 'entropy_chunk_size': 64} if route == 'sweeps' else kw


@pytest.mark.parametrize('route', ('off', 'sweeps'))
def test_lfq_distributed_entropy_matches_one_process(route):
    kw = _lfq_kwargs(route)
    x = np.random.default_rng(7).standard_normal((8, 16, 8), dtype=np.float32)
    jm = vqtpu.LFQ(**kw, sync_axis='data', rngs=nnx.Rngs(0))
    state = jax_state(jm)
    ranks = td.run_world(td.lfq_dp_body, kwargs=kw, state=state, x=x, inv_temps=INV_TEMPS)
    one = vqtpu_torch.LFQ(**kw, device='cpu').train()
    load_vqtpu_state(one, state)
    jm.train()
    graphdef, jstate = nnx.split(jm)

    for i, inv_temp in enumerate(INV_TEMPS):
        tx = torch.from_numpy(x).requires_grad_()
        _, idx, aux = one(tx, inv_temperature=inv_temp)
        aux.backward()
        np.testing.assert_allclose(np.mean([r[i]['aux'] for r in ranks]), float(aux.detach()), rtol=1e-5)
        got = np.concatenate([r[i]['x_grad'] for r in ranks])
        want = tx.grad.numpy()
        np.testing.assert_allclose(got / WORLD, want, rtol=0, atol=2e-5 * np.abs(want).max())
        np.testing.assert_array_equal(np.concatenate([r[i]['idx'] for r in ranks]), idx.numpy())

        def body(state, x):
            loss, gx = jax.value_and_grad(lambda x: nnx.merge(graphdef, state)(x, inv_temperature=inv_temp)[2])(x)
            return loss[None], gx
        jloss, jgx = jax.jit(jax.shard_map(body, mesh=jax_mesh(), in_specs=(P(), P('data')),
                                           out_specs=(P('data'), P('data')), check_vma=False))(jstate, jnp.asarray(x))
        jgx = np.asarray(jgx)
        if inv_temp == 1.0:
            np.testing.assert_allclose([r[i]['aux'] for r in ranks], np.asarray(jloss), rtol=1e-5)
            np.testing.assert_allclose(got, jgx, rtol=0, atol=2e-5 * np.abs(jgx).max())
        else:   # tests/test_torch_lfq.py's tolerances at inv_temperature 100
            np.testing.assert_allclose([r[i]['aux'] for r in ranks], np.asarray(jloss), rtol=1e-4)
            assert float(np.abs(got - jgx).max()) < 5e-4


def test_fsp_distributed_moments_match_one_process():
    kw = dict(levels=[8, 6, 5], quantize_rate=1.0)
    x = np.random.default_rng(3).standard_normal((16, 8, 3), dtype=np.float32)
    jm = vqtpu.FSP(**kw, sync_axis='data', rngs=nnx.Rngs(0))
    state = jax_state(jm)
    ranks = td.run_world(td.fsp_dp_body, kwargs=kw, state=state, x=x)

    one = vqtpu_torch.FSP(**kw, device='cpu').train()
    load_vqtpu_state(one, state)
    tx = torch.from_numpy(x).requires_grad_()
    _, _, loss, info = one(tx)
    loss.backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    for r in ranks:
        np.testing.assert_allclose(r['loss'], float(loss.detach()), **tol)
        for name, value in info['norm_info'].items():
            np.testing.assert_allclose(r[name], value.detach().numpy(), **tol, err_msg=name)
    got = np.concatenate([r['x_grad'] for r in ranks]) / WORLD
    np.testing.assert_allclose(got, tx.grad.numpy(), rtol=1e-5, atol=1e-6)

    jm.train()
    graphdef, jstate = nnx.split(jm)

    def body(state, x):
        loss, gx = jax.value_and_grad(lambda x: nnx.merge(graphdef, state)(x)[2])(x)
        return loss[None], gx
    jloss, jgx = jax.jit(jax.shard_map(body, mesh=jax_mesh(), in_specs=(P(), P('data')),
                                       out_specs=(P('data'), P('data')), check_vma=False))(jstate, jnp.asarray(x))
    np.testing.assert_allclose([r['loss'] for r in ranks], np.asarray(jloss), **tol)
    np.testing.assert_allclose(np.concatenate([r['x_grad'] for r in ranks]), np.asarray(jgx), **tol)


def test_data_parallel_trainer_converges_and_repeats():
    x = np.random.default_rng(0).standard_normal((32, 4, 8), dtype=np.float32)
    runs = [td.run_world(td.trainer_body, x=x, steps=20) for _ in range(2)]
    for ranks in runs:
        losses = ranks[0]['losses']
        assert losses[-1] < losses[0], losses
        assert all(r['eval_matches'] and r['multiprocess'] for r in ranks)
        np.testing.assert_array_equal(ranks[0]['losses'], ranks[1]['losses'])
        for name in ('embed', 'embed_avg', 'cluster_size'):
            np.testing.assert_array_equal(ranks[0][name], ranks[1][name], err_msg=name)
        for name, p in ranks[0]['params'].items():
            np.testing.assert_array_equal(p, ranks[1]['params'][name], err_msg=name)
    a, b = runs[0][0], runs[1][0]
    np.testing.assert_array_equal(a['losses'], b['losses'])
    np.testing.assert_array_equal(a['embed'], b['embed'])
    for name, p in a['params'].items():
        np.testing.assert_array_equal(p, b['params'][name], err_msg=name)


def test_trainer_step_is_the_one_process_gradient():
    """One trainer step on two ranks against one Adam step of the same
    model on the whole batch: the psum's summed cotangent and the
    trainer's mean make the single-process gradient."""
    x = np.random.default_rng(1).standard_normal((8, 4, 8), dtype=np.float32)
    ranks = td.run_world(td.trainer_body, x=x, steps=1, vq_kwargs=dict(ema_update=False))
    torch.manual_seed(0)
    model = td.DPModel(sync_axis=None, ema_update=False)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    loss = td.dp_model_loss(model, torch.from_numpy(x))
    loss.backward()
    opt.step()
    np.testing.assert_allclose(ranks[0]['losses'][0], float(loss.detach()), rtol=1e-5)
    for name, p in model.named_parameters():
        # Adam's first step moves each entry by lr * sign(g), so equal
        # gradients up to rounding give equal parameters
        np.testing.assert_allclose(ranks[0]['params'][name], p.detach().numpy(), rtol=0, atol=1e-6, err_msg=name)


def test_collectives_gradient_contracts():
    ranks = td.run_world(td.collectives_body)
    w = np.arange(WORLD * 2, dtype=np.float32) + 1.0
    for r, out in enumerate(ranks):
        mine = w[2 * r:2 * r + 2]
        np.testing.assert_array_equal(out['all_gather_exact'], mine[None])
        np.testing.assert_array_equal(out['all_gather'], WORLD * mine[None])
        np.testing.assert_array_equal(out['all_gather_value'], [[1.0, 1.0], [2.0, 2.0]])
        np.testing.assert_array_equal(out['all_gather_stacked'], [[[1.0, 1.0], [2.0, 2.0]]])
        np.testing.assert_array_equal(out['psum_value'], [3.0, 3.0])
        np.testing.assert_array_equal(out['psum'], w.reshape(WORLD, 2).sum(0))
        np.testing.assert_array_equal(out['psum_exact'], mine)
        np.testing.assert_array_equal(out['psum_in_bwd'], w)
        np.testing.assert_array_equal(out['pmean_value'], [1.5, 1.5])
        np.testing.assert_array_equal(out['pmean'], w.reshape(WORLD, 2).sum(0) / WORLD)
        assert (out['axis_size'], out['axis_index'], out['bound'], out['bound_after']) == (WORLD, r, True, False)


def test_unbound_axis_raises_and_none_is_identity():
    x = torch.arange(4.0, requires_grad=True)
    for fn in (collectives.psum, collectives.psum_exact, collectives.psum_in_bwd, collectives.pmean,
               collectives.all_gather, collectives.all_gather_exact):
        assert fn(x, None) is x
        with pytest.raises(NameError, match="unbound axis name: 'data'"):
            fn(x, 'data')
    assert (collectives.axis_size(None), collectives.axis_index(None)) == (1, 0)
    assert not collectives.axis_is_bound(None) and not collectives.axis_is_bound('data')
    with pytest.raises(NameError):
        collectives.axis_size('data')
    # a VectorQuantize with sync_axis: the eval forward and decode reach no
    # collective; a training forward outside a mesh raises as JAX's unbound psum
    vq = vqtpu_torch.VectorQuantize(dim=8, codebook_size=16, sync_axis='data', device='cpu').eval()
    z = torch.randn(2, 5, 8)
    q, idx, _ = vq(z)
    assert torch.equal(vq.get_output_from_indices(idx), q)
    with pytest.raises(NameError, match='data'):
        vq.train()(z)


def test_composites_pass_sync_axis_to_every_quantizer():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 12, 16), dtype=np.float32)
    x_img = rng.standard_normal((4, 16, 4, 4), dtype=np.float32)
    ranks = td.run_world(td.composites_body, x=x, x_img=x_img)
    for name, out in ranks[0].items():
        assert out['sync_axes'] and set(out['sync_axes']) == {'data'}, (name, out['sync_axes'])
        for a, b in zip(out['codebooks'], ranks[1][name]['codebooks']):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f'{name} {key}')


AFFINE_INPLACE = (
    dict(dim=16, codebook_size=CODES, affine_param=True, sync_affine_param=True),
    dict(dim=16, codebook_size=CODES, learnable_codebook=True, ema_update=False,
         in_place_codebook_optimizer=partial(torch.optim.SGD, lr=0.5)),
)


def test_affine_and_in_place_optimizer_sync():
    """affine_param's batch moments with sync_affine_param, and the in-place
    optimizer's step on gradients averaged over the ranks: the ranks'
    state stays identical and equals one process's on the whole batch
    (rtol 1e-5, atol 1e-6). sync_codebook names the axis: True means
    'data', a string the axis itself."""
    x = np.random.default_rng(9).standard_normal((4, 10, 16), dtype=np.float32)
    ranks = td.run_world(td.affine_inplace_body, x=x, kwargs_list=AFFINE_INPLACE)
    for i, kwargs in enumerate(AFFINE_INPLACE):
        for key, value in ranks[0][i].items():
            np.testing.assert_array_equal(value, ranks[1][i][key], err_msg=key)
        torch.manual_seed(0)
        one = vqtpu_torch.VectorQuantize(**kwargs, device='cpu').train()
        one(torch.from_numpy(x))
        for key, value in one._codebook.state_dict().items():
            np.testing.assert_allclose(ranks[0][i][key], value.detach().numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=key)
    synced = vqtpu_torch.VectorQuantize(dim=16, codebook_size=CODES, sync_codebook=True, device='cpu')
    assert synced.sync_axis == synced._codebook.sync_axis == 'data'
    named = vqtpu_torch.VectorQuantize(dim=8, codebook_size=4, sync_codebook='batch', device='cpu')
    assert named._codebook.sync_axis == 'batch'


# the names of vqtpu.parallel the port lacks: none, since the row-sharded
# (tensor-parallel) and group-parallel names are ported
NOT_PORTED = ()


def test_parallel_exports_the_data_parallel_names():
    import vqtpu.parallel as jparallel
    import vqtpu_torch.parallel as tparallel
    # the package's names, its submodules but `collectives` left out
    jnames = {n for n, v in vars(jparallel).items()
              if not n.startswith('_') and not isinstance(v, types.ModuleType)} | {'collectives'}
    missing = sorted(n for n in jnames - set(NOT_PORTED) if not hasattr(tparallel, n))
    assert not missing, missing
    assert {'psum', 'pmean', 'all_gather', 'axis_size', 'make_mesh', 'DataParallelTrainer', 'init_multihost',
            'is_multiprocess', 'global_batch', 'ShardedCodebookState', 'init_sharded_codebook', 'sharded_quantize',
            'sharded_ema_update', 'sharded_nearest_code', 'sharded_gather_codes', 'sharded_quantize_lookup_bf16',
            'local_onehot_from_global', 'codebook_pspecs', 'find_sharded_codebooks', 'TensorParallelTrainer',
            'tp_apply', 'group_parallel_forward', 'group_parallel_output_from_indices'} <= set(jnames)
    assert all(hasattr(tparallel, n) for n in jnames)
