"""The port's row-sharded codebooks (`code_axis`, vqtpu_torch.parallel.tp)
against the JAX package's and against the port's own unsharded modules, on
the CPU. Mirrors tests/test_tp.py.

The torch side runs in gloo worlds (tests/torch_dist.py): two ranks
on a ('code',) mesh for every module case, four on a (2, 2) ('data',
'code') mesh for the trainer, the 2D parity, the checkpoint resume and the
sharded_vq engine. Each world runs once per module (fixtures) and the tests
read its results. The JAX side runs in this process under `shard_map` on
two (or 2 x 2) of its eight CPU devices, from the same state
(load_vqtpu_state) and, for kmeans and expiry, the same global index draws
(`masked_sample_indices` replaced on both sides: the sharded draw keeps a
rank's window of that vector in both packages).

Tolerances:
  - against the port's unsharded forward (the same code path with every
    collective of one rank): indices exact; quantized rows, losses and
    x.grad to atol 2e-6; EMA state to atol 2e-6 (the laplace total and the
    affine codebook moments are summed per shard, then across shards);
    gradients of parameters to atol 1e-6 (the psum of partial gradients);
  - against JAX: indices by the float64 near-tie rule
    (`selection_disagreements`, 1e-5 relative: XLA scores -cdist^2, the
    port x.e - |e|^2/2); quantized rows and losses to atol 2e-5, EMA state
    to rtol 1e-5, atol 1e-5 (the bounds tests/test_torch_parallel.py uses
    for the same state);
  - rows of a sharded lookup bit-equal to codebook rows (held in one
    process over 2, 4 and 8 simulated shards as well).
"""

import importlib

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
from vqtpu.parallel import codebook_pspecs as jcodebook_pspecs
from vqtpu.parallel import sharded_ema_update as jsharded_ema_update
from vqtpu.parallel import sharded_quantize as jsharded_quantize
from vqtpu_torch.kernels.distance import nearest_code_plain, selection_bias
from vqtpu_torch.parallel import codebook_pspecs, find_code_partial_grad_paths
from vqtpu_torch.parallel.shard import _RowGather, local_or_dump

from torch_parity import assert_indices_tie_equal, jax_state, one_torch_thread  # noqa: F401  (autouse)

jkmeans = importlib.import_module('vqtpu.codebook.kmeans')

WORLD = 2
DIM, CODES = 32, 64
STEPS = 3
rng = np.random.default_rng(1)
XS = [rng.standard_normal((16, 8, DIM), dtype=np.float32) for _ in range(STEPS)]
GS = [rng.standard_normal((16, 8, DIM), dtype=np.float32) for _ in range(STEPS)]
# the global index vector of every draw of (n rows, num) from 16 x 8 tokens
TABLES = {(128, CODES): rng.integers(0, 128, CODES).astype(np.int64)}

# the configurations of tests/test_tp.py::test_code_sharded_matches_unsharded
# and ::test_code_sharded_multihead, held against JAX
JAX_CASES = {
    'ema': {},
    'kmeans': {'kmeans_init': True, 'kmeans_iters': 4},
    'expiry': {'threshold_ema_dead_code': 1.0},
    'affine': {'affine_param': True},
    'cosine': {'use_cosine_sim': True},
    'dist-path': {'stochastic_sample_codes': True, 'sample_codebook_temp': 0.0},
    'multihead': dict(heads=2, separate_codebook_per_head=True, codebook_dim=16),
}
# gradients through the sharded lookup, the orthogonal loss and the
# distance path's losses (tests/test_tp.py::test_learnable_codebook_gradient_parity,
# ::test_orthogonal_reg_code_sharded_parity, ::test_code_sharded_dist_loss_gradient_parity),
# held against the port's unsharded forward; the gumbel draws come from the
# codebook's generator, seeded alike on every rank and in the one process
GRAD_CASES = {
    'learnable': dict(learnable_codebook=True, ema_update=False),
    'ortho': dict(orthogonal_reg_weight=1.0, learnable_codebook=True, ema_update=False),
    'ortho-active': dict(orthogonal_reg_weight=1.0, orthogonal_reg_active_codes_only=True, learnable_codebook=True,
                         ema_update=False),
    'diversity': dict(codebook_diversity_loss_weight=0.5),
    'ce-commit': dict(commitment_use_cross_entropy_loss=True),
    'gumbel-st': dict(straight_through=True, rotation_trick=False, stochastic_sample_codes=True,
                      sample_codebook_temp=1.0),
    'ce-stochastic': dict(commitment_use_cross_entropy_loss=True, stochastic_sample_codes=True,
                          sample_codebook_temp=1.0),
}
IMG = rng.standard_normal((2, 16, 4, 4), dtype=np.float32)
MODULE_CASES = {
    'simvq': dict(cls='SimVQ', kwargs=dict(dim=DIM, codebook_size=CODES), xs=XS, gs=GS),
    'simvq-decode': dict(cls='SimVQ', kwargs=dict(dim=DIM, codebook_size=CODES), xs=XS[:1], train=False,
                         decode='indices_to_codes'),
    'rvq': dict(cls='ResidualVQ', kwargs=dict(dim=DIM, num_quantizers=3, codebook_size=CODES), xs=XS[:2]),
    'rvq-decode': dict(cls='ResidualVQ', kwargs=dict(dim=DIM, num_quantizers=3, codebook_size=CODES), xs=XS[:1],
                       train=False, decode='get_output_from_indices'),
    'qinco': dict(cls='ResidualVQ', kwargs=dict(dim=16, num_quantizers=3, codebook_size=32,
                                                 implicit_neural_codebook=True,
                                                 mlp_kwargs=dict(dim_hidden=32, depth=2)),
                  xs=[x[:4, :6, :16].copy() for x in XS[:1]], gs=[g[:4, :6, :16].copy() for g in GS[:1]]),
    'qinco-decode': dict(cls='ResidualVQ', kwargs=dict(dim=16, num_quantizers=3, codebook_size=32,
                                                        implicit_neural_codebook=True,
                                                        mlp_kwargs=dict(dim_hidden=32, depth=2)),
                         xs=[x[:4, :6, :16].copy() for x in XS[:1]], train=False, decode='get_output_from_indices'),
    'rsimvq': dict(cls='ResidualSimVQ', kwargs=dict(dim=DIM, num_quantizers=3, codebook_size=CODES), xs=XS[:2],
                   gs=GS[:2]),
    'rsimvq-decode': dict(cls='ResidualSimVQ', kwargs=dict(dim=DIM, num_quantizers=3, codebook_size=CODES),
                          xs=XS[:1], train=False, decode='get_output_from_indices'),
    'vq-decode': dict(cls='VectorQuantize', kwargs=dict(dim=DIM, codebook_size=CODES), xs=XS[:1], train=False,
                      decode='get_output_from_indices'),
    'bf16-euclidean': dict(cls='VectorQuantize', kwargs=dict(dim=DIM, codebook_size=CODES, quantize_tier='bf16'),
                           xs=XS[:1], train=False, decode='get_output_from_indices'),
    'bf16-cosine': dict(cls='VectorQuantize', kwargs=dict(dim=DIM, codebook_size=CODES, quantize_tier='bf16',
                                                          use_cosine_sim=True),
                        xs=XS[:1], train=False, decode='get_output_from_indices'),
    'bf16-rvq': dict(cls='ResidualVQ', kwargs=dict(dim=DIM, num_quantizers=3, codebook_size=CODES,
                                                   quantize_tier='bf16'),
                     xs=XS[:1], train=False, decode='get_output_from_indices'),
    'rpq': dict(cls='RandomProjectionQuantizer', kwargs=dict(dim=DIM, codebook_size=CODES, codebook_dim=16),
                xs=XS[:1], train=False),
    'hq': dict(cls='HierarchicalVQ', kwargs=dict(dim=16, codebook_size=CODES, scales=(1, 2, 4),
                                                 accept_image_fmap=True, kmeans_init=False), xs=[IMG]),
    'grouped-rvq': dict(cls='GroupedResidualVQ', kwargs=dict(dim=DIM, num_quantizers=2, codebook_size=CODES,
                                                             groups=2), xs=XS[:1]),
}


def _jax_vq(kw):
    return vqtpu.VectorQuantize(dim=DIM, codebook_size=CODES, rngs=nnx.Rngs(0), **kw)


def _cases():
    cases = {}
    for name, kw in JAX_CASES.items():
        state = jax_state(_jax_vq(kw))
        case = dict(cls='VectorQuantize', kwargs=dict(dim=DIM, codebook_size=CODES, **kw), state=state, xs=XS,
                    gs=GS)
        if name in ('kmeans', 'expiry'):
            case['index_tables'] = [TABLES] * STEPS
        cases[name] = case
    for name, kw in GRAD_CASES.items():
        cases[name] = dict(cls='VectorQuantize', kwargs=dict(dim=DIM, codebook_size=CODES, **kw), xs=XS, gs=GS)
    cases.update(MODULE_CASES)
    for case in cases.values():
        case['kwargs'] = dict(case['kwargs'], code_axis='code')
    return cases


CASES = _cases()


@pytest.fixture(scope='module')
def code_world():
    """Every case on two ('code',) ranks and on one process."""
    names = list(CASES)
    ranks = td.run_world(td.tp_cases_body, world=WORLD, axes=('code',),
                         cases=[CASES[n] for n in names])
    return {n: dict(ranks=[r[i] for r in ranks], one=td.run_case(CASES[n])) for i, n in enumerate(names)}


def _leaves(out):
    """The arrays of a module's outputs (tuples of per-scale or per-group
    arrays flattened)."""
    if isinstance(out, (list, tuple)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [np.asarray(out)]


def assert_matches_unsharded(res, atol=2e-6, grad_atol=1e-6):
    """The ranks held their rows, agree with each other bit for bit, and
    match the one process: indices exact, the rest to atol."""
    r0, r1 = res['ranks']
    one = res['one']
    assert r0['sharded_rows'] and r1['sharded_rows']
    for s, (a, b, c) in enumerate(zip(one['steps'], r0['steps'], r1['steps'])):
        for i, (oa, ob, oc) in enumerate(zip(_leaves(a['out']), _leaves(b['out']), _leaves(c['out']))):
            np.testing.assert_array_equal(ob, oc, err_msg=f'step {s} output {i}: the ranks differ')
            if np.issubdtype(oa.dtype, np.integer):
                np.testing.assert_array_equal(oa, ob, err_msg=f'step {s} indices')
            else:
                np.testing.assert_allclose(ob, oa, rtol=0, atol=atol, err_msg=f'step {s} output {i}')
        if a['x_grad'] is not None:
            np.testing.assert_allclose(b['x_grad'], a['x_grad'], rtol=0, atol=atol, err_msg=f'step {s} x.grad')
        if a['decoded'] is not None:
            np.testing.assert_array_equal(b['decoded'], b['out'][0], err_msg='the decode round trip')
            np.testing.assert_array_equal(b['decoded'], a['decoded'], err_msg='the decode against unsharded')
    for key, value in one['state'].items():
        np.testing.assert_allclose(np.asarray(r0['state'][key], np.float64), np.asarray(value, np.float64),
                                   rtol=0, atol=atol, err_msg=key)
    assert sorted(one['grads']) == sorted(r0['grads'])
    for key, value in one['grads'].items():
        np.testing.assert_allclose(r0['grads'][key], value, rtol=0, atol=grad_atol, err_msg=f'grad {key}')


def _jax_sharded_steps(kw, xs, tables=None):
    """JAX's VectorQuantize(code_axis='code') on two CPU devices, 3 training
    steps: per step (quantized, indices, loss), and the final state."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ('code',))
    vq = vqtpu.VectorQuantize(dim=DIM, codebook_size=CODES, code_axis='code', rngs=nnx.Rngs(0), **kw)
    graphdef, state = nnx.split(vq)
    specs = jcodebook_pspecs(state, vq)

    def body(state, batch):
        m = nnx.merge(graphdef, state)
        q, ind, loss = m(batch)
        _, new_state = nnx.split(m)
        return new_state, q, ind, loss

    saved = (jkmeans.masked_sample_indices, jcodebook.masked_sample_indices)
    if tables is not None:
        jkmeans.masked_sample_indices = jcodebook.masked_sample_indices = \
            lambda key, n, mask, num: jnp.asarray(tables[(n, num)], jnp.int32)
    try:
        step = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(specs, P()),
                                     out_specs=(specs, P(), P(), P()), check_vma=False))
        outs = []
        for x in xs:
            state, q, ind, loss = step(state, jnp.asarray(x))
            outs.append((np.asarray(q), np.asarray(ind), float(loss)))
    finally:
        jkmeans.masked_sample_indices, jcodebook.masked_sample_indices = saved
    return outs, jax_state(nnx.merge(graphdef, state))


@pytest.mark.parametrize('name', list(JAX_CASES))
def test_code_sharded_matches_unsharded_and_jax(code_world, name):
    """Two-rank row-sharded VectorQuantize, three EMA training steps (with
    the backward), against the port on one process and against JAX's
    sharded run on two devices."""
    res = code_world[name]
    assert_matches_unsharded(res)
    kw = JAX_CASES[name]
    outs, jstate = _jax_sharded_steps(kw, XS, TABLES if 'index_tables' in CASES[name] else None)
    metric = 'cosine' if kw.get('use_cosine_sim') else 'euclidean'
    heads = kw.get('heads', 1)
    for s, ((qj, ij, lj), step) in enumerate(zip(outs, res['ranks'][0]['steps'])):
        q, idx, loss = step['out']
        one = res['one']['steps'][s]
        embed = one['embed_used']                                  # (h, c, d)
        x = XS[s].reshape(-1, heads, embed.shape[-1]).transpose(1, 0, 2)
        if metric == 'cosine':
            x = x / np.linalg.norm(x, axis=-1, keepdims=True)
        assert_indices_tie_equal(x, embed, metric, ij.reshape(-1, heads).T, idx.reshape(-1, heads).T)
        if np.array_equal(ij, idx):
            np.testing.assert_allclose(q, qj, rtol=0, atol=2e-5, err_msg=f'step {s} quantize')
            np.testing.assert_allclose(loss, lj, rtol=1e-5, atol=2e-5, err_msg=f'step {s} loss')
    torch_state = res['ranks'][0]['state']
    for key in ('embed', 'embed_avg', 'cluster_size'):
        np.testing.assert_allclose(torch_state[f'_codebook.{key}'], jstate['_codebook'][key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize('name', list(GRAD_CASES))
def test_code_sharded_gradients_match_unsharded(code_world, name):
    """Learnable rows, the orthogonal loss (all codes, active codes) and the
    distance path's differentiable consumers: outputs, x.grad and the
    codebook's gradient (gathered from the ranks' rows) match one process."""
    assert_matches_unsharded(code_world[name])
    if name.startswith(('learnable', 'ortho')):
        assert '_codebook.embed' in code_world[name]['ranks'][0]['grads']


@pytest.mark.parametrize('name', list(MODULE_CASES))
def test_code_sharded_modules_match_unsharded(code_world, name):
    """SimVQ (its transform's gradient psum'd over the code axis),
    ResidualVQ, QINCo (forward, gradient, decode), ResidualSimVQ, the bf16
    tier (bit-equal to unsharded), decode round trips, and code_axis
    through RandomProjectionQuantizer, HierarchicalVQ and
    GroupedResidualVQ."""
    res = code_world[name]
    exact = name.startswith('bf16') or name.endswith('decode')
    assert_matches_unsharded(res, atol=0 if exact else 2e-6)


def test_simvq_and_qinco_declare_partial_gradients():
    simvq = vqtpu_torch.SimVQ(dim=DIM, codebook_size=CODES, code_axis='code', device='cpu')
    assert find_code_partial_grad_paths(simvq) == [('code_transform', 'code')]
    assert codebook_pspecs(simvq) == {'frozen_codebook': 2}
    qinco = vqtpu_torch.ResidualVQ(dim=16, num_quantizers=3, codebook_size=32, implicit_neural_codebook=True,
                                   code_axis='code', device='cpu')
    assert find_code_partial_grad_paths(qinco) == [('mlps', 'code')]
    assert len(codebook_pspecs(qinco)) == 3 * 5
    plain = vqtpu_torch.ResidualVQ(dim=16, num_quantizers=3, codebook_size=32, code_axis='code', device='cpu')
    assert find_code_partial_grad_paths(plain) == []


def test_orthogonal_reg_max_codes_excluded_with_code_axis():
    with pytest.raises(ValueError, match='orthogonal_reg_max_codes'):
        vqtpu_torch.VectorQuantize(dim=DIM, codebook_size=CODES, code_axis='code', orthogonal_reg_weight=1.0,
                                   orthogonal_reg_max_codes=16, device='cpu')
    with pytest.raises(AssertionError):
        vqtpu.VectorQuantize(dim=DIM, codebook_size=CODES, code_axis='code', orthogonal_reg_weight=1.0,
                             orthogonal_reg_max_codes=16, rngs=nnx.Rngs(0))


@pytest.mark.parametrize('world', [2, 4, 8])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_sharded_gather_codes_bit_parity(world, dtype):
    """The sharded lookup over `world` simulated shards in one process (each
    shard's rows with its dump row, summed as the psum sums them): rows
    bit-equal to the codebook's, float32 and bfloat16."""
    e = torch.from_numpy(rng.standard_normal((CODES, DIM), dtype=np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, CODES, (7, 9))).to(torch.int32)
    c_local = CODES // world
    rows = sum(_RowGather.apply(e[r * c_local:(r + 1) * c_local], local_or_dump(idx.reshape(-1), c_local,
                                                                                r * c_local)).float()
               for r in range(world))
    np.testing.assert_array_equal(rows.to(dtype).reshape(7, 9, DIM).float().numpy(), e[idx.long()].float().numpy())


@pytest.mark.parametrize('world', [2, 4, 8])
def test_winner_reduction_over_simulated_shards(world):
    """The shards' (best score, local index) pairs reduced as
    `_global_winner_index` reduces them, over `world` simulated shards:
    indices equal the unsharded plain selection's (a column's score does not
    depend on the shard on this CPU's BLAS either; duplicated rows across
    shards resolve to the lowest global index)."""
    x = torch.from_numpy(rng.standard_normal((300, DIM), dtype=np.float32))
    e = torch.from_numpy(rng.standard_normal((CODES, DIM), dtype=np.float32))
    e[CODES - 1] = e[0]                               # a tie across the first and last shard
    x[:5] = e[0]
    bias = selection_bias(e, 'euclidean')
    want, best = nearest_code_plain(x, e, bias, return_best=True)
    c_local = CODES // world
    parts = [nearest_code_plain(x, e[r * c_local:(r + 1) * c_local], bias[r * c_local:(r + 1) * c_local], True)
             for r in range(world)]
    scores = torch.stack([p[1] for p in parts])
    top = scores.max(0).values
    win = (scores == top).int().argmax(0)
    got = torch.stack([p[0] for p in parts]).gather(0, win[None])[0] + win * c_local
    assert_indices_tie_equal(x[None].numpy(), e[None].numpy(), 'euclidean', want[None].numpy(), got[None].numpy())
    assert torch.equal(got[:5], torch.zeros(5, dtype=got.dtype))


# -- the (2, 2) ('data', 'code') world -----------------------------------------------

X2D = [rng.standard_normal((16, 8, DIM), dtype=np.float32) for _ in range(STEPS)]
AE_XS = [rng.standard_normal((32, 4, 8), dtype=np.float32) for _ in range(5)]
CASES_2D = {
    'plain': dict(cls='VectorQuantize', kwargs=dict(dim=DIM, codebook_size=CODES, sync_axis='data',
                                                     code_axis='code'), xs=X2D),
    'kmeans-expiry': dict(cls='VectorQuantize', kwargs=dict(dim=DIM, codebook_size=CODES, sync_axis='data',
                                                             code_axis='code', kmeans_init=True, kmeans_iters=3,
                                                             threshold_ema_dead_code=0.5), xs=X2D),
}


@pytest.fixture(scope='module')
def world_2d(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('world_2d')
    ranks = td.run_world(td.tp_trainer_body, world=4, axes=('data', 'code'), shape=(2, 2),
                         xs=AE_XS, ckpt_dir=str(tmp), cases=list(CASES_2D.values()))
    one = td.run_case(dict(CASES_2D['plain'], kwargs=dict(dim=DIM, codebook_size=CODES)))
    return ranks, one


def test_2d_mesh_dp_tp_parity_vs_unsharded(world_2d):
    """A (data=2, code=2) mesh, statistics psum'd over data and rows sharded
    over code, against one process over the whole batch: plain EMA indices
    exact and state to 2e-6 over 3 steps; with kmeans init and expiry the
    state stays finite and the four ranks agree."""
    ranks, one = world_2d
    for s, step in enumerate(one['steps']):
        idx = np.concatenate([ranks[0]['cases'][0]['steps'][s]['out'][1], ranks[2]['cases'][0]['steps'][s]['out'][1]])
        np.testing.assert_array_equal(idx, step['out'][1], err_msg=f'step {s}')
    for key, value in one['state'].items():
        np.testing.assert_allclose(np.asarray(ranks[0]['cases'][0]['state'][key], np.float64),
                                   np.asarray(value, np.float64), rtol=0, atol=2e-6, err_msg=key)
    health = [r['cases'][1]['state'] for r in ranks]
    assert all(r['cases'][1]['sharded_rows'] for r in ranks)
    cs = health[0]['_codebook.cluster_size']
    assert np.isfinite(cs).all() and cs.sum() > 0 and health[0]['_codebook.embed'].shape == (1, CODES, DIM)
    for other in health[1:]:
        for key, value in health[0].items():
            np.testing.assert_array_equal(value, other[key], err_msg=key)


def test_tp_trainer_2d_mesh_converges_and_stays_replicated(world_2d):
    """TensorParallelTrainer, kmeans init and expiry on sharded rows: the
    loss halves over 15 Adam steps, the data replicas of each code shard
    hold bit-identical rows, every rank holds 128 of the 256 rows."""
    ranks, _ = world_2d
    for r in ranks:
        conv = r['converge']
        assert conv['losses'][-1] < conv['losses'][0] * 0.5, conv['losses']
        assert conv['replicated'] and conv['initted'] and conv['rows'] == 128
    assert all(r['converge']['losses'] == ranks[0]['converge']['losses'] for r in ranks)


def test_tp_trainer_learnable_codebook(world_2d):
    """A learnable codebook's rows train sharded: the loss falls, the rows
    move, and Adam's moments hold the rank's 128 rows."""
    ranks, _ = world_2d
    for r in ranks:
        learn = r['learnable']
        assert learn['losses'][-1] < learn['losses'][0] and learn['moved']
        assert (1, 128, 32) in [tuple(s) for s in learn['moment_rows']]


def test_tp_checkpoint_resume_trajectory(world_2d):
    """A checkpoint of the sharded model (gathered over code, written by rank
    0) holds the full codebook and restores into a model at rest; a fresh
    trainer from it continues the trajectory bit for bit (SGD, the expiry
    generator carried across)."""
    ranks, _ = world_2d
    for r in ranks:
        res = r['resume']
        assert res['checkpoint_rows'] == 256
        assert res['a'][3:] == res['b'], (res['a'], res['b'])
        assert res['state_equal']


def test_tp_decode_round_trip(world_2d):
    """tp_apply of the eval forward and decode on a model at rest: the
    decode equals the quantized output, both equal the unsharded eval, and
    the model is at rest again after the call."""
    ranks, _ = world_2d
    for r in ranks:
        assert r['decode']['round_trip'] and r['decode']['equal_unsharded'] and r['decode']['at_rest'] == 256


ENGINE_STEPS = 20


def test_sharded_vq_engine_matches_jax_over_20_steps(world_2d):
    """The sharded_vq engine (sharded_quantize, sharded_ema_update) on the
    (2, 2) mesh for 20 EMA steps against JAX's on a (2, 2) device mesh:
    indices by the near-tie rule, the state to rtol 1e-5, atol 1e-5, and
    the quantization error falls."""
    ranks, _ = world_2d
    eng = [r['engine'] for r in ranks]
    xs, embed0 = td.ENGINE_INPUTS
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ('data', 'code'))

    def step(state, x):
        idx, q = jsharded_quantize(x, state.embed, 'code')
        return jsharded_ema_update(state, x, idx, code_axis='code', data_axis='data', decay=0.9), idx, q

    from vqtpu.parallel import init_sharded_codebook
    spec_state = type(init_sharded_codebook(jnp.zeros((2, 2))))(P('code'), P('code'), P('code'))
    run = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(spec_state, P('data')),
                                out_specs=(spec_state, P('data'), P('data')), check_vma=False))
    state = init_sharded_codebook(jnp.asarray(embed0))
    for s, x in enumerate(xs):
        used = np.asarray(state.embed)
        state, jidx, _ = run(state, jnp.asarray(x))
        tidx = np.concatenate([eng[0]['idx'][s], eng[2]['idx'][s]])
        assert_indices_tie_equal(x[None], used[None], 'euclidean', np.asarray(jidx)[None], tidx[None])
    for key in ('embed', 'embed_avg', 'cluster_size'):
        np.testing.assert_allclose(eng[0]['state'][key], np.asarray(getattr(state, key)), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    err = eng[0]['errors']
    assert err[-1] < err[0], err
