"""The tensor-parallel step compiled whole (`TensorParallelTrainer(
compiled=True)`), on the CPU, as the JAX package jits its shard_map'd step.

One world of four gloo ranks on a (2, 2) ('data', 'code') mesh
(tests/torch_dist.py::tp_compile_body) runs every case under
`torch.compile(..., fullgraph=True)` with the `aot_eager` backend and a
recording backend that keeps the captured graphs. Each compiled trainer
steps beside an eager twin (`compiled=False`) from the same state:

  - (a) AEModel (Linear, VectorQuantize(sync_axis='data', code_axis='code')
    with kmeans init and dead-code expiry, Linear), SGD, 3 steps: the data
    replicas of each code shard bit-identical, the model's and the
    optimizer's state within 1e-5 of each entry's largest, the indices by
    the float64 tie rule on the whole codebook; at most two graphs (kmeans
    init, then the steps after it), each holding the all_reduce nodes of
    the gradient pmean over 'data', of the selection's winner reduction
    over 'code' and of the loss pmean, and the ops `vqtpu::nearest_code_best`
    and `vqtpu::code_sums`, no argmax standing in for them;
  - (b) a learnable codebook with Adam: the codebook's rows and Adam's
    moments hold the rank's rows;
  - (c) a SimVQ with `code_axis`, whose transform's partial gradients are
    psum'd over 'code' in the graph;
  - (d) the dryrun's code-sharded ResidualVQ (`entry.TPRVQModel`)
    compiled, held to JAX's TensorParallelTrainer from the same state and
    batch with tests/test_torch_entry.py's tolerances (loss rtol 1e-5, the
    state within 1e-5 of its largest entry) and to its eager twin;
  - (e) `compiled=None` runs eagerly on the CPU and compiles for a model
    on the card;
  - (f) `tp_apply(compiled=True)` of VectorQuantize(dim=32,
    codebook_size=256, sync_axis='data', code_axis='code') loaded from a
    JAX state at rest, beside its eager call (`compiled=None`) and JAX's
    jitted tp_apply on a (2, 2) device mesh from the same state: the eval
    forward and decode over three batches (one graph, holding
    `vqtpu::nearest_code_best` and the winner reduction's all_reduce, no
    argmax), a `mutates_state=True` training forward, and the restore of a
    non-mutating one. Tolerances as tests/test_torch_tp.py's: against eager
    bit-identical (outputs, the state after), against JAX the indices by
    the float64 tie rule on the whole codebook, the rows bit-equal to
    codebook rows, the EMA state to rtol 1e-5, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import torch_dist as td
import vqtpu
from test_torch_entry import JaxTPRVQModel, _close_to_largest, _jax_codebooks, _jax_recon_plus_aux, _numpy_tree
from torch_parity import assert_indices_tie_equal, jax_state, one_torch_thread  # noqa: F401  (autouse)
from vqtpu_torch.parallel import Mesh, TensorParallelTrainer
from vqtpu_torch.parallel import tp as ttp

WORLD = 4
MESH = (('data', 'code'), (2, 2))
REL = 1e-5
STEPS = 3
AE_SHAPE = (4, 16, 8)
# the AEModel cases: its VectorQuantize's kwargs and the optimizer
AE_CASES = {
    'kmeans_expiry': (dict(kmeans_init=True, kmeans_iters=3, threshold_ema_dead_code=2), 'sgd'),
    'learnable_adam': (dict(learnable_codebook=True, ema_update=False), 'adam'),
}


@pytest.fixture(scope='module')
def world():
    """JAX's TensorParallelTrainer step of the code-sharded ResidualVQ in
    this process; every port case in one 4-rank world."""
    from vqtpu.parallel import TensorParallelTrainer as JaxTensorParallelTrainer

    rng = np.random.default_rng(21)
    rvq_batch = rng.standard_normal((4 * WORLD, 4, 8), dtype=np.float32)
    rvq = JaxTPRVQModel(nnx.Rngs(0), WORLD)
    rvq_state = _numpy_tree(nnx.state(rvq))
    devices = np.array(jax.devices()[:WORLD]).reshape(MESH[1])
    rvq_loss = JaxTensorParallelTrainer(rvq, optax.adamw(3e-4), _jax_recon_plus_aux,
                                        JaxMesh(devices, MESH[0])).step(jnp.asarray(rvq_batch))
    jax_side = dict(loss=float(rvq_loss), codebooks=_jax_codebooks([rvq.rvq]), after=_numpy_tree(nnx.state(rvq)))

    xs = [np.random.default_rng(s).standard_normal(AE_SHAPE, dtype=np.float32) for s in range(STEPS)]
    cases = {name: ('steps', dict(model='ae', kwargs=kw, opt=opt, xs=xs)) for name, (kw, opt) in AE_CASES.items()}
    cases['simvq'] = ('steps', dict(model='simvq', kwargs={}, opt='sgd', xs=xs))
    cases['rvq'] = ('rvq', dict(state=rvq_state, batch=rvq_batch))
    cases['tp_apply'] = ('tp_apply', dict(state=jax_state(_jax_apply_vq()), xs=TP_APPLY_XS))
    ranks = td.run_world(td.tp_compile_body, world=WORLD, axes=MESH[0], shape=MESH[1], cases=cases)
    return dict(jax=jax_side, ranks=ranks)


TP_APPLY_XS = [np.random.default_rng(40 + s).standard_normal((4, 16, 32), dtype=np.float32) for s in range(3)]


def _jax_apply_vq():
    return vqtpu.VectorQuantize(dim=32, codebook_size=256, sync_axis='data', code_axis='code', rngs=nnx.Rngs(0))


def _jax_tp_apply(fn, x, train: bool, mutates_state: bool = False):
    """JAX's tp_apply of `fn` on the (2, 2) ('data', 'code') device mesh,
    the batch over 'data': its outputs and the module's state after."""
    from vqtpu.parallel import tp_apply as jtp_apply

    vq = _jax_apply_vq()
    vq.train() if train else vq.eval()
    mesh = JaxMesh(np.array(jax.devices()[:WORLD]).reshape(MESH[1]), MESH[0])
    out = jtp_apply(vq, mesh, fn, jnp.asarray(x), in_specs=P('data'), out_specs=P('data'),
                    mutates_state=mutates_state)
    return [np.asarray(o) for o in out], jax_state(vq)


def _ops(graph: dict, name: str) -> list:
    return graph.get(f'_c10d_functional::{name}', [])


def _code_replicas(ranks):
    """The pairs of ranks that hold the same code shard: rank r sits at
    ('data', 'code') = divmod(r, 2)."""
    return [(ranks[c], ranks[2 + c]) for c in range(MESH[1][1])]


def _held_to_eager(r, s):
    """Step s of one rank: the compiled losses and state against the
    eager twin's."""
    np.testing.assert_allclose(r['loss'][0], r['loss'][1], rtol=REL)
    for key, want in r['eager'].items():
        got = r['compiled'][key]
        assert got.shape == want.shape, (s, key)
        if np.issubdtype(want.dtype, np.floating):
            _close_to_largest(got, want, REL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f'step {s} {key}')


@pytest.mark.parametrize('case', list(AE_CASES))
def test_ae_steps_compiled_match_eager(world, case):
    ranks = [out[case] for out in world['ranks']]
    n_params = ranks[0][-1]['n_params']
    kmeans = AE_CASES[case][0].get('kmeans_init', False)
    d, c = 32, 256
    for s in range(STEPS):
        for a, b in _code_replicas(ranks):
            assert a[s]['loss'][0] == b[s]['loss'][0], s
            for key, v in a[s]['compiled'].items():
                np.testing.assert_array_equal(v, b[s]['compiled'][key], err_msg=f'step {s} {key} data replicas')
        for r in ranks:
            _held_to_eager(r[s], s)
            assert_indices_tie_equal(r[s]['x_in'].reshape(1, -1, d), r[s]['embed_used'], 'euclidean',
                                     r[s]['idx'][0], r[s]['idx'][1])
            assert r[s]['embed_used'].shape == (1, c, d)
        # the codebook's rows: the rank's
        assert ranks[0][s]['compiled']['model.vq._codebook.embed'].shape == (1, c // MESH[1][1], d)

        # one graph for the first step, one for the steps after it (the
        # codebook's host mirror of its `initted` flag, set by the first
        # forward), with or without kmeans init
        graphs = ranks[0][s]['graphs']
        assert len(graphs) == (1 if s < 2 else 0), (s, len(graphs))
        for g in graphs:
            reduced = _ops(g, 'all_reduce')
            tokens = AE_SHAPE[0] // MESH[1][0] * AE_SHAPE[1]
            # the gradient pmean over 'data', the loss pmean
            assert (n_params,) in reduced and () in reduced, (s, reduced)
            # the winner reduction over 'code': pmax of the scores, pmin of
            # the ranks holding them, psum of the winner's index
            assert reduced.count((tokens,)) >= 3, (s, reduced)
            assert len(_ops(g, 'wait_tensor')) == len(reduced) + len(_ops(g, 'all_gather_into_tensor'))
            assert len(g.get('vqtpu::nearest_code_best', [])) == 1, g
            assert g.get('vqtpu::code_sums'), g
            assert len(g.get('vqtpu::kmeans', [])) == (1 if kmeans and s == 0 else 0), g
            assert 'aten::argmax' not in g, g


def test_ae_kmeans_expiry_reaches_the_sharded_draw(world):
    r = world['ranks'][0]['kmeans_expiry']
    sizes = [r[s]['compiled']['model.vq._codebook.cluster_size'] for s in range(STEPS)]
    threshold = AE_CASES['kmeans_expiry'][0]['threshold_ema_dead_code']
    assert any(int((cs == threshold).sum()) for cs in sizes), 'no code expired: the step would not draw'


def test_learnable_codebook_moments_hold_the_rank_rows(world):
    for out in world['ranks']:
        r = out['learnable_adam']
        c_local = 256 // MESH[1][1]
        assert (1, c_local, 32) in r[-1]['moment_shapes'], r[-1]['moment_shapes']
        assert (1, 256, 32) not in r[-1]['moment_shapes']
        embed = [k for k in r[-1]['compiled'] if k.startswith('opt.') and k.endswith('exp_avg')
                 and r[-1]['compiled'][k].shape == (1, c_local, 32)]
        assert embed and np.abs(r[-1]['compiled'][embed[0]]).max() > 0


def test_simvq_partial_grads_psum_in_the_graph(world):
    ranks = [out['simvq'] for out in world['ranks']]
    n_partial = ranks[0][-1]['n_partial']
    for s in range(STEPS):
        for a, b in _code_replicas(ranks):
            for key, v in a[s]['compiled'].items():
                np.testing.assert_array_equal(v, b[s]['compiled'][key], err_msg=f'step {s} {key} data replicas')
        for r in ranks:
            _held_to_eager(r[s], s)
            np.testing.assert_array_equal(r[s]['idx'][0], r[s]['idx'][1])
    # the transform's weight is replicated: every rank holds the same after the psum
    key = 'model.sim.code_transform.weight'
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[-1]['compiled'][key], ranks[0][-1]['compiled'][key])
    (g,) = ranks[0][0]['graphs']
    assert (n_partial,) in _ops(g, 'all_reduce'), (n_partial, _ops(g, 'all_reduce'))
    assert len(g.get('vqtpu::nearest_code_best', [])) == 1 and 'aten::argmax' not in g, g


def test_rvq_compiled_step_matches_jax(world):
    """The dryrun's code-sharded ResidualVQ, compiled, against JAX's
    TensorParallelTrainer from the same state: the loss, every codebook and
    the whole state after the step."""
    import vqtpu_torch.entry as tentry
    from vqtpu_torch import load_vqtpu_state

    jax_side = world['jax']
    ranks = [out['rvq'] for out in world['ranks']]
    r0 = ranks[0]
    np.testing.assert_allclose(r0['loss'][0], jax_side['loss'], rtol=REL, atol=0)
    np.testing.assert_allclose(r0['loss'][0], r0['loss'][1], rtol=REL, atol=0)
    assert len(r0['codebooks']) == len(jax_side['codebooks']) == 2
    for got, want in zip(r0['codebooks'], jax_side['codebooks']):
        for k in want:
            assert got[k].shape == want[k].shape, k
            _close_to_largest(got[k], want[k], REL)
    model = tentry.TPRVQModel(16 * WORLD, 'cpu')
    load_vqtpu_state(model, jax_side['after'])
    for k, w in model.state_dict().items():
        for other in (w.numpy(), r0['eager'][k]):
            if w.is_floating_point():
                _close_to_largest(r0['compiled'][k], other, REL)
            else:
                np.testing.assert_array_equal(r0['compiled'][k], other, err_msg=k)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r['compiled'][k], r0['compiled'][k], err_msg=f'{k} ranks')
    (g,) = r0['graphs']
    n_params = sum(p.numel() for p in model.parameters())
    assert (n_params,) in _ops(g, 'all_reduce') and () in _ops(g, 'all_reduce'), g
    assert len(g.get('vqtpu::nearest_code_best', [])) == 2 and 'aten::argmax' not in g, g


def test_compiled_defaults_to_the_card(monkeypatch):
    """compiled=None runs eagerly for a model on the CPU and compiles for
    one on the card (`shard._on_card`), checked at construction."""
    mesh = Mesh(MESH[0], (1, 1), {'data': None, 'code': None}, (0, 0))

    def trainer(**kw):
        model = td.AEModel(sync_axis='data', code_axis='code')
        return TensorParallelTrainer(model, torch.optim.SGD(model.parameters(), lr=0.1), td.ae_loss, mesh, **kw)
    assert not trainer().compiled
    assert trainer(compiled=True).compiled
    monkeypatch.setattr(ttp, '_on_card', lambda model: True)
    assert trainer().compiled
    assert not trainer(compiled=False).compiled


def _jax_eval_decode(m, z):
    q, ind, _ = m(z)
    return q, ind, m.get_output_from_indices(ind)


def _jax_train_forward(m, z):
    q, ind, _ = m(z)        # the loss is a scalar: no 'data' blocks
    return q, ind


def _rank_blocks(ranks, key, i):
    """Output i of `key` of every data rank (ranks 0 and 2), in data
    order: the global batch's."""
    return np.concatenate([ranks[r][key][i] for r in (0, 2)])


def test_tp_apply_eval_decode_compiled(world):
    """Three eval calls of one module-level fn: one graph, captured by the
    first, with the sharded selection's op and the winner reduction's
    all_reduce and no argmax; each call bit-identical to the eager call,
    its rows bit-equal to codebook rows and to the decode, its indices
    JAX's by the float64 tie rule; the model at rest after it."""
    ranks = [out['tp_apply']['eval'] for out in world['ranks']]
    embed = jax_state(_jax_apply_vq())['_codebook']['embed']            # (1, 256, 32)
    for s, x in enumerate(TP_APPLY_XS):
        for r in ranks:
            call = r['calls'][s]
            for got, want in zip(call['compiled'], call['eager']):
                np.testing.assert_array_equal(got, want, err_msg=f'call {s}')
            q, idx, dec = call['compiled']
            np.testing.assert_array_equal(q, embed[0][idx.astype(np.int64)])
            np.testing.assert_array_equal(dec, q)
            assert len(call['graphs']) == (1 if s == 0 else 0), (s, len(call['graphs']))
        (jq, jidx, jdec), _ = _jax_tp_apply(_jax_eval_decode, x, train=False)
        idx = np.concatenate([ranks[r]['calls'][s]['compiled'][1] for r in (0, 2)])
        assert_indices_tie_equal(x.reshape(1, -1, 32), embed, 'euclidean', jidx.reshape(1, -1), idx.reshape(1, -1))
    (g,) = ranks[0]['calls'][0]['graphs']
    tokens = TP_APPLY_XS[0].shape[0] // MESH[1][0] * TP_APPLY_XS[0].shape[1]
    assert len(g.get('vqtpu::nearest_code_best', [])) == 1 and 'aten::argmax' not in g, g
    assert _ops(g, 'all_reduce').count((tokens,)) >= 3, _ops(g, 'all_reduce')
    for r in ranks:
        assert r['cached'] == 1 and r['rows_at_rest'] == 256


def test_tp_apply_mutating_training_forward_compiled(world):
    """A training forward with mutates_state=True, compiled: its outputs and
    the state it leaves (gathered back to full rows) bit-identical to the
    eager call's, the data replicas of a code shard alike, the statistics'
    psums in the graph; against JAX's mutating tp_apply the indices by the
    tie rule and the EMA state to rtol 1e-5, atol 1e-5."""
    ranks = [out['tp_apply']['mutating'] for out in world['ranks']]
    for r in ranks:
        for got, want in zip(r['compiled'], r['eager']):
            np.testing.assert_array_equal(got, want)
        for key, want in r['state_eager'].items():
            np.testing.assert_array_equal(r['state_compiled'][key], want, err_msg=key)
            np.testing.assert_array_equal(r['state_compiled'][key], ranks[0]['state_compiled'][key], err_msg=key)
        assert r['state_compiled']['_codebook.embed'].shape == (1, 256, 32)
    (g,) = ranks[0]['graphs']
    assert len(g.get('vqtpu::nearest_code_best', [])) == 1 and 'aten::argmax' not in g, g
    # the statistics' psums over 'data' and 'code'
    assert len(_ops(g, 'all_reduce')) >= 5, _ops(g, 'all_reduce')
    x = TP_APPLY_XS[0]
    (jq, jidx), jstate = _jax_tp_apply(_jax_train_forward, x, train=True, mutates_state=True)
    embed = jax_state(_jax_apply_vq())['_codebook']['embed']
    assert_indices_tie_equal(x.reshape(1, -1, 32), embed, 'euclidean', jidx.reshape(1, -1),
                             _rank_blocks(ranks, 'compiled', 1).reshape(1, -1))
    for key in ('embed', 'embed_avg', 'cluster_size'):
        np.testing.assert_allclose(ranks[0]['state_compiled'][f'_codebook.{key}'], jstate['_codebook'][key],
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_tp_apply_restores_a_non_mutating_call(world):
    """The same training forward without mutates_state, compiled: every
    parameter and buffer (the random stream's state among them) bit-equal
    to before the call, the codebook at rest, and the outputs those of the
    mutating call from the same state."""
    for out in world['ranks']:
        r = out['tp_apply']['restore']
        assert sorted(r['after']) == sorted(r['before'])
        for key, want in r['before'].items():
            np.testing.assert_array_equal(r['after'][key], want, err_msg=key)
        for got, want in zip(r['out'], out['tp_apply']['mutating']['compiled']):
            np.testing.assert_array_equal(got, want)


def test_tp_apply_more_keys_than_dynamos_recompile_limit(world):
    """One `fn` under more keys than Dynamo keeps graphs of one code object,
    in one process and without a reset (the decode with recompile_limit + 1
    backends): every call compiles (fullgraph raises past the limit) and
    equals the eager decode, each body on a code object of its own with
    one graph."""
    for out in world['ranks']:
        r = out['tp_apply']['many_keys']
        assert r['equal'] == [True] * (torch._dynamo.config.recompile_limit + 1)
        assert r['graphs'] == [1] * len(r['equal'])
