"""The data-parallel step compiled whole (`DataParallelTrainer(compiled=True)`,
`eval_step_fn(compiled=True)`), on the CPU, as the JAX package jits its
shard_map'd step.

One world of two gloo ranks (tests/torch_dist.py::dp_compile_body) runs
every case under `torch.compile(..., fullgraph=True)` with the `aot_eager`
backend and a recording backend that keeps the captured graphs:

  - each named-axis collective: its value and the gradient of a weighted
    sum bit-equal to eager, its `_c10d_functional` node in the captured
    forward graph (and in the backward graph where its backward is a
    collective), and an unbound axis raising NameError from the compiled
    call; the gather as a psum of blocks among zeros (the compiled form
    over gloo on the card) bit-equal to the all_gather;
  - three VQ steps (GainVQ: a scalar gain before VectorQuantize(sync_axis=
    'data') with kmeans init and dead-code expiry, Adam) on the 'on'
    route's plain version and on 'off', against an eager twin from the
    same state: the ranks bit-identical, the model's and Adam's state
    within 1e-5 of each entry's largest, the indices by the float64 tie
    rule; two graphs (kmeans init, then the steps after it), each holding
    the psums of the statistics, the expiry pool's all_gather, the
    gradient pmean and the loss pmean, and the kernel's op with no argmax
    standing in for it. The stream draws the same bits eager and compiled
    (core.sampling), so the twins' kmeans and expiry draws agree without
    injection;
  - BASELINE config 5's step, compiled, held to JAX's DataParallelTrainer
    from the same state with the tolerances of tests/test_torch_entry.py
    (loss rtol 1e-5, every tensor of the state within 1e-5 of its largest
    entry) and to the eager step;
  - the DP LFQ step (distributed entropy) on 'off' and on the sweeps'
    plain version, against eager with tests/test_torch_parallel.py's
    tolerances: aux rtol 1e-5, the SGD update (lr times the averaged
    gradient) within 2e-5 of its largest entry, indices equal;
  - eval_step_fn compiled against eager.
"""

import numpy as np
import pytest
import torch
from flax import nnx

import torch_dist as td
from test_torch_entry import JaxConfig5Model, _close_to_largest, _jax_codebooks, _jax_recon_plus_aux, _numpy_tree
from torch_parity import assert_indices_tie_equal, one_torch_thread  # noqa: F401  (autouse)
from vqtpu_torch.parallel import DataParallelTrainer, Mesh, eval_step_fn

WORLD = 2
REL = 1e-5
VQ_KW = dict(dim=16, codebook_size=16, decay=0.8, kmeans_init=True, kmeans_iters=3, threshold_ema_dead_code=2)
VQ_SHAPE = (4, 20, 16)
VQ_STEPS = 3
VQ_ROUTES = ('on', 'off')
LFQ_ROUTES = {'off': {}, 'sweeps': dict(entropy_fused='on', entropy_chunk_size=64)}

# each collective's op in the captured forward and backward graphs
COLLECTIVE_OPS = {
    'psum': ('all_reduce', 'all_reduce'),
    'psum_exact': ('all_reduce', None),
    'psum_in_bwd': (None, 'all_reduce'),
    'pmean': ('all_reduce', 'all_reduce'),
    'all_gather': ('all_gather_into_tensor', 'all_reduce'),
    'all_gather_by_sum': ('all_reduce', 'all_reduce'),
    'all_gather_exact': ('all_gather_into_tensor', None),
    'pmax': ('all_reduce', None),
    'pmin': ('all_reduce', None),
    'axis_size': (None, None),
    'axis_index': (None, None),
    'axis_is_bound': (None, None),
}


@pytest.fixture(scope='module')
def world():
    """The JAX side of config 5 in this process, every port case in one
    2-rank world."""
    from jax.sharding import Mesh as JaxMesh
    import jax
    import jax.numpy as jnp
    import optax
    from vqtpu.parallel import DataParallelTrainer as JaxDataParallelTrainer

    rng = np.random.default_rng(20)
    c5_batch = rng.standard_normal((2 * WORLD, 4, 8), dtype=np.float32)
    c5 = JaxConfig5Model(nnx.Rngs(0))
    c5_state = _numpy_tree(nnx.state(c5))
    c5_loss = JaxDataParallelTrainer(c5, optax.adamw(3e-4), _jax_recon_plus_aux,
                                     JaxMesh(np.array(jax.devices()[:WORLD]), ('data',))).step(jnp.asarray(c5_batch))
    jax_side = dict(loss=float(c5_loss), codebooks=_jax_codebooks(c5.grvq.rvqs), after=_numpy_tree(nnx.state(c5)))

    xs = [np.random.default_rng(s).standard_normal(VQ_SHAPE, dtype=np.float32) for s in range(VQ_STEPS)]
    cases = dict(collectives=('collectives', {}),
                 **{f'vq_{r}': ('vq', dict(kwargs=dict(VQ_KW, train_fused=r), xs=xs)) for r in VQ_ROUTES},
                 config5=('config5', dict(state=c5_state, batch=c5_batch)),
                 **{f'lfq_{r}': ('lfq', dict(kwargs=kw, x=rng.standard_normal((8, 16, 8), dtype=np.float32)))
                    for r, kw in LFQ_ROUTES.items()},
                 eval=('eval', dict(x=rng.standard_normal((8, 4, 8), dtype=np.float32))))
    ranks = td.run_world(td.dp_compile_body, world=WORLD, cases=cases)
    return dict(jax=jax_side, ranks=ranks, xs=xs)


def _ops(graph: dict, name: str) -> list:
    return graph.get(f'_c10d_functional::{name}', [])


@pytest.mark.parametrize('name', list(COLLECTIVE_OPS))
def test_collective_compiles_whole(world, name):
    fw_op, bw_op = COLLECTIVE_OPS[name]
    for rank, out in enumerate(world['ranks']):
        res = out['collectives'][name]
        for key in ('value', 'grad'):
            np.testing.assert_array_equal(res['compiled'][key], res['eager'][key], err_msg=f'rank {rank} {key}')
        fw, bw = res['graphs']
        for graph, op in ((fw, fw_op), (bw, bw_op)):
            got = {k.split('::')[1] for k in graph if k.startswith('_c10d_functional::') and 'wait' not in k}
            assert got == ({op} if op else set()), (rank, graph)
            if op:
                assert len(_ops(graph, 'wait_tensor')) == len(_ops(graph, op)), graph
        if name == 'all_gather_by_sum':
            # exactly the all_gather's value and gradient
            for key in ('value', 'grad'):
                np.testing.assert_array_equal(res['compiled'][key], out['collectives']['all_gather']['eager'][key])
        if name == 'axis_is_bound':
            assert res['unbound'] is None      # False outside a mesh, no raise
        else:
            assert res['unbound'].startswith('NameError') and "unbound axis name: 'data'" in res['unbound'], res
    # the ranks' values: the collective's, not a local stand-in
    a, b = (r['collectives'][name]['compiled']['value'] for r in world['ranks'])
    if name in ('psum', 'psum_exact', 'pmean', 'all_gather', 'all_gather_by_sum', 'all_gather_exact'):
        np.testing.assert_array_equal(a, b)
    elif name in ('axis_index', 'psum_in_bwd', 'pmax', 'pmin'):
        assert not np.array_equal(a, b)


@pytest.mark.parametrize('route', VQ_ROUTES)
def test_vq_step_compiled_matches_eager(world, route):
    r0, r1 = (r[f'vq_{route}'] for r in world['ranks'])
    n_params = r0[-1]['n_params']
    expired = 0
    for s in range(VQ_STEPS):
        a, b = r0[s], r1[s]
        # the ranks are bit-identical
        assert a['loss'][0] == b['loss'][0], s
        for key, v in a['compiled'].items():
            np.testing.assert_array_equal(v, b['compiled'][key], err_msg=f'step {s} {key} ranks')
        # against the eager twin
        np.testing.assert_allclose(a['loss'][0], a['loss'][1], rtol=REL)
        for r in (a, b):
            assert_indices_tie_equal(r['x_in'].reshape(1, -1, VQ_KW['dim']), r['embed_used'], 'euclidean',
                                     r['idx'][0], r['idx'][1])
        for key, want in a['eager'].items():
            got = a['compiled'][key]
            assert got.shape == want.shape, key
            if np.issubdtype(want.dtype, np.floating):
                _close_to_largest(got, want, REL)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f'step {s} {key}')
        expired += int((a['compiled']['model.vq._codebook.cluster_size'] == VQ_KW['threshold_ema_dead_code']).sum())

        # one graph for the step with kmeans init, one for the steps after it
        graphs = a['graphs']
        assert len(graphs) == (1 if s < 2 else 0), (s, len(graphs))
        if not graphs:
            continue
        (g,) = graphs
        h, c, d = 1, VQ_KW['codebook_size'], VQ_KW['dim']
        reduced = _ops(g, 'all_reduce')
        # the statistics' psums, the gradient pmean, the loss pmean
        for shape in ((h, c), (h, c, d), (n_params,), ()):
            assert shape in reduced, (s, shape, reduced)
        assert _ops(g, 'all_gather_into_tensor'), g          # the expiry pool
        assert len(_ops(g, 'wait_tensor')) == len(reduced) + len(_ops(g, 'all_gather_into_tensor'))
        assert len(g.get('vqtpu::kmeans', [])) == (1 if s == 0 else 0), g
        kernel = 'vqtpu::fused_train' if route == 'on' else 'vqtpu::quantize_lookup'
        assert len(g.get(kernel, [])) == 1, g
        assert 'aten::argmax' not in g, g
    assert expired > 0, 'no code expired: the step would not reach the pooled draw'


def test_config5_compiled_step_matches_jax(world):
    """The compiled step against JAX's DataParallelTrainer from the same
    state: the loss, every codebook and the whole state after the step."""
    import vqtpu_torch.entry as tentry
    from vqtpu_torch import load_vqtpu_state

    jax_side = world['jax']
    r0, r1 = (r['config5'] for r in world['ranks'])
    np.testing.assert_allclose(r0['loss'][0], jax_side['loss'], rtol=REL, atol=0)
    np.testing.assert_allclose(r0['loss'][0], r0['loss'][1], rtol=REL, atol=0)
    assert len(r0['codebooks']) == len(jax_side['codebooks']) == 4
    for got, want in zip(r0['codebooks'], jax_side['codebooks']):
        for k in want:
            _close_to_largest(got[k], want[k], REL)
    model = tentry.Config5Model('cpu')
    load_vqtpu_state(model, jax_side['after'])
    for k, w in model.state_dict().items():
        for other in (w.numpy(), r0['eager'][k]):
            if w.is_floating_point():
                _close_to_largest(r0['compiled'][k], other, REL)
            else:
                np.testing.assert_array_equal(r0['compiled'][k], other, err_msg=k)
        np.testing.assert_array_equal(r0['compiled'][k], r1['compiled'][k], err_msg=f'{k} ranks')
    (g,) = r0['graphs']
    n_params = sum(p.numel() for p in model.parameters())
    assert (n_params,) in _ops(g, 'all_reduce') and () in _ops(g, 'all_reduce'), g
    # the group codebooks' statistics: 2 groups x 2 layers, bins and sums each
    assert sum(1 for shape in _ops(g, 'all_reduce') if shape == (1, 32)) == 4, g
    assert len(g.get('vqtpu::code_sums', [])) >= 1 and 'aten::argmax' not in g, g


@pytest.mark.parametrize('route', list(LFQ_ROUTES))
def test_lfq_step_compiled_matches_eager(world, route):
    for rank, out in enumerate(world['ranks']):
        r = out[f'lfq_{route}']
        np.testing.assert_allclose(r['loss'][0], r['loss'][1], rtol=REL)
        np.testing.assert_array_equal(r['idx'][0], r['idx'][1])
        for k, before in r['before'].items():
            update = before - r['eager'][k]
            scale = np.abs(update).max()
            assert scale > 0, k
            np.testing.assert_allclose(r['compiled'][k], r['eager'][k], rtol=0, atol=2e-5 * scale, err_msg=k)
        (g,) = r['graphs']
        # the batch distribution's psum, forward, and its summed cotangent, backward
        assert _ops(g, 'all_reduce').count((1, 2 ** 8)) == 2, g
        assert bool(g.get('vqtpu::lfq_entropy')) == (route == 'sweeps'), g
    a, b = (out[f'lfq_{route}']['compiled'] for out in world['ranks'])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f'{k} ranks')


def test_eval_step_fn_compiled_matches_eager(world):
    for out in world['ranks']:
        r = out['eval']
        for got, want in zip(r['compiled'], r['eager']):
            _close_to_largest(got, want, REL)
        assert len(r['graphs']) == 1 and not any(k.startswith('_c10d') for k in r['graphs'][0])


def test_compiled_defaults_to_the_card():
    """compiled=None compiles where the model is on the card and runs
    eagerly on the CPU; the step function is compiled once, at
    construction."""
    mesh = Mesh(('data',), (1,), {'data': None}, (0,))
    model = td.DPModel(sync_axis=None)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    assert not DataParallelTrainer(model, opt, td.dp_model_loss, mesh).compiled
    assert DataParallelTrainer(model, opt, td.dp_model_loss, mesh, compiled=True).compiled
    assert callable(eval_step_fn(model, mesh))
