"""Group parallelism compiled whole (`group_parallel_forward(compiled=True)`,
`group_parallel_output_from_indices(compiled=True)`), on the CPU, as the JAX
package jits its shard_map'd group-parallel forward and decode; and the
repair of `update_state=False` (F4), which left each rank's own members
with the state their forward wrote.

One world of four gloo ranks (tests/torch_dist.py::gp_compile_body) runs
every case on its ('group',) mesh of 4 or on a ('data', 'group') (2, 2)
mesh, with the `aot_eager` backend and a recording backend that keeps the
captured graphs. Each case builds three twins from one torch seed or one
JAX state: the compiled call, the eager call (`compiled=None`, eager on the
CPU) and the serial module.

Tolerances, as tests/test_torch_group_parallel.py's: the compiled call
against the eager one and the serial loop bit-identical (outputs, x.grad,
states, decodes); with the batch split over 'data' the indices exact and
the rest within 1e-6 of serial; against JAX every group's layer indices by
the float64 near-tie rule, quantized to atol 2e-5, FSQ's indices exactly
and its values to 1e-6, LFQ's indices exactly and its losses to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import torch_dist as td
import vqtpu
import vqtpu_torch
from test_torch_group_parallel import MASK, STATE, VQ_KW, X, X4, X8, X_STEPS, _case, _ce_indices, _jvq
from vqtpu.parallel import group_parallel_forward as jgroup_parallel_forward
from vqtpu.parallel import make_mesh as jmake_mesh
from vqtpu_torch import load_vqtpu_state
from vqtpu_torch.parallel import group as tgroup

from torch_parity import assert_indices_tie_equal, jax_state, one_torch_thread  # noqa: F401  (autouse)

G = np.random.default_rng(22).standard_normal(X.shape, dtype=np.float32)
FSQ_KW = dict(dim=8, groups=2, num_quantizers=2, levels=[8, 5, 5, 3])
LFQ_KW = dict(dim=8, groups=2, num_quantizers=2, codebook_size=16)
FSQ_STATE = jax_state(vqtpu.GroupedResidualFSQ(rngs=nnx.Rngs(7), **FSQ_KW))
LFQ_STATE = jax_state(vqtpu.GroupedResidualLFQ(rngs=nnx.Rngs(7), **LFQ_KW))
CASES = dict([
    # F4 first: a training call without update_state, then two with it,
    # the first on the same input; x takes its gradient
    _case('f4-grad', state=STATE, xs=[X, *X_STEPS], update=[False, True, True], gs=[G] * 3),
    _case('eval-all-codes', state=STATE, xs=X_STEPS, train=False, mesh='2d', call=dict(return_all_codes=True),
          decode=True),
    _case('dropout', kwargs=dict(VQ_KW, quantize_dropout=True), xs=[X, X, X]),
    _case('ce', state=STATE, indices=_ce_indices()),
    _case('fsq', cls='GroupedResidualFSQ', kwargs=FSQ_KW, state=FSQ_STATE, xs=[X8], train=False, mesh='2d',
          decode=True),
    _case('lfq-mask', cls='GroupedResidualLFQ', kwargs=LFQ_KW, state=LFQ_STATE, xs=[X8], mesh='2d', mask=MASK),
    _case('vq-2d-data', kwargs=dict(VQ_KW, groups=2, sync_axis='data'), ser_kwargs=dict(VQ_KW, groups=2),
          xs=[X4], mesh='2d', data_axis='data'),
])


@pytest.fixture(scope='module')
def world():
    names = list(CASES)
    ranks = td.run_world(td.gp_compile_body, world=4, axes=('group',), cases=[CASES[n] for n in names],
                         many_keys=dict(kwargs=dict(FSQ_KW, groups=4), x=X8))
    return {n: [r[i] for r in ranks] for i, n in enumerate([*names, 'many-keys'])}


def _flat(t):
    if isinstance(t, (list, tuple)):
        return [leaf for x in t for leaf in _flat(x)]
    return [np.asarray(t)]


def _assert_equal(got, want, at):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), at
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f'{at} output {i}')


def _assert_states_equal(got, want, at):
    assert sorted(got) == sorted(want), at
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=f'{at} {key}')


@pytest.mark.parametrize('name', [n for n in CASES if 'data_axis' not in CASES[n]])
def test_compiled_equals_eager_and_serial(world, name):
    """Every step of the case: the compiled call's outputs, x.grad and
    state after it bit-identical to the eager call's, and (on a step that
    writes its state) to the serial module's; the decodes the same."""
    for rank, res in enumerate(world[name]):
        for s, step in enumerate(res['steps']):
            at = f'{name} rank {rank} step {s}'
            others = [step['eager']] + ([step['ser']] if 'ser' in step else [])
            for other in others:
                _assert_equal(step['compiled']['out'], other['out'], at)
                _assert_states_equal(step['compiled']['state'], other['state'], at)
                if other['x_grad'] is not None:
                    np.testing.assert_array_equal(step['compiled']['x_grad'], other['x_grad'], err_msg=f'{at} x.grad')
        if res['decoded'] is not None:
            for decoded in res['decoded']['compiled']:
                for want in (res['decoded']['eager'], res['decoded']['ser']):
                    np.testing.assert_array_equal(decoded, want, err_msg=f'{name} rank {rank} decode')


@pytest.mark.parametrize('name', list(CASES))
def test_one_graph_per_cache_key(world, name):
    """The compiled forward captures its graph (and its backward's, with a
    gradient) on its first call and none on the calls after it with the
    same key, whatever update_state; the decode one graph for two calls.
    The eager twin (`compiled=None` on the CPU) caches nothing."""
    for res in world[name]:
        captured = [len(step['graphs']) for step in res['steps']]
        assert captured == [2 if CASES[name].get('gs') else 1] + [0] * (len(captured) - 1), captured
        decodes = 1 if CASES[name].get('decode') else 0
        assert res['n_graphs'] == captured[0] + decodes
        assert res['cached'] == 1 + decodes, res['cached']


def test_more_keys_than_dynamos_recompile_limit(world):
    """More keys than Dynamo keeps graphs of one code object, in one process
    and without a reset: every key's call compiles (fullgraph raises past
    the limit) and equals the eager call, each body on a code object of
    its own with one graph."""
    for res in world['many-keys']:
        assert res['equal'] == [True] * (torch._dynamo.config.recompile_limit + 1)
        assert res['graphs'] == [1] * len(res['equal'])


def test_f4_update_state_false_leaves_every_rank_as_before(world):
    """F4: a training call with update_state=False leaves every rank's
    state_dict bit-equal to before the call, compiled and eager, as JAX's
    group_parallel_forward(update_state=False) leaves its module from the
    same state; its outputs equal those of the update_state=True call on
    the same input from the same state (the next step), and the serial
    module's."""
    par = _jvq()
    par.train()
    jgroup_parallel_forward(par, jnp.asarray(X), jmake_mesh(('group',), (4,), jax.devices()[:4]),
                            update_state=False)
    jax_after = vqtpu_torch.GroupedResidualVQ(**VQ_KW, device='cpu')
    load_vqtpu_state(jax_after, jax_state(par))
    jax_after = td.np_tree(dict(jax_after.state_dict()))
    for rank, res in enumerate(world['f4-grad']):
        kept, written = res['steps'][:2]
        for name in ('compiled', 'eager'):
            _assert_states_equal(kept[name]['state'], res['before'], f'rank {rank} {name}')
            _assert_states_equal(kept[name]['state'], jax_after, f'rank {rank} {name} against JAX')
            _assert_equal(kept[name]['out'], written[name]['out'], f'rank {rank} {name} against update_state=True')
            np.testing.assert_array_equal(kept[name]['x_grad'], written[name]['x_grad'])
        _assert_equal(kept['compiled']['out'], written['ser']['out'], f'rank {rank} against serial')
        # the call with update_state=True does write: the EMA moved
        assert any(not np.array_equal(written['compiled']['state'][k], v) for k, v in res['before'].items())


def test_x_grad_psum_in_the_backward_graph(world):
    """x requires grad: the forward graph holds the member's selection, one
    op a layer, and gathers its quantized slice over 'group'; the backward
    graph sums x's cotangent over it (psum_in_bwd); x.grad equals eager's
    and the serial module's (the first test)."""
    fwd, bwd = world['f4-grad'][0]['steps'][0]['graphs']
    dpg = VQ_KW['dim'] // VQ_KW['groups']
    assert len(fwd.get('vqtpu::quantize_lookup', [])) == VQ_KW['num_quantizers'], fwd
    assert (1, *X.shape[:-1], dpg) in fwd.get('_c10d_functional::all_gather_into_tensor', []), fwd
    assert X.shape in bwd.get('_c10d_functional::all_reduce', []), bwd
    assert np.abs(world['f4-grad'][0]['steps'][0]['compiled']['x_grad']).max() > 0


def test_eval_all_codes_and_decode_match_jax(world):
    """Eval with return_all_codes on the (2, 2) mesh's group axis, compiled,
    against JAX's group_parallel_forward on its (2, 2) device mesh: each
    group's layer indices by the near-tie rule on the layer's input,
    quantized to 2e-5; the compiled decode equals the quantized output."""
    par = _jvq()
    par.eval()
    jmesh = jmake_mesh(('data', 'group'), (2, 2), jax.devices()[:4])
    res = world['eval-all-codes'][0]
    dpg = VQ_KW['dim'] // VQ_KW['groups']
    for s, x in enumerate(X_STEPS):
        q_j, ind_j, _, _ = jgroup_parallel_forward(par, jnp.asarray(x), jmesh, return_all_codes=True)
        q, ind, _, codes = res['steps'][s]['compiled']['out']
        np.testing.assert_allclose(q, np.asarray(q_j), rtol=0, atol=2e-5)
        for g in range(VQ_KW['groups']):
            residual = x[..., g * dpg:(g + 1) * dpg].reshape(-1, dpg)
            for layer in range(VQ_KW['num_quantizers']):
                embed = STATE['rvqs'][g]['layers'][layer]['_codebook']['embed']
                assert_indices_tie_equal(residual[None], embed, 'euclidean',
                                         np.asarray(ind_j[g])[..., layer].reshape(1, -1),
                                         ind[g][..., layer].reshape(1, -1))
                residual = residual - codes[g][layer].reshape(-1, dpg)
    for decoded in res['decoded']['compiled']:
        np.testing.assert_array_equal(decoded, res['steps'][-1]['compiled']['out'][0])


def test_dropout_shared_index_compiled(world):
    """quantize_dropout: the index drawn outside the graph from the first
    member's stream, an input of the one graph; three steps bit-identical
    to serial (the first test), the -1 slots included."""
    steps = world['dropout'][0]['steps']
    assert any((s['compiled']['out'][1] == -1).any() for s in steps)


def test_fsq_compiled_matches_jax(world):
    """GroupedResidualFSQ eval compiled on the (2, 2) mesh: JAX's serial
    forward's indices exactly, its values to 1e-6."""
    jfsq = vqtpu.GroupedResidualFSQ(rngs=nnx.Rngs(7), **FSQ_KW)
    jfsq.eval()
    q_j, ind_j = jfsq(jnp.asarray(X8))
    q, ind = world['fsq'][0]['steps'][0]['compiled']['out']
    np.testing.assert_array_equal(ind, np.asarray(ind_j))
    np.testing.assert_allclose(q, np.asarray(q_j), rtol=0, atol=1e-6)


def test_lfq_mask_compiled_matches_jax(world):
    """GroupedResidualLFQ in training with a mask, compiled: JAX's indices
    (sign bits), its losses to rtol 1e-5."""
    jlfq = vqtpu.GroupedResidualLFQ(rngs=nnx.Rngs(7), **LFQ_KW)
    jlfq.train()
    _, ind_j, loss_j = jlfq(jnp.asarray(X8), mask=jnp.asarray(MASK))
    _, ind, loss = world['lfq-mask'][0]['steps'][0]['compiled']['out']
    np.testing.assert_array_equal(ind, np.asarray(ind_j))
    np.testing.assert_allclose(loss, np.asarray(loss_j), rtol=1e-5, atol=1e-6)


def test_2d_data_group_compiled(world):
    """('data', 'group') with the batch over 'data' and the statistics
    psum'd over it inside the graph: bit-identical to the eager call;
    against the serial module on the whole batch the indices exact, the
    rest within 1e-6."""
    for rank, res in enumerate(world['vq-2d-data']):
        step = res['steps'][0]
        _assert_equal(step['compiled']['out'], step['eager']['out'], f'rank {rank}')
        _assert_states_equal(step['compiled']['state'], step['eager']['state'], f'rank {rank}')
        data_index = rank // 2
        q, ind, loss = step['compiled']['out']
        qs, inds, losses = step['ser']['out']
        np.testing.assert_array_equal(ind, inds[:, data_index * 2:(data_index + 1) * 2])
        np.testing.assert_allclose(q, qs[data_index * 2:(data_index + 1) * 2], rtol=0, atol=1e-6)
        np.testing.assert_allclose(loss, losses, rtol=0, atol=1e-6)
        for key, value in step['ser']['state'].items():
            np.testing.assert_allclose(step['compiled']['state'][key], value, rtol=0, atol=1e-6, err_msg=key)


def test_compiled_defaults_to_the_card(monkeypatch):
    """compiled=None runs the plain body for a module on the CPU and a
    cached compiled one for a module on the card (`shard._on_card`); a
    second call with the same key reuses the cached body."""
    module = vqtpu_torch.GroupedResidualVQ(**VQ_KW, device='cpu')
    monkeypatch.setattr(tgroup, '_GP_CACHE', {})
    built = []

    def build():
        built.append(1)
        return lambda *args: None
    key = ('fwd', 'mesh')
    assert tgroup._body(key, build, module, None, 'aot_eager') is not None and not tgroup._GP_CACHE
    monkeypatch.setattr(tgroup, '_on_card', lambda m: True)
    first = tgroup._body(key, build, module, None, 'aot_eager')
    assert tgroup._body(key, build, module, None, 'aot_eager') is first
    assert list(tgroup._GP_CACHE) == [(*key, 'aot_eager')] and len(built) == 2
    assert tgroup._body(key, build, module, False, 'aot_eager') is not first
