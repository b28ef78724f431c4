"""The port's group-parallel Grouped composites
(vqtpu_torch.parallel.group_parallel_forward) against the port's serial
loop and against the JAX package's group_parallel_forward, on the CPU.
Mirrors tests/test_group_parallel.py.

One gloo world of four ranks (tests/torch_dist.py::gp_body) runs
every case: on its ('group',) mesh of 4 (one member a rank) or on a
('data', 'group') (2, 2) mesh (two members a rank, with or without the
batch split over 'data'). Each rank runs the parallel module and its serial
twin (the same torch seed, or the same JAX state) on the same input.

Tolerances: against the serial loop, which runs the same member forwards on
the same inputs, outputs, indices, losses and states are bit-identical;
with the batch split over 'data' the members psum their statistics, so
indices are exact and the rest within 1e-6 (the psum adds the halves' sums
in another order), as in the JAX test. Against JAX: every group's layer
indices by the float64 near-tie rule on that layer's input (XLA scores
-cdist^2, the port x.e - |e|^2/2), quantized outputs to atol 2e-5 (2e-6
in the JAX test between its jit and eager runs; the frameworks' f32
residual sums round apart), FSQ's indices exactly and its values to 1e-6,
LFQ's indices exactly (sign bits) and its losses to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import nnx

import torch_dist as td
import vqtpu
from vqtpu.parallel import group_parallel_forward as jgroup_parallel_forward
from vqtpu.parallel import make_mesh as jmake_mesh

from torch_parity import assert_indices_tie_equal, jax_state, one_torch_thread  # noqa: F401  (autouse)

VQ_KW = dict(dim=16, groups=4, num_quantizers=3, codebook_size=32)
rng = np.random.default_rng(3)
X = rng.standard_normal((2, 24, 16), dtype=np.float32)
X_STEPS = [X, X + np.float32(0.1)]
X4 = rng.standard_normal((4, 24, 16), dtype=np.float32)
X_IMG = rng.standard_normal((2, 16, 4, 4), dtype=np.float32)
X8 = rng.standard_normal((2, 16, 8), dtype=np.float32)
MASK = np.arange(16)[None, :] < np.array([16, 9])[:, None]
HALF = rng.standard_normal((2, 64, 8), dtype=np.float32)


def _jvq(**kw):
    return vqtpu.GroupedResidualVQ(rngs=nnx.Rngs(7), **{**VQ_KW, **kw})


def _case(name, cls='GroupedResidualVQ', kwargs=None, state=None, xs=(X,), train=True, mesh='group', **extra):
    kwargs = dict(VQ_KW) if kwargs is None else kwargs
    return name, dict(cls=cls, par_kwargs=kwargs, ser_kwargs=extra.pop('ser_kwargs', kwargs), state=state,
                      xs=list(xs), train=train, mesh=mesh, **extra)


def _ce_indices():
    """Each group's indices of JAX's eval forward on X, for the CE path."""
    m = _jvq()
    m.eval()
    _, ind, _ = m(jnp.asarray(X))
    return [np.asarray(ind[g]) for g in range(VQ_KW['groups'])]


STATE = jax_state(_jvq())
CASES = dict([
    _case('vq-train-g1', state=STATE, xs=X_STEPS),
    _case('vq-eval-g1', state=STATE, xs=X_STEPS, train=False),
    _case('vq-train-g2', state=STATE, xs=X_STEPS, mesh='2d'),
    _case('vq-eval-g2', state=STATE, xs=X_STEPS, train=False, mesh='2d'),
    _case('all-codes', state=STATE, train=False, call=dict(return_all_codes=True), decode=True),
    _case('dropout', kwargs=dict(VQ_KW, quantize_dropout=True), xs=[X, X, X]),
    _case('ce', state=STATE, indices=_ce_indices()),
    _case('fsq', cls='GroupedResidualFSQ', kwargs=dict(dim=8, groups=2, num_quantizers=2, levels=[8, 5, 5, 3]),
          xs=[X8], train=False, mesh='2d', decode=True,
          state=jax_state(vqtpu.GroupedResidualFSQ(rngs=nnx.Rngs(7), dim=8, groups=2, num_quantizers=2,
                                                   levels=[8, 5, 5, 3]))),
    _case('lfq-mask', cls='GroupedResidualLFQ', kwargs=dict(dim=8, groups=2, num_quantizers=2, codebook_size=16),
          xs=[X8], mesh='2d', mask=MASK,
          state=jax_state(vqtpu.GroupedResidualLFQ(rngs=nnx.Rngs(7), dim=8, groups=2, num_quantizers=2,
                                                   codebook_size=16))),
    _case('vq-2d-data', kwargs=dict(VQ_KW, groups=2, sync_axis='data'), ser_kwargs=dict(VQ_KW, groups=2),
          xs=[X4], mesh='2d', data_axis='data'),
    _case('fmap', kwargs=dict(VQ_KW, accept_image_fmap=True), xs=[X_IMG], train=False),
    _case('stochastic', kwargs=dict(dim=16, groups=2, num_quantizers=2, codebook_size=32,
                                    stochastic_sample_codes=True, sample_codebook_temp=100.0),
          xs=[np.concatenate([HALF, HALF], axis=-1)], mesh='2d'),
])


@pytest.fixture(scope='module')
def world():
    names = list(CASES)
    ranks = td.run_world(td.gp_body, world=4, axes=('group',),
                         cases=[CASES[n] for n in names])
    return {n: [r[i] for r in ranks] for i, n in enumerate(names)}


def _flat(t):
    if isinstance(t, (list, tuple)):
        return [leaf for x in t for leaf in _flat(x)]
    return [np.asarray(t)]


def assert_equals_serial(results):
    """Every rank's parallel outputs equal its serial twin's bit for bit,
    and so do the states after the call and the decodes."""
    for rank, res in enumerate(results):
        for s, step in enumerate(res['steps']):
            par, ser = _flat(step['par']), _flat(step['ser'])
            assert len(par) == len(ser)
            for i, (p, q) in enumerate(zip(par, ser)):
                np.testing.assert_array_equal(p, q, err_msg=f'rank {rank} step {s} output {i}')
        for key, value in res['ser_state'].items():
            np.testing.assert_array_equal(res['par_state'][key], value, err_msg=key)
        if res['decoded'] is not None:
            np.testing.assert_array_equal(res['decoded']['par'], res['decoded']['ser'])


@pytest.mark.parametrize('g_local', (1, 2))
@pytest.mark.parametrize('train', (True, False))
def test_vq_bit_identity(world, g_local, train):
    """Two steps of GroupedResidualVQ(dim=16, groups=4, num_quantizers=3,
    codebook_size=32), one member a rank (g_local 1) or two (g_local 2),
    in training (EMA updates) and eval: bit-identical to the serial loop,
    the state included."""
    name = f"vq-{'train' if train else 'eval'}-g{g_local}"
    assert_equals_serial(world[name])


def test_vq_all_codes_and_decode(world):
    """return_all_codes and group_parallel_output_from_indices against the
    serial loop (bit-identical) and against JAX's group_parallel_forward on
    its 4-device group mesh (each group's layer indices by the near-tie rule
    on the layer's input, quantized to 2e-5)."""
    results = world['all-codes']
    assert_equals_serial(results)
    par = _jvq()
    par.eval()
    q_j, ind_j, _, codes_j = jgroup_parallel_forward(par, jnp.asarray(X), jmake_mesh(('group',), (4,),
                                                                                     jax.devices()[:4]),
                                                     return_all_codes=True)
    q, ind, _, codes = results[0]['steps'][0]['par']
    np.testing.assert_allclose(q, np.asarray(q_j), rtol=0, atol=2e-5)
    dpg = VQ_KW['dim'] // VQ_KW['groups']
    for g in range(VQ_KW['groups']):
        residual = X[..., g * dpg:(g + 1) * dpg].reshape(-1, dpg)
        for layer in range(VQ_KW['num_quantizers']):
            embed = STATE['rvqs'][g]['layers'][layer]['_codebook']['embed']
            assert_indices_tie_equal(residual[None], embed, 'euclidean', np.asarray(ind_j[g])[..., layer].reshape(1, -1),
                                     ind[g][..., layer].reshape(1, -1))
            residual = residual - codes[g][layer].reshape(-1, dpg)
    assert len(codes) == VQ_KW['groups']


def test_vq_quantize_dropout_shared_index(world):
    """quantize_dropout: the one index drawn on every rank from the first
    member's generator, as the serial forward draws it; three steps
    bit-identical, the -1 slots included."""
    assert_equals_serial(world['dropout'])
    steps = world['dropout'][0]['steps']
    assert any((s['par'][1] == -1).any() for s in steps)


def test_vq_ce_loss_path(world):
    """indices= (the cross-entropy path): the quantized output and the sum of
    the groups' losses bit-identical to serial."""
    assert_equals_serial(world['ce'])


def test_fsq_bit_identity(world):
    """GroupedResidualFSQ on the (2, 2) mesh's group axis: bit-identical to
    serial and its decode, and to JAX's serial forward (indices exact,
    values to 1e-6)."""
    assert_equals_serial(world['fsq'])
    jfsq = vqtpu.GroupedResidualFSQ(rngs=nnx.Rngs(7), dim=8, groups=2, num_quantizers=2, levels=[8, 5, 5, 3])
    jfsq.eval()
    q_j, ind_j = jfsq(jnp.asarray(X8))
    q, ind = world['fsq'][0]['steps'][0]['par']
    np.testing.assert_array_equal(ind, np.asarray(ind_j))
    np.testing.assert_allclose(q, np.asarray(q_j), rtol=0, atol=1e-6)


def test_lfq_bit_identity_with_mask(world):
    """GroupedResidualLFQ in training with a mask: bit-identical to serial,
    and its indices equal JAX's (sign bits), its losses to rtol 1e-5."""
    assert_equals_serial(world['lfq-mask'])
    jlfq = vqtpu.GroupedResidualLFQ(rngs=nnx.Rngs(7), dim=8, groups=2, num_quantizers=2, codebook_size=16)
    jlfq.train()
    _, ind_j, loss_j = jlfq(jnp.asarray(X8), mask=jnp.asarray(MASK))
    _, ind, loss = world['lfq-mask'][0]['steps'][0]['par']
    np.testing.assert_array_equal(ind, np.asarray(ind_j))
    np.testing.assert_allclose(loss, np.asarray(loss_j), rtol=1e-5, atol=1e-6)


def test_vq_2d_data_group_mesh(world):
    """('data', 'group') (2, 2): the batch split over 'data', the members
    psum their statistics (sync_axis='data'), against the serial module
    (no sync) on the whole batch: indices exact, outputs, the pmean'd
    losses and the EMA state within 1e-6."""
    results = world['vq-2d-data']
    for rank, res in enumerate(results):
        data_index = rank // 2
        q, ind, loss = res['steps'][0]['par']
        qs, inds, losses = res['steps'][0]['ser']
        np.testing.assert_array_equal(ind, inds[:, data_index * 2:(data_index + 1) * 2])
        np.testing.assert_allclose(q, qs[data_index * 2:(data_index + 1) * 2], rtol=0, atol=1e-6)
        np.testing.assert_allclose(loss, losses, rtol=0, atol=1e-6)
        for key, value in res['ser_state'].items():
            np.testing.assert_allclose(res['par_state'][key], value, rtol=0, atol=1e-6, err_msg=key)


def test_fmap_layout(world):
    """accept_image_fmap: the groups split the channel axis; bit-identical
    to serial."""
    assert_equals_serial(world['fmap'])


def test_stochastic_streams_decorrelated(world):
    """Stochastic codes: identical features in both groups, so only the
    gumbel noise tells the groups' indices apart; each member draws from its
    own generator on its owner rank, so the groups differ, and each equals
    the serial loop's draw."""
    assert_equals_serial(world['stochastic'])
    ind = world['stochastic'][0]['steps'][0]['par'][1]
    assert not (ind[0] == ind[1]).all()
