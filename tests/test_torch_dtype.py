"""The port's modules on bf16 and fp16 inputs against the JAX package's, on
the CPU, from the same state (load_vqtpu_state).

The JAX package promotes a low-precision input where it first meets an f32
weight (a projection, a rotation, a convolution, the random projections,
BinaryMapper's code table) and quantizes in f32; the port casts there to the
weight's dtype. Each case drives both packages with the same kwargs on the
same seeded numpy input, rounded once to bf16 or fp16 (the two roundings are
checked equal), in eval and in one training forward; the port also takes
the backward of that training forward. Held:

  - every output's dtype is the one the JAX package returns;
  - values: an f32 output within rtol 1e-5, atol 1e-5 of JAX's (from the
    promotion on both packages run the same f32 operations, in other
    orders); a bf16 or fp16 output within one ulp of its dtype (rtol and
    atol its eps: the two packages may round the last f32 value apart).
    SimVQ's rotation-trick forward in training is a known rounding edge: both
    packages compute it from the low-precision tokens' norms and directions,
    and the result lies within about one eps of the input dtype times the
    row's norm of the row (0.0146 apart in bf16). There each package is held
    within 2 eps |row| of the codebook row, and the two within 4 eps |row|.
    A token whose index differs (below) may move its own values;
  - indices by the rules of the module tests: a codebook's picks, per call,
    by the float64 tie rule on the port's own input
    (`torch_parity.assert_indices_tie_equal`); scalar quantizers' (LFQ, FSQ,
    FSP, LatentQuantize and their composites) equal but on edge tokens,
    whose port index moves when the input moves by 1e-6 of its magnitude
    (plus 1e-6), and at most 1% of all differ (a bf16 residual lands exactly
    on an edge, 0 for LFQ, more often than an f32 one, and both packages
    compute it exactly there); QINCo's (selections on per-token codebooks)
    equal; BinaryMapper's bits equal but where a
    bit's float64 probability lies within 2^-7 of its threshold: torch and
    XLA may round a bf16 sigmoid to either side (for logit 0.00735, 0.5 and
    0.5039);
  - after a training step, every float tensor of the port's state within
    rtol 1e-5, atol 1e-5 of JAX's (loaded into a copy of the port module);
    the input gradient has the input's dtype and is finite.

HierarchicalVQ is held in bf16 only, as the JAX package's tests hold it,
from the random codebook (kmeans init is tests/test_torch_hierarchical_vq.py's).
Expiry rows, FSP's uniforms and BinaryMapper's Bernoulli bits are injected
as in tests/test_torch_hierarchical_vq.py, tests/test_torch_fsp.py and
tests/test_torch_binary_mapper.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu
import vqtpu.codebook.codebook as jcodebook
import vqtpu_torch
import vqtpu_torch.codebook.codebook as tcodebook
import vqtpu_torch.core.sampling as tsampling
from vqtpu_torch import load_vqtpu_state

from torch_parity import assert_indices_tie_equal, jax_state, one_torch_thread  # noqa: F401  (autouse)

DTYPES = {'bf16': (jnp.bfloat16, torch.bfloat16), 'fp16': (jnp.float16, torch.float16)}
F32_TOL = dict(rtol=1e-5, atol=1e-5)
MAX_EDGE_SHARE = 1e-2
EDGE_REL = 1e-6

# name -> (class name in both packages, kwargs, input shape, index rule)
MODULES = {
    'LFQ': ('LFQ', dict(dim=16, codebook_size=256), (2, 32, 16), 'scalar'),
    'ResidualLFQ': ('ResidualLFQ', dict(dim=16, codebook_size=256, num_quantizers=2), (2, 32, 16), 'scalar'),
    'GroupedResidualLFQ': ('GroupedResidualLFQ', dict(dim=16, codebook_size=256, num_quantizers=2, groups=2),
                           (2, 32, 16), 'scalar'),
    'FSQ': ('FSQ', dict(levels=[8, 5, 5], dim=16), (2, 32, 16), 'scalar'),
    'ResidualFSQ': ('ResidualFSQ', dict(dim=16, levels=[8, 5, 5], num_quantizers=2), (2, 32, 16), 'scalar'),
    # no projection: eval takes the fused chain ('on') or the loop ('off')
    'ResidualFSQ_fused_on': ('ResidualFSQ', dict(dim=3, levels=[8, 5, 5], num_quantizers=3, eval_fused='on'),
                             (2, 32, 3), 'scalar'),
    'ResidualFSQ_fused_off': ('ResidualFSQ', dict(dim=3, levels=[8, 5, 5], num_quantizers=3, eval_fused='off'),
                              (2, 32, 3), 'scalar'),
    'GroupedResidualFSQ': ('GroupedResidualFSQ', dict(dim=16, levels=[8, 5, 5], num_quantizers=2, groups=2),
                           (2, 32, 16), 'scalar'),
    'FSP': ('FSP', dict(levels=[8, 5, 5], dim=16), (2, 32, 16), 'scalar'),
    'LatentQuantize': ('LatentQuantize', dict(levels=[5, 5, 8], dim=16), (2, 16, 32), 'scalar'),
    'ResidualVQ': ('ResidualVQ', dict(dim=16, codebook_size=32, num_quantizers=2, codebook_dim=8),
                   (2, 32, 16), 'codebook'),
    'GroupedResidualVQ': ('GroupedResidualVQ', dict(dim=16, codebook_size=32, num_quantizers=2, groups=2,
                                                    codebook_dim=4), (2, 32, 16), 'codebook'),
    # QINCo's MLP takes the bf16 condition; its layers select on per-token codebooks
    'ResidualVQ_qinco': ('ResidualVQ', dict(dim=16, codebook_size=32, num_quantizers=3,
                                            implicit_neural_codebook=True), (2, 8, 16), 'exact'),
    'RPQ': ('RandomProjectionQuantizer', dict(dim=16, codebook_size=32, codebook_dim=8, num_codebooks=2),
            (2, 32, 16), 'codebook'),
    'HierarchicalVQ': ('HierarchicalVQ', dict(dim=8, codebook_size=16, scales=(1, 2, 4), accept_image_fmap=True,
                                              kmeans_init=False), (3, 8, 4, 4), 'codebook'),
    'BinaryMapper': ('BinaryMapper', dict(bits=4), (3, 10, 4), 'bits'),
    # these two ran before the repair; they are held here as well
    'VectorQuantize': ('VectorQuantize', dict(dim=16, codebook_size=32, codebook_dim=8), (2, 32, 16), 'codebook'),
    'SimVQ': ('SimVQ', dict(dim=16, codebook_size=32), (2, 32, 16), 'simvq'),
}

CASES = [(name, dt, mode) for name in MODULES for dt in DTYPES for mode in ('eval', 'train')
         if not (name == 'HierarchicalVQ' and dt == 'fp16')]


def _u(shape):
    return np.random.default_rng(7).random(tuple(shape), dtype=np.float32)


@pytest.fixture
def injected(monkeypatch):
    """Expiry takes the same rows in both packages, the n-th
    uniform draw of either is numpy's draw n (FSP's perturbation), and the
    Bernoulli bits are u < p for the same numpy uniforms u."""
    def rows(n, num):
        return np.random.default_rng(100 + n).integers(0, n, num)

    monkeypatch.setattr(jcodebook, 'masked_sample_vectors',
                        lambda key, s, mask, num: jnp.take(s, rows(s.shape[0], num), axis=0))
    monkeypatch.setattr(tcodebook, 'masked_sample_vectors',
                        lambda gen, s, mask, num: s[torch.from_numpy(rows(s.shape[0], num))])
    draws = {'jax': 0, 'torch': 0}

    def uniform(side, shape):
        draws[side] += 1
        return np.random.default_rng(1000 + draws[side]).random(tuple(shape), dtype=np.float32)

    monkeypatch.setattr(jax.random, 'uniform', lambda key, shape=(), dtype=jnp.float32, *a, **k:
                        jnp.asarray(uniform('jax', shape), dtype))
    monkeypatch.setattr(tsampling, 'uniform_noise', lambda gen, shape, dtype=torch.float32, device=None:
                        torch.from_numpy(uniform('torch', shape)).to(dtype))
    monkeypatch.setattr(jax.random, 'bernoulli', lambda key, p, *a, **k: jnp.asarray(_u(p.shape)) < p)
    monkeypatch.setattr(tsampling, 'bernoulli', lambda gen, prob: torch.from_numpy(_u(prob.shape)) < prob)


def _pair(name):
    cls, kw = MODULES[name][:2]
    jm = getattr(vqtpu, cls)(**kw, rngs=nnx.Rngs(0))
    tm = getattr(vqtpu_torch, cls)(**kw, device='cpu')
    load_vqtpu_state(tm, jax_state(jm))
    return jm, tm


def _call(m, x, name):
    return m(x, return_indices=True) if name == 'BinaryMapper' else m(x)


def _leaves(out):
    """The arrays of a module's output in a fixed order (dicts by key)."""
    if out is None:
        return []
    if isinstance(out, dict):
        return [leaf for key in sorted(out) for leaf in _leaves(out[key])]
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


def _record_codebook_calls(tm, monkeypatch):
    """Each Codebook call of either package, in order: the port's (h, N, d)
    f32 input, the codebook it met and its (h, N) picks; JAX's picks."""
    port, jax_picks = [], []

    def pre(module, args, kwargs):
        x = args[0].detach().float()
        x = x[None] if x.ndim < 4 else x
        port.append([x.reshape(x.shape[0], -1, x.shape[-1]), module.embed.detach().clone(), None,
                     'cosine' if module.use_cosine_sim else 'euclidean'])

    def post(module, args, kwargs, out):
        port[-1][2] = out[1].reshape(port[-1][1].shape[0], -1)

    handles = []
    for m in tm.modules():
        if isinstance(m, tcodebook.Codebook):
            handles.append(m.register_forward_pre_hook(pre, with_kwargs=True))
            handles.append(m.register_forward_hook(post, with_kwargs=True))
    call = jcodebook.Codebook.__call__

    def recording_call(self, *args, **kwargs):
        out = call(self, *args, **kwargs)
        jax_picks.append(np.asarray(out[1]))
        return out
    monkeypatch.setattr(jcodebook.Codebook, '__call__', recording_call)
    return port, jax_picks, handles


def _edge_entries(tm_before, x32, name, t_idx):
    """Per index array, True where the port's index moves when the f32 input
    moves by EDGE_REL of its magnitude (plus EDGE_REL) either way, in eval
    (no draw; these modules pick the same indices in either mode)."""
    moved = [np.zeros(i.shape, bool) for i in t_idx]
    step = EDGE_REL * (x32.abs() + 1.0)
    for sign in (1.0, -1.0):
        m = copy.deepcopy(tm_before).eval()
        with torch.no_grad():
            out = _leaves(_call(m, x32 + sign * step, name))
        idx = [o.numpy() for o in out if not o.dtype.is_floating_point]
        moved = [mv | (a != b) for mv, a, b in zip(moved, idx, t_idx)]
    return moved


def _bit_edges(tm, x32, idx_shape):
    """(...,) True where some bit's float64 probability lies within 2^-7 of
    its threshold: 0.5 when deterministic, else the injected uniform."""
    p = torch.sigmoid(x32.double()).numpy()
    deterministic = tm.deterministic_on_eval and not tm.training
    threshold = 0.5 if deterministic else _u(p.shape)
    return (np.abs(p - threshold) <= 2 ** -7).any(-1).reshape(idx_shape)


@pytest.mark.parametrize('name,dt,mode', CASES)
def test_low_precision_input_matches_jax(name, dt, mode, injected, monkeypatch):
    jdtype, tdtype = DTYPES[dt]
    rule, shape = MODULES[name][3], MODULES[name][2]
    train = mode == 'train'
    jm, tm = _pair(name)
    jm.train() if train else jm.eval()
    tm.train(train)
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal(shape, dtype=np.float32) * (2.0 if rule == 'bits' else 1.0)
    jx = jnp.asarray(x).astype(jdtype)
    tx = torch.from_numpy(x).to(tdtype)
    np.testing.assert_array_equal(np.asarray(jx.astype(jnp.float32)), tx.float().numpy())
    x32 = tx.float()

    tm_before = copy.deepcopy(tm)
    calls = _record_codebook_calls(tm, monkeypatch) if rule == 'codebook' else None
    j_out = _leaves(_call(jm, jx, name))
    tx.requires_grad_(train)
    t_out = _leaves(_call(tm, tx, name))
    if calls is not None:
        for h in calls[2]:
            h.remove()

    assert len(j_out) == len(t_out)
    for j, t in zip(j_out, t_out):
        assert str(t.dtype).replace('torch.', '') == str(j.dtype), (name, t.dtype, j.dtype)
        assert tuple(t.shape) == tuple(j.shape)
    t_idx = [t.numpy() for t in t_out if not t.dtype.is_floating_point]
    j_idx = [np.asarray(j) for j in j_out if not jnp.issubdtype(j.dtype, jnp.floating)]

    # indices
    differ = [a != b for a, b in zip(t_idx, j_idx)]
    if rule == 'codebook':
        port, jax_picks = calls[:2]
        assert len(port) == len(jax_picks) > 0
        for (xin, embed, picks, metric), jpicks in zip(port, jax_picks):
            assert_indices_tie_equal(xin, embed, metric, jpicks, picks)
    elif rule == 'exact':
        assert not any(d.any() for d in differ)
    elif rule == 'simvq':
        with torch.no_grad():
            embed = tm_before.codebook[None]
        assert_indices_tie_equal(x32.reshape(1, -1, shape[-1]), embed, 'euclidean', j_idx[0], t_idx[0])
    else:
        if rule == 'scalar':
            edges = _edge_entries(tm_before, x32, name, t_idx)
        else:
            edges = [_bit_edges(tm, x32, t_idx[0].shape)] * len(t_idx)
        for d, edge in zip(differ, edges):
            edge = np.broadcast_to(edge, d.shape)
            assert not (d & ~edge).any(), f'{int((d & ~edge).sum())} indices differ off an edge'
            assert d.sum() <= max(1, MAX_EDGE_SHARE * d.size), (int(d.sum()), d.size)

    # values: a token whose index differs may move its own values
    n_differ = sum(int(d.sum()) for d in differ)
    for j, t in zip(j_out, t_out):
        if not t.dtype.is_floating_point:
            continue
        eps = 0.0 if t.dtype == torch.float32 else torch.finfo(t.dtype).eps
        tol = dict(rtol=max(F32_TOL['rtol'], eps), atol=max(F32_TOL['atol'], eps))
        j = np.asarray(j.astype(jnp.float32))
        t = t.detach().float().numpy()
        if name == 'SimVQ' and train and t.ndim == len(shape):
            with torch.no_grad():
                rows = tm_before.codebook[torch.from_numpy(t_idx[0]).long()].numpy()
            bound = torch.finfo(tdtype).eps * np.linalg.norm(rows, axis=-1, keepdims=True)
            assert (np.abs(t - rows) <= 2 * bound).all() and (np.abs(j - rows) <= 2 * bound).all()
            assert (np.abs(t - j) <= 4 * bound).all()
        elif n_differ == 0:
            np.testing.assert_allclose(t, j, **tol, err_msg=name)
        else:
            per_token = max(t.size // t_idx[0].size, 1)
            assert (~np.isclose(t, j, **tol)).sum() <= n_differ * per_token
    if not train:
        return
    # the port's backward, and the state after the step
    floats = [t for t in t_out if t.dtype.is_floating_point and t.requires_grad]
    if floats:
        g = np.random.default_rng(1)
        loss = sum((t.float() * torch.from_numpy(g.standard_normal(tuple(t.shape), dtype=np.float32))).sum()
                   for t in floats)
        loss.backward()
        assert tx.grad is not None and tx.grad.dtype == tdtype and torch.isfinite(tx.grad).all()
    want = copy.deepcopy(tm_before)
    load_vqtpu_state(want, jax_state(jm))
    got = dict(tm.state_dict())
    for key, value in want.state_dict().items():
        if value.dtype.is_floating_point:
            np.testing.assert_allclose(got[key].float().numpy(), value.float().numpy(), **F32_TOL, err_msg=key)
