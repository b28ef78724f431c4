"""The port's VectorQuantize eval forward (vqtpu_torch) against the JAX
module (vqtpu), on the CPU, with the JAX module's state carried over by
load_vqtpu_state.

On the CPU the JAX module selects codes with its XLA formulation
(-||x - e||^2) while the port uses the kernel's (x.e - ||e||^2/2): equal in
exact arithmetic, so indices are held to the tie rule
(torch_parity.assert_indices_tie_equal) and outputs to atol 1e-5 (f32
matmul accumulation order in the projections) where the indices agree."""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu
import vqtpu_torch
from vqtpu_torch import load_vqtpu_state
from vqtpu_torch.codebook import Codebook

from torch_parity import assert_indices_tie_equal, jax_state, one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]

# name -> (constructor kwargs, input shape, forward kwargs built from the rng)
CASES = {
    'default': (dict(dim=32, codebook_size=64), (2, 64, 32), None),
    'heads_shared': (dict(dim=32, codebook_size=64, heads=2, codebook_dim=16), (2, 48, 32), None),
    'heads_separate': (
        dict(dim=32, codebook_size=64, heads=2, codebook_dim=16, separate_codebook_per_head=True),
        (2, 48, 32), None,
    ),
    'projection': (
        dict(dim=32, codebook_size=64, codebook_dim=12, layernorm_after_project_in=True),
        (2, 40, 32), None,
    ),
    'heads_projection': (
        dict(dim=32, codebook_size=64, heads=2, codebook_dim=8, separate_codebook_per_head=True),
        (2, 40, 32), None,
    ),
    'cosine': (dict(dim=32, codebook_size=64, use_cosine_sim=True), (2, 64, 32), None),
    'xla_formulation': (dict(dim=32, codebook_size=64, use_pallas=False), (2, 64, 32), None),
    'mask': (dict(dim=32, codebook_size=64), (3, 40, 32), 'mask'),
    'lens_input_padding': (
        dict(dim=32, codebook_size=64, return_zeros_for_masked_padding=False), (3, 40, 32), 'lens',
    ),
    'channel_first_mask': (dict(dim=32, codebook_size=64, channel_last=False), (2, 32, 24), 'mask'),
    'image_fmap': (dict(dim=32, codebook_size=64, accept_image_fmap=True), (2, 32, 6, 5), None),
    'fmap_3d': (dict(dim=16, codebook_size=32, accept_3d_fmap=True), (2, 16, 2, 3, 4), None),
    'single_token': (dict(dim=32, codebook_size=64), (7, 32), None),
    'bf16_tier': (dict(dim=32, codebook_size=64, quantize_tier='bf16'), (2, 64, 32), None),
    'bf16_tier_heads': (
        dict(dim=32, codebook_size=64, heads=2, codebook_dim=16, quantize_tier='bf16'),
        (2, 48, 32), 'mask',
    ),
}


def _pair(kwargs, seed=0):
    jvq = vqtpu.VectorQuantize(**kwargs, rngs=nnx.Rngs(seed)).eval()
    tvq = vqtpu_torch.VectorQuantize(**kwargs, device='cpu').eval()
    load_vqtpu_state(tvq, jax_state(jvq))
    return jvq, tvq


def _forward_kwargs(kind, kwargs, shape, rng):
    if kind is None:
        return {}, {}
    b = shape[0]
    n = shape[1] if kwargs.get('channel_last', True) else shape[2]
    lens = rng.integers(1, n + 1, (b,))
    if kind == 'lens':
        return {'lens': jnp.asarray(lens)}, {'lens': torch.from_numpy(lens)}
    mask = np.arange(n)[None, :] < lens[:, None]
    return {'mask': jnp.asarray(mask)}, {'mask': torch.from_numpy(mask)}


def _flat_indices(tvq, idx, batch):
    """Module indices -> (H, N) in the codebook's token order."""
    h = tvq.heads
    if h == 1:
        return idx.reshape(1, -1)
    idx = idx.reshape(batch, -1, h)
    if tvq.separate_codebook_per_head:
        return idx.permute(2, 0, 1).reshape(h, -1)
    return idx.permute(0, 2, 1).reshape(1, -1)


def _codebook_space(tvq, x):
    if x.ndim == 2:
        x = x[:, None, :]
    tokens, _ = tvq._normalize_input_layout(x)
    with torch.no_grad():
        xc = tvq.codebook_input(tokens).float()
    return xc.reshape(xc.shape[0], -1, xc.shape[-1])


@pytest.mark.parametrize('case', sorted(CASES))
def test_vq_eval_matches_jax(case):
    kwargs, shape, kind = CASES[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape, dtype=np.float32)
    jkw, tkw = _forward_kwargs(kind, kwargs, shape, rng)
    jvq, tvq = _pair(kwargs)

    jq, jidx, jloss = jvq(jnp.asarray(x), **jkw)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        tq, tidx, tloss = tvq(tx, **tkw)
    jq, jidx = np.array(jq), np.array(jidx)
    assert tq.shape == jq.shape and tq.dtype == torch.float32
    assert tidx.shape == jidx.shape and tidx.dtype == torch.int32
    assert float(tloss) == float(jloss) == 0.0

    # indices by the tie rule, in the codebook space the port quantized in
    metric = 'cosine' if kwargs.get('use_cosine_sim') else 'euclidean'
    embed = tvq._codebook.embed
    xc = _codebook_space(tvq, tx)
    if kwargs.get('quantize_tier') == 'bf16':
        xc, embed = xc.bfloat16().float(), embed.bfloat16().float()
    b = shape[0]
    assert_indices_tie_equal(
        xc, embed, metric,
        _flat_indices(tvq, tidx, b), _flat_indices(tvq, torch.from_numpy(jidx), b),
    )

    # outputs: the same as JAX's where every index agrees, and in any case
    # the port's decode of its indices equals JAX's decode of them
    if np.array_equal(tidx.numpy(), jidx):
        np.testing.assert_allclose(tq.numpy(), jq, atol=1e-5, rtol=0)
    safe = torch.where(tidx >= 0, tidx, 0)
    with torch.no_grad():
        dec = tvq.get_output_from_indices(safe)
    jdec = np.asarray(jvq.get_output_from_indices(jnp.asarray(safe.numpy())))
    np.testing.assert_allclose(dec.float().numpy(), jdec.astype(np.float32), atol=1e-5, rtol=0)
    if kind is None:
        np.testing.assert_allclose(dec.float().numpy(), tq.numpy(), atol=1e-6, rtol=0)


def test_vq_mask_zeros_and_minus_one():
    jvq, tvq = _pair(dict(dim=16, codebook_size=32))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 20, 16), dtype=np.float32))
    lens = torch.tensor([20, 7])
    with torch.no_grad():
        q, idx, _ = tvq(x, lens=lens)
        q_prefix, idx_prefix, _ = tvq(x[1:, :7])
    assert (idx[1, 7:] == -1).all() and (q[1, 7:] == 0).all()
    assert torch.equal(idx[1:, :7], idx_prefix) and torch.equal(q[1:, :7], q_prefix)
    # decode counts -1 from the end of the codebook, as jnp.take does
    codes = tvq.get_codes_from_indices(torch.tensor([[-1, 0]]))
    assert torch.equal(codes[0, 0], tvq.codebook[-1])
    with pytest.raises(IndexError):
        tvq.get_codes_from_indices(torch.tensor([[32]]))
    # the codebook setter writes the codebook buffer
    tvq.codebook = torch.zeros(32, 16)
    assert (tvq._codebook.embed == 0).all()


def test_vq_return_loss_breakdown_and_bf16_input():
    _, tvq = _pair(dict(dim=16, codebook_size=32, codebook_dim=8))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 10, 16), dtype=np.float32))
    with torch.no_grad():
        q, idx, loss, breakdown = tvq(x, return_loss_breakdown=True)
        qb, idxb, _ = tvq(x.bfloat16())
    assert isinstance(breakdown, vqtpu_torch.LossBreakdown)
    assert all(float(t) == 0.0 for t in breakdown) and float(loss) == 0.0
    assert qb.dtype == torch.bfloat16 and qb.shape == q.shape


def test_vq_training_forward_not_ported():
    """The training forward is ported (tests/test_torch_vq_train.py), and so
    are the distance-materializing features (held against the JAX package
    in tests/test_torch_vq_distances.py), in both modes; the codebook
    features still to port raise and name themselves."""
    _, tvq = _pair(dict(dim=16, codebook_size=32))
    x = torch.zeros(2, 4, 16)
    for mode in ('train', 'eval'):
        getattr(tvq, mode)()
        q, idx, loss = tvq(x, topk=2)
        assert q.shape == (2, 4, 2, 16) and idx.shape == loss.shape == (2, 4, 2)
        q, ce = tvq(x, indices=torch.zeros(2, 4, dtype=torch.long))
        assert q.shape == x.shape and bool(torch.isfinite(ce))
        q, idx, _ = tvq(x, codebook_transform_fn=lambda e: e[:, None, None].expand(1, 2, 4, 32, 16))
        assert q.shape == x.shape and idx.shape == (2, 4)
    tvq.train()
    q, idx, loss = tvq(x)
    assert q.shape == x.shape and float(loss) >= 0.0

    # the learnable family is ported (tests/test_torch_vq_learnable.py);
    # the distributed codebooks still raise and name themselves
    for kwargs in (dict(learnable_codebook=True), dict(affine_param=True), dict(vq_bridge=lambda e: e),
                   dict(stat_precision='default')):
        cb = Codebook(16, 8, device='cpu', **kwargs)
        q, idx, _ = cb(torch.randn(5, 16), need_distances=False)
        assert q.shape == (5, 16) and idx.shape == (5,)
    for kwargs, feature in (
        (dict(sync_axis='data'), 'sync_axis'),
        (dict(code_axis='code'), 'code_axis'),
    ):
        with pytest.raises(NotImplementedError, match=feature):
            Codebook(16, 8, device='cpu', **kwargs)
    # the distance path of a bare codebook: distances (h, n, c) beside the
    # fast path's None, and the same indices
    cb = Codebook(16, 8, device='cpu').eval()
    z = torch.randn(3, 16)
    q_fast, i_fast, none = cb(z, need_distances=False)
    q_dist, i_dist, dist = cb(z)
    assert none is None and dist.shape == (1, 3, 8)
    assert torch.equal(i_fast, i_dist) and torch.equal(q_fast, q_dist)
    # a kmeans_init codebook initialises on its first forward, in eval too,
    # as the JAX package does (held against it in test_torch_vq_train.py)
    cb = Codebook(16, 8, kmeans_init=True, device='cpu').eval()
    cb(torch.randn(30, 16), need_distances=False)
    assert bool(cb.initted) and bool(cb.embed.abs().sum() > 0)


# the distributed features, still out of the port's slices
NOT_PORTED = ('sync_codebook', 'sync_axis', 'code_axis')


@pytest.mark.parametrize('kwargs,feature', (
    (dict(sync_codebook=True), 'sync_codebook'),
    (dict(sync_axis='data'), 'sync_axis'),
    (dict(code_axis='code'), 'code_axis'),
    (dict(vq_bridge=lambda e: e), 'vq_bridge'),
    (dict(learnable_codebook=True, ema_update=False), 'learnable_codebook'),
    (dict(affine_param=True), 'affine_param'),
    (dict(in_place_codebook_optimizer=lambda p: torch.optim.SGD(p, lr=0.1), learnable_codebook=True,
          ema_update=False), 'in_place_codebook_optimizer'),
    (dict(orthogonal_reg_weight=0.1), 'orthogonal_reg_weight'),
    (dict(directional_reparam=True, threshold_ema_dead_code=2), 'directional_reparam'),
    (dict(stat_precision='default'), 'stat_precision'),
))
def test_vq_out_of_slice_features_raise(kwargs, feature):
    """The distributed features raise and name themselves; the learnable
    family, once out of the slice, builds and trains (held against the JAX
    package in tests/test_torch_vq_learnable.py)."""
    if feature in NOT_PORTED:
        with pytest.raises(NotImplementedError, match=feature):
            vqtpu_torch.VectorQuantize(dim=16, codebook_size=8, device='cpu', **kwargs)
        return
    vq = vqtpu_torch.VectorQuantize(dim=16, codebook_size=8, device='cpu', **kwargs).train()
    x = torch.randn(2, 4, 16, requires_grad=True)
    q, idx, loss = vq(x)
    (q.sum() + loss).backward()
    assert q.shape == x.shape and idx.shape == (2, 4) and bool(torch.isfinite(x.grad).all())


def test_vq_device_defaults_to_cuda():
    if torch.cuda.is_available():
        vq = vqtpu_torch.VectorQuantize(dim=16, codebook_size=8)
        assert vq.codebook.device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            vqtpu_torch.VectorQuantize(dim=16, codebook_size=8)


def test_load_vqtpu_state_rejects_mismatches():
    jvq, tvq = _pair(dict(dim=16, codebook_size=8, codebook_dim=4))
    state = jax_state(jvq)
    assert torch.equal(tvq.project_in_linear.weight, torch.from_numpy(np.array(state['project_in_linear']['kernel'].T)))
    assert torch.equal(tvq._codebook.embed, torch.from_numpy(np.array(state['_codebook']['embed'])))
    extra = {**state, 'unknown': np.zeros(1)}
    with pytest.raises(KeyError, match='unknown'):
        load_vqtpu_state(tvq, extra)
    missing = {**state, '_codebook': {k: v for k, v in state['_codebook'].items() if k != 'cluster_size'}}
    with pytest.raises(KeyError, match='cluster_size'):
        load_vqtpu_state(tvq, missing)
    wrong = {**state, 'project_out_linear': {**state['project_out_linear'], 'bias': np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match='shape'):
        load_vqtpu_state(tvq, wrong)


def test_port_imports_neither_jax_nor_vqtpu():
    probe = (
        'import pkgutil, sys, vqtpu_torch\n'
        'for m in pkgutil.walk_packages(vqtpu_torch.__path__, "vqtpu_torch."):\n'
        '    __import__(m.name)\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vqtpu")]\n'
        'assert not bad, bad\n'
    )
    subprocess.run([sys.executable, '-c', probe], cwd=REPO, check=True, timeout=120)

    banned = ('jax', 'jaxlib', 'flax', 'optax', 'vqtpu')
    files = sorted((REPO / 'vqtpu_torch').rglob('*.py')) + [REPO / 'chip_smoke.py']
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split('.')[0] not in banned, f'{path}: imports {name}'
