"""The port's fused training step (vqtpu_torch.kernels.train_fused) against
the JAX package's (vqtpu.kernels.train_fused), on the CPU.

On the CPU the port's `fused_train_quantize` runs
`fused_train_quantize_plain`, the plain version of the Hopper kernel; the
JAX side runs its Pallas kernel in interpret mode, as tests/test_core.py
does. Both select with x.e + bias and a first-index argmax, so indices must
be equal; rows are bit copies of codebook rows; bins are sums of 0/1 or f32
weights (atol 1e-4, as the JAX test holds them), esum f32 sums in another
order (rtol 1e-6, atol 1e-5)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vqtpu.kernels.train_fused as jtf
import vqtpu_torch.kernels.train_fused as ttf
from vqtpu_torch.kernels.distance import selection_bias

from torch_parity import one_torch_thread  # noqa: F401  (autouse)


def _operands(shape, metric, weighted, seed=0):
    *heads, n, c, d = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*heads, n, d), dtype=np.float32)
    e = rng.standard_normal((*heads, c, d), dtype=np.float32)
    if metric == 'cosine':
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        e /= np.linalg.norm(e, axis=-1, keepdims=True)
    w = (rng.random((*heads, n)) > 0.3).astype(np.float32) if weighted else None
    return x, e, w


def _jax_fused(x, e, metric, w):
    """JAX fused_train_quantize per head (it takes one head a call)."""
    if x.ndim == 2:
        out = jtf.fused_train_quantize(jnp.asarray(x), jnp.asarray(e), metric,
                                       None if w is None else jnp.asarray(w), interpret=True)
        return [np.asarray(o) for o in out]
    outs = [_jax_fused(x[i], e[i], metric, None if w is None else w[i]) for i in range(x.shape[0])]
    return [np.stack([o[k] for o in outs]) for k in range(4)]


@pytest.mark.parametrize('weighted', (False, True), ids=('unweighted', 'weighted'))
@pytest.mark.parametrize('metric', ('euclidean', 'cosine'))
@pytest.mark.parametrize('shape', ((1024, 64, 96), (1000, 130, 100), (37, 5, 3), (3, 200, 20, 16)),
                         ids=('1024x64x96', '1000x130x100', 'ragged', 'heads'))
def test_plain_matches_jax_kernel(shape, metric, weighted):
    x, e, w = _operands(shape, metric, weighted)
    jidx, jq, jbins, jesum = _jax_fused(x, e, metric, w)
    tx, te = torch.from_numpy(x), torch.from_numpy(e)
    tw = None if w is None else torch.from_numpy(w)
    idx, q, bins, esum = ttf.fused_train_quantize(tx, te, metric, tw)

    assert idx.dtype == torch.int32 and idx.shape == x.shape[:-1]
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(q.numpy(), np.take_along_axis(e, idx.numpy()[..., None].astype(np.int64), -2)
                                  if e.ndim == 3 else e[idx.numpy()])
    np.testing.assert_allclose(bins.numpy(), jbins, atol=1e-4, rtol=0)
    np.testing.assert_allclose(esum.numpy(), jesum, rtol=1e-6, atol=1e-5)

    # the plain version is what the CPU dispatch ran, on the same bias
    plain = ttf.fused_train_quantize_plain(tx, te, selection_bias(te, metric), tw)
    for a, b in zip(plain, (idx, q, bins, esum)):
        assert torch.equal(a, b)


def test_statistics_are_the_one_hot_sums():
    # against a float64 one-hot product, including dropped-weight tokens
    x, e, w = _operands((3, 300, 17, 5), 'euclidean', True, seed=2)
    tx, te, tw = map(torch.from_numpy, (x, e, w))
    idx, _, bins, esum = ttf.fused_train_quantize(tx, te, 'euclidean', tw)
    onehot = torch.nn.functional.one_hot(idx.long(), 17).double() * tw.double()[..., None]
    np.testing.assert_allclose(bins.numpy(), onehot.sum(1).numpy(), rtol=0, atol=0)
    want = torch.einsum('hnc,hnd->hcd', onehot, tx.double())
    np.testing.assert_allclose(esum.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    b2, e2 = ttf.code_statistics_plain(tx, idx, 17, tw)
    assert torch.equal(b2, bins) and torch.equal(e2, esum)


def test_ties_go_to_the_first_code():
    x = torch.zeros(16, 8)
    idx, q, bins, esum = ttf.fused_train_quantize(x, torch.zeros(12, 8))
    assert (idx == 0).all() and bins[0] == 16 and bins[1:].sum() == 0
    base = torch.from_numpy(np.random.default_rng(1).standard_normal((40, 24), dtype=np.float32))
    idx, q, bins, _ = ttf.fused_train_quantize(base, torch.cat([base] * 4))
    assert torch.equal(idx, torch.arange(40, dtype=torch.int32))
    assert torch.equal(q, base) and torch.equal(bins[:40], torch.ones(40)) and bins[40:].sum() == 0


def _fake_library(err=0):
    calls = []

    def train(*args):
        calls.append(args)
        return err
    lib = types.SimpleNamespace(
        vqtpu_train_fused_f32=train,
        vqtpu_train_fused_scratch_floats=lambda h, n, c, d: 7,
        vqtpu_cuda_error_string=lambda code: b'invalid argument',
    )
    return lib, calls


class _NoDevice:
    def __init__(self, device):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_dispatch_and_wrapper_checks(monkeypatch):
    x, e, w = _operands((40, 10, 8), 'euclidean', True)
    tx, te, tw = map(torch.from_numpy, (x, e, w))
    before = ttf.fused_train_quantize.launches
    ttf.fused_train_quantize(tx, te, 'euclidean', tw)
    assert ttf.fused_train_quantize.launches == before        # the CPU runs the plain version
    with pytest.raises(ValueError, match='CUDA or CPU'):
        ttf.fused_train_quantize(tx.to('meta'), te.to('meta'), bias=torch.zeros(10, device='meta'))

    # what the CUDA wrapper checks before it launches; its library is faked,
    # so a CUDA-less machine runs the wrapper up to the launch
    lib, calls = _fake_library()
    monkeypatch.setattr(ttf, '_kernel_library', lambda: lib)
    monkeypatch.setattr(torch.cuda, 'device', _NoDevice)
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda dev: types.SimpleNamespace(cuda_stream=0))
    bias = selection_bias(te, 'euclidean')
    with pytest.raises(TypeError, match='float32'):
        ttf._fused_train_cuda(tx.double(), te, bias, None)
    with pytest.raises(ValueError, match='contiguous'):
        ttf._fused_train_cuda(torch.from_numpy(np.asfortranarray(x)), te, bias, None)
    with pytest.raises(TypeError, match='weights must be float32'):
        ttf._fused_train_cuda(tx, te, bias, tw.double())
    with pytest.raises(ValueError, match='weights must be contiguous'):
        ttf._fused_train_cuda(tx, te, bias, torch.stack([tw, tw], 1)[:, 0])
    with pytest.raises(ValueError, match='do not match'):
        ttf._fused_train_cuda(tx, te, bias, tw[:5])
    assert not calls

    idx, q, bins, esum = ttf._fused_train_cuda(tx, te, bias, tw)
    assert len(calls) == 1 and ttf.fused_train_quantize.launches == before + 1
    assert idx.shape == (40,) and q.shape == (40, 8) and bins.shape == (10,) and esum.shape == (10, 8)
    assert calls[0][3] == tw.data_ptr() and calls[0][9:13] == (1, 40, 10, 8)
    ttf._fused_train_cuda(tx, te, bias, None)
    assert calls[1][3] is None

    lib, _ = _fake_library(err=1)
    monkeypatch.setattr(ttf, '_kernel_library', lambda: lib)
    with pytest.raises(RuntimeError, match='launch failed: invalid argument'):
        ttf._fused_train_cuda(tx, te, bias, None)
    assert ttf.fused_train_quantize.launches == before + 2
