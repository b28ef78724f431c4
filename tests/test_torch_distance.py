"""The port's selection and lookup (vqtpu_torch.kernels.distance) against
the JAX package's (vqtpu.kernels.distance), on the CPU.

On the CPU the port's `nearest_code` runs `nearest_code_plain`, the plain
version of the Hopper kernel (x @ e.T + bias, first-index argmax); the JAX
side runs its Pallas selection kernel in interpret mode, which uses the
same formulation, so the indices must match exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vqtpu.core.layout as jlayout
import vqtpu.core.utils as ju
import vqtpu.kernels.distance as jd
import vqtpu_torch.core.layout as tlayout
import vqtpu_torch.core.utils as tu
import vqtpu_torch.kernels.distance as td
from vqtpu_torch.kernels import _build

from torch_parity import assert_indices_tie_equal, one_torch_thread  # noqa: F401  (autouse)


def _operands(n, c, d, metric, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    e = rng.standard_normal((c, d), dtype=np.float32)
    if metric == 'cosine':
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        e /= np.linalg.norm(e, axis=-1, keepdims=True)
    return x, e


@pytest.mark.parametrize('metric', td.METRICS)
@pytest.mark.parametrize('n,c,d', ((300, 130, 96), (1024, 512, 256), (64, 8, 32)))
def test_nearest_code_plain_matches_jax_kernel(metric, n, c, d):
    x, e = _operands(n, c, d, metric)
    want = np.asarray(jd.nearest_code(jnp.asarray(x), jnp.asarray(e), metric, interpret=True))
    tx, te = torch.from_numpy(x), torch.from_numpy(e)
    got = td.nearest_code(tx, te, metric)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = td.nearest_code_plain(tx, te, td.selection_bias(te, metric))
    assert torch.equal(plain, got)


def test_nearest_code_plain_chunking(monkeypatch):
    # the large-codebook case: scores computed a few tokens at a time
    x, e = _operands(300, 130, 96, 'euclidean', seed=3)
    tx, te = torch.from_numpy(x), torch.from_numpy(e)
    bias = td.selection_bias(te, 'euclidean')
    whole = td.nearest_code_plain(tx, te, bias)
    monkeypatch.setattr(td, '_PLAIN_CHUNK_ELEMS', 7 * 130)
    assert torch.equal(td.nearest_code_plain(tx, te, bias), whole)


def test_nearest_code_ties_first_index():
    # all-zero tokens against an all-zero codebook: every code ties
    x = np.zeros((16, 8), np.float32)
    e = np.zeros((12, 8), np.float32)
    got = td.nearest_code(torch.from_numpy(x), torch.from_numpy(e))
    assert (got == 0).all()
    assert (np.asarray(jd.nearest_code(jnp.asarray(x), jnp.asarray(e), interpret=True)) == 0).all()

    # duplicated rows: the first copy wins, also when the copies lie in
    # different 128-code tiles of the kernel
    rng = np.random.default_rng(1)
    base = rng.standard_normal((64, 32), dtype=np.float32)
    e2 = np.concatenate([base] * 5)                      # copies 64 apart
    for metric in td.METRICS:
        got = td.nearest_code(torch.from_numpy(base), torch.from_numpy(e2), metric)
        want = np.asarray(jd.nearest_code(jnp.asarray(base), jnp.asarray(e2), metric, interpret=True))
        np.testing.assert_array_equal(got.numpy(), want)
        if metric == 'euclidean':
            np.testing.assert_array_equal(got.numpy(), np.arange(64))


def test_nearest_code_batched_heads():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 50, 16), dtype=np.float32)
    e = rng.standard_normal((3, 20, 16), dtype=np.float32)
    want = np.asarray(jd.nearest_code(jnp.asarray(x), jnp.asarray(e), interpret=True))
    got = td.nearest_code(torch.from_numpy(x), torch.from_numpy(e))
    assert got.shape == (3, 50)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('metric', td.METRICS)
def test_nearest_code_xla_matches_jax(metric):
    x, e = _operands(512, 64, 32, metric, seed=4)
    want_idx, want_best = jd.nearest_code_xla(jnp.asarray(x), jnp.asarray(e), metric, return_best=True)
    got_idx, got_best = td.nearest_code_xla(torch.from_numpy(x), torch.from_numpy(e), metric, return_best=True)
    assert got_idx.dtype == torch.int32
    assert_indices_tie_equal(x[None], e[None], metric, got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_best.numpy(), np.asarray(want_best), rtol=1e-5, atol=1e-4)


def test_argmax_first_with_best_matches_jax():
    rng = np.random.default_rng(5)
    scores = rng.integers(0, 4, (40, 9)).astype(np.float32)   # many ties
    want_idx, want_best = jd.argmax_first_with_best(jnp.asarray(scores))
    got_idx, got_best = td.argmax_first_with_best(torch.from_numpy(scores))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_best.numpy(), np.asarray(want_best))


def test_gather_codes_exact():
    rng = np.random.default_rng(6)
    e = rng.standard_normal((33, 7), dtype=np.float32)
    idx = rng.integers(0, 33, (4, 5)).astype(np.int32)
    got = td.gather_codes(torch.from_numpy(e), torch.from_numpy(idx))
    want = np.asarray(jd.gather_codes(jnp.asarray(e), jnp.asarray(idx)))
    assert got.shape == (4, 5, 7)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), e[idx])


@pytest.mark.parametrize('metric', td.METRICS)
@pytest.mark.parametrize('shape', ((256, 64, 32), (2, 100, 24, 16)))
def test_quantize_lookup_tiers_match_jax(metric, shape):
    heads = shape[:-3]
    n, c, d = shape[-3:]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((*heads, n, d), dtype=np.float32)
    e = rng.standard_normal((*heads, c, d), dtype=np.float32)
    if metric == 'cosine':
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        e /= np.linalg.norm(e, axis=-1, keepdims=True)
    tx, te = torch.from_numpy(x), torch.from_numpy(e)
    h = heads[0] if heads else 1

    # exact tier: JAX routes to its XLA formulation on the CPU
    want_idx, _ = jd.quantize_lookup(jnp.asarray(x), jnp.asarray(e), metric)
    idx, q = td.quantize_lookup(tx, te, metric)
    assert idx.dtype == torch.int32 and q.dtype == torch.float32
    assert_indices_tie_equal(x, e.reshape(h, c, d), metric, idx.numpy(), np.asarray(want_idx))
    rows = np.stack([e.reshape(h, c, d)[i][idx.reshape(h, n)[i].numpy()] for i in range(h)])
    np.testing.assert_array_equal(q.numpy().reshape(h, n, d), rows)

    # bf16 tier: indices by the tie rule on the bf16 values, rows bit-equal
    # to the bf16-cast codebook rows
    want_idx, want_q = jd.quantize_lookup(jnp.asarray(x), jnp.asarray(e), metric, tier='bf16')
    idx, q = td.quantize_lookup(tx, te, metric, tier='bf16')
    assert q.dtype == torch.bfloat16
    xb = tx.bfloat16().float().numpy()
    eb = te.bfloat16().float().reshape(h, c, d)
    assert_indices_tie_equal(xb, eb.numpy(), metric, idx.numpy(), np.asarray(want_idx))
    rows = torch.stack([eb[i][idx.reshape(h, n)[i].long()] for i in range(h)])
    assert torch.equal(q.float().reshape(h, n, d), rows)
    same = (idx.numpy() == np.asarray(want_idx))
    np.testing.assert_array_equal(
        q.float().numpy()[same], np.asarray(want_q.astype(jnp.float32))[same]
    )


def test_kernel_wrapper_dispatch_and_checks(monkeypatch):
    x, e = _operands(40, 10, 8, 'euclidean')
    tx, te = torch.from_numpy(x), torch.from_numpy(e)
    before = td.nearest_code.launches
    td.nearest_code(tx, te)
    assert td.nearest_code.launches == before     # the CPU runs the plain version
    with pytest.raises(ValueError, match='CUDA or CPU'):
        td.nearest_code(tx.to('meta'), te.to('meta'), bias=torch.zeros(10, device='meta'))

    # what the CUDA path checks before it launches
    bias = td.selection_bias(te, 'euclidean')
    td._check_kernel_operands(tx, te, bias)
    with pytest.raises(TypeError, match='float32'):
        td._check_kernel_operands(tx.double(), te, bias)
    with pytest.raises(ValueError, match='contiguous'):
        td._check_kernel_operands(torch.from_numpy(np.asfortranarray(x)), te, bias)
    with pytest.raises(ValueError, match='shape mismatch'):
        td._check_kernel_operands(tx[:, :4].contiguous(), te, bias)
    with pytest.raises(ValueError, match='metric'):
        td.selection_bias(te, 'manhattan')

    # without nvcc the kernel cannot be built, and says so
    monkeypatch.setenv('PATH', '')
    monkeypatch.setenv('CUDA_HOME', '/nonexistent')
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.nvcc()


def test_selection_disagreements_flags_real_mismatch():
    x, e = _operands(64, 16, 8, 'euclidean', seed=8)
    tx, te = torch.from_numpy(x), torch.from_numpy(e)
    bias = td.selection_bias(te, 'euclidean')
    idx = td.nearest_code(tx, te)
    assert td.selection_disagreements(tx, te, bias, idx, idx)['disagree'] == 0
    wrong = (idx + 1) % 16
    r = td.selection_disagreements(tx, te, bias, idx, wrong)
    assert r['disagree'] == 64 and r['non_tie'] == 64 and r['max_score_gap'] > 0


@pytest.mark.parametrize('fn', ('l2norm', 'cdist_sq', 'masked_mean', 'lens_to_mask', 'pack_tokens', 'to_tokens'))
def test_core_helpers_match_jax(fn):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 5, 8), dtype=np.float32)
    tx = torch.from_numpy(x)
    if fn == 'l2norm':
        x[0, 0] = 0.0                                        # the eps clamp
        got, want = tu.l2norm(torch.from_numpy(x)), ju.l2norm(jnp.asarray(x))
    elif fn == 'cdist_sq':
        y = rng.standard_normal((3, 4, 8), dtype=np.float32)
        got, want = tu.cdist_sq(tx, torch.from_numpy(y)), ju.cdist_sq(jnp.asarray(x), jnp.asarray(y))
    elif fn == 'masked_mean':
        mask = rng.random((3, 5)) < 0.5
        got = tu.masked_mean(tx, torch.from_numpy(mask))
        want = ju.masked_mean(jnp.asarray(x), jnp.asarray(mask))
        assert float(tu.masked_mean(tx, None)) == pytest.approx(float(x.mean()), rel=1e-6)
    elif fn == 'lens_to_mask':
        lens = np.array([0, 3, 5])
        got, want = tu.lens_to_mask(torch.from_numpy(lens), 5), ju.lens_to_mask(jnp.asarray(lens), 5)
    elif fn == 'pack_tokens':
        flat, unpack = tu.pack_tokens(tx[:, :, None])         # (3, 5, 1, 8)
        jflat, _ = ju.pack_tokens(jnp.asarray(x)[:, :, None])
        assert torch.equal(unpack(flat), tx[:, :, None])
        got, want = flat, jflat
    else:
        img = rng.standard_normal((2, 8, 3, 4), dtype=np.float32)
        tokens, layout = tlayout.to_tokens(torch.from_numpy(img), image_fmap=True)
        jtokens, jl = jlayout.to_tokens(jnp.asarray(img), image_fmap=True)
        assert (layout.batch, layout.spatial, layout.dim, layout.moved_channel) == \
            (jl.batch, jl.spatial, jl.dim, jl.moved_channel)
        assert torch.equal(layout.restore(tokens), torch.from_numpy(img))
        idx = torch.arange(24).reshape(2, 12)
        assert layout.restore_indices(idx).shape == (2, 3, 4)
        got, want = tokens, jtokens
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
