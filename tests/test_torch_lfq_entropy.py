"""The port's LFQ entropy statistics (vqtpu_torch.kernels.lfq_entropy) against
the JAX package's fused sweeps (vqtpu.kernels.lfq_entropy), on the CPU.

On the CPU the port's `lfq_entropy_stats` runs the plain sweeps; the JAX side
runs its Pallas kernels in interpret mode, padded to its token block with
zero weights (the port takes any N). Tolerances:

  - forward, ent and avgp: 1e-5 relative to the largest entry at
    inv_temp 1; 1e-4 at inv_temp 100, where the logits carry the dot's f32
    rounding (whose order differs between the two matmuls) times 200, as
    tests/test_lfq.py holds the JAX fused sweeps to its streamed path;
  - gradients through jax.vjp and torch.autograd.grad with the same
    cotangents: at inv_temp 1, dx and dw within 2e-5 of their largest
    entry; at inv_temp 100, where the softmax saturates and the gradient is
    rounding noise, max |delta| < 5e-4 with the cotangents of LFQ's aux
    loss (the bound of tests/test_lfq.py::test_lfq_fused_entropy_bwd_at_default_temp),
    and within 1e-3 of the largest entry, so that an output of zeros fails;
  - the plain backward against autograd of the plain forward, in float64:
    1e-9 relative.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vqtpu.kernels.lfq_entropy as jle
import vqtpu_torch.kernels.lfq_entropy as tle

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

EPS = 1e-5


def _inputs(n, d, spherical, weighted, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    if spherical:
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    w = (rng.random(n) > 0.3).astype(np.float32) if weighted else np.ones(n, np.float32)
    return x, w


def _lfq_cotangents(w, avgp, weight=0.1, gamma=1.0):
    """The cotangents LFQ's aux loss weight * (sum w ent / W - gamma H(avgp / W))
    sends to (ent, avgp), from the JAX forward's avgp."""
    denom = max(float(w.sum()), 1e-6)
    a = avgp.astype(np.float64) / denom
    entbar = weight * w / denom
    gbar = weight * gamma * (np.log(np.maximum(a, EPS)) + (a > EPS)) / denom
    return entbar.astype(np.float32), gbar.astype(np.float32)


def _padded(x, w, block_n=128):
    """x and w padded to the JAX sweeps' token block, with zero weights."""
    n_pad = -(-x.shape[0] // block_n) * block_n
    xp = np.zeros((n_pad, x.shape[1]), np.float32)
    xp[:len(x)] = x
    wp = np.zeros(n_pad, np.float32)
    wp[:len(w)] = w
    return xp, wp


def _jax_logz(x, w, k, v, inv_temp):
    """logz of the JAX forward pass (`_fwd_pass`: `_kernel_a`, an online
    max, in interpret mode), N padded as `_jax_stats` pads."""
    xp, wp = _padded(x, w)
    logz = jle._fwd_pass(jnp.asarray(xp), jnp.asarray(wp).reshape(-1, 1), k=k, v=v, inv_temp=inv_temp, eps=EPS,
                         block_n=128, block_k=min(k, 2048), interpret=True)[2]
    return np.array(logz).reshape(-1)[:len(x)]


def _jax_stats(x, w, k, v, inv_temp):
    """The JAX fused sweeps in interpret mode, N padded to the token block
    with zero weights; returns the forward and the vjp on the padded rows."""
    n = x.shape[0]
    block_n = 128
    xp, wp = _padded(x, w, block_n)
    n_pad = xp.shape[0]

    def f(a, b):
        return jle.lfq_entropy_stats_fused(a, b, k=k, v=v, inv_temp=inv_temp, block_n=block_n,
                                           block_k=min(k, 2048), interpret=True)
    (ent, avgp), vjp = jax.vjp(f, jnp.asarray(xp), jnp.asarray(wp))

    def grads(entbar, gbar):
        eb = np.zeros(n_pad, np.float32)
        eb[:n] = entbar
        dx, dw = vjp((jnp.asarray(eb), jnp.asarray(gbar)))
        return np.asarray(dx)[:n], np.asarray(dw)[:n]
    return np.asarray(ent)[:n], np.asarray(avgp), grads


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


CASES = {
    'k256_spherical_t1': (512, 8, True, 1.0, False, 1.0),
    'k256_scale025_weighted_t100': (512, 8, False, 0.25, True, 100.0),
    'k1024_spherical_weighted_t100': (384, 10, True, 1.0, True, 100.0),
    'k1024_scale025_t1': (384, 10, False, 0.25, False, 1.0),
    'k1024_ragged300_weighted_t1': (300, 10, True, 1.0, True, 1.0),
    'k1024_ragged300_t100': (300, 10, False, 0.25, False, 100.0),
}


@pytest.mark.parametrize('case', list(CASES))
def test_stats_and_vjp_match_jax_kernels(case):
    n, d, spherical, scale, weighted, inv_temp = CASES[case]
    k = 1 << d
    x, w = _inputs(n, d, spherical, weighted, seed=len(case))
    v = tle.code_magnitude(d, scale, spherical)
    assert v == jle.code_magnitude(d, scale, spherical)
    jent, javgp, jgrads = _jax_stats(x, w, k, v, inv_temp)

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ent, avgp = tle.lfq_entropy_stats(tx, tw, k=k, v=v, inv_temp=inv_temp)
    assert ent.shape == (n,) and avgp.shape == (k,)
    fwd_tol = 1e-5 if inv_temp == 1.0 else 1e-4
    assert _rel(ent.detach().numpy(), jent) <= fwd_tol
    assert _rel(avgp.detach().numpy(), javgp) <= fwd_tol

    if inv_temp == 1.0:
        rng = np.random.default_rng(7)
        entbar = rng.standard_normal(n).astype(np.float32)
        gbar = rng.standard_normal(k).astype(np.float32)
    else:
        entbar, gbar = _lfq_cotangents(w, javgp)
    jdx, jdw = jgrads(entbar, gbar)
    dx, dw = torch.autograd.grad((ent, avgp), (tx, tw), (torch.from_numpy(entbar), torch.from_numpy(gbar)))
    if inv_temp == 1.0:
        np.testing.assert_allclose(dx.numpy(), jdx, rtol=0, atol=2e-5 * np.abs(jdx).max())
        np.testing.assert_allclose(dw.numpy(), jdw, rtol=0, atol=2e-5 * np.abs(jdw).max())
    else:
        assert float(np.abs(dx.numpy() - jdx).max()) < 5e-4
        assert float(np.abs(dw.numpy() - jdw).max()) < 5e-4
        # and relative to the largest entry, which 5e-4 alone may exceed
        assert _rel(dx.numpy(), jdx) <= 1e-3 and _rel(dw.numpy(), jdw) <= 1e-3


@pytest.mark.parametrize('case', list(CASES))
def test_plain_logz_matches_jax_kernel_a(case):
    """logz = m + log s of the port's `sweep_a_plain` (its shift the largest
    logit in closed form) against the JAX package's `_fwd_pass` (its
    `_kernel_a`, an online max, in interpret mode, N padded as `_jax_stats`
    pads), within the forward tolerance of max(|logz|, 1)."""
    n, d, spherical, scale, weighted, inv_temp = CASES[case]
    k = 1 << d
    x, w = _inputs(n, d, spherical, weighted, seed=len(case))
    v = tle.code_magnitude(d, scale, spherical)
    jlogz = _jax_logz(x, w, k, v, inv_temp)
    m, s = tle.sweep_a_plain(torch.from_numpy(x), k=k, v=v, inv_temp=inv_temp)
    logz = (m + torch.log(s)).numpy()
    assert logz.shape == (n,) and bool(np.isfinite(logz).all())
    fwd_tol = 1e-5 if inv_temp == 1.0 else 1e-4
    assert float(np.abs(logz - jlogz).max()) <= fwd_tol * max(float(np.abs(jlogz).max()), 1.0)


@pytest.mark.parametrize('inv_temp,v', ((100.0, 0.25), (-3.0, -0.5)))
def test_largest_logit_in_closed_form(inv_temp, v):
    """Sweep A's shift, in float64: max_k l_nk = 2 |inv_temp| |v| ||x_n||_1,
    for either sign of inv_temp and v, and s = sum_k exp(l - m) >= 1."""
    n, d = 50, 9
    k = 1 << d
    x = torch.from_numpy(_inputs(n, d, False, False, seed=d)[0]).double()
    logits = tle._logits(x, 0, k, v, inv_temp)
    shift = tle.logit_shift(x, v=v, inv_temp=inv_temp)
    torch.testing.assert_close(shift, logits.amax(1), rtol=1e-13, atol=0)
    torch.testing.assert_close(shift, 2 * abs(inv_temp) * abs(v) * x.abs().sum(1), rtol=1e-15, atol=0)
    m, s = tle.sweep_a_plain(x, k=k, v=v, inv_temp=inv_temp)
    assert torch.equal(m, shift) and bool((s >= 1 - 1e-12).all())
    torch.testing.assert_close(m + torch.log(s), torch.logsumexp(logits, 1), rtol=1e-13, atol=0)


def test_sigma_factors_out_of_the_pair_loop():
    """Sweep C's grouping, in float64: sigma = sum_k p (entbar f'(p) + w gbar)
    = entbar sum_k p f'(p) + w gdot, held against `sweep_c_plain`."""
    n, d, inv_temp = 64, 8, 10.0
    k = 1 << d
    x, w = (torch.from_numpy(a).double() for a in _inputs(n, d, True, True, seed=5))
    v = tle.code_magnitude(d, 1.0, True)
    rng = np.random.default_rng(6)
    entbar = torch.from_numpy(rng.standard_normal(n))
    gbar = torch.from_numpy(rng.standard_normal(k))
    m, s = tle.sweep_a_plain(x, k=k, v=v, inv_temp=inv_temp)
    logz = m + torch.log(s)
    sigma, gdot = tle.sweep_c_plain(x, w, logz, entbar, gbar, k=k, v=v, inv_temp=inv_temp, eps=EPS)
    p = torch.exp(tle._logits(x, 0, k, v, inv_temp) - logz[:, None])
    fprime = -torch.log(p.clamp_min(EPS)) - (p > EPS).double()
    slope_sum = (p * fprime).sum(1)
    torch.testing.assert_close(gdot, p @ gbar, rtol=1e-12, atol=0)
    torch.testing.assert_close(sigma, entbar * slope_sum + w * gdot, rtol=0, atol=1e-12 * float(sigma.abs().max()))


@pytest.mark.parametrize('inv_temp', (1.0, 100.0))
@pytest.mark.parametrize('d', (6, 10))
def test_plain_backward_matches_autograd_of_plain_forward(d, inv_temp):
    n, k = 200, 1 << d
    x, w = _inputs(n, d, False, True, seed=d)
    v = tle.code_magnitude(d, 0.5, False)
    tx = torch.from_numpy(x).double().requires_grad_()
    tw = torch.from_numpy(w).double().requires_grad_()
    ent, avgp, logz = tle.entropy_fwd_plain(tx, tw, k, v, inv_temp)
    rng = np.random.default_rng(d)
    entbar = torch.from_numpy(rng.standard_normal(n))
    gbar = torch.from_numpy(rng.standard_normal(k))
    want_dx, want_dw = torch.autograd.grad((ent, avgp), (tx, tw), (entbar, gbar))
    dx, dw = tle.entropy_bwd_plain(tx.detach(), tw.detach(), logz.detach(), entbar, gbar, k, v, inv_temp)
    np.testing.assert_allclose(dx.numpy(), want_dx.numpy(), rtol=0, atol=1e-9 * float(want_dx.abs().max()))
    np.testing.assert_allclose(dw.numpy(), want_dw.numpy(), rtol=0, atol=1e-9 * float(want_dw.abs().max()))


def test_plain_sweeps_do_not_depend_on_the_chunk(monkeypatch):
    """Chunks of 16 codes give the one-chunk values to f32 summation order
    (1e-5 of each output's largest entry)."""
    n, d = 64, 9
    k = 1 << d
    x, w = _inputs(n, d, True, True, seed=3)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    v = tle.code_magnitude(d, 1.0, True)
    rng = np.random.default_rng(4)
    entbar = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    gbar = torch.from_numpy(rng.standard_normal(k).astype(np.float32))

    def run():
        ent, avgp, logz = tle.entropy_fwd_plain(tx, tw, k, v, 10.0)
        dx, dw = tle.entropy_bwd_plain(tx, tw, logz, entbar, gbar, k, v, 10.0)
        return ent, avgp, logz, dx, dw
    whole = run()
    monkeypatch.setattr(tle, '_PLAIN_CHUNK_ELEMS', n * 16)
    assert tle._chunk(n, k) == 16
    for a, b in zip(run(), whole):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize('d', (1, 3, 8))
def test_code_tile_is_the_jax_code_tile(d):
    k = 1 << d
    size = min(k, 8)
    for i_k in range(k // size):
        want = np.asarray(jle._code_tile(i_k, size, d, 0.375)).T
        got = tle.code_tile(i_k * size, size, d, 0.375).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('spherical', (False, True))
@pytest.mark.parametrize('scale', (1.0, 0.5, 0.25, 0.3))
def test_code_magnitude_matches_jax(scale, spherical):
    for d in (1, 8, 18, 24):
        assert tle.code_magnitude(d, scale, spherical) == jle.code_magnitude(d, scale, spherical)


def _fake_library(err=0):
    calls = []

    def sweep(name):
        def run(*args):
            calls.append((name, args))
            return err
        return run
    lib = types.SimpleNamespace(
        vqtpu_lfq_sweep_a=sweep('a'), vqtpu_lfq_sweep_b=sweep('b'),
        vqtpu_lfq_sweep_c=sweep('c'), vqtpu_lfq_sweep_d=sweep('d'),
        vqtpu_lfq_scratch_floats=lambda sweep, n, d: 5,
        vqtpu_lfq_avgp_rows=lambda n, d: 3,
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


def _pretend_cuda(monkeypatch, lib):
    """Run the CUDA wrappers on CPU tensors up to the (faked) launch."""
    monkeypatch.setattr(tle, '_kernel_library', lambda: lib)
    monkeypatch.setattr(torch.cuda, 'device', _NoDevice)
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tle, '_runs_plain', lambda name, x: False)


def test_dispatch_and_wrapper_checks(monkeypatch):
    n, d = 40, 5
    k = 1 << d
    x, w = map(torch.from_numpy, _inputs(n, d, False, True, seed=0))
    before = {name: f.launches for name, f in tle.SWEEPS.items()}
    ent, avgp = tle.lfq_entropy_stats(x, w, k=k, v=1.0, inv_temp=1.0)
    assert {name: f.launches for name, f in tle.SWEEPS.items()} == before   # the CPU runs the plain sweeps
    with pytest.raises(ValueError, match='CUDA or CPU'):
        tle.sweep_a(x.to('meta'), k=k, v=1.0, inv_temp=1.0)
    with pytest.raises(ValueError, match='k must be 2'):
        tle.lfq_entropy_stats(x, w, k=k // 2, v=1.0, inv_temp=1.0)
    with pytest.raises(ValueError, match=r'\(N,\)'):
        tle.lfq_entropy_stats(x, w[:5], k=k, v=1.0, inv_temp=1.0)

    lib, calls = _fake_library()
    _pretend_cuda(monkeypatch, lib)
    kw = dict(k=k, v=0.5, inv_temp=100.0)
    with pytest.raises(ValueError, match='1 <= d <= 24'):
        tle.sweep_a(torch.zeros(4, 25), k=1 << 25, v=0.5, inv_temp=1.0)
    with pytest.raises(TypeError, match='x must be float32'):
        tle.sweep_a(x.double(), **kw)
    with pytest.raises(ValueError, match='x must be contiguous'):
        tle.sweep_a(torch.from_numpy(np.asfortranarray(x.numpy())), **kw)
    with pytest.raises(TypeError, match='w must be float32'):
        tle.sweep_b(x, w.double(), w, eps=EPS, **kw)
    with pytest.raises(ValueError, match='gbar must have shape'):
        tle.sweep_c(x, w, w, w, w, eps=EPS, **kw)
    with pytest.raises(ValueError, match='sigma must have shape'):
        tle.sweep_d(x, w, w, w, torch.zeros(k), w[:3], eps=EPS, **kw)
    assert not calls

    m, s = tle.sweep_a(x, **kw)
    ent, avgp = tle.sweep_b(x, w, m, eps=EPS, **kw)
    sigma, gdot = tle.sweep_c(x, w, m, ent, torch.zeros(k), eps=EPS, **kw)
    dx = tle.sweep_d(x, w, m, ent, torch.zeros(k), sigma, eps=EPS, **kw)
    assert [c[0] for c in calls] == ['a', 'b', 'c', 'd']
    assert {name: f.launches - before[name] for name, f in tle.SWEEPS.items()} == dict(a=1, b=1, c=1, d=1)
    assert m.shape == s.shape == ent.shape == sigma.shape == gdot.shape == (n,)
    assert avgp.shape == (k,) and dx.shape == (n, d)
    # pointers, then n, d, v, inv_temp (and eps), then the stream
    assert calls[0][1][0] == x.data_ptr() and calls[0][1][4:] == (n, d, 0.5, 100.0, 0)
    assert calls[3][1][8:] == (n, d, 0.5, 100.0, EPS, 0)

    lib, _ = _fake_library(err=1)
    monkeypatch.setattr(tle, '_kernel_library', lambda: lib)
    with pytest.raises(RuntimeError, match='sweep_c kernel launch failed: invalid argument'):
        tle.sweep_c(x, w, m, ent, torch.zeros(k), eps=EPS, **kw)
