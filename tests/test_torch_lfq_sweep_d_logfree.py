"""The algebra of the log-free sweeps A, C and D (K5, K7 and K8's kernels in
vqtpu_torch/kernels/csrc/lfq_entropy.cu), in f32 torch on the CPU, where
the kernels cannot run.

    A:  logz_n = log sum_k exp(l_nk)
    C:  sigma_n = sum_k p g,  gdot_n = sum_k p gbar_k
    D:  dx_n = 2 inv_temp sum_k p_nk (g_nk - sigma_n) c_k,
        g = entbar f'(p) + w gbar,  f'(p) = -log max(p, eps) - [p > eps]

The kernels take no log and no accurate exp: where p > eps, log p =
l - logz and f'(p) = -(l - logz) - 1; where p <= eps, f'(p) = -log(eps).
They work in base 2, with log2(e) folded into the logit scale: t = dot * 2
inv_temp log2(e) - logz log2(e), p = 2^t, f'(p) = -t ln 2 - 1. Sweep A
shifts by the largest logit in closed form, m2 = |2 inv_temp log2(e) v|
||x||_1, and sums 2^(t - m2) with no running max; sweep C groups sigma as
entbar sum_k p f'(p) + w gdot, the first sum in base-2 units. `sweep_a_log_free`, `sweep_c_log_free` and
`sweep_d_log_free` below are those formulations in f32 (exp2 in place of
the card's ex2.approx). Each is held to two references by chip_smoke.py's
rule: within its tolerance of the largest entry (logz: 1e-5 of
max(|logz|, 1) at inv_temp 1, 1e-4 at 100; sigma, gdot and dx: 2e-5), or
within 4x the error of the plain f32 sweep against the same reference, the
limit under a tenth of the largest entry, at d = 10:

  - the plain sweep in float64 on the same statistics (logz, sigma);
  - the JAX package's fused sweeps in interpret mode (logz from their
    forward, gdot as their dw and dx through jax.vjp, with their own
    statistics), run as tests/test_torch_lfq_entropy.py runs them.

The kernels themselves are held to the plain sweeps on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import math

import numpy as np
import pytest
import torch

import vqtpu_torch.kernels.lfq_entropy as tle

from test_torch_lfq_entropy import EPS, _inputs, _jax_logz, _jax_stats, _lfq_cotangents
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

N = 200


def _log2_probs(x, logz, *, k, v, inv_temp):
    """(codes, t = log2 p, p) in the dtype of x, base 2."""
    codes = tle.code_tile(0, k, x.shape[1], v, x.dtype)
    scale2 = torch.tensor(2.0 * inv_temp * math.log2(math.e), dtype=x.dtype)
    t = (x @ codes.T) * scale2 - (logz * math.log2(math.e))[:, None]
    return codes, t, torch.exp2(t)


def sweep_a_log_free(x, *, k, v, inv_temp):
    """(m, s) of sweep A in the dtype of x, base 2: the shift m2 in closed
    form, s = sum_k 2^(t_k - m2) with no running max, m = m2 ln 2."""
    codes = tle.code_tile(0, k, x.shape[1], v, x.dtype)
    scale2 = torch.tensor(2.0 * inv_temp * math.log2(math.e), dtype=x.dtype)
    m2 = x.abs().sum(1) * torch.tensor(abs(2.0 * inv_temp * math.log2(math.e) * v), dtype=x.dtype)
    s = torch.exp2((x @ codes.T) * scale2 - m2[:, None]).sum(1)
    return m2 * math.log(2.0), s


def sweep_c_log_free(x, w, logz, entbar, gbar, *, k, v, inv_temp, eps):
    """(sigma, gdot) of sweep C without a log, g factored out of the sum:
    S = sum_k p f'(p) in base-2 units (f'(p) / ln 2 = -t - log2 e where
    p > eps, else -log2(eps)), times ln 2 once."""
    _, t, p = _log2_probs(x, logz, k=k, v=v, inv_temp=inv_temp)
    neg_log2_eps = -torch.log2(torch.tensor(eps, dtype=x.dtype))
    slope2 = torch.where(p > eps, -t - math.log2(math.e), neg_log2_eps)
    gdot = p @ gbar
    return entbar * ((p * slope2).sum(1) * math.log(2.0)) + w * gdot, gdot


def sweep_d_log_free(x, w, logz, entbar, gbar, sigma, *, k, v, inv_temp, eps):
    """dx (N, d) of sweep D without a log, in the dtype of x, base 2."""
    codes, t, p = _log2_probs(x, logz, k=k, v=v, inv_temp=inv_temp)
    neg_log_eps = -torch.log(torch.tensor(eps, dtype=x.dtype))
    slope = torch.where(p > eps, -t * math.log(2.0) - 1.0, neg_log_eps)
    g = entbar[:, None] * slope + w[:, None] * gbar
    return ((p * (g - sigma[:, None])) @ codes) * (2.0 * inv_temp)


def _held(got, plain, ref, tol=2e-5, floor=0.0):
    """chip_smoke.py's rule for an output against `ref` (tol of
    max(largest entry, floor)); returns the two errors."""
    scale = float(ref.abs().max())
    err = float((got.double() - ref).abs().max())
    plain_err = float((plain.double() - ref).abs().max())
    limit = max(tol * max(scale, floor), 4 * plain_err)
    assert limit < 0.1 * scale, (limit, scale)
    assert err <= limit, (err, plain_err, scale)
    return err, plain_err


def _statistics(inv_temp, d=10, seed=60):
    """Inputs, float64 statistics and cotangents of sweeps C and D at d."""
    k = 1 << d
    x, w = _inputs(N, d, True, True, seed=seed + d)
    v = tle.code_magnitude(d, 1.0, True)
    x64, w64 = torch.from_numpy(x).double(), torch.from_numpy(w).double()
    m, s = tle.sweep_a_plain(x64, k=k, v=v, inv_temp=inv_temp)
    logz64 = m + torch.log(s)
    _, avgp64 = tle.sweep_b_plain(x64, w64, logz64, k=k, v=v, inv_temp=inv_temp, eps=EPS)
    if inv_temp == 1.0:
        gen = np.random.default_rng(seed + 10 + d)
        entbar = gen.standard_normal(N).astype(np.float32)
        gbar = gen.standard_normal(k).astype(np.float32)
    else:
        entbar, gbar = _lfq_cotangents(w, avgp64.numpy())
    return x, w, v, logz64, entbar, gbar


@pytest.mark.parametrize('inv_temp', (1.0, 100.0))
def test_log_free_sweep_d(inv_temp):
    d = 10
    k = 1 << d
    x, w, v, logz64, entbar, gbar = _statistics(inv_temp, d, seed=40)
    kw = dict(k=k, v=v, inv_temp=inv_temp, eps=EPS)
    x64, w64 = torch.from_numpy(x).double(), torch.from_numpy(w).double()
    eb, gb = torch.from_numpy(entbar), torch.from_numpy(gbar)
    sigma64, _ = tle.sweep_c_plain(x64, w64, logz64, eb.double(), gb.double(), **kw)

    # f32 inputs of the sweep, shared by the log-free and the plain sweep
    args = (torch.from_numpy(x), torch.from_numpy(w), logz64.float(), eb, gb, sigma64.float())
    got = sweep_d_log_free(*args, **kw)
    plain = tle.sweep_d_plain(*args, **kw)
    assert got.dtype == torch.float32 and got.shape == (N, d)

    ref64 = tle.sweep_d_plain(*(a.double() for a in args), **kw)
    _held(got, plain, ref64)

    _, _, grads = _jax_stats(x, w, k, v, inv_temp)
    jax_dx = torch.from_numpy(np.array(grads(entbar, gbar)[0])).double()
    _held(got, plain, jax_dx)


@pytest.mark.parametrize('inv_temp', (1.0, 100.0))
def test_closed_form_sweep_a(inv_temp):
    d = 10
    k = 1 << d
    x, w, v, logz64, _, _ = _statistics(inv_temp, d)
    tx = torch.from_numpy(x)
    m, s = sweep_a_log_free(tx, k=k, v=v, inv_temp=inv_temp)
    # the largest term is 1 up to the f32 rounding of its logit: the dot and
    # ||x||_1 each within d u of |v| ||x||_1 (u = 2^-24), then the scale's
    # roundings, all times 2 |inv_temp| log2(e)
    m2 = m.double() / math.log(2.0)
    assert m.dtype == torch.float32 and bool((s >= torch.exp2(-(d + 2) * 2.0 ** -23 * m2)).all())
    got = m + torch.log(s)
    m_plain, s_plain = tle.sweep_a_plain(tx, k=k, v=v, inv_temp=inv_temp)
    plain = m_plain + torch.log(s_plain)
    tol = 1e-5 if inv_temp == 1.0 else 1e-4
    _held(got, plain, logz64, tol, floor=1.0)

    jax_logz = torch.from_numpy(_jax_logz(x, w, k, v, inv_temp)).double()
    _held(got, plain, jax_logz, tol, floor=1.0)


@pytest.mark.parametrize('inv_temp', (1.0, 100.0))
def test_log_free_sweep_c(inv_temp):
    d = 10
    k = 1 << d
    x, w, v, logz64, entbar, gbar = _statistics(inv_temp, d)
    kw = dict(k=k, v=v, inv_temp=inv_temp, eps=EPS)
    args = (torch.from_numpy(x), torch.from_numpy(w), logz64.float(), torch.from_numpy(entbar),
            torch.from_numpy(gbar))
    got = sweep_c_log_free(*args, **kw)
    plain = tle.sweep_c_plain(*args, **kw)
    refs = tle.sweep_c_plain(*(a.double() for a in args), **kw)
    for out, pl, ref in zip(got, plain, refs):
        assert out.dtype == torch.float32 and out.shape == (N,)
        _held(out, pl, ref)

    _, _, grads = _jax_stats(x, w, k, v, inv_temp)
    jax_gdot = torch.from_numpy(np.array(grads(entbar, gbar)[1])).double()
    _held(got[1], plain[1], jax_gdot)
