"""The algebra of the log-free sweep D (K8's kernel in
vqtpu_torch/kernels/csrc/lfq_entropy.cu), in f32 torch on the CPU, where the
kernel cannot run.

    dx_n = 2 inv_temp sum_k p_nk (g_nk - sigma_n) c_k,
    g = entbar f'(p) + w gbar,  f'(p) = -log max(p, eps) - [p > eps]

The kernel takes no log: where p > eps, log p = l - logz and f'(p) =
-(l - logz) - 1; where p <= eps, f'(p) = -log(eps). It works in base 2, with
log2(e) folded into the logit scale: t = dot * 2 inv_temp log2(e) - logz
log2(e), p = 2^t, f'(p) = -t ln 2 - 1. `sweep_d_log_free` below is that
formulation in f32 (exp2 in place of the card's ex2.approx). It is held to
two references by chip_smoke.py's rule: within 2e-5 of the largest entry, or
within 4x the error of the plain f32 sweep (`sweep_d_plain`) against the
same reference, the limit under a tenth of the largest entry, at d = 10:

  - `sweep_d_plain` in float64 on the same statistics (logz, sigma);
  - the JAX package's fused sweeps in interpret mode (their dx through
    jax.vjp, with their own statistics), run as tests/test_torch_lfq_entropy.py
    runs them.

The kernel itself is held to `sweep_d_plain` on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import math

import numpy as np
import pytest
import torch

import vqtpu_torch.kernels.lfq_entropy as tle

from test_torch_lfq_entropy import EPS, _inputs, _jax_stats, _lfq_cotangents
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

N = 200


def sweep_d_log_free(x, w, logz, entbar, gbar, sigma, *, k, v, inv_temp, eps):
    """dx (N, d) of sweep D without a log, in the dtype of x, base 2."""
    codes = tle.code_tile(0, k, x.shape[1], v, x.dtype)
    scale2 = torch.tensor(2.0 * inv_temp * math.log2(math.e), dtype=x.dtype)
    t = (x @ codes.T) * scale2 - (logz * math.log2(math.e))[:, None]     # log2 p
    p = torch.exp2(t)
    neg_log_eps = -torch.log(torch.tensor(eps, dtype=x.dtype))
    slope = torch.where(p > eps, -t * math.log(2.0) - 1.0, neg_log_eps)
    g = entbar[:, None] * slope + w[:, None] * gbar
    return ((p * (g - sigma[:, None])) @ codes) * (2.0 * inv_temp)


def _held(got, plain, ref):
    """chip_smoke.py's rule for dx against `ref`; returns the two errors."""
    scale = float(ref.abs().max())
    err = float((got.double() - ref).abs().max())
    plain_err = float((plain.double() - ref).abs().max())
    limit = max(2e-5 * scale, 4 * plain_err)
    assert limit < 0.1 * scale, (limit, scale)
    assert err <= limit, (err, plain_err, scale)
    return err, plain_err


@pytest.mark.parametrize('inv_temp', (1.0, 100.0))
def test_log_free_sweep_d(inv_temp):
    d = 10
    k = 1 << d
    x, w = _inputs(N, d, True, True, seed=40 + d)
    v = tle.code_magnitude(d, 1.0, True)
    kw = dict(k=k, v=v, inv_temp=inv_temp, eps=EPS)
    x64, w64 = torch.from_numpy(x).double(), torch.from_numpy(w).double()
    m, s = tle.sweep_a_plain(x64, k=k, v=v, inv_temp=inv_temp)
    logz64 = m + torch.log(s)
    _, avgp64 = tle.sweep_b_plain(x64, w64, logz64, k=k, v=v, inv_temp=inv_temp, eps=EPS)
    if inv_temp == 1.0:
        gen = np.random.default_rng(50 + d)
        entbar = gen.standard_normal(N).astype(np.float32)
        gbar = gen.standard_normal(k).astype(np.float32)
    else:
        entbar, gbar = _lfq_cotangents(w, avgp64.numpy())
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
