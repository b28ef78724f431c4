"""The port's float64 C oracle (vqtpu_torch.kernels.native_check) against the
JAX package's (vqtpu.kernels.native_check), on the CPU: both run
native/vqcheck.c, so their picks are equal exactly, on random inputs and on
exact ties (first index). The port's plain selection (nearest_code_plain,
x.e - ||e||^2/2 in f32) agrees with the oracle except at near-ties: tokens
whose two picks, scored again in float64, differ by at most 1e-5 relative
(selection_disagreements). Skips where no C compiler exists."""

import numpy as np
import pytest
import torch

import vqtpu.kernels.native_check as jcheck
import vqtpu_torch.kernels.native_check as tcheck
from vqtpu_torch.kernels.distance import nearest_code_plain, selection_bias, selection_disagreements

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

METRICS = ('euclidean', 'cosine')


@pytest.fixture(scope='module', autouse=True)
def lib():
    if not (tcheck.available() and jcheck.available()):
        pytest.skip('no C toolchain available to build the native oracle')


def _inputs(n, c, d, metric, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    e = rng.standard_normal((c, d), dtype=np.float32)
    if metric == 'cosine':
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        e /= np.linalg.norm(e, axis=-1, keepdims=True)
    return x, e


@pytest.mark.parametrize('metric', METRICS)
def test_oracle_bit_equal_to_jax(metric):
    x, e = _inputs(300, 64, 24, metric, seed=0)
    got = tcheck.nearest_code_ref(x, e, metric)
    assert got.dtype == np.int32 and got.shape == (300,)
    assert np.array_equal(got, jcheck.nearest_code_ref(x, e, metric))
    # a tensor is taken by its host copy
    assert np.array_equal(tcheck.nearest_code_ref(torch.from_numpy(x), torch.from_numpy(e), metric), got)


@pytest.mark.parametrize('metric', METRICS)
def test_oracle_exact_ties_take_the_first_index(metric):
    """Duplicated codes and all-zero tokens: every score ties, and both
    oracles take the first of the tied codes."""
    rng = np.random.default_rng(1)
    base = rng.standard_normal((8, 16), dtype=np.float32)
    e = np.concatenate([base, base, base])               # code j ties with j + 8 and j + 16
    x = np.concatenate([base[[3, 5, 7]], np.zeros((4, 16), np.float32)])
    got = tcheck.nearest_code_ref(x, e, metric)
    assert np.array_equal(got, jcheck.nearest_code_ref(x, e, metric))
    assert np.all(got < 8)
    assert list(got[:3]) == [3, 5, 7]
    assert np.all(got[3:] == (0 if metric == 'cosine' else np.argmin((base ** 2).sum(-1))))


@pytest.mark.parametrize('metric', METRICS)
def test_plain_selection_agrees_with_oracle(metric):
    x, e = _inputs(2048, 256, 32, metric, seed=2)
    tx, te = torch.from_numpy(x), torch.from_numpy(e)
    bias = selection_bias(te, metric)
    plain = nearest_code_plain(tx, te, bias)
    oracle = torch.from_numpy(tcheck.nearest_code_ref(x, e, metric))
    r = selection_disagreements(tx, te, bias, plain, oracle)
    assert r['non_tie'] == 0, r
    assert r['disagree'] <= 2, r


def test_bad_metric_raises():
    with pytest.raises(ValueError, match='metric'):
        tcheck.nearest_code_ref(np.zeros((1, 2), np.float32), np.zeros((1, 2), np.float32), 'manhattan')
