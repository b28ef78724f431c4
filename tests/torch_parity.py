"""Helpers for the tests that hold the PyTorch port (vqtpu_torch) against
the JAX package (vqtpu): state and gradient transfer and the index tie
rule."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from flax import nnx

from vqtpu_torch.kernels.distance import selection_bias, selection_disagreements
from vqtpu_torch.utils.weights import leaf_rules

# share of tokens allowed to flip at a near-tie (see assert_indices_tie_equal)
MAX_TIE_SHARE = 1e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each port test runs torch on one thread: the suite runs test files in
    parallel worker processes, and torch's default of one thread per core
    in each of them oversubscribes the host (and upsets the suite's
    wall-clock timing tests)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_state(model) -> dict:
    """The JAX model's state as a nested dict of numpy arrays, the form
    vqtpu_torch.load_vqtpu_state takes."""
    def to_np(leaf):
        if jax.dtypes.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            return np.asarray(jax.random.key_data(leaf))
        return np.asarray(leaf)
    return jax.tree.map(to_np, nnx.to_pure_dict(nnx.state(model)))


def torch_layout_grads(module, grads, prefix: str = '') -> dict:
    """A JAX gradient tree (the nested dict of a model's nnx.Param
    gradients, as numpy arrays) mapped onto the torch module's parameter
    names and layouts, with the layout rules of load_vqtpu_state (Linear and
    Conv kernels transposed, other parameters as they are):
    {torch parameter name: numpy array}."""
    rules = leaf_rules(module)
    children = dict(module.named_children())
    params = dict(module.named_parameters(recurse=False))
    out = {}
    for key, value in grads.items():
        key = str(key)                       # nnx.List children are keyed 0, 1, ...
        if rules is not None and key in rules:
            name, convert = rules[key]
            value = np.asarray(value)
            out[prefix + name] = convert(value) if convert else value
        elif rules is None and key in params:
            out[prefix + key] = np.asarray(value)
        elif key in children:
            out.update(torch_layout_grads(children[key], value, f'{prefix}{key}.'))
        else:
            raise KeyError(f'{prefix}{key}: no such parameter or submodule in the torch module')
    return out


def assert_grads_close(module, grads, rtol, atol, none_is_zero=False):
    """Every parameter of the torch module has a .grad equal, to the
    tolerance, to the JAX gradient of the same parameter; the JAX tree
    covers every parameter. With `none_is_zero`, a parameter the backward
    did not reach (.grad None) counts as a zero gradient: JAX gives zeros
    where torch gives none."""
    want = torch_layout_grads(module, grads)
    params = dict(module.named_parameters())
    assert sorted(want) == sorted(params), (sorted(want), sorted(params))
    for name, p in params.items():
        grad = torch.zeros_like(p) if none_is_zero and p.grad is None else p.grad
        assert grad is not None, name
        np.testing.assert_allclose(grad.numpy(), want[name], rtol=rtol, atol=atol, err_msg=name)


def assert_indices_tie_equal(x, embed, metric, idx_a, idx_b):
    """Two selections of (H, N, d) tokens against (H, c, d) codebooks agree
    except at near-ties: tokens whose two picks, scored again in float64,
    differ by at most 1e-5 relative (vqtpu_torch selection_disagreements).
    Such tokens may make up at most MAX_TIE_SHARE of all. Positions where
    both indices are -1 (masked) are skipped."""
    x = torch.as_tensor(np.array(x)).float()
    embed = torch.as_tensor(np.array(embed)).float()
    idx_a = torch.as_tensor(np.array(idx_a)).long().reshape(embed.shape[0], -1)
    idx_b = torch.as_tensor(np.array(idx_b)).long().reshape(embed.shape[0], -1)
    x = x.reshape(embed.shape[0], -1, embed.shape[-1])
    disagree = tokens = 0
    for h in range(embed.shape[0]):
        masked = (idx_a[h] < 0) | (idx_b[h] < 0)
        assert torch.equal(idx_a[h] < 0, idx_b[h] < 0), 'masked positions differ'
        keep = ~masked
        r = selection_disagreements(
            x[h][keep], embed[h], selection_bias(embed[h], metric),
            idx_a[h][keep], idx_b[h][keep],
        )
        assert r['non_tie'] == 0, r
        disagree += r['disagree']
        tokens += r['tokens']
    assert disagree <= MAX_TIE_SHARE * max(tokens, 1), (disagree, tokens)
    return disagree
