"""The port's fused ResidualFSQ eval (vqtpu_torch.kernels.residual_fsq_fused)
against the JAX package's Pallas kernel in interpret mode, on the CPU, and
the dispatch of `eval_fused` on the CPU.

The plain version is factored as a soft clamp and the chain of q layers, so
that the chain can be fed JAX's own clamped tensor: XLA's f32 tanh on the
CPU is an approximation (about 2e-7 from float64, where torch's is 3e-8), and
it differs from torch's on about half of the elements. Fed that tensor:
  - the chain gives the JAX module's eager loop bit for bit (both sides round
    the same operations in the same order);
  - against the Pallas kernel in interpret mode, whose jit contracts
    multiplies and adds into FMAs, layers at scale > 1e-2 agree exactly and
    deeper layers to the share measured here (DEEP_SHARE), as
    tests/test_residual_fsq_fused.py holds the JAX kernel to the JAX loop;
    values agree within two deepest quanta, and so do the reconstructions
    decoded from either side's indices.
The whole plain version (with torch's tanh) is held to the same value bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu.composite.residual_fsq as jres
from vqtpu.kernels.residual_fsq_fused import fused_residual_fsq_eval as jax_fused
import vqtpu_torch
import vqtpu_torch.composite.residual_fsq as tres
import vqtpu_torch.kernels.residual_fsq_fused as tk

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

# the cases of tests/test_residual_fsq_fused.py:36-43, and a ragged token count
CASES = {
    'l8555_q8': ((8, 5, 5, 5), 8, (2, 999)),
    'l865_q3': ((8, 6, 5), 3, (2, 999)),
    'l75555_q6': ((7, 5, 5, 5, 5), 6, (2, 999)),
    'l44_q2': ((4, 4), 2, (2, 999)),
    'l8555_q3': ((8, 5, 5, 5), 3, (2, 999)),
    'ragged_1234': ((8, 6, 5), 4, (1234,)),
}

# Least share of equal indices per layer at scale <= 1e-2, the chain on JAX's
# clamped tensor against the Pallas kernel in interpret mode: 0.9 of the
# share measured on these inputs (seed 0), which is, by layer from the first
# at scale <= 1e-2: l8555_q8 layers 3-7: 1.0, 0.998999, 0.995996, 0.956957,
# 0.677177; l75555_q6 layers 3-5: 1.0, 1.0, 0.998999; the other cases have
# no such layer, or (ragged_1234, layer 3) 1.0.
DEEP_SHARE = 0.9 * np.array([1.0, 0.998999, 0.995996, 0.956957, 0.677177])


def _deepest_quantum(levels, q):
    lv = np.asarray(levels, np.float64)
    return float((2.0 / (lv - 1) * lv ** -(q - 1)).max())


def _jax_module(levels, q):
    m = jres.ResidualFSQ(levels=list(levels), num_quantizers=q, eval_fused='off', rngs=nnx.Rngs(0))
    m.eval()
    return m


def _inputs(levels, lead, seed=0):
    return np.random.default_rng(seed).standard_normal((*lead, len(levels)), dtype=np.float32)


def _jax_clamped(x, clamp):
    c = jnp.asarray(clamp, jnp.float32)
    return np.array(jnp.tanh(jnp.asarray(x) / c) * c)


def _assert_layers(levels, q, idx, jidx):
    """Layers at scale > 1e-2 equal; deeper ones at least DEEP_SHARE."""
    shares = [float((idx[..., i] == jidx[..., i]).mean()) for i in range(q)]
    deep = 0
    for i, share in enumerate(shares):
        if min(levels) ** -i > 1e-2:
            assert share == 1.0, (i, shares)
        else:
            assert share >= DEEP_SHARE[min(deep, len(DEEP_SHARE) - 1)], (i, shares)
            deep += 1
    return shares


@pytest.mark.parametrize('case', CASES)
def test_plain_version_matches_jax_kernel(case):
    levels, q, lead = CASES[case]
    jm = _jax_module(levels, q)
    x = _inputs(levels, lead)
    scales = np.array(jm._scales())
    clamp = tuple(jm.soft_clamp_input_value)
    jq, jidx = jax_fused(jnp.asarray(x), jnp.asarray(scales), levels=levels, clamp=clamp, num_quantizers=q,
                         interpret=True)
    jq, jidx = np.asarray(jq), np.asarray(jidx)
    tol = 2 * _deepest_quantum(levels, q)
    tm = tres.ResidualFSQ(levels=list(levels), num_quantizers=q, device='cpu').eval()
    jdec = np.asarray(jm.get_output_from_indices(jnp.asarray(jidx.reshape(1, -1, q))))

    # the chain on JAX's clamped input: layers at scale > 1e-2 exact
    z = _jax_clamped(x, clamp)
    qsum, idx = tk.residual_fsq_chain_plain(torch.from_numpy(z), torch.from_numpy(scales), levels)
    assert qsum.dtype == torch.float32 and idx.dtype == torch.int32
    assert qsum.shape == jq.shape and idx.shape == jidx.shape
    _assert_layers(levels, q, idx.numpy(), jidx)
    assert float(np.abs(qsum.numpy() - jq).max()) <= tol
    # both index sets decode to the same reconstruction
    dec = tm.get_output_from_indices(idx.reshape(1, -1, q))
    assert float(np.abs(dec.numpy() - jdec).max()) <= tol
    # the JAX module's eager loop rounds as the chain does: bit for bit
    jl_q, jl_idx = jm(jnp.asarray(x if x.ndim == 3 else x[None]))
    np.testing.assert_array_equal(idx.numpy().reshape(-1, q), np.asarray(jl_idx).reshape(-1, q))
    np.testing.assert_array_equal(qsum.numpy().reshape(-1, len(levels)), np.asarray(jl_q).reshape(-1, len(levels)))

    # the whole plain version, with torch's tanh: by value and by decode
    fq, fidx = tk.fused_residual_fsq_eval(torch.from_numpy(x), torch.from_numpy(scales), levels=levels,
                                          clamp=clamp, num_quantizers=q)
    assert fidx.dtype == torch.int32 and fidx.shape == (*lead, q) and fq.shape == x.shape
    assert float(np.abs(fq.numpy() - jq).max()) <= tol
    fdec = tm.get_output_from_indices(fidx.reshape(1, -1, q))
    assert float(np.abs(fdec.numpy() - jdec).max()) <= tol
    # the plain version on the CPU is the port's own loop, bit for bit
    loop_q, loop_idx = tm(torch.from_numpy(x.reshape(1, -1, len(levels))))
    assert tm.eval_fused == 'auto'
    assert torch.equal(loop_idx.reshape(fidx.shape), fidx) and torch.equal(loop_q.reshape(fq.shape), fq)


def test_plain_version_casts_to_f32_before_the_clamp():
    levels, q = (8, 5, 5, 5), 4
    tm = tres.ResidualFSQ(levels=list(levels), num_quantizers=q, device='cpu').eval()
    x = torch.from_numpy(_inputs(levels, (3, 50), seed=2)).bfloat16()
    kw = dict(levels=levels, clamp=tm.soft_clamp_input_value, num_quantizers=q)
    qb, ib = tk.fused_residual_fsq_eval(x, tm._scales(), **kw)
    qf, i_f = tk.fused_residual_fsq_eval(x.float(), tm._scales(), **kw)
    assert qb.dtype == torch.bfloat16 and torch.equal(ib, i_f) and torch.equal(qb, qf.bfloat16())


def test_wrapper_rejects_what_it_does_not_take():
    scales = torch.ones(2, 3)
    kw = dict(levels=(8, 6, 5), clamp=(1.1, 1.2, 1.25), num_quantizers=2)
    with pytest.raises(ValueError, match='CUDA or CPU'):
        tk.fused_residual_fsq_eval(torch.zeros(4, 3, device='meta'), scales, **kw)
    with pytest.raises(ValueError, match='scales'):
        tk.fused_residual_fsq_eval(torch.zeros(4, 3), torch.ones(3, 3), **kw)
    with pytest.raises(ValueError, match='x'):
        tk.fused_residual_fsq_eval(torch.zeros(4, 4), scales, **kw)


# -- dispatch on the CPU (tests/test_residual_fsq_fused.py:88-122) -------------------


def _count_calls(monkeypatch):
    calls = []
    real = tres.fused_residual_fsq_eval

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(tres, 'fused_residual_fsq_eval', spy)
    return calls


def test_auto_and_training_take_the_loop_on_cpu(monkeypatch):
    calls = _count_calls(monkeypatch)
    launches = tk.fused_residual_fsq_eval.launches
    x = torch.randn(2, 64, 4)
    auto = tres.ResidualFSQ(levels=[8, 5, 5, 5], num_quantizers=2, device='cpu').eval()   # 'auto', CPU -> loop
    auto(x)
    on_train = tres.ResidualFSQ(levels=[8, 5, 5, 5], num_quantizers=2, eval_fused='on', device='cpu').train()
    on_train(x)                                                                          # training -> loop
    assert calls == [] and tk.fused_residual_fsq_eval.launches == launches
    on_eval = tres.ResidualFSQ(levels=[8, 5, 5, 5], num_quantizers=2, eval_fused='on', device='cpu').eval()
    on_eval(x)                                                                           # 'on' -> the plain version
    assert calls == [1] and tk.fused_residual_fsq_eval.launches == launches


def test_an_eval_forward_that_needs_a_gradient_takes_the_loop(monkeypatch):
    """The fused chain has no backward: with a gradient asked of the input
    (here through the projection's parameters), 'on' loops and the
    straight-through gradient reaches the projection."""
    calls = _count_calls(monkeypatch)
    m = tres.ResidualFSQ(levels=[8, 5, 5, 5], num_quantizers=3, dim=8, eval_fused='on', device='cpu').eval()
    x = torch.randn(2, 30, 8)
    q, _ = m(x)
    q.square().mean().backward()
    assert calls == [] and m.project_in.weight.grad is not None and bool((m.project_in.weight.grad != 0).any())
    with torch.no_grad():
        m(x)
    assert calls == [1]


@pytest.mark.parametrize('config', (
    dict(levels=[5, 5, 5, 5], orthogonal_rotation=True),
    dict(levels=[5, 5, 5, 5], bound_hard_clamp=False, soft_clamp_input_value=1.5),
    dict(levels=[5, 5, 5, 5], bound_hard_clamp=False),
), ids=('rotation', 'tanh_bound', 'no_clamp'))
def test_ineligible_configurations_keep_the_loop_under_on(monkeypatch, config):
    calls = _count_calls(monkeypatch)
    x = torch.randn(2, 64, 4)
    torch.manual_seed(0)
    rot = tres.ResidualFSQ(num_quantizers=2, eval_fused='on', device='cpu', **config).eval()
    ref = tres.ResidualFSQ(num_quantizers=2, eval_fused='off', device='cpu', **config).eval()
    ref.load_state_dict(rot.state_dict())
    out_a, ind_a = rot(x)
    out_b, ind_b = ref(x)
    assert calls == []
    assert torch.equal(out_a, out_b) and torch.equal(ind_a, ind_b)


def test_exports():
    assert vqtpu_torch.kernels.fused_residual_fsq_eval is tk.fused_residual_fsq_eval
    assert vqtpu_torch.kernels.fused_residual_fsq_eval_plain is tk.fused_residual_fsq_eval_plain
    assert isinstance(tk.fused_residual_fsq_eval.launches, int)
