"""The fused ResidualFSQ kernel's plan (vqtpu_torch.kernels.residual_fsq_fused):
its reciprocals, the proofs of its two routes, and its chain without IEEE
divisions, emulated in plain PyTorch (`kernel_chain_plain`), on the CPU.

The kernel divides a / b as q0 = RN(a y), e = fma(-q0, b, a), fma(e, y, q0)
with y = RN(1 / b) from the wrapper, takes the bracket from one saturating
FMA, and makes the index as the integer sum of bracket * basis where the
wrapper proves that the plain chain's rounded float sum is that integer. The
emulation rounds each FMA once (`fma_f32`), so it computes what the kernel
computes; the kernel itself is held to its plain version on the card
(tests/test_torch_cuda.py).
"""

import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu.composite.residual_fsq as jres
import vqtpu_torch.composite.residual_fsq as tres
import vqtpu_torch.kernels.residual_fsq_fused as tk

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

# (levels, q, integer index route proven): the configurations of the card
# cases (tests/test_torch_cuda.py RFSQ_CASES)
CARD_CASES = {
    'l8555_q8': ((8, 5, 5, 5), 8, True),
    'l865_q3': ((8, 6, 5), 3, True),
    'l75555_q6': ((7, 5, 5, 5, 5), 6, True),
    'l44_q2': ((4, 4), 2, True),
    'l8555_q3': ((8, 5, 5, 5), 3, True),
    'd9_q5_general': ((5,) * 9, 5, False),      # prod(levels) = 1,953,125: the digit route
    'd4_q17_general': ((8, 5, 5, 5), 17, True),
    'd1_q1': ((3,), 1, True),
    'l777_q8': ((7, 7, 7), 8, True),
    'l5555_q16': ((5, 5, 5, 5), 16, True),
    'l256_256_64_q3': ((256, 256, 64), 3, False),   # prod(levels) = 2^22
    'binade_l5_q16': ((5,), 16, True),
    'binade_l7_q16': ((7,), 16, True),
    'binade_l8_q16': ((8,), 16, True),
}


def _module(levels, q):
    return tres.ResidualFSQ(levels=list(levels), num_quantizers=q, device='cpu').eval()


def _plan(levels, q):
    return tk.kernel_plan(tuple(levels), tuple(_module(levels, q).soft_clamp_input_value), q)


def _f32(v):
    return np.float32(v)


def _tokens(levels, n, seed):
    """Random tokens at 1.5 sigma, every dim's bin edges at every layer's
    first scale and their f32 neighbours, and signed zeros."""
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal((n, len(levels)))).astype(np.float32)
    edges = []
    for level in levels:
        e = np.float32(np.arange(-level, level + 1) / (level - 1))
        edges.append(np.concatenate([e, np.nextafter(e, np.float32(np.inf)), np.nextafter(e, np.float32(-np.inf)),
                                     np.float32([0.0, -0.0, 1.0, -1.0])]))
    width = max(len(e) for e in edges)
    edge_rows = np.stack([np.resize(e, width) for e in edges], -1)
    return torch.from_numpy(np.concatenate([x, edge_rows]))


@pytest.mark.parametrize('case', CARD_CASES)
def test_reciprocals_are_correctly_rounded(case):
    """Every reciprocal of the plan is RN(1 / v): the IEEE f32 quotient, and
    no f32 neighbour lies nearer to 1 / v (checked with Fraction). The
    plan's scales are the module's bit for bit, its other constants the
    chain's."""
    levels, q, _ = CARD_CASES[case]
    m = _module(levels, q)
    plan = tk.kernel_plan(tuple(levels), tuple(m.soft_clamp_input_value), q)
    k = tk._plan_tensors(plan)
    assert torch.equal(k['scales'], m._scales())
    chain = tk.chain_constants(levels, 'cpu')
    assert torch.equal(k['lm1'], chain['levels_minus_1']) and torch.equal(k['step'], chain['inv_step'])
    assert torch.equal(k['basis'], chain['basis'])
    assert torch.equal(k['clamp'], torch.tensor(m.soft_clamp_input_value, dtype=torch.float32))
    for value, recip in ((k['step'], k['rstep']), (k['clamp'], k['rclamp']), (k['scales'], k['rscales'])):
        for v, y in zip(value.reshape(-1).tolist(), recip.reshape(-1).tolist()):
            assert _f32(y) == _f32(1) / _f32(v)
            exact = 1 / Fraction(v)
            for neighbour in (np.nextafter(_f32(y), _f32(np.inf)), np.nextafter(_f32(y), _f32(-np.inf))):
                assert abs(Fraction(y) - exact) <= abs(Fraction(float(neighbour)) - exact)


def test_round_f32_and_fma_f32_round_once():
    """`round_f32` against the IEEE f32 quotient (normal, subnormal and
    overflowing results), and `fma_f32` against `round_f32` of the exact
    a * b + c, on random triples and on products that land a half ulp from
    c's neighbours (the double-rounding cases)."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(400) * np.exp2(rng.integers(-60, 60, 400))).astype(np.float32)
    b = (rng.standard_normal(400) * np.exp2(rng.integers(-80, 80, 400))).astype(np.float32)
    with np.errstate(over='ignore', under='ignore'):
        ieee = a / b
    for x, y, want in zip(a, b, ieee):
        assert tk.round_f32(Fraction(float(x)) / Fraction(float(y))) == float(want)
    assert tk.round_f32(Fraction(1, 2 ** 150) * 3) == float(np.float32(2.0 ** -149) * 2)
    assert tk.round_f32(Fraction(2) ** 128) == math.inf

    c = (rng.standard_normal(600) * 4).astype(np.float32)
    fa = (rng.standard_normal(600)).astype(np.float32)
    fb = (rng.standard_normal(600) * 2.0 ** -20).astype(np.float32)
    # a * b = half an ulp of c plus or minus 2^-60: the float64 sum lands on
    # the midpoint, the exact one beside it
    half_ulp = (np.spacing(np.abs(c[:200])) / 2).astype(np.float32)
    fa[:200] = half_ulp * np.float32(2.0 ** 20)
    fb[:200] = np.float32(2.0 ** -20) + np.where(np.arange(200) % 2, 1, -1).astype(np.float32) * np.float32(2.0 ** -43)
    got = tk.fma_f32(torch.from_numpy(fa), torch.from_numpy(fb), torch.from_numpy(c))
    for x, y, z, g in zip(fa, fb, c, got.tolist()):
        assert g == tk.round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))


@pytest.mark.parametrize('case', CARD_CASES)
def test_route_decision(case):
    """Both routes for the card cases, the integer index refused where the
    proof's bound reaches 0.5 (prod(levels) near 2^21-2^24)."""
    levels, q, integer = CARD_CASES[case]
    plan = _plan(levels, q)
    assert plan.exact_division
    assert plan.integer_index is integer
    assert (plan.index_error_bound < 0.5) is integer


def test_route_refusals():
    """prod(levels) > 2^24 is refused without enumerating; a clamp below 1
    or a scale below 2^-100 takes the IEEE divisions; other scales than the
    plan's are held by the kernel, not the plan."""
    plan = tk.kernel_plan((4096, 4096, 2), (1.0, 1.0, 1.0), 2)
    assert not plan.integer_index and plan.index_error_bound is None and plan.exact_division
    assert not tk.kernel_plan((8, 5), (0.5, 1.25), 3).exact_division
    assert tk.kernel_plan((8, 5), (8 / 7, 1.25), 3).exact_division
    deep = tk.kernel_plan((1024,), (1024 / 1023,), 12)          # 1024^-11 = 2^-110
    assert not deep.exact_division and deep.integer_index


@pytest.mark.parametrize('case', ('l8555_q8', 'l777_q8', 'l5555_q16', 'l256_256_64_q3', 'd9_q5_general',
                                  'binade_l7_q16'))
def test_kernel_chain_divides_exactly(case):
    """The kernel's chain on tokens that reach every bin edge gives the plain
    chain's values and indices bit for bit; on the exact-division route every
    residual it divides is 0 or at least 2^-102, and the division sequence
    gives f32 r / s on each of them."""
    levels, q, _ = CARD_CASES[case]
    plan = _plan(levels, q)
    x = _tokens(levels, 3000, seed=1)
    z = tk.soft_clamp_plain(x, plan.clamp)
    want = tk.residual_fsq_chain_plain(z, tk.canonical_scales(levels, q), levels)
    qsum, idx, residuals = tk.kernel_chain_plain(z, plan)
    assert torch.equal(qsum, want[0]) and torch.equal(idx, want[1])
    k = tk._plan_tensors(plan)
    fast = ((z == 0) | (z.abs() >= tk.MIN_FAST_Z)).all(-1)
    assert float(fast.float().mean()) > 0.99     # the neighbours of 0 are subnormal: the IEEE route
    r = residuals[:, fast]
    assert bool(((r == 0) | (r.abs() >= tk.RESIDUAL_FLOOR)).all())
    scales, rscales = k['scales'][:, None, :], k['rscales'][:, None, :]
    assert torch.equal(tk.exact_quotient(r, scales, rscales), r / scales)


@pytest.mark.parametrize('case', ('l8555_q8', 'l5555_q16', 'l256_256_64_q3'))
def test_division_sequence_on_random_and_edge_values(case):
    """a / b by the sequence equals f32 a / b for every divisor of the plan
    (scales, steps, clamps) on random dividends over [2^-102, 8], both signs,
    the bin edges b (2k + 1) / (L - 1) and their neighbours, 0, +-1, and the
    smallest residuals of a 16-layer stack (2^-102 and its neighbours)."""
    levels, q, _ = CARD_CASES[case]
    k = tk._plan_tensors(_plan(levels, q))
    rng = np.random.default_rng(2)
    rand = (rng.uniform(1, 2, 4000) * np.exp2(rng.integers(-102, 3, 4000))).astype(np.float32)
    tiny = np.float32(2.0 ** -102)
    special = np.float32([0.0, 1.0, -1.0, tiny, np.nextafter(tiny, np.float32(1)), 2.0 ** -79, 2.0 ** -60])
    for value, recip in ((k['scales'], k['rscales']), (k['step'][None], k['rstep'][None]),
                         (k['clamp'][None], k['rclamp'][None])):
        for i in range(value.shape[0]):
            for j, level in enumerate(levels):
                b, y = value[i, j], recip[i, j]
                edges = (np.arange(-level, level + 1, dtype=np.float32) / np.float32(level - 1)) * np.float32(b)
                a = np.concatenate([rand, -rand, special, edges, np.nextafter(edges, np.float32(np.inf)),
                                    np.nextafter(edges, np.float32(-np.inf))])
                a = torch.from_numpy(a.astype(np.float32))
                assert torch.equal(tk.exact_quotient(a, b, y), a / b), (i, j, float(b))


def test_soft_clamp_by_the_sequence():
    """The kernel's clamp x / c by the sequence (an infinite quotient passed
    on) gives torch's tanh(x / c) * c for infinite, huge, signed-zero and
    ordinary inputs down to 2^-102; below it the token's z lies under
    MIN_FAST_Z, which sends it to the IEEE divisions."""
    for levels, q in (((8, 5, 5, 5), 8), ((7, 7, 7), 8)):
        plan = _plan(levels, q)
        rng = np.random.default_rng(3)
        x = (3 * rng.standard_normal((2000, len(levels)))).astype(np.float32)
        x[:16] = np.float32([np.inf, -np.inf, 3.4e38, -3e38, 1e30, -1e20, 0.0, -0.0, 2.0 ** -102, -(2.0 ** -90),
                             2.0 ** -79, 1.0, -1.0, 1e-3, 7.0, -7.0])[:, None]
        x = torch.from_numpy(x)
        assert torch.equal(tk.soft_clamp_kernel_plain(x, plan), tk.soft_clamp_plain(x, plan.clamp))
        small = torch.tensor([[1e-40, -1e-45, 2.0 ** -103, 2.0 ** -80][i % 4] for i in range(len(levels))])
        assert bool((tk.soft_clamp_plain(small[None], plan.clamp).abs() < tk.MIN_FAST_Z).all())


@pytest.mark.parametrize('case', ('l8555_q8', 'l777_q8', 'l5555_q16', 'l75555_q6'))
def test_integer_index_equals_the_plain_chain(case):
    """Where the integer route is proven, sum_d bracket * basis equals the
    plain chain's rounded float sum on every bracket combination of layer 0
    (one token per combination, at the bins' centres) and on random tokens."""
    levels, q, _ = CARD_CASES[case]
    plan = _plan(levels, q)
    assert plan.integer_index
    grids = torch.meshgrid(*[torch.arange(level, dtype=torch.float32) for level in levels], indexing='ij')
    brackets = torch.stack([g.reshape(-1) for g in grids], -1)
    centres = (2 * brackets / (torch.tensor(levels) - 1) - 1) * 0.999
    z = torch.cat([centres, tk.soft_clamp_plain(_tokens(levels, 2000, seed=4), plan.clamp)])
    qsum, idx, _ = tk.kernel_chain_plain(z, plan)
    want = tk.residual_fsq_chain_plain(z, tk.canonical_scales(levels, q), levels)
    assert torch.equal(idx, want[1]) and torch.equal(qsum, want[0])
    basis = torch.tensor([math.prod(levels[:j]) for j in range(len(levels))])
    assert torch.equal(idx[:len(brackets), 0].long(), (brackets.long() * basis).sum(-1))


@pytest.mark.parametrize('case', ('l8555_q8', 'l777_q8'))
def test_kernel_chain_matches_jax_loop(case):
    """Fed the JAX module's own soft-clamped tensor (XLA's tanh differs from
    torch's by an ulp), the kernel's chain gives the JAX eager loop's values
    and indices bit for bit."""
    levels, q, _ = CARD_CASES[case]
    jm = jres.ResidualFSQ(levels=list(levels), num_quantizers=q, eval_fused='off', rngs=nnx.Rngs(0))
    jm.eval()
    x = np.random.default_rng(5).standard_normal((1, 1500, len(levels))).astype(np.float32)
    clamp = tuple(jm.soft_clamp_input_value)
    z = np.array(jnp.tanh(jnp.asarray(x) / jnp.asarray(clamp, jnp.float32)) * jnp.asarray(clamp, jnp.float32))
    jq, jidx = jm(jnp.asarray(x))
    plan = tk.kernel_plan(tuple(levels), clamp, q)
    qsum, idx, _ = tk.kernel_chain_plain(torch.from_numpy(z), plan)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(qsum.numpy(), np.asarray(jq))
