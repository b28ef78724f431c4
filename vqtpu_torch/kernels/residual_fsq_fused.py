"""The fused eval forward of ResidualFSQ (counterpart of
vqtpu/kernels/residual_fsq_fused.py).

The preserve-symmetry, hard-clamp ResidualFSQ stack quantizes each token in
one chain: a soft clamp z = tanh(x / c) * c, then for each of q layers with
scale s_i = L^-i

    zi = r / s_i;  b = clip(zi, -1, 1);  br = floor((L - 1) (b + 1) / 2 + 0.5)
    code = (2 / (L - 1)) br - 1;  qv = code s_i;  r = r - qv;  qsum = qsum + qv
    index_i = round(sum_d ((code + 1) / (2 / (L - 1))) basis_d)

with r = z at the start and the mixed-radix basis of the levels. These are
the expressions, in order, of the ResidualFSQ loop over FSQ layers
(composite/residual_fsq.py and quantizers/fsq.py), so the chain gives the
loop's values.

`fused_residual_fsq_eval` dispatches on where x lies: a CUDA tensor goes to
the hand-written Hopper kernel in csrc/residual_fsq_fused.cu (two tokens a
thread; every multiply and add rounded on its own, as PyTorch's elementwise
kernels round them, and no IEEE division on the routes `kernel_plan` proves
for the configuration, so the kernel gives the plain version's bits), a CPU
tensor to `fused_residual_fsq_eval_plain`, the same chain in plain PyTorch,
factored as `soft_clamp_plain` and `residual_fsq_chain_plain`.
`kernel_chain_plain` is the kernel's own arithmetic in plain PyTorch, for
the tests.

The entry point is the custom op `torch.ops.vqtpu.residual_fsq_eval` (CPU:
the plain version; CUDA: the kernel; a fake for shapes), which
`torch.compile` keeps opaque. Its static configuration (levels, clamp, q)
is part of the call; the CUDA implementation works out `kernel_plan` from
it on the host, once per configuration, outside any traced graph.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from fractions import Fraction

import torch

from . import _build

MAX_DIM = 128


def chain_constants(levels, device) -> dict[str, torch.Tensor]:
    """(d,) f32 per-dim constants of the chain, each computed as the FSQ
    layer computes it: L - 1, 2 / (L - 1) and the index basis."""
    levels_f32 = torch.tensor(tuple(levels), dtype=torch.float32, device=device)
    levels_minus_1 = levels_f32 - 1
    basis = torch.tensor([math.prod(levels[:i]) for i in range(len(levels))], dtype=torch.int32, device=device)
    return dict(levels_minus_1=levels_minus_1, inv_step=2.0 / levels_minus_1, basis=basis.float())


def soft_clamp_plain(x: torch.Tensor, clamp) -> torch.Tensor:
    """tanh(x / c) * c, per dim, in the dtype of x."""
    c = torch.tensor(tuple(clamp), dtype=x.dtype, device=x.device)
    return torch.tanh(x / c) * c


def residual_fsq_chain_plain(z: torch.Tensor, scales: torch.Tensor, levels):
    """The q layers of the chain on soft-clamped f32 tokens z (..., d) ->
    (qsum (..., d) f32, indices (..., q) int32)."""
    k = chain_constants(levels, z.device)
    residual = z.float()
    qsum = torch.zeros_like(residual)
    indices = []
    for s in scales.float():
        bounded = torch.clamp(residual / s, -1.0, 1.0)
        bracket = torch.floor((k['levels_minus_1'] * (bounded + 1) / 2.0) + 0.5)
        codes = k['inv_step'] * bracket - 1.0
        quantized = codes * s
        residual = residual - quantized
        qsum = qsum + quantized
        digits = (codes + 1.0) / k['inv_step']
        indices.append(torch.round((digits * k['basis']).sum(-1)).to(torch.int32))
    return qsum, torch.stack(indices, -1)


def _check(x: torch.Tensor, scales: torch.Tensor, levels, clamp, num_quantizers: int):
    d = len(levels)
    if x.shape[-1] != d or tuple(scales.shape) != (num_quantizers, d) or len(clamp) != d:
        raise ValueError(f'fused_residual_fsq_eval: x (..., {d}), scales ({num_quantizers}, {d}) and {d} clamp '
                         f'values expected, got x {tuple(x.shape)}, scales {tuple(scales.shape)}, '
                         f'{len(clamp)} clamp values')
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f'fused_residual_fsq_eval takes 1 <= d <= {MAX_DIM}, got {d}')
    if num_quantizers < 1:
        raise ValueError(f'num_quantizers must be >= 1, got {num_quantizers}')


def fused_residual_fsq_eval_plain(x: torch.Tensor, scales: torch.Tensor, *, levels, clamp, num_quantizers: int):
    """Plain version of the kernel: the soft clamp in f32, then the chain;
    (quantized (..., d) in x.dtype, indices (..., q) int32)."""
    _check(x, scales, levels, clamp, num_quantizers)
    qsum, indices = residual_fsq_chain_plain(soft_clamp_plain(x.float(), clamp), scales, levels)
    return qsum.to(x.dtype), indices


# -- the kernel's plan: constants, reciprocals and the proofs of its routes ---------

# The kernel divides r / s as q0 = RN(r y), e = fma(-q0, s, r), RN(e y + q0)
# with y = RN(1 / s) (Markstein's correction step), which is the correctly
# rounded quotient when s and y are normal and e is exact. e is exact when r
# is 0 or |r| >= 2^-102 (its exact value is then a multiple of 2^-149 of at
# most 24 bits). Every nonzero residual of the chain is at least the finest
# grid of its sources, the soft-clamped token z and the layers' quanta
# code * s: the wrapper proves the quanta's grid per configuration, and the
# kernel checks z per token (MIN_FAST_Z, kMinFastZ in the source).
RESIDUAL_FLOOR = 2.0 ** -102
MIN_FAST_Z = 2.0 ** -79           # ulp(z) >= 2^-102
# scales and clamp values whose quotients stay in the normal range
SCALE_RANGE = (2.0 ** -100, 2.0 ** 20)
CLAMP_RANGE = (1.0, 2.0 ** 20)
U32 = 2.0 ** -24


def round_f32(v: Fraction) -> float:
    """v rounded to the nearest binary32 value, ties to even, in one
    rounding (no detour through float64)."""
    if v == 0:
        return 0.0
    sign, a = (-1.0, -v) if v < 0 else (1.0, v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    ulp = Fraction(2) ** (max(e, -126) - 23)
    m = a / ulp
    n, rem = divmod(m.numerator, m.denominator)
    if 2 * rem > m.denominator or (2 * rem == m.denominator and n % 2):
        n += 1
    out = n * ulp
    if out > Fraction(2) ** 128 - Fraction(2) ** 104:   # beyond FLT_MAX + half an ulp
        return sign * math.inf
    return sign * float(out)


def reciprocal_f32(v: float) -> float:
    """RN(1 / v) in binary32, v a binary32 value."""
    return round_f32(1 / Fraction(v))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """RN(a b + c) in f32, rounded once, as the card's FFMA rounds it: the
    product of two f32 values is exact in float64, the sum is split into its
    float64 value and exact error (TwoSum), and a float64 sum that lands on a
    midpoint of two f32 values is resolved by the error's sign."""
    a, b, c = torch.broadcast_tensors(a.double(), b.double(), c.double())
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    f = s.float()
    f64 = f.double()
    other = torch.nextafter(f, torch.where(s > f64, math.inf, -math.inf).float())
    midpoint = (f64 != s) & (s == (f64 + other.double()) / 2) & (err != 0)
    beyond = midpoint & (torch.sign(err) == torch.sign(other.double() - s))
    return torch.where(beyond, other, f)


def exact_quotient(a: torch.Tensor, b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The kernel's division of a by b in f32 from y = RN(1 / b): q0 = RN(a y),
    e = fma(-q0, b, a), fma(e, y, q0)."""
    q0 = a.float() * y
    return fma_f32(fma_f32(-q0, b, a), y, q0)


@dataclass(frozen=True)
class KernelPlan:
    """What the kernel takes for one configuration, and the routes proven
    for it. `consts` is the kernel's constant block, f32 values in order:
    L - 1, 2 / (L - 1) (the step), RN(1 / step), clamp, RN(1 / clamp), basis
    (d each), then the scales (q, d) and RN(1 / scale) (q, d)."""

    levels: tuple
    clamp: tuple
    num_quantizers: int
    consts: tuple
    exact_division: bool   # every division of the chain by the sequence, no IEEE division
    integer_index: bool    # index = sum of bracket * basis, exact in integers
    index_error_bound: float | None   # the proof's bound on |plain float index - integer index|


def canonical_scales(levels, num_quantizers: int) -> torch.Tensor:
    """(q, d) f32 scales L^-i as ResidualFSQ computes them (float64, then
    f32). The kernel holds the scales it is given to these bit for bit: a
    launch with other scales takes the IEEE divisions throughout."""
    return torch.tensor([[float(level) ** -i for level in levels] for i in range(num_quantizers)],
                        dtype=torch.float64).float()


def _reciprocals(t: torch.Tensor) -> torch.Tensor:
    return torch.tensor([reciprocal_f32(float(v)) for v in t.reshape(-1)], dtype=torch.float32).reshape(t.shape)


def _codes(level: int, step: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Every bracket 0 .. L - 1 of one dim and its code, as the chain
    computes it: (brackets f32, codes f32)."""
    bracket = torch.arange(level, dtype=torch.float32)
    return bracket, step * bracket - 1.0


@functools.lru_cache(maxsize=64)
def kernel_plan(levels: tuple, clamp: tuple, num_quantizers: int) -> KernelPlan:
    """Constants and route proofs for one configuration, on the host, once.

    exact_division: every clamp value in CLAMP_RANGE and every scale in
    SCALE_RANGE (normal quotients and reciprocals), and the smallest nonzero
    quantum RN(code * s) of every layer and dim at least 2^-79, so that with
    the kernel's per-token check on z every nonzero residual is at least
    2^-102 and the sequence's remainder is exact. (The digit route's
    (code + 1) / step divides values that are 0 or at least 2^-24.)

    integer_index: the plain chain's index is round(sum_d RN(RN(RN(code + 1)
    / step) basis)). Each dim's term is a function of its bracket alone; its
    largest error against bracket * basis over all brackets is found by
    enumerating them, and the f32 sum of d nonnegative terms adds at most
    (d - 1) 2^-24 S, S the largest possible sum. When the two together stay
    below 0.5 (and prod(levels) <= 2^24, so that the integer sum is exact in
    f32), the rounded float sum is the integer sum of bracket * basis."""
    d, q = len(levels), num_quantizers
    k = chain_constants(levels, 'cpu')
    lm1, step, basis = k['levels_minus_1'], k['inv_step'], k['basis']
    scales = canonical_scales(levels, q)
    c = torch.tensor(clamp, dtype=torch.float32)

    exact = all(CLAMP_RANGE[0] <= abs(float(v)) <= CLAMP_RANGE[1] for v in c)
    exact = exact and bool(((scales >= SCALE_RANGE[0]) & (scales <= SCALE_RANGE[1])).all())
    enumerate_index = math.prod(levels) <= 2 ** 24
    terms_max, term_err = [], []
    for j, level in enumerate(levels):
        bracket, code = _codes(level, step[j])
        nonzero = code[code != 0].abs()
        smallest_quantum = (nonzero.min() * scales[:, j]).abs()
        exact = exact and bool((smallest_quantum >= MIN_FAST_Z).all())
        if enumerate_index:
            term = ((code + 1.0) / step[j]) * basis[j]
            terms_max.append(float(term.max()))
            term_err.append(float((term.double() - bracket.double() * float(basis[j])).abs().max()))
    bound = None
    if len(term_err) == d:
        bound = sum(term_err) + (d - 1) * U32 * sum(terms_max) * (1 + 2 ** -20)
    consts = torch.cat([lm1, step, _reciprocals(step), c, _reciprocals(c), basis, scales.reshape(-1),
                        _reciprocals(scales).reshape(-1)])
    return KernelPlan(levels=tuple(levels), clamp=tuple(clamp), num_quantizers=q,
                      consts=tuple(consts.tolist()), exact_division=exact,
                      integer_index=bound is not None and bound < 0.5, index_error_bound=bound)


def _plan_tensors(plan: KernelPlan):
    d, q = len(plan.levels), plan.num_quantizers
    t = torch.tensor(plan.consts, dtype=torch.float32)
    per_dim = t[:6 * d].reshape(6, d)
    return dict(lm1=per_dim[0], step=per_dim[1], rstep=per_dim[2], clamp=per_dim[3], rclamp=per_dim[4],
                basis=per_dim[5], scales=t[6 * d:6 * d + q * d].reshape(q, d), rscales=t[6 * d + q * d:].reshape(q, d))


def soft_clamp_kernel_plain(x: torch.Tensor, plan: KernelPlan) -> torch.Tensor:
    """The kernel's soft clamp on the exact-division route, in plain
    PyTorch: x / c by the sequence (an infinite quotient passed on as it
    is), then tanh(.) * c."""
    k = _plan_tensors(plan)
    q0 = x.float() * k['rclamp']
    xc = torch.where(q0.isinf(), q0, exact_quotient(x, k['clamp'], k['rclamp']))
    return torch.tanh(xc) * k['clamp']


def kernel_chain_plain(z: torch.Tensor, plan: KernelPlan):
    """The kernel's chain in plain PyTorch, its FMAs rounded once
    (`fma_f32`), on soft-clamped f32 tokens z (..., d). Tokens on the
    exact-division route (the plan proves it and every dim of z is 0 or at
    least MIN_FAST_Z) divide by the sequence and take the bracket from one
    saturated FMA, floor(RN(L - 1) * sat(RN(zi / 2 + 1/2))) + 1/2), and the
    index on the integer route; other tokens take `residual_fsq_chain_plain`,
    as the kernel takes its IEEE divisions. Returns (qsum, indices, the
    residual each layer divided), and gives residual_fsq_chain_plain's bits
    wherever the plan's proofs hold."""
    k = _plan_tensors(plan)
    r = z.float()
    acc = torch.zeros_like(r)
    fast = ((r == 0) | (r.abs() >= MIN_FAST_Z)).all(-1, keepdim=True) & plan.exact_division
    indices, residuals = [], []
    for s, ys in zip(k['scales'], k['rscales']):
        residuals.append(r)
        zi = exact_quotient(r, s, ys)
        half = fma_f32(zi, torch.tensor(0.5), torch.tensor(0.5)).clamp(0.0, 1.0)
        bracket = torch.floor((k['lm1'] * half) + 0.5)
        code = k['step'] * bracket - 1.0
        quantized = code * s
        r = r - quantized
        acc = acc + quantized
        if plan.integer_index:
            idx = (bracket.long() * k['basis'].long()).sum(-1)
        else:
            terms = exact_quotient(code + 1.0, k['step'], k['rstep']) * k['basis']
            total = torch.zeros_like(terms[..., 0])
            for j in range(terms.shape[-1]):
                total = total + terms[..., j]
            idx = torch.round(total)
        indices.append(idx.to(torch.int32))
    qsum_plain, indices_plain = residual_fsq_chain_plain(z, k['scales'], plan.levels)
    qsum = torch.where(fast, acc, qsum_plain)
    idx = torch.where(fast, torch.stack(indices, -1), indices_plain)
    return qsum, idx, torch.stack(residuals)


def _kernel_library() -> ctypes.CDLL:
    lib = _build.load('residual_fsq_fused')
    fn = lib.vqtpu_residual_fsq_eval_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.vqtpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vqtpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def _plan_buffers(levels: tuple, clamp: tuple, num_quantizers: int, device: torch.device):
    """The plan and its constant block twice: in host memory (the fixed
    instantiations take it by value, in the kernel's parameter space) and on
    the device (the general instantiation and the IEEE route read it there);
    made once per configuration and device."""
    plan = kernel_plan(levels, clamp, num_quantizers)
    host = torch.tensor(plan.consts, dtype=torch.float32)
    return plan, host, host.to(device)


def _fused_residual_fsq_eval_cuda(x, scales, levels, clamp, num_quantizers):
    """The kernel on a CUDA tensor; counts the launch."""
    _check(x, scales, levels, clamp, num_quantizers)
    d, q = len(levels), num_quantizers
    lead = x.shape[:-1]
    n = math.prod(lead)
    if n >= 2**31:
        raise ValueError(f'{n} tokens are out of the kernel range')
    xt = x.reshape(n, d).float().contiguous()
    if xt.data_ptr() % 16:
        xt = xt.clone()               # the kernel reads a token's dims 16 bytes at a time
    qsum = torch.empty((n, d), dtype=torch.float32, device=x.device)
    indices = torch.empty((n, q), dtype=torch.int32, device=x.device)
    if n:
        lib = _kernel_library()
        plan, host, dev = _plan_buffers(tuple(levels), tuple(float(c) for c in clamp), q, x.device)
        scales = scales.to(device=x.device, dtype=torch.float32).contiguous()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.vqtpu_residual_fsq_eval_f32(xt.data_ptr(), host.data_ptr(), dev.data_ptr(), scales.data_ptr(),
                                                  qsum.data_ptr(), indices.data_ptr(), n, d, q,
                                                  int(plan.exact_division), int(plan.integer_index), stream)
        if err != 0:
            msg = lib.vqtpu_cuda_error_string(err).decode()
            raise RuntimeError(f'fused_residual_fsq_eval kernel launch failed: {msg} ({err})')
        fused_residual_fsq_eval.launches += 1
    return qsum.to(x.dtype).reshape(*lead, d), indices.reshape(*lead, q)


@torch.library.custom_op('vqtpu::residual_fsq_eval', mutates_args=(), device_types='cpu')
def _residual_fsq_eval_op(
    x: torch.Tensor, scales: torch.Tensor, levels: list[int], clamp: list[float], num_quantizers: int
) -> tuple[torch.Tensor, torch.Tensor]:
    return fused_residual_fsq_eval_plain(x, scales, levels=levels, clamp=clamp, num_quantizers=num_quantizers)


@_residual_fsq_eval_op.register_kernel('cuda')
def _(x, scales, levels, clamp, num_quantizers):
    return _fused_residual_fsq_eval_cuda(x, scales, levels, clamp, num_quantizers)


@_residual_fsq_eval_op.register_fake
def _(x, scales, levels, clamp, num_quantizers):
    return torch.empty_like(x), x.new_empty((*x.shape[:-1], num_quantizers), dtype=torch.int32)


def fused_residual_fsq_eval(x: torch.Tensor, scales: torch.Tensor, *, levels, clamp, num_quantizers: int):
    """Eval forward of the preserve-symmetry hard-clamp ResidualFSQ stack.

    x: (..., d) tokens before the soft clamp, cast to f32 first. scales:
    (q, d), the module's `_scales()`. levels and clamp: d values each.
    Returns (quantized (..., d) in x.dtype, indices (..., q) int32).

    A CUDA tensor launches the Hopper kernel (counted in
    `fused_residual_fsq_eval.launches`) with the routes `kernel_plan`
    proves for the configuration, a CPU tensor takes
    `fused_residual_fsq_eval_plain`; any other device raises. The call is
    the op `torch.ops.vqtpu.residual_fsq_eval`; no gradient flows through
    it."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'fused_residual_fsq_eval runs on CUDA or CPU tensors, not {x.device}')
    _check(x, scales, levels, clamp, num_quantizers)
    return torch.ops.vqtpu.residual_fsq_eval(x.detach(), scales.detach(), [int(v) for v in levels],
                                             [float(c) for c in clamp], int(num_quantizers))


fused_residual_fsq_eval.launches = 0
