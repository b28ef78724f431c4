"""LFQ entropy statistics over the implicit codebook (counterpart of
vqtpu/kernels/lfq_entropy.py).

LFQ's entropy aux loss needs, for every token, a softmax over all K = 2^d
implicit codes. Every code is a vector of +v / -v (dim j of code k is +v
when bit d-1-j of k is set, MSB first), so the codebook is generated, never
stored. Four sweeps over the codes compute the statistics and their
gradient without an (N, K) tensor in memory:

    logits l_nk = (x_n . c_k * -2) * -inv_temp
    A  (fwd): m = 2 |inv_temp| |v| ||x_n||_1, the largest logit in closed form;
              s = sum_k exp(l - m)                    -> logz = m + log s
    B  (fwd): p = exp(l - logz); ent_n = sum_k -p log max(p, eps);
              avgp_k = sum_n w_n p_nk
    C  (bwd): g = entbar f'(p) + w gbar, f'(p) = -log max(p, eps) - [p > eps];
              sigma_n = sum_k p g,  gdot_n = sum_k p gbar_k
    D  (bwd): dx_n = 2 inv_temp sum_k p (g - sigma_n) c_k

`sweep_a` .. `sweep_d` dispatch on where their tensors lie: CUDA tensors go
to the hand-written Hopper kernels in csrc/lfq_entropy.cu (deterministic, no
float atomics), CPU tensors to `sweep_a_plain` .. `sweep_d_plain`, the same
formulas in plain PyTorch, chunked over K. Two custom ops tie them
together: `torch.ops.vqtpu.lfq_entropy` runs A then B and
`torch.ops.vqtpu.lfq_entropy_backward` C then D, each with a CPU
implementation (the plain sweeps), a CUDA one (the kernels) and a fake for
shapes; the second is the first's autograd formula, so `torch.compile`
traces both into its graph and keeps them opaque. `lfq_entropy_stats` is
the entry point.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

MAX_DIM = 24

# the plain sweeps compute logits for this many (token, code) pairs at a time
_PLAIN_CHUNK_ELEMS = 1 << 26


def code_magnitude(codebook_dim: int, codebook_scale: float, spherical: bool) -> float:
    """The shared |entry| of every implicit code, with LFQ's arithmetic
    (bits * 2s - s, then l2norm * s when spherical) in float32."""
    s = np.float32(codebook_scale)
    if not spherical:
        return float(s)
    norm = np.sqrt(np.float32(codebook_dim) * s * s, dtype=np.float32)
    return float(s / np.maximum(norm, np.float32(1e-6)) * s)


def code_tile(start: int, size: int, d: int, v: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """(size, d) codes start .. start + size - 1: +v where the bit is set,
    -v where it is not, dims MSB first."""
    idx = torch.arange(start, start + size, device=device)
    shifts = torch.arange(d - 1, -1, -1, device=device)
    bits = (idx[:, None] >> shifts) & 1
    return torch.where(bits == 1, torch.tensor(v, dtype=dtype, device=device),
                       torch.tensor(-v, dtype=dtype, device=device))


def _chunk(n: int, k: int) -> int:
    """Codes per plain chunk: a power of two that divides k."""
    budget = max(1, _PLAIN_CHUNK_ELEMS // max(n, 1))
    return min(k, 1 << (budget.bit_length() - 1))


def _logits(x: torch.Tensor, start: int, size: int, v: float, inv_temp: float) -> torch.Tensor:
    codes = code_tile(start, size, x.shape[1], v, x.dtype, x.device)
    # two rounded multiplies, as LFQ's distance = -2 x.c; logits = distance * -inv_temp
    return ((x @ codes.T) * -2.0) * -inv_temp


def _chunks(x: torch.Tensor, k: int):
    size = _chunk(x.shape[0], k)
    return ((start, size) for start in range(0, k, size))


def logit_shift(x: torch.Tensor, *, v: float, inv_temp: float) -> torch.Tensor:
    """(N, d) -> (N,) the largest logit of each token in closed form,
    2 |inv_temp| |v| ||x_n||_1: every code is +-v in each dim, and the sign
    pattern of x reaches the largest dot, |v| ||x_n||_1."""
    return x.abs().sum(1) * abs(v) * (2.0 * abs(inv_temp))


def sweep_a_plain(x: torch.Tensor, *, k: int, v: float, inv_temp: float):
    """(N, d) -> (m, s) (N,) with logz = m + log s: m is `logit_shift` and
    s = sum_k exp(l_k - m), one shifted sum over the K codes (each term at
    most 1 up to rounding, so s >= 1)."""
    m = logit_shift(x, v=v, inv_temp=inv_temp)
    s = torch.zeros_like(m)
    for start, size in _chunks(x, k):
        s = s + torch.exp(_logits(x, start, size, v, inv_temp) - m[:, None]).sum(1)
    return m, s


def sweep_b_plain(x, w, logz, *, k: int, v: float, inv_temp: float, eps: float):
    """(N, d), (N,) weights, (N,) logz -> (ent (N,), avgp (K,))."""
    ent = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    avgp = []
    for start, size in _chunks(x, k):
        p = torch.exp(_logits(x, start, size, v, inv_temp) - logz[:, None])
        ent = ent + (-p * torch.log(p.clamp_min(eps))).sum(1)
        avgp.append((p * w[:, None]).sum(0))
    return ent, torch.cat(avgp)


def _probs_and_g(x, w, logz, entbar, gbar, start, size, v, inv_temp, eps):
    p = torch.exp(_logits(x, start, size, v, inv_temp) - logz[:, None])
    fprime = -torch.log(p.clamp_min(eps)) - (p > eps).to(p.dtype)
    gb = gbar[start:start + size]
    g = entbar[:, None] * fprime + w[:, None] * gb
    return p, g, gb


def sweep_c_plain(x, w, logz, entbar, gbar, *, k: int, v: float, inv_temp: float, eps: float):
    """-> (sigma (N,), gdot (N,)), the softmax-VJP statistics."""
    sigma = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    gdot = torch.zeros_like(sigma)
    for start, size in _chunks(x, k):
        p, g, gb = _probs_and_g(x, w, logz, entbar, gbar, start, size, v, inv_temp, eps)
        sigma = sigma + (p * g).sum(1)
        gdot = gdot + (p * gb).sum(1)
    return sigma, gdot


def sweep_d_plain(x, w, logz, entbar, gbar, sigma, *, k: int, v: float, inv_temp: float, eps: float):
    """-> dx (N, d) = 2 inv_temp sum_k p (g - sigma) c_k."""
    dx = torch.zeros_like(x)
    for start, size in _chunks(x, k):
        p, g, _ = _probs_and_g(x, w, logz, entbar, gbar, start, size, v, inv_temp, eps)
        codes = code_tile(start, size, x.shape[1], v, x.dtype, x.device)
        dx = dx + ((p * (g - sigma[:, None])) @ codes) * (2.0 * inv_temp)
    return dx


def entropy_fwd_plain(x, w, k: int, v: float, inv_temp: float, eps: float = 1e-5):
    """Sweeps A and B in plain PyTorch: (ent (N,), avgp (K,), logz (N,))."""
    m, s = sweep_a_plain(x, k=k, v=v, inv_temp=inv_temp)
    logz = m + torch.log(s)
    ent, avgp = sweep_b_plain(x, w, logz, k=k, v=v, inv_temp=inv_temp, eps=eps)
    return ent, avgp, logz


def entropy_bwd_plain(x, w, logz, entbar, gbar, k: int, v: float, inv_temp: float, eps: float = 1e-5):
    """Sweeps C and D in plain PyTorch: (dx (N, d), dw (N,) = gdot)."""
    kw = dict(k=k, v=v, inv_temp=inv_temp, eps=eps)
    sigma, gdot = sweep_c_plain(x, w, logz, entbar, gbar, **kw)
    return sweep_d_plain(x, w, logz, entbar, gbar, sigma, **kw), gdot


# -- the Hopper kernels ---------------------------------------------------------


def _kernel_library() -> ctypes.CDLL:
    lib = _build.load('lfq_entropy')
    ptr, n, d, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    signatures = {
        'vqtpu_lfq_sweep_a': [ptr] * 4 + [n, d, f, f, ptr],
        'vqtpu_lfq_sweep_b': [ptr] * 6 + [n, d, f, f, f, ptr],
        'vqtpu_lfq_sweep_c': [ptr] * 8 + [n, d, f, f, f, ptr],
        'vqtpu_lfq_sweep_d': [ptr] * 8 + [n, d, f, f, f, ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vqtpu_lfq_scratch_floats.argtypes = [ctypes.c_int, n, d]
    lib.vqtpu_lfq_scratch_floats.restype = ctypes.c_longlong
    lib.vqtpu_lfq_avgp_rows.argtypes = [n, d]
    lib.vqtpu_lfq_avgp_rows.restype = ctypes.c_longlong
    lib.vqtpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vqtpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _runs_plain(name: str, x: torch.Tensor) -> bool:
    """True for CPU tensors (the plain sweep), False for CUDA tensors (the
    kernel); raises for any other device."""
    if x.device.type == 'cpu':
        return True
    if x.device.type != 'cuda':
        raise ValueError(f'{name} runs on CUDA or CPU tensors, not {x.device}')
    return False


def _check_operands(name: str, x: torch.Tensor, k: int, columns=(), gbar=None):
    """Raise on what the kernels do not take; returns (n, d)."""
    if x.ndim != 2:
        raise ValueError(f'{name} takes x of shape (N, d), got {tuple(x.shape)}')
    n, d = x.shape
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f'{name}: the kernels keep a token in registers and take 1 <= d <= {MAX_DIM}, got {d}')
    if k != 1 << d:
        raise ValueError(f'{name}: k must be 2^d = {1 << d}, got {k}')
    if n >= 2**31:
        raise ValueError(f'{name}: {n} tokens are out of the kernel range')
    tensors = [('x', x, (n, d))] + [(c, t, (n,)) for c, t in columns]
    if gbar is not None:
        tensors.append(('gbar', gbar, (k,)))
    for label, t, shape in tensors:
        if tuple(t.shape) != shape:
            raise ValueError(f'{name}: {label} must have shape {shape}, got {tuple(t.shape)}')
        if t.dtype != torch.float32:
            raise TypeError(f'{name}: {label} must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: {label} must be contiguous')
        if t.device != x.device:
            raise ValueError(f'{name}: {label} is on {t.device}, x on {x.device}')
    return n, d


def _launch(name: str, tensors, scalars) -> None:
    """Run C function vqtpu_lfq_<name> (name 'sweep_a' .. 'sweep_d') on the
    tensors' pointers, its scratch, n, d and the scalars, on the current
    stream; raise on a launch error."""
    lib = _kernel_library()
    x = tensors[0]
    n, d = x.shape
    scratch = torch.empty(lib.vqtpu_lfq_scratch_floats('abcd'.index(name[-1]), n, d), device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f'vqtpu_lfq_{name}')(
            *(t.data_ptr() for t in tensors), scratch.data_ptr(), n, d, *scalars, stream)
    if err != 0:
        msg = lib.vqtpu_cuda_error_string(err).decode()
        raise RuntimeError(f'{name} kernel launch failed: {msg} ({err})')


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels read gbar 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def sweep_a(x: torch.Tensor, *, k: int, v: float, inv_temp: float):
    """(m, s) with logz = m + log s (pass A): m is the shift of
    `logit_shift`, the largest logit in closed form, not the largest of the
    computed logits (the kernel rounds it in base 2), and s the sum of
    exp(l - m). CUDA tensors launch the kernel (counted in
    `sweep_a.launches`), CPU tensors take `sweep_a_plain`."""
    if _runs_plain('sweep_a', x):
        return sweep_a_plain(x, k=k, v=v, inv_temp=inv_temp)
    n, d = _check_operands('sweep_a', x, k)
    m = torch.empty(n, device=x.device)
    s = torch.empty(n, device=x.device)
    if n:
        _launch('sweep_a', (x, m, s), (v, inv_temp))
        sweep_a.launches += 1
    return m, s


def sweep_b(x, w, logz, *, k: int, v: float, inv_temp: float, eps: float):
    """(ent (N,), avgp (K,)) (pass B). CUDA tensors launch the kernel
    (`sweep_b.launches`), CPU tensors take `sweep_b_plain`."""
    if _runs_plain('sweep_b', x):
        return sweep_b_plain(x, w, logz, k=k, v=v, inv_temp=inv_temp, eps=eps)
    n, d = _check_operands('sweep_b', x, k, (('w', w), ('logz', logz)))
    ent = torch.empty(n, device=x.device)
    if not n:
        return ent, torch.zeros(k, device=x.device)
    rows = torch.empty(_kernel_library().vqtpu_lfq_avgp_rows(n, d), k, device=x.device)
    _launch('sweep_b', (x, w, logz, ent, rows), (v, inv_temp, eps))
    sweep_b.launches += 1
    # the rows of per-token-group column sums, added in row order
    return ent, rows.sum(0)


def sweep_c(x, w, logz, entbar, gbar, *, k: int, v: float, inv_temp: float, eps: float):
    """(sigma (N,), gdot (N,)) (pass C). CUDA tensors launch the kernel
    (`sweep_c.launches`), CPU tensors take `sweep_c_plain`."""
    if _runs_plain('sweep_c', x):
        return sweep_c_plain(x, w, logz, entbar, gbar, k=k, v=v, inv_temp=inv_temp, eps=eps)
    n, d = _check_operands('sweep_c', x, k, (('w', w), ('logz', logz), ('entbar', entbar)), gbar)
    gbar = _aligned(gbar)
    sigma = torch.empty(n, device=x.device)
    gdot = torch.empty(n, device=x.device)
    if n:
        _launch('sweep_c', (x, w, logz, entbar, gbar, sigma, gdot), (v, inv_temp, eps))
        sweep_c.launches += 1
    return sigma, gdot


def sweep_d(x, w, logz, entbar, gbar, sigma, *, k: int, v: float, inv_temp: float, eps: float):
    """dx (N, d) (pass D). CUDA tensors launch the kernel
    (`sweep_d.launches`), CPU tensors take `sweep_d_plain`."""
    if _runs_plain('sweep_d', x):
        return sweep_d_plain(x, w, logz, entbar, gbar, sigma, k=k, v=v, inv_temp=inv_temp, eps=eps)
    n, d = _check_operands('sweep_d', x, k,
                           (('w', w), ('logz', logz), ('entbar', entbar), ('sigma', sigma)), gbar)
    gbar = _aligned(gbar)
    dx = torch.empty(n, d, device=x.device)
    if n:
        _launch('sweep_d', (x, w, logz, entbar, gbar, sigma, dx), (v, inv_temp, eps))
        sweep_d.launches += 1
    return dx


for _sweep in (sweep_a, sweep_b, sweep_c, sweep_d):
    _sweep.launches = 0
SWEEPS = {'a': sweep_a, 'b': sweep_b, 'c': sweep_c, 'd': sweep_d}


def _entropy_fwd_kernels(x, w, k, v, inv_temp, eps):
    """Sweeps A then B through the kernels: (ent, avgp, logz)."""
    m, s = sweep_a(x, k=k, v=v, inv_temp=inv_temp)
    logz = m + torch.log(s)
    ent, avgp = sweep_b(x, w, logz, k=k, v=v, inv_temp=inv_temp, eps=eps)
    return ent, avgp, logz


@torch.library.custom_op('vqtpu::lfq_entropy', mutates_args=(), device_types='cpu')
def _lfq_entropy_op(
    x: torch.Tensor, w: torch.Tensor, k: int, v: float, inv_temp: float, eps: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return entropy_fwd_plain(x, w, k, v, inv_temp, eps)


@_lfq_entropy_op.register_kernel('cuda')
def _(x, w, k, v, inv_temp, eps):
    return _entropy_fwd_kernels(x, w, k, v, inv_temp, eps)


@_lfq_entropy_op.register_fake
def _(x, w, k, v, inv_temp, eps):
    n = x.shape[0]
    return x.new_empty(n), x.new_empty(k), x.new_empty(n)


def _entropy_bwd(x, w, logz, entbar, gbar, k, v, inv_temp, eps, need_dx, sweep_c, sweep_d):
    kw = dict(k=k, v=v, inv_temp=inv_temp, eps=eps)
    sigma, gdot = sweep_c(x, w, logz, entbar, gbar, **kw)
    dx = sweep_d(x, w, logz, entbar, gbar, sigma, **kw) if need_dx else x.new_empty(0)
    return dx, gdot


@torch.library.custom_op('vqtpu::lfq_entropy_backward', mutates_args=(), device_types='cpu')
def _lfq_entropy_backward_op(
    x: torch.Tensor, w: torch.Tensor, logz: torch.Tensor, entbar: torch.Tensor, gbar: torch.Tensor,
    k: int, v: float, inv_temp: float, eps: float, need_dx: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    return _entropy_bwd(x, w, logz, entbar, gbar, k, v, inv_temp, eps, need_dx, sweep_c_plain, sweep_d_plain)


@_lfq_entropy_backward_op.register_kernel('cuda')
def _(x, w, logz, entbar, gbar, k, v, inv_temp, eps, need_dx):
    return _entropy_bwd(x, w, logz, entbar, gbar, k, v, inv_temp, eps, need_dx, sweep_c, sweep_d)


@_lfq_entropy_backward_op.register_fake
def _(x, w, logz, entbar, gbar, k, v, inv_temp, eps, need_dx):
    return x.new_empty(x.shape if need_dx else (0,)), x.new_empty(x.shape[0])


def _entropy_setup_context(ctx, inputs, output):
    x, w, k, v, inv_temp, eps = inputs
    ctx.save_for_backward(x, w, output[2])
    ctx.params = dict(k=k, v=v, inv_temp=inv_temp, eps=eps)


def _entropy_backward(ctx, entbar, gbar, _logz_bar):
    """Sweeps C then D: dx and dw = gdot (sweep D only when x needs its
    gradient)."""
    x, w, logz = ctx.saved_tensors
    p = ctx.params
    dx, gdot = torch.ops.vqtpu.lfq_entropy_backward(
        x, w, logz, entbar.contiguous(), gbar.contiguous(), p['k'], p['v'], p['inv_temp'], p['eps'],
        ctx.needs_input_grad[0])
    return (dx if ctx.needs_input_grad[0] else None, gdot if ctx.needs_input_grad[1] else None,
            None, None, None, None)


torch.library.register_autograd('vqtpu::lfq_entropy', _entropy_backward, setup_context=_entropy_setup_context)


def lfq_entropy_stats(x: torch.Tensor, w: torch.Tensor, *, k: int, v: float, inv_temp: float,
                      eps: float = 1e-5):
    """(ent (N,), avg_prob_num (K,)) for the implicit +-v codebook of k = 2^d
    codes: ent_n is the entropy of token n's code softmax (unweighted; the
    caller applies w), avg_prob_num_k = sum_n w_n p_nk. x is (N, d) with any
    N >= 0 (no padding), w (N,). Differentiable in x and w through sweeps C
    and D. CUDA tensors run the Hopper kernels (f32 and contiguous, or they
    raise), CPU tensors the plain sweeps; the call is the op
    `torch.ops.vqtpu.lfq_entropy`."""
    if x.ndim != 2 or tuple(w.shape) != (x.shape[0],):
        raise ValueError(f'lfq_entropy_stats takes x (N, d) and w (N,), got {tuple(x.shape)}, {tuple(w.shape)}')
    if k != 1 << x.shape[1]:
        raise ValueError(f'k must be 2^d = {1 << x.shape[1]}, got {k}')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'lfq_entropy_stats runs on CUDA or CPU tensors, not {x.device}')
    ent, avgp, _ = torch.ops.vqtpu.lfq_entropy(x, w, k, float(v), float(inv_temp), float(eps))
    return ent, avgp
