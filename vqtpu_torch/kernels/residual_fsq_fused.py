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
the hand-written Hopper kernel in csrc/residual_fsq_fused.cu (one thread per
token; every multiply and add rounded on its own, as PyTorch's elementwise
kernels round them, so the kernel gives the plain version's bits), a CPU
tensor to `fused_residual_fsq_eval_plain`, the same chain in plain PyTorch,
factored as `soft_clamp_plain` and `residual_fsq_chain_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import math

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


def _kernel_library() -> ctypes.CDLL:
    lib = _build.load('residual_fsq_fused')
    fn = lib.vqtpu_residual_fsq_eval_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.vqtpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vqtpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def _kernel_constants(levels: tuple, clamp: tuple, device: torch.device) -> torch.Tensor:
    """The kernel's per-dim constants in one f32 buffer: L - 1, 2 / (L - 1),
    clamp and basis, computed with the plain version's own expressions;
    made once per configuration and device, so a forward copies nothing
    from the host."""
    k = chain_constants(levels, device)
    c = torch.tensor(clamp, dtype=torch.float32, device=device)
    return torch.cat([k['levels_minus_1'], k['inv_step'], c, k['basis']])


def fused_residual_fsq_eval(x: torch.Tensor, scales: torch.Tensor, *, levels, clamp, num_quantizers: int):
    """Eval forward of the preserve-symmetry hard-clamp ResidualFSQ stack.

    x: (..., d) tokens before the soft clamp, cast to f32 first. scales:
    (q, d), the module's `_scales()`. levels and clamp: d values each.
    Returns (quantized (..., d) in x.dtype, indices (..., q) int32).

    A CUDA tensor launches the Hopper kernel (counted in
    `fused_residual_fsq_eval.launches`), a CPU tensor takes
    `fused_residual_fsq_eval_plain`; any other device raises."""
    if x.device.type == 'cpu':
        return fused_residual_fsq_eval_plain(x, scales, levels=levels, clamp=clamp, num_quantizers=num_quantizers)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_residual_fsq_eval runs on CUDA or CPU tensors, not {x.device}')
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
        consts = _kernel_constants(tuple(levels), tuple(float(c) for c in clamp), x.device)
        scales = scales.to(device=x.device, dtype=torch.float32).contiguous()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.vqtpu_residual_fsq_eval_f32(xt.data_ptr(), consts.data_ptr(), scales.data_ptr(),
                                                  qsum.data_ptr(), indices.data_ptr(), n, d, q, stream)
        if err != 0:
            msg = lib.vqtpu_cuda_error_string(err).decode()
            raise RuntimeError(f'fused_residual_fsq_eval kernel launch failed: {msg} ({err})')
        fused_residual_fsq_eval.launches += 1
    return qsum.to(x.dtype).reshape(*lead, d), indices.reshape(*lead, q)


fused_residual_fsq_eval.launches = 0
