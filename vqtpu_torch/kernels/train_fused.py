"""The fused training step: selection, exact lookup and EMA statistics
(counterpart of vqtpu/kernels/train_fused.py).

    idx  = first argmax_j (x . e_j + bias_j)    q = codebook[idx]
    bins = sum_t w_t onehot(idx_t)              esum = sum_t w_t onehot(idx_t) x_t

`fused_train_quantize` dispatches on where its tensors lie: CUDA tensors go
to the hand-written Hopper kernels in csrc/train_fused.cu (one call: the
split-TF32 selection of `nearest_code` with its row copy, then the
statistics by sorted code; deterministic, no float atomics), CPU tensors to
`fused_train_quantize_plain`, the same function in plain PyTorch.

`code_statistics_plain` is also the statistics of the unfused training
route (`train_fused='auto'|'off'`). It sums with `index_put_(...,
accumulate=True)`: on the card that is PyTorch's sort-based accumulation,
deterministic and in f32 whatever the TF32 setting, and it never forms the
(n, c) one-hot.

`code_sums` is the kernel's statistics alone, for indices chosen elsewhere:
on the card the passes by sorted code of csrc/train_fused.cu. It is the
backward of `lookup_with_code_grad`, the row lookup of a learnable codebook:
the selection kernel picks the codes and copies their rows, and the
codebook's gradient is the sum by code of the rows' gradients, in token
order within a code, so two backward passes give the same bits
(`index_select`'s own backward, `index_add_`, sums with float atomics in
an order that changes from run to run).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .distance import (
    _check_kernel_operands, gather_codes_per_head, nearest_code_plain, quantize_lookup, selection_bias,
)


def code_statistics_plain(
    x: torch.Tensor, idx: torch.Tensor, codebook_size: int,
    weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, n, d) tokens, (h, n) indices in [0, c), optional (h, n) weights
    -> (bins (h, c), esum (h, c, d)), both float32."""
    h, n, d = x.shape
    x = x.float()
    flat = (idx.long() + torch.arange(h, device=x.device)[:, None] * codebook_size).reshape(-1)
    w = torch.ones(h * n, device=x.device) if weights is None else weights.reshape(-1).float()
    vals = x.reshape(-1, d) if weights is None else x.reshape(-1, d) * w[:, None]
    bins = torch.zeros(h * codebook_size, device=x.device)
    esum = torch.zeros(h * codebook_size, d, device=x.device)
    bins.index_put_((flat,), w, accumulate=True)
    esum.index_put_((flat,), vals, accumulate=True)
    return bins.reshape(h, codebook_size), esum.reshape(h, codebook_size, d)


def fused_train_quantize_plain(
    x: torch.Tensor, embed: torch.Tensor, bias: torch.Tensor,
    weights: torch.Tensor | None = None,
):
    """Plain version of the kernel: (n, d) or (h, n, d) tokens, (..., c, d)
    codes, (..., c) bias, optional (..., n) weights -> (idx int32, q, bins,
    esum). Selection as `nearest_code_plain`, rows by `index_select`,
    statistics by `code_statistics_plain`."""
    squeeze = x.ndim == 2
    if squeeze:
        x, embed, bias = x[None], embed[None], bias[None]
        weights = None if weights is None else weights[None]
    idx = nearest_code_plain(x, embed, bias)
    q = gather_codes_per_head(embed, idx)
    bins, esum = code_statistics_plain(x, idx, embed.shape[1], weights)
    out = (idx, q, bins, esum)
    return tuple(t[0] for t in out) if squeeze else out


def _kernel_library() -> ctypes.CDLL:
    lib = _build.load('train_fused')
    for fn in (lib.vqtpu_train_fused_f32, lib.vqtpu_train_fused_f32_simt):
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.vqtpu_train_fused_stage.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4 + [
        ctypes.c_void_p]
    lib.vqtpu_train_fused_stage.restype = ctypes.c_int
    lib.vqtpu_train_fused_scratch_floats.argtypes = [ctypes.c_longlong] * 4
    lib.vqtpu_train_fused_scratch_floats.restype = ctypes.c_longlong
    lib.vqtpu_code_sums_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    lib.vqtpu_code_sums_f32.restype = ctypes.c_int
    lib.vqtpu_code_sums_scratch_floats.argtypes = [ctypes.c_longlong] * 4
    lib.vqtpu_code_sums_scratch_floats.restype = ctypes.c_longlong
    lib.vqtpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vqtpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_weights(weights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(n,) or (h, n) weights for (h, n, d) tokens -> (h, n), or raise."""
    if weights.ndim == 1:
        weights = weights[None]
    if tuple(weights.shape) != tuple(x.shape[:2]):
        raise ValueError(f'weights {tuple(weights.shape)} do not match tokens {tuple(x.shape)}')
    if weights.dtype != torch.float32:
        raise TypeError(f'weights must be float32, got {weights.dtype}')
    if not weights.is_contiguous():
        raise ValueError('weights must be contiguous')
    if weights.device != x.device:
        raise ValueError(f'weights is on {weights.device}, x on {x.device}')
    return weights


def _fused_train_cuda(x, embed, bias, weights, entry='vqtpu_train_fused_f32'):
    """The step through C function `entry` of csrc/train_fused.cu; the
    port's path (the default entry) counts the launch."""
    squeeze = x.ndim == 2
    x, embed, bias = _check_kernel_operands(x, embed, bias, 'fused_train_quantize')
    if weights is not None:
        weights = _check_weights(weights, x)
    h, n, d = x.shape
    c = embed.shape[1]
    if c * d >= 2**31:
        raise ValueError(f'codebook of {c} x {d} is out of the kernel range')
    dev = x.device
    idx = torch.empty((h, n), dtype=torch.int32, device=dev)
    q = torch.empty((h, n, d), device=dev)
    bins = torch.empty((h, c), device=dev)
    esum = torch.empty((h, c, d), device=dev)
    if n == 0:
        bins.zero_()
        esum.zero_()
    else:
        lib = _kernel_library()
        # the selection's packed codebook, then the statistics' arrays
        scratch = torch.empty(lib.vqtpu_train_fused_scratch_floats(h, n, c, d), device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, entry)(
                x.data_ptr(), embed.data_ptr(), bias.data_ptr(),
                None if weights is None else weights.data_ptr(),
                idx.data_ptr(), q.data_ptr(), bins.data_ptr(), esum.data_ptr(),
                scratch.data_ptr(), h, n, c, d, stream,
            )
        if err != 0:
            msg = lib.vqtpu_cuda_error_string(err).decode()
            raise RuntimeError(f'fused_train_quantize kernel launch failed: {msg} ({err})')
        if entry == 'vqtpu_train_fused_f32':
            fused_train_quantize.launches += 1
    out = (idx, q, bins, esum)
    return tuple(t[0] for t in out) if squeeze else out


def _fused_train_simt(x, embed, bias, weights=None):
    """The step that `fused_train_quantize`'s kernel replaced (the
    register-blocked f32 FMA tile of csrc/select_codes.cuh with its row
    copy, then the split statistics), on CUDA tensors only: a same-run
    yardstick for measurements and card tests. No path of the port calls
    it, and it counts no launch."""
    if x.device.type != 'cuda':
        raise ValueError(f'_fused_train_simt runs on CUDA tensors only, not {x.device}')
    return _fused_train_cuda(x, embed, bias, weights, entry='vqtpu_train_fused_f32_simt')


# the passes that `_fused_train_stages` runs one at a time: the two
# selections, the replaced split statistics, and the statistics by sorted
# code (csrc/train_fused.cu, passes a-f)
STAGES = ('select_tf32', 'select_simt', 'split_partial', 'split_merge',
          'sort', 'row_scan', 'code_scan', 'scatter', 'segment_sums', 'segment_merge')


def _fused_train_stages(x, embed, bias) -> dict:
    """Callables, by the names of STAGES, that each run one pass of the
    unweighted step on these CUDA operands ((n, d) tokens and (c, d) codes,
    or with heads), on buffers shared between them, for timing: each
    selection with its row copy (the split-TF32 one with its codebook
    pre-pass), and each pass of either statistics, which reads what the
    passes before it left (the two statistics share their scratch). No path
    of the port calls them, and they count no launch."""
    x, embed, bias = _check_kernel_operands(x, embed, bias, '_fused_train_stages')
    h, n, d = x.shape
    c = embed.shape[1]
    dev = x.device
    lib = _kernel_library()
    bufs = dict(idx=torch.empty((h, n), dtype=torch.int32, device=dev), q=torch.empty((h, n, d), device=dev),
                bins=torch.empty((h, c), device=dev), esum=torch.empty((h, c, d), device=dev),
                scratch=torch.empty(lib.vqtpu_train_fused_scratch_floats(h, n, c, d), device=dev))

    def stage(i):
        def run():
            with torch.cuda.device(dev):
                err = lib.vqtpu_train_fused_stage(
                    i, x.data_ptr(), embed.data_ptr(), bias.data_ptr(), None,
                    *(bufs[k].data_ptr() for k in ('idx', 'q', 'bins', 'esum', 'scratch')),
                    h, n, c, d, torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise RuntimeError(f'{STAGES[i]} launch failed: {lib.vqtpu_cuda_error_string(err).decode()}')
        return run

    return {name: stage(i) for i, name in enumerate(STAGES)}


def fused_train_quantize(
    x: torch.Tensor,
    embed: torch.Tensor,
    metric: str = 'euclidean',
    weights: torch.Tensor | None = None,
    *,
    bias: torch.Tensor | None = None,
):
    """(n, d) or (h, n, d) tokens, (c, d) or (h, c, d) codes -> (idx int32,
    q, bins, esum) as in the module doc. `weights`: optional (n,) or (h, n)
    f32 statistic weights (a mask); every token gets its row and index.
    Cosine expects normalized operands, as `nearest_code` does.

    CUDA tensors launch the Hopper kernel (f32 and contiguous, or it
    raises) and count the call in `fused_train_quantize.launches`; CPU
    tensors take `fused_train_quantize_plain`."""
    if bias is None:
        bias = selection_bias(embed, metric)
    if x.device.type == 'cpu':
        return fused_train_quantize_plain(x, embed, bias, weights)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_train_quantize runs on CUDA or CPU tensors, not {x.device}')
    return _fused_train_cuda(x, embed, bias, weights)


fused_train_quantize.launches = 0


def _code_sums_cuda(x, idx, codebook_size, weights):
    """code_sums through csrc/train_fused.cu's statistics by sorted code;
    counts the launch."""
    squeeze = x.ndim == 2
    if squeeze:
        x, idx = x[None], idx[None]
    if x.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f'code_sums takes float32 x and int32 indices, got {x.dtype} and {idx.dtype}')
    if idx.device != x.device:
        raise ValueError(f'indices are on {idx.device}, x on {x.device}')
    if x.ndim != 3 or tuple(idx.shape) != tuple(x.shape[:2]):
        raise ValueError(f'indices {tuple(idx.shape)} do not match tokens {tuple(x.shape)}')
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError('code_sums needs contiguous x and indices')
    if weights is not None:
        weights = _check_weights(weights, x)
    h, n, d = x.shape
    c = codebook_size
    if not (1 <= h <= 65535) or c * d >= 2**31 or n >= 2**31:
        raise ValueError(f'{h} heads of {n} tokens and a codebook of {c} x {d} are out of the kernel range')
    dev = x.device
    bins = torch.empty((h, c), device=dev)
    esum = torch.empty((h, c, d), device=dev)
    if n == 0:
        bins.zero_()
        esum.zero_()
    else:
        lib = _kernel_library()
        scratch = torch.empty(lib.vqtpu_code_sums_scratch_floats(h, n, c, d), device=dev)
        with torch.cuda.device(dev):
            err = lib.vqtpu_code_sums_f32(
                x.data_ptr(), idx.data_ptr(), None if weights is None else weights.data_ptr(),
                bins.data_ptr(), esum.data_ptr(), scratch.data_ptr(), h, n, c, d,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f'code_sums kernel launch failed: {lib.vqtpu_cuda_error_string(err).decode()} ({err})')
        code_sums.launches += 1
    return (bins[0], esum[0]) if squeeze else (bins, esum)


def code_sums(
    x: torch.Tensor, idx: torch.Tensor, codebook_size: int,
    weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, d) or (h, n, d) rows, their int32 codes in [0, c) -> (bins (h?,
    c), esum (h?, c, d)): the weighted count and the weighted sum of the
    rows of each code, as `code_statistics_plain` gives them.

    CUDA tensors launch the statistics by sorted code of
    csrc/train_fused.cu (f32 and contiguous, or it raises; deterministic)
    and count the call in `code_sums.launches`; CPU tensors take
    `code_statistics_plain`."""
    if x.device.type == 'cpu':
        if x.ndim == 2:
            bins, esum = code_statistics_plain(x[None], idx[None], codebook_size,
                                               None if weights is None else weights[None])
            return bins[0], esum[0]
        return code_statistics_plain(x, idx, codebook_size, weights)
    if x.device.type != 'cuda':
        raise ValueError(f'code_sums runs on CUDA or CPU tensors, not {x.device}')
    return _code_sums_cuda(x, idx, codebook_size, weights)


code_sums.launches = 0


class _LookupWithCodeGrad(torch.autograd.Function):
    """quantize_lookup whose rows carry their gradient to the codebook."""

    @staticmethod
    def forward(ctx, x, embed, metric):
        idx, rows = quantize_lookup(x, embed, metric)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(idx)
        ctx.codebook_size = embed.shape[-2]
        return idx, rows

    @staticmethod
    def backward(ctx, grad_idx, grad_rows):
        idx, = ctx.saved_tensors
        _, grad_embed = code_sums(grad_rows.float().contiguous(), idx, ctx.codebook_size)
        return None, grad_embed, None


def lookup_with_code_grad(
    x: torch.Tensor, embed: torch.Tensor, metric: str = 'euclidean'
) -> tuple[torch.Tensor, torch.Tensor]:
    """`quantize_lookup(x, embed, metric)` -> (indices int32, rows), with the
    rows differentiable with respect to `embed`: the backward pass gives
    the codebook the sum, by code, of the rows' gradients (`code_sums`,
    deterministic on the card). (n, d) or (h, n, d) tokens against (c, d)
    or (h, c, d) codes. No gradient reaches x, whose only part in the
    result is the choice of codes."""
    return _LookupWithCodeGrad.apply(x, embed, metric)
