"""Nearest-code selection and code lookup: the port's hot path
(counterpart of vqtpu/kernels/distance.py).

    score[t, j] = x_t . e_j + bias_j     bias = -||e_j||^2 / 2 (L2), 0 (cosine)
    idx[t]      = first argmax_j score   quant[t] = codebook[idx[t]]

`nearest_code` dispatches on where its tensors lie: CUDA tensors go to the
hand-written Hopper kernel in csrc/nearest_code.cu, CPU tensors to
`nearest_code_plain`, the same formulation in plain PyTorch. Indices are
int32, as the kernel writes them.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.utils import cdist_sq
from . import _build

METRICS = ('euclidean', 'cosine')

# the plain version computes scores for this many (token, code) pairs at a
# time, so that a large codebook's (n, c) score matrix is never whole
_PLAIN_CHUNK_ELEMS = 1 << 26


def selection_bias(embed: torch.Tensor, metric: str) -> torch.Tensor:
    """(..., c, d) codebook -> (..., c) f32 bias added to x.e: -||e||^2/2 for
    euclidean, 0 for cosine (vqtpu/kernels/distance.py::_prepare_operands)."""
    if metric not in METRICS:
        raise ValueError(f'metric must be one of {METRICS}, got {metric!r}')
    embed = embed.float()
    if metric == 'cosine':
        return torch.zeros(embed.shape[:-1], dtype=torch.float32, device=embed.device)
    return -0.5 * (embed ** 2).sum(-1)


def nearest_code_plain(
    x: torch.Tensor, embed: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Plain version of the kernel: (..., n, d), (..., c, d), (..., c) ->
    (..., n) int32 argmax of `x @ embed.T + bias`, first index on ties,
    computed in chunks of tokens."""
    if x.ndim == 3:
        return torch.stack([
            nearest_code_plain(x[i], embed[i], bias[i]) for i in range(x.shape[0])
        ])
    n, c = x.shape[0], embed.shape[0]
    rows = max(1, _PLAIN_CHUNK_ELEMS // c)
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    embed_t = embed.T
    for start in range(0, n, rows):
        scores = x[start:start + rows] @ embed_t + bias
        out[start:start + rows] = scores.argmax(-1)
    return out


def _check_kernel_operands(x, embed, bias, name='nearest_code'):
    if x.ndim != embed.ndim or x.ndim not in (2, 3) or bias.ndim != x.ndim - 1:
        raise ValueError(
            f'{name} takes x (n, d) or (h, n, d), embed (c, d) or '
            f'(h, c, d) and bias (c,) or (h, c); got {tuple(x.shape)}, '
            f'{tuple(embed.shape)}, {tuple(bias.shape)}'
        )
    if x.ndim == 2:
        x, embed, bias = x[None], embed[None], bias[None]
    h, n, d = x.shape
    if embed.shape[0] != h or embed.shape[2] != d or tuple(bias.shape) != tuple(embed.shape[:2]):
        raise ValueError(
            f'shape mismatch: x {tuple(x.shape)}, embed {tuple(embed.shape)}, '
            f'bias {tuple(bias.shape)}'
        )
    c = embed.shape[1]
    if not (1 <= h <= 65535 and 1 <= c < 2**31 and 1 <= d < 2**31 and n < 2**31):
        raise ValueError(f'sizes out of the kernel range: h={h} n={n} c={c} d={d}')
    for name, t in (('x', x), ('embed', embed), ('bias', bias)):
        if t.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if t.device != x.device:
            raise ValueError(f'{name} is on {t.device}, x on {x.device}')
    return x, embed, bias


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.vqtpu_cuda_error_string(err).decode()
        raise RuntimeError(f'{what} kernel launch failed: {msg} ({err})')


def _nearest_code_cuda(x, embed, bias, rows: bool = False):
    """The tensor-core kernel: indices, and with `rows` the winning codebook
    rows copied by the same launch. Counts one launch in
    `nearest_code.launches`."""
    squeeze = x.ndim == 2
    x, embed, bias = _check_kernel_operands(x, embed, bias)
    h, n, d = x.shape
    c = embed.shape[1]
    idx = torch.empty((h, n), dtype=torch.int32, device=x.device)
    q = torch.empty((h, n, d), dtype=torch.float32, device=x.device) if rows else None
    if n:
        lib = _kernel_library()
        scratch = torch.empty(lib.vqtpu_nearest_code_scratch_floats(h, c, d), device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.vqtpu_nearest_code_f32(
                x.data_ptr(), embed.data_ptr(), bias.data_ptr(), scratch.data_ptr(), idx.data_ptr(),
                None if q is None else q.data_ptr(), h, n, c, d, stream,
            )
        _raise_on(lib, err, 'nearest_code')
        nearest_code.launches += 1
    if squeeze:
        idx, q = idx[0], None if q is None else q[0]
    return (idx, q) if rows else idx


def _kernel_library() -> ctypes.CDLL:
    lib = _build.load('nearest_code')
    ptr, size = ctypes.c_void_p, ctypes.c_longlong
    lib.vqtpu_nearest_code_f32.argtypes = [ptr] * 6 + [size] * 4 + [ptr]
    lib.vqtpu_nearest_code_f32.restype = ctypes.c_int
    lib.vqtpu_nearest_code_f32_simt.argtypes = [ptr] * 4 + [size] * 4 + [ptr]
    lib.vqtpu_nearest_code_f32_simt.restype = ctypes.c_int
    lib.vqtpu_nearest_code_scratch_floats.argtypes = [size] * 3
    lib.vqtpu_nearest_code_scratch_floats.restype = ctypes.c_longlong
    lib.vqtpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vqtpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _nearest_code_simt(x: torch.Tensor, embed: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The register-blocked f32 FMA selection tile that the tensor-core
    kernel replaced (csrc/select_codes.cuh, still K4's tile), on CUDA
    tensors only: a same-run yardstick for measurements and card tests. No
    path of the port calls it, and it counts no launch."""
    if x.device.type != 'cuda':
        raise ValueError(f'_nearest_code_simt runs on CUDA tensors only, not {x.device}')
    squeeze = x.ndim == 2
    x, embed, bias = _check_kernel_operands(x, embed, bias, '_nearest_code_simt')
    h, n, d = x.shape
    idx = torch.empty((h, n), dtype=torch.int32, device=x.device)
    if n:
        lib = _kernel_library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.vqtpu_nearest_code_f32_simt(
                x.data_ptr(), embed.data_ptr(), bias.data_ptr(), idx.data_ptr(),
                h, n, embed.shape[1], d, stream,
            )
        _raise_on(lib, err, '_nearest_code_simt')
    return idx[0] if squeeze else idx


def nearest_code(
    x: torch.Tensor,
    embed: torch.Tensor,
    metric: str = 'euclidean',
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Nearest-code indices: (n, d) or (h, n, d) tokens against (c, d) or
    (h, c, d) codes -> (n,) or (h, n) int32, first index on ties.

    `bias` defaults to `selection_bias(embed, metric)`. CUDA tensors launch
    the Hopper kernel (f32, contiguous, or it raises) and count the launch
    in `nearest_code.launches`; CPU tensors take `nearest_code_plain`.
    """
    if bias is None:
        bias = selection_bias(embed, metric)
    if x.device.type == 'cpu':
        return nearest_code_plain(x, embed, bias)
    if x.device.type != 'cuda':
        raise ValueError(f'nearest_code runs on CUDA or CPU tensors, not {x.device}')
    return _nearest_code_cuda(x, embed, bias)


nearest_code.launches = 0


def argmax_first_with_best(scores: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., c) scores -> (argmax index int32, best score), first index on
    ties."""
    idx = scores.argmax(-1)
    best = scores.gather(-1, idx[..., None])[..., 0]
    return idx.to(torch.int32), best


def nearest_code_xla(
    x: torch.Tensor,
    embed: torch.Tensor,
    metric: str = 'euclidean',
    *,
    return_best: bool = False,
):
    """The JAX package's XLA formulation: argmax of -cdist_sq (euclidean) or
    of x.e (cosine). (..., n, d), (..., c, d) -> (..., n) int32 indices, and
    the winning scores with `return_best=True`."""
    if metric not in METRICS:
        raise ValueError(f'metric must be one of {METRICS}, got {metric!r}')
    if metric == 'cosine':
        scores = x.float() @ embed.float().transpose(-1, -2)
    else:
        scores = -cdist_sq(x, embed)
    idx, best = argmax_first_with_best(scores)
    return (idx, best) if return_best else idx


def gather_codes(embed: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Codebook row lookup (c, d), (...) -> (..., d): an exact row copy."""
    flat = embed.index_select(0, indices.reshape(-1))
    return flat.reshape(*indices.shape, embed.shape[-1])


def gather_codes_per_head(embed: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """(h, c, d), (h, n) -> (h, n, d)."""
    if embed.shape[0] == 1:
        return gather_codes(embed[0], indices[0])[None]
    return torch.stack([gather_codes(embed[i], indices[i]) for i in range(embed.shape[0])])


def quantize_lookup(
    x: torch.Tensor,
    embed: torch.Tensor,
    metric: str = 'euclidean',
    *,
    tier: str = 'exact',
) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, d) or (h, n, d) tokens -> (indices int32, quantized rows).

    tier='exact': f32 selection and an exact row copy. On CUDA tensors one
    launch of the selection kernel does both (counted in
    `nearest_code.launches`; f32 and contiguous, or it raises); CPU tensors
    take `nearest_code_plain` and `index_select`.
    tier='bf16': x and the codebook are cast to bfloat16; scores are f32
    products of the bf16 values (each product is exact in f32) with the bias
    taken from the bf16-cast codebook, so indices and rows are exact with
    respect to the bf16 values; the rows come back in bfloat16.
    """
    if tier == 'bf16':
        return _quantize_lookup_bf16(x, embed, metric)
    if tier != 'exact':
        raise ValueError(f"tier must be 'exact' or 'bf16', got {tier!r}")
    if x.device.type == 'cuda':
        return _nearest_code_cuda(x, embed, selection_bias(embed, metric), rows=True)
    idx = nearest_code(x, embed, metric)
    if embed.ndim > 2:
        return idx, gather_codes_per_head(embed, idx)
    return idx, gather_codes(embed, idx)


def _quantize_lookup_bf16(x, embed, metric):
    eb = embed.to(torch.bfloat16)
    ef = eb.float()
    # a product of two bf16 tensors would round the scores to bf16; the
    # f32 product of the bf16 values keeps them as the JAX package does
    scores = x.to(torch.bfloat16).float() @ ef.transpose(-1, -2)
    scores = scores + selection_bias(ef, metric)[..., None, :]
    idx = scores.argmax(-1).to(torch.int32)
    if eb.ndim > 2:
        return idx, gather_codes_per_head(eb, idx)
    return idx, gather_codes(eb, idx)


def selection_disagreements(
    x: torch.Tensor,
    embed: torch.Tensor,
    bias: torch.Tensor,
    idx_a: torch.Tensor,
    idx_b: torch.Tensor,
    rel: float = 1e-5,
) -> dict:
    """Compare two selections of the same (n, d) tokens against one (c, d)
    codebook. At each token where they differ, both picks are scored again
    in float64; the token is a near-tie when the two scores differ by at
    most `rel` times the larger of |score| and ||x||*||e|| (the size of the
    rounding an f32 dot product can carry). Returns the token count, the
    disagreements, the disagreements that are not near-ties, and the largest
    float64 score gap among the disagreements."""
    idx_a = idx_a.reshape(-1).long()
    idx_b = idx_b.reshape(-1).long()
    differ = (idx_a != idx_b).nonzero().reshape(-1)
    result = {'tokens': int(idx_a.numel()), 'disagree': int(differ.numel()),
              'non_tie': 0, 'max_score_gap': 0.0}
    if differ.numel() == 0:
        return result
    xd = x.reshape(-1, x.shape[-1])[differ].double()
    ea = embed[idx_a[differ]].double()
    eb = embed[idx_b[differ]].double()
    sa = (xd * ea).sum(-1) + bias[idx_a[differ]].double()
    sb = (xd * eb).sum(-1) + bias[idx_b[differ]].double()
    xn = xd.norm(dim=-1)
    scale = torch.stack([
        sa.abs(), sb.abs(), xn * ea.norm(dim=-1), xn * eb.norm(dim=-1)
    ]).amax(0)
    gap = (sa - sb).abs()
    result['non_tie'] = int((gap > rel * scale).sum())
    result['max_score_gap'] = float(gap.max())
    return result
