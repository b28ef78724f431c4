"""The port's quantization cores under `torch.autocast` on the CPU.

A caller may run the port's modules under `torch.autocast('cpu',
dtype=torch.bfloat16)`, and on the CPU autocast takes `mm`, `bmm`,
`matmul` and `linear` to bf16. The cores (the codebook's selection, kmeans,
EMA statistics and distance path, SimVQ's implicit codebook, the orthogonal
loss, LFQ's entropy products, FSQ's quantization region) run in f32 with
autocast off, as the JAX package's cores force f32. Each case runs the same
call on two copies of one module (their generators included), once plainly
and once under bf16 autocast, on f32 inputs and without projections (a
projection stays under the caller's autocast, as in the reference): every
output and every tensor of the module's state after the call must be
bit-equal. The plain CPU statistics are deterministic with one torch
thread (`torch_parity.one_torch_thread`).
"""

import copy

import pytest
import torch

import vqtpu_torch
from vqtpu_torch.core.utils import orthogonal_loss_fn

from torch_parity import one_torch_thread  # noqa: F401  (autouse)


def _x(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _vq(**kw):
    return vqtpu_torch.VectorQuantize(dim=32, codebook_size=64, decay=0.8, device='cpu', **kw)


def _loss_breakdown(m, x):
    return m(x, return_loss_breakdown=True)


# name -> (module factory, training?, call)
CASES = {
    'vq_eval': (lambda: _vq(), False, lambda m, x: m(x)),
    'vq_ema_step_on': (lambda: _vq(train_fused='on'), True, lambda m, x: m(x)),
    'vq_ema_step_off': (lambda: _vq(train_fused='off'), True, lambda m, x: m(x)),
    'vq_kmeans_init_and_expiry': (lambda: _vq(kmeans_init=True, threshold_ema_dead_code=2), True,
                                  lambda m, x: m(x)),
    'vq_cosine_step': (lambda: _vq(use_cosine_sim=True), True, lambda m, x: m(x)),
    # the distance path: stochastic codes and their one-hot statistics product
    'vq_stochastic_step': (lambda: _vq(stochastic_sample_codes=True), True, lambda m, x: m(x)),
    'vq_stat_precision_high_step': (lambda: _vq(stat_precision='high'), True, lambda m, x: m(x)),
    'vq_topk_eval': (lambda: _vq(), False, lambda m, x: m(x, topk=3)),
    'vq_diversity_step': (lambda: _vq(codebook_diversity_loss_weight=1.0), True, _loss_breakdown),
    'vq_orthogonal_loss_step': (lambda: _vq(orthogonal_reg_weight=1.0), True, _loss_breakdown),
    'vq_orthogonal_active_codes_step': (
        lambda: _vq(orthogonal_reg_weight=1.0, orthogonal_reg_active_codes_only=True), True, _loss_breakdown),
    'rvq_eval': (lambda: vqtpu_torch.ResidualVQ(dim=32, codebook_size=64, num_quantizers=3, device='cpu'),
                 False, lambda m, x: m(x)),
    'rvq_step': (lambda: vqtpu_torch.ResidualVQ(dim=32, codebook_size=64, num_quantizers=3, device='cpu'),
                 True, lambda m, x: m(x)),
    'simvq_eval': (lambda: vqtpu_torch.SimVQ(dim=32, codebook_size=64, device='cpu'), False, lambda m, x: m(x)),
    'simvq_step': (lambda: vqtpu_torch.SimVQ(dim=32, codebook_size=64, device='cpu'), True, lambda m, x: m(x)),
    'lfq_dense_step': (lambda: vqtpu_torch.LFQ(dim=8, codebook_size=256, device='cpu'), True,
                       lambda m, x: m(x[..., :8], return_loss_breakdown=True)),
    'lfq_streamed_step': (lambda: vqtpu_torch.LFQ(dim=8, codebook_size=256, entropy_fused='off',
                                                  entropy_chunk_size=64, device='cpu'), True,
                          lambda m, x: m(x[..., :8], return_loss_breakdown=True)),
    'lfq_fused_step': (lambda: vqtpu_torch.LFQ(dim=8, codebook_size=256, entropy_fused='on', device='cpu'), True,
                       lambda m, x: m(x[..., :8], return_loss_breakdown=True)),
    'lfq_rotation_eval': (lambda: vqtpu_torch.LFQ(dim=8, codebook_size=256, orthogonal_rotation=True,
                                                  device='cpu'), False, lambda m, x: m(x[..., :8])),
    'fsq_eval': (lambda: vqtpu_torch.FSQ(levels=[8, 5, 5, 5], device='cpu'), False, lambda m, x: m(x[..., :4])),
    'fsq_rotation_step': (lambda: vqtpu_torch.FSQ(levels=[5, 5, 5, 5], orthogonal_rotation=True, device='cpu'),
                          True, lambda m, x: m(x[..., :4])),
    'residual_fsq_eval_fused': (lambda: vqtpu_torch.ResidualFSQ(dim=4, levels=[8, 5, 5, 5], num_quantizers=3,
                                                                eval_fused='on', device='cpu'),
                                False, lambda m, x: m(x[..., :4])),
    'residual_fsq_step': (lambda: vqtpu_torch.ResidualFSQ(dim=4, levels=[8, 5, 5, 5], num_quantizers=3,
                                                          device='cpu'), True, lambda m, x: m(x[..., :4])),
}


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _tensors(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def test_cpu_autocast_rounds_products_here():
    """The premise: CPU autocast does take a product of f32 tensors to bf16."""
    a, b = _x(8, 8), _x(8, 8, seed=1)
    with torch.autocast('cpu', dtype=torch.bfloat16):
        assert (a @ b).dtype == torch.bfloat16


@pytest.mark.parametrize('case', sorted(CASES))
def test_core_is_bit_equal_under_autocast(case):
    make, train, call = CASES[case]
    torch.manual_seed(0)
    model = make().train(train)
    plain, cast = copy.deepcopy(model), copy.deepcopy(model)
    x = _x(4, 64, 32, seed=1) * 2.0
    want = call(plain, x)
    with torch.autocast('cpu', dtype=torch.bfloat16):
        got = call(cast, x)
    want, got = _tensors(want), _tensors(got)
    assert len(want) == len(got) > 0
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and torch.equal(w, g), (case, i)
    state_want, state_got = plain.state_dict(), cast.state_dict()
    for key, w in state_want.items():
        assert torch.equal(w, state_got[key]), (case, key)


def test_orthogonal_loss_fn_is_bit_equal_under_autocast():
    codebook = _x(2, 64, 32)
    want = orthogonal_loss_fn(codebook)
    with torch.autocast('cpu', dtype=torch.bfloat16):
        got = orthogonal_loss_fn(codebook)
    assert got.dtype == torch.float32 and torch.equal(want, got)


def test_projections_stay_under_the_callers_autocast():
    """project_in is the caller's layer: under bf16 autocast its product is
    bf16, and only the core after it is forced to f32."""
    vq = vqtpu_torch.VectorQuantize(dim=32, codebook_size=64, codebook_dim=16, device='cpu').eval()
    x = _x(2, 16, 32)
    with torch.autocast('cpu', dtype=torch.bfloat16):
        assert vq.project_in(x).dtype == torch.bfloat16
        q, idx, _ = vq(x)
    assert q.dtype == torch.float32 and idx.dtype == torch.int32
