"""The Hopper kernels (selection, fused train step) against their plain
versions, on the card.

Marked `cuda`: each test asks the `card` fixture for the device, which
skips when there is no CUDA card. Run on a machine with an H100 and nvcc:
python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import vqtpu_torch
import vqtpu_torch.kernels.distance as td
import vqtpu_torch.kernels.train_fused as ttf

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card; the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _operands(shape, metric, device, seed=0):
    *heads, n, c, d = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((*heads, n, d), dtype=np.float32)).to(device)
    e = torch.from_numpy(rng.standard_normal((*heads, c, d), dtype=np.float32)).to(device)
    if metric == 'cosine':
        x = x / x.norm(dim=-1, keepdim=True)
        e = e / e.norm(dim=-1, keepdim=True)
    return x, e


@pytest.mark.parametrize('metric', td.METRICS)
@pytest.mark.parametrize('shape', (
    (300, 130, 96), (64, 8, 32), (1, 1, 1), (4099, 640, 130), (3, 1000, 257, 40), (20000, 512, 256),
))
def test_kernel_matches_plain(card, metric, shape):
    x, e = _operands(shape, metric, card)
    bias = td.selection_bias(e, metric)
    before = td.nearest_code.launches
    got = td.nearest_code(x, e, metric, bias)
    torch.cuda.synchronize()
    assert td.nearest_code.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == x.shape[:-1]
    want = td.nearest_code_plain(x, e, bias)
    if x.ndim == 2:
        x, e, bias, got, want = x[None], e[None], bias[None], got[None], want[None]
    for h in range(x.shape[0]):
        r = td.selection_disagreements(x[h], e[h], bias[h], got[h], want[h])
        assert r['non_tie'] == 0 and r['disagree'] <= 1e-3 * r['tokens'], r


def test_kernel_ties_first_index(card):
    x = torch.zeros(1000, 256, device=card)
    assert (td.nearest_code(x, torch.zeros(512, 256, device=card)) == 0).all()
    base, _ = _operands((64, 1, 48), 'euclidean', card, seed=1)
    dup = torch.cat([base] * 8)                  # copies in one thread, one tile, other tiles
    assert torch.equal(td.nearest_code(base, dup).cpu(), torch.arange(64, dtype=torch.int32))


def test_kernel_rejects_what_it_does_not_take(card):
    x, e = _operands((100, 16, 8), 'euclidean', card)
    with pytest.raises(TypeError, match='float32'):
        td.nearest_code(x.half(), e)
    with pytest.raises(ValueError, match='contiguous'):
        td.nearest_code(x.T.contiguous().T, e)


def test_vq_eval_on_card_matches_cpu(card):
    torch.manual_seed(0)
    vq = vqtpu_torch.VectorQuantize(dim=64, codebook_size=512, heads=2, codebook_dim=32,
                                    separate_codebook_per_head=True, device=card).eval()
    ref = vqtpu_torch.VectorQuantize(dim=64, codebook_size=512, heads=2, codebook_dim=32,
                                     separate_codebook_per_head=True, device='cpu').eval()
    ref.load_state_dict({k: v.cpu() for k, v in vq.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 300, 64), dtype=np.float32))
    before = td.nearest_code.launches
    with torch.no_grad():
        q, idx, _ = vq(x.to(card))
        q_ref, idx_ref, _ = ref(x)
        xc = vq.codebook_input(x.to(card))                       # (h, b, n, d)
    assert td.nearest_code.launches == before + 1
    rows = torch.stack([vq.codebook[h][idx[..., h].long()] for h in range(2)], -2)
    assert torch.equal(vq.project_out(rows.reshape(4, 300, 64)), q)
    embed = vq._codebook.embed
    for h in range(2):
        r = td.selection_disagreements(
            xc[h].reshape(-1, 32), embed[h], td.selection_bias(embed[h], 'euclidean'),
            idx[..., h].reshape(-1), idx_ref[..., h].reshape(-1).to(card),
        )
        assert r['non_tie'] == 0, r


@pytest.mark.parametrize('weighted', (False, True), ids=('unweighted', 'weighted'))
@pytest.mark.parametrize('metric', td.METRICS)
@pytest.mark.parametrize('shape', (
    (1024, 64, 96), (1000, 130, 100), (37, 5, 3), (3, 200, 20, 16), (20000, 512, 256),
))
def test_train_kernel_matches_plain(card, metric, shape, weighted):
    x, e = _operands(shape, metric, card)
    w = None
    if weighted:
        w = (torch.rand(x.shape[:-1], device=card, generator=torch.Generator(card).manual_seed(1)) > 0.3).float()
    bias = td.selection_bias(e, metric)
    before = ttf.fused_train_quantize.launches
    idx, q, bins, esum = ttf.fused_train_quantize(x, e, metric, w, bias=bias)
    again = ttf.fused_train_quantize(x, e, metric, w, bias=bias)
    torch.cuda.synchronize()
    assert ttf.fused_train_quantize.launches == before + 2
    # two calls bit-identical, and the same indices as the selection kernel
    assert all(torch.equal(a, b) for a, b in zip((idx, q, bins, esum), again))
    assert torch.equal(idx, td.nearest_code(x, e, metric, bias))
    pidx, _, pbins, pesum = ttf.fused_train_quantize_plain(x, e, bias, w)
    if x.ndim == 2:
        x, e, bias, idx, q, pidx = x[None], e[None], bias[None], idx[None], q[None], pidx[None]
    for h in range(x.shape[0]):
        assert torch.equal(q[h], e[h][idx[h].long()])
        r = td.selection_disagreements(x[h], e[h], bias[h], idx[h], pidx[h])
        assert r['non_tie'] == 0, r
    if torch.equal(idx, pidx.reshape(idx.shape)):
        assert torch.equal(bins, pbins)
        # f32 sums in another order: within 1e-5 of the largest entry
        assert float((esum - pesum).abs().max()) <= 1e-5 * max(float(esum.abs().max()), 1.0)


def test_train_kernel_ties_and_bins(card):
    x = torch.zeros(1000, 256, device=card)
    idx, q, bins, esum = ttf.fused_train_quantize(x, torch.zeros(512, 256, device=card))
    assert (idx == 0).all() and float(bins[0]) == 1000 and float(bins[1:].abs().sum()) == 0
    assert float(esum.abs().sum()) == 0
    base, _ = _operands((64, 1, 48), 'euclidean', card, seed=1)
    idx, q, bins, _ = ttf.fused_train_quantize(base, torch.cat([base] * 8))
    assert torch.equal(idx.cpu(), torch.arange(64, dtype=torch.int32))
    assert torch.equal(q, base) and torch.equal(bins[:64].cpu(), torch.ones(64))


def test_train_kernel_rejects_what_it_does_not_take(card):
    x, e = _operands((100, 16, 8), 'euclidean', card)
    with pytest.raises(TypeError, match='float32'):
        ttf.fused_train_quantize(x.half(), e)
    with pytest.raises(ValueError, match='contiguous'):
        ttf.fused_train_quantize(x.T.contiguous().T, e)
    with pytest.raises(TypeError, match='weights must be float32'):
        ttf.fused_train_quantize(x, e, weights=torch.ones(100, device=card, dtype=torch.float64))


@pytest.mark.parametrize('route', ('on', 'off'))
def test_vq_training_step_on_card_matches_cpu(card, route):
    torch.manual_seed(0)
    kwargs = dict(dim=64, codebook_size=256, heads=2, codebook_dim=32, separate_codebook_per_head=True,
                  train_fused=route)
    vq = vqtpu_torch.VectorQuantize(**kwargs, device=card).train()
    ref = vqtpu_torch.VectorQuantize(**kwargs, device='cpu').train()
    ref.load_state_dict({k: v.cpu() for k, v in vq.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 300, 64), dtype=np.float32))
    launches = (ttf.fused_train_quantize.launches, td.nearest_code.launches)
    xc = x.to(card).requires_grad_()
    q, idx, loss = vq(xc)
    (loss + q.square().mean()).backward()
    xr = x.clone().requires_grad_()
    q_ref, idx_ref, loss_ref = ref(xr)
    (loss_ref + q_ref.square().mean()).backward()
    torch.cuda.synchronize()
    fused, nearest = ttf.fused_train_quantize.launches - launches[0], td.nearest_code.launches - launches[1]
    assert (fused, nearest) == ((1, 0) if route == 'on' else (0, 1))
    if torch.equal(idx.cpu(), idx_ref):
        torch.testing.assert_close(q.detach().cpu(), q_ref.detach(), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(loss.detach().cpu(), loss_ref.detach(), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(xc.grad.cpu(), xr.grad, rtol=1e-4, atol=1e-6)
        assert torch.equal(vq._codebook.cluster_size.cpu(), ref._codebook.cluster_size)
        torch.testing.assert_close(vq._codebook.embed.cpu(), ref._codebook.embed, rtol=1e-5, atol=1e-5)
    assert torch.isfinite(xc.grad).all()
