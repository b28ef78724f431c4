"""The Hopper selection kernel against its plain version, on the card.

Marked `cuda`: each test asks the `card` fixture for the device, which
skips when there is no CUDA card. Run on a machine with an H100 and nvcc:
python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import vqtpu_torch
import vqtpu_torch.kernels.distance as td

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
