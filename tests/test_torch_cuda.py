"""The Hopper kernels (selection, fused train step, LFQ entropy sweeps,
fused ResidualFSQ eval) against their plain versions, on the card.

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


SELECTION_SHAPES = (
    (300, 130, 96), (64, 8, 32), (1, 1, 1), (4099, 640, 130), (3, 1000, 257, 40), (20000, 512, 256),
    (500, 300, 30), (64, 5, 3),
)


@pytest.mark.parametrize('metric', td.METRICS)
@pytest.mark.parametrize('shape', SELECTION_SHAPES)
def test_kernel_matches_plain(card, metric, shape):
    x, e = _operands(shape, metric, card)
    bias = td.selection_bias(e, metric)
    before = td.nearest_code.launches
    got = td.nearest_code(x, e, metric, bias)
    again = td.nearest_code(x, e, metric, bias)
    torch.cuda.synchronize()
    assert td.nearest_code.launches == before + 2
    assert got.dtype == torch.int32 and got.shape == x.shape[:-1]
    assert torch.equal(got, again)
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
    # the probes of chip_smoke.py: 512 codes of 256 dims, copies in other c-tiles
    base, _ = _operands((256, 1, 256), 'euclidean', card, seed=2)
    for copies in (2, 8):
        first = base[:512 // copies]
        idx, q = td.quantize_lookup(first, torch.cat([first] * copies))
        assert torch.equal(idx.cpu(), torch.arange(512 // copies, dtype=torch.int32)) and torch.equal(q, first)
    zero_x = torch.zeros(1000, 256, device=card)
    e = _operands((1, 512, 256), 'cosine', card, seed=3)[1]
    assert (td.nearest_code(zero_x, e, 'cosine') == 0).all()


@pytest.mark.parametrize('metric', td.METRICS)
@pytest.mark.parametrize('shape', SELECTION_SHAPES)
def test_quantize_lookup_rows_bit_equal(card, metric, shape):
    """One launch gives the indices of `nearest_code` and the original
    codebook rows, bit for bit."""
    x, e = _operands(shape, metric, card, seed=4)
    before = td.nearest_code.launches
    idx, q = td.quantize_lookup(x, e, metric)
    torch.cuda.synchronize()
    assert td.nearest_code.launches == before + 1
    assert torch.equal(idx, td.nearest_code(x, e, metric)) and q.shape == x.shape
    if x.ndim == 2:
        x, e, idx, q = x[None], e[None], idx[None], q[None]
    for h in range(x.shape[0]):
        assert torch.equal(q[h], e[h][idx[h].long()])


@pytest.mark.parametrize('shape', ((300, 130, 96), (64, 8, 32), (3, 1000, 257, 40), (20000, 512, 256)))
def test_simt_yardstick_matches_plain(card, shape):
    """The replaced f32 tile, kept as a same-run yardstick, still selects as
    the plain version does, and counts no launch of the port's kernel."""
    x, e = _operands(shape, 'euclidean', card, seed=5)
    bias = td.selection_bias(e, 'euclidean')
    before = td.nearest_code.launches
    got = td._nearest_code_simt(x, e, bias)
    torch.cuda.synchronize()
    assert td.nearest_code.launches == before
    want = td.nearest_code_plain(x, e, bias)
    if x.ndim == 2:
        x, e, bias, got, want = x[None], e[None], bias[None], got[None], want[None]
    for h in range(x.shape[0]):
        r = td.selection_disagreements(x[h], e[h], bias[h], got[h], want[h])
        assert r['non_tie'] == 0, r


def test_kernel_rejects_what_it_does_not_take(card):
    x, e = _operands((100, 16, 8), 'euclidean', card)
    with pytest.raises(TypeError, match='float32'):
        td.nearest_code(x.half(), e)
    with pytest.raises(ValueError, match='contiguous'):
        td.nearest_code(x.T.contiguous().T, e)
    with pytest.raises(TypeError, match='float32'):
        td.quantize_lookup(x, e.double())
    with pytest.raises(ValueError, match='contiguous'):
        td.quantize_lookup(x, e.T.contiguous().T)
    with pytest.raises(ValueError, match='CUDA tensors only'):
        td._nearest_code_simt(x.cpu(), e.cpu(), td.selection_bias(e.cpu(), 'euclidean'))


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
    # two calls bit-identical, and the indices of the selection kernel but for
    # near-ties (K4 keeps the f32 FMA tile, the selection kernel is split-TF32)
    assert all(torch.equal(a, b) for a, b in zip((idx, q, bins, esum), again))
    nc = td.nearest_code(x, e, metric, bias)
    pidx, _, pbins, pesum = ttf.fused_train_quantize_plain(x, e, bias, w)
    if x.ndim == 2:
        x, e, bias, idx, q, pidx, nc = x[None], e[None], bias[None], idx[None], q[None], pidx[None], nc[None]
    for h in range(x.shape[0]):
        assert torch.equal(q[h], e[h][idx[h].long()])
        assert td.selection_disagreements(x[h], e[h], bias[h], idx[h], nc[h])['non_tie'] == 0
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


# -- the LFQ entropy sweeps (csrc/lfq_entropy.cu) ---------------------------------

import vqtpu_torch.kernels.lfq_entropy as tle  # noqa: E402


def _lfq_operands(n, d, spherical, weighted, device, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    if spherical:
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    w = (rng.random(n) > 0.3).astype(np.float32) if weighted else np.ones(n, np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(w).to(device)


def _max_rel(a, ref):
    return float((a.double() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize('case', (
    (8192, 18, True, 1.0, False, 100.0), (8192, 18, True, 1.0, True, 1.0), (300, 10, False, 0.25, True, 100.0),
    (1000, 8, True, 1.0, False, 1.0), (777, 12, False, 0.5, True, 1.0), (50, 3, False, 1.0, False, 1.0),
    (129, 1, True, 1.0, True, 100.0),
), ids=('main_t100', 'main_weighted_t1', 'ragged', 'k256', 'k4096', 'k8', 'k2'))
def test_lfq_sweeps_match_plain(card, case):
    """Each sweep against the plain sweep in float64 on the same inputs:
    forward values within 1e-5 (inv_temp 1) or 1e-4 (inv_temp 100) of the
    largest entry; sigma, gdot and dx within 2e-5 of theirs (at inv_temp 100
    with the cotangents of LFQ's aux loss) or, where a sum over 2^18 codes
    cancels, within 4x the plain sweep's own f32 error against float64. Each
    limit lies below a tenth of the largest entry. Two calls bit-identical."""
    n, d, spherical, scale, weighted, inv_temp = case
    k = 1 << d
    x, w = _lfq_operands(n, d, spherical, weighted, card)
    v = tle.code_magnitude(d, scale, spherical)
    kw = dict(k=k, v=v, inv_temp=inv_temp)
    x64, w64 = x.double(), w.double()
    m64, s64 = tle.sweep_a_plain(x64, **kw)
    logz64 = m64 + torch.log(s64)
    ent64, avgp64 = tle.sweep_b_plain(x64, w64, logz64, eps=1e-5, **kw)
    before = {name: f.launches for name, f in tle.SWEEPS.items()}
    m, s = tle.sweep_a(x, **kw)
    logz = m + torch.log(s)
    ent, avgp = tle.sweep_b(x, w, logz, eps=1e-5, **kw)
    if inv_temp == 1.0:
        gen = np.random.default_rng(1)
        entbar = torch.from_numpy(gen.standard_normal(n).astype(np.float32)).to(card)
        gbar = torch.from_numpy(gen.standard_normal(k).astype(np.float32)).to(card)
    else:
        denom = w.sum().clamp_min(1e-6)
        a = avgp64 / denom
        entbar = (0.1 * w / denom).float()
        gbar = (0.1 * (torch.log(a.clamp_min(1e-5)) + (a > 1e-5).double()) / denom).float()
    sigma, gdot = tle.sweep_c(x, w, logz, entbar, gbar, eps=1e-5, **kw)
    dx = tle.sweep_d(x, w, logz, entbar, gbar, sigma, eps=1e-5, **kw)
    again = (tle.sweep_a(x, **kw), tle.sweep_b(x, w, logz, eps=1e-5, **kw),
             tle.sweep_c(x, w, logz, entbar, gbar, eps=1e-5, **kw),
             tle.sweep_d(x, w, logz, entbar, gbar, sigma, eps=1e-5, **kw))
    torch.cuda.synchronize()
    assert {name: f.launches - before[name] for name, f in tle.SWEEPS.items()} == dict(a=2, b=2, c=2, d=2)
    assert all(torch.equal(a, b) for a, b in zip((m, s, ent, avgp, sigma, gdot, dx),
                                                 (*again[0], *again[1], *again[2], again[3])))

    fwd_tol = 1e-5 if inv_temp == 1.0 else 1e-4
    assert float((logz.double() - logz64).abs().max()) <= fwd_tol * max(float(logz64.abs().max()), 1.0)
    assert _max_rel(ent, ent64) <= fwd_tol and _max_rel(avgp, avgp64) <= fwd_tol
    sigma64, gdot64 = tle.sweep_c_plain(x64, w64, logz64, entbar.double(), gbar.double(), eps=1e-5, **kw)
    dx64 = tle.sweep_d_plain(x64, w64, logz64, entbar.double(), gbar.double(), sigma64, eps=1e-5, **kw)
    sigma32, gdot32 = tle.sweep_c_plain(x, w, logz, entbar, gbar, eps=1e-5, **kw)
    dx32 = tle.sweep_d_plain(x, w, logz, entbar, gbar, sigma32, eps=1e-5, **kw)
    for got, plain, ref in ((sigma, sigma32, sigma64), (gdot, gdot32, gdot64), (dx, dx32, dx64)):
        err = float((got.double() - ref).abs().max())
        limit = max(2e-5 * float(ref.abs().max()), 4 * float((plain.double() - ref).abs().max()))
        # a limit at a tenth of the largest entry would pass an output of zeros,
        # unless the entries are below what f32 holds
        tiny = torch.finfo(torch.float32).tiny
        assert err <= limit and (limit < 0.1 * float(ref.abs().max()) or float(ref.abs().max()) < tiny), (err, limit)


@pytest.mark.parametrize('case', ((8192, 18, 100.0), (8192, 18, 1.0), (4096, 8, 100.0), (3000, 10, 1.0),
                                  (777, 10, 100.0)), ids=('main_t100', 'main_t1', 'd8', 'd10', 'd10_ragged'))
def test_sweep_d_log_free_matches_plain(card, case):
    """Sweep D (log-free, base 2 on ex2) against `sweep_d_plain` in float64 on
    the same statistics: within 2e-5 of the largest entry or 4x the plain f32
    sweep's own error, the limit under a tenth of that entry; two calls
    bit-identical."""
    n, d, inv_temp = case
    k = 1 << d
    x, w = _lfq_operands(n, d, True, True, card, seed=11)
    kw = dict(k=k, v=tle.code_magnitude(d, 1.0, True), inv_temp=inv_temp, eps=1e-5)
    x64, w64 = x.double(), w.double()
    m64, s64 = tle.sweep_a_plain(x64, k=k, v=kw['v'], inv_temp=inv_temp)
    logz64 = m64 + torch.log(s64)
    if inv_temp == 1.0:
        gen = np.random.default_rng(12)
        entbar = torch.from_numpy(gen.standard_normal(n).astype(np.float32)).to(card)
        gbar = torch.from_numpy(gen.standard_normal(k).astype(np.float32)).to(card)
    else:
        # the cotangents LFQ's aux loss sends (weight 0.1, gamma 1)
        a = tle.sweep_b_plain(x64, w64, logz64, **kw)[1] / w64.sum()
        entbar = (0.1 * w / w.sum()).float()
        gbar = (0.1 * (torch.log(a.clamp_min(1e-5)) + (a > 1e-5).double()) / w64.sum()).float()
    sigma64, _ = tle.sweep_c_plain(x64, w64, logz64, entbar.double(), gbar.double(), **kw)
    logz, sigma = logz64.float(), sigma64.float()
    before = tle.sweep_d.launches
    dx = tle.sweep_d(x, w, logz, entbar, gbar, sigma, **kw)
    again = tle.sweep_d(x, w, logz, entbar, gbar, sigma, **kw)
    torch.cuda.synchronize()
    assert tle.sweep_d.launches == before + 2 and torch.equal(dx, again)
    ref = tle.sweep_d_plain(x64, w64, logz.double(), entbar.double(), gbar.double(), sigma.double(), **kw)
    plain = tle.sweep_d_plain(x, w, logz, entbar, gbar, sigma, **kw)
    scale = float(ref.abs().max())
    limit = max(2e-5 * scale, 4 * float((plain.double() - ref).abs().max()))
    assert limit < 0.1 * scale
    assert float((dx.double() - ref).abs().max()) <= limit


def test_lfq_entropy_stats_on_card_matches_cpu(card):
    n, d = 2000, 12
    x, w = _lfq_operands(n, d, True, True, card, seed=2)
    v = tle.code_magnitude(d, 1.0, True)
    xs = [x.clone().requires_grad_(), x.cpu().requires_grad_()]
    outs = [tle.lfq_entropy_stats(t, w.to(t.device), k=1 << d, v=v, inv_temp=1.0) for t in xs]
    gen = np.random.default_rng(3)
    entbar = torch.from_numpy(gen.standard_normal(n).astype(np.float32))
    gbar = torch.from_numpy(gen.standard_normal(1 << d).astype(np.float32))
    grads = [torch.autograd.grad(o, t, (entbar.to(t.device), gbar.to(t.device)))[0] for o, t in zip(outs, xs)]
    for a, b in zip(outs[0], outs[1]):
        assert _max_rel(a.detach().cpu(), b.detach().double()) <= 1e-5
    assert _max_rel(grads[0].cpu(), grads[1].double()) <= 2e-5


def test_lfq_kernels_reject_what_they_do_not_take(card):
    x, w = _lfq_operands(100, 8, False, False, card)
    with pytest.raises(ValueError, match='1 <= d <= 24'):
        tle.sweep_a(torch.zeros(4, 25, device=card), k=1 << 25, v=1.0, inv_temp=1.0)
    with pytest.raises(TypeError, match='float32'):
        tle.sweep_a(x.double(), k=256, v=1.0, inv_temp=1.0)
    with pytest.raises(ValueError, match='contiguous'):
        tle.sweep_b(x, torch.stack([w, w], 1)[:, 0], w, k=256, v=1.0, inv_temp=1.0, eps=1e-5)
    col = torch.zeros(4, device=card)
    with pytest.raises(ValueError, match='1 <= d <= 24'):
        tle.sweep_d(torch.zeros(4, 25, device=card), col, col, col, torch.zeros(1 << 25, device=card), col,
                    k=1 << 25, v=1.0, inv_temp=1.0, eps=1e-5)
    with pytest.raises(ValueError, match='sigma must have shape'):
        tle.sweep_d(x, w, w, w, torch.zeros(256, device=card), col, k=256, v=1.0, inv_temp=1.0, eps=1e-5)


@pytest.mark.parametrize('route', ('on', 'auto', 'off'))
def test_lfq_training_step_on_card_matches_cpu(card, route):
    """LFQ with a chunked codebook (chunk 2^8 of 2^12): 'on' and 'auto' run
    the four sweeps on the card, 'off' none. Values within 1e-4 relative,
    and the input gradient of the aux loss alone and of the whole loss
    within 1e-3 of their largest entry, of the CPU run of the same weights
    (inv_temperature 100)."""
    torch.manual_seed(0)
    kw = dict(dim=12, codebook_size=2 ** 12, entropy_loss_weight=0.1, spherical=True,
              entropy_chunk_size=2 ** 8, entropy_fused=route)
    lfq = vqtpu_torch.LFQ(**kw, device=card).train()
    ref = vqtpu_torch.LFQ(**kw, device='cpu').train()
    ref.load_state_dict({k: v.cpu() for k, v in lfq.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 300, 12), dtype=np.float32))
    before = {name: f.launches for name, f in tle.SWEEPS.items()}
    xc = x.to(card).requires_grad_()
    q, idx, aux = lfq(xc)
    aux_grad, = torch.autograd.grad(aux, xc, retain_graph=True)
    q.square().mean().backward()
    xr = x.clone().requires_grad_()
    q_ref, idx_ref, aux_ref = ref(xr)
    aux_grad_ref, = torch.autograd.grad(aux_ref, xr, retain_graph=True)
    q_ref.square().mean().backward()
    torch.cuda.synchronize()
    launched = {name: f.launches - before[name] for name, f in tle.SWEEPS.items()}
    assert launched == ({k: 0 for k in 'abcd'} if route == 'off' else {k: 1 for k in 'abcd'})
    bits = (x > 0).long() << torch.arange(11, -1, -1)
    assert torch.equal(idx.cpu(), idx_ref) and torch.equal(idx.cpu(), bits.sum(-1).int())
    torch.testing.assert_close(q.detach().cpu(), q_ref.detach(), rtol=0, atol=1e-6)
    torch.testing.assert_close(aux.detach().cpu(), aux_ref.detach(), rtol=1e-4, atol=0)
    assert _max_rel(aux_grad.cpu(), aux_grad_ref.double()) <= 1e-3
    assert _max_rel((xc.grad + aux_grad).cpu(), (xr.grad + aux_grad_ref).double()) <= 1e-3


def test_residual_lfq_on_card_matches_cpu(card):
    torch.manual_seed(1)
    kw = dict(dim=32, codebook_size=2 ** 10, num_quantizers=3, entropy_loss_weight=0.1, entropy_fused='on')
    rlfq = vqtpu_torch.ResidualLFQ(**kw, device=card).train()
    ref = vqtpu_torch.ResidualLFQ(**kw, device='cpu').train()
    ref.load_state_dict({k: v.cpu() for k, v in rlfq.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 500, 32), dtype=np.float32))
    before = tle.sweep_d.launches
    q, idx, losses = rlfq(x.to(card))
    (losses.sum() + q.square().mean()).backward()
    q_ref, idx_ref, losses_ref = ref(x)
    torch.cuda.synchronize()
    assert tle.sweep_d.launches == before + 3
    assert torch.equal(idx.cpu(), idx_ref)
    torch.testing.assert_close(q.detach().cpu(), q_ref.detach(), rtol=0, atol=1e-5)
    torch.testing.assert_close(losses.detach().cpu(), losses_ref.detach(), rtol=1e-4, atol=1e-7)


# -- the fused ResidualFSQ eval (csrc/residual_fsq_fused.cu) ------------------------

import vqtpu_torch.kernels.residual_fsq_fused as trf  # noqa: E402

RFSQ_CASES = {
    # levels, q, leading shape: the cases of tests/test_residual_fsq_fused.py,
    # a ragged count, a leading shape, and the general instantiation (d > 8, q > 16)
    'l8555_q8': ((8, 5, 5, 5), 8, (64, 2048)),
    'l865_q3': ((8, 6, 5), 3, (4096,)),
    'l75555_q6': ((7, 5, 5, 5, 5), 6, (4096,)),
    'l44_q2': ((4, 4), 2, (4096,)),
    'l8555_q3': ((8, 5, 5, 5), 3, (4096,)),
    'ragged_1234': ((8, 6, 5), 4, (1234,)),
    'lead_2x999': ((8, 5, 5, 5), 8, (2, 999)),
    'd9_q5_general': ((5, 5, 5, 5, 5, 5, 5, 5, 5), 5, (3000,)),
    'd4_q17_general': ((8, 5, 5, 5), 17, (3000,)),
    'd1_q1': ((3,), 1, (7,)),
}


def _rfsq_call(x, levels, q, plain=False):
    m = vqtpu_torch.ResidualFSQ(levels=list(levels), num_quantizers=q, device=x.device)
    fn = trf.fused_residual_fsq_eval_plain if plain else trf.fused_residual_fsq_eval
    return fn(x, m._scales(), levels=levels, clamp=m.soft_clamp_input_value, num_quantizers=q)


@pytest.mark.parametrize('case', RFSQ_CASES)
def test_rfsq_kernel_matches_plain_bit_for_bit(card, case):
    """K9 against its plain version on the card, same inputs: quantized
    values and indices bit-identical, two calls bit-identical, one launch a
    call."""
    levels, q, lead = RFSQ_CASES[case]
    rng = np.random.default_rng(7)
    x = torch.from_numpy(1.5 * rng.standard_normal((*lead, len(levels))).astype(np.float32)).to(card)
    before = trf.fused_residual_fsq_eval.launches
    got = _rfsq_call(x, levels, q)
    again = _rfsq_call(x, levels, q)
    want = _rfsq_call(x, levels, q, plain=True)
    torch.cuda.synchronize()
    assert trf.fused_residual_fsq_eval.launches == before + 2
    assert got[1].dtype == torch.int32 and got[1].shape == (*lead, q) and got[0].shape == x.shape
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert torch.equal(got[1], want[1]), float((got[1] != want[1]).float().mean())
    assert torch.equal(got[0], want[0]), float((got[0] - want[0]).abs().max())


def test_rfsq_kernel_rejects_what_it_does_not_take(card):
    with pytest.raises(ValueError, match='1 <= d <= 128'):
        trf.fused_residual_fsq_eval(torch.zeros(4, 129, device=card), torch.ones(2, 129, device=card),
                                    levels=(3,) * 129, clamp=(1.5,) * 129, num_quantizers=2)
    with pytest.raises(ValueError, match='scales'):
        trf.fused_residual_fsq_eval(torch.zeros(4, 3, device=card), torch.ones(3, 3, device=card),
                                    levels=(8, 6, 5), clamp=(1.1, 1.2, 1.25), num_quantizers=2)
    empty = _rfsq_call(torch.zeros(0, 4, device=card), (8, 5, 5, 5), 3)
    assert empty[0].shape == (0, 4) and empty[1].shape == (0, 3)


def test_rfsq_eval_routes_on_card(card):
    """'auto' eval launches K9 once per ResidualFSQ (twice for two groups) and
    equals 'off' bit for bit; 'off', training and an ineligible 'on' launch
    nothing; the decode from indices matches the output within 1e-6."""
    torch.manual_seed(2)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((4, 1000, 4), dtype=np.float32)).to(card)
    m = vqtpu_torch.ResidualFSQ(levels=[8, 5, 5, 5], num_quantizers=8, device=card).eval()
    launches = trf.fused_residual_fsq_eval.launches
    with torch.no_grad():
        q_auto, idx_auto = m(x)
        assert trf.fused_residual_fsq_eval.launches == launches + 1
        m.eval_fused = 'off'
        q_off, idx_off = m(x)
        m.train()
        m(x)
        assert trf.fused_residual_fsq_eval.launches == launches + 1
        m.eval()
        assert torch.equal(idx_auto, idx_off) and torch.equal(q_auto, q_off)
        torch.testing.assert_close(m.get_output_from_indices(idx_auto), q_auto, rtol=0, atol=1e-6)

        rot = vqtpu_torch.ResidualFSQ(levels=[5, 5, 5, 5], num_quantizers=3, eval_fused='on',
                                      orthogonal_rotation=True, device=card).eval()
        rot_off = vqtpu_torch.ResidualFSQ(levels=[5, 5, 5, 5], num_quantizers=3, eval_fused='off',
                                          orthogonal_rotation=True, device=card).eval()
        rot_off.load_state_dict(rot.state_dict())
        a, b = rot(x), rot_off(x)
        assert trf.fused_residual_fsq_eval.launches == launches + 1
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

        g = vqtpu_torch.GroupedResidualFSQ(dim=8, groups=2, levels=[8, 5, 5, 5], num_quantizers=8,
                                           device=card).eval()
        gq, gidx = g(torch.cat([x, x.flip(1)], -1))
        assert trf.fused_residual_fsq_eval.launches == launches + 3
        torch.testing.assert_close(g.get_output_from_indices(gidx), gq, rtol=0, atol=1e-6)


def test_fsq_on_card_matches_cpu(card):
    """FSQ and ResidualFSQ training forward + backward on the card against
    the same weights on the CPU: hard-clamp FSQ codes equal; values within
    1e-5 and gradients within 1e-5 of their largest entry."""
    torch.manual_seed(3)
    kw = dict(levels=[8, 5, 5, 5], num_quantizers=4, dim=32, quantize_dropout=True)
    m = vqtpu_torch.ResidualFSQ(**kw, device=card).train()
    ref = vqtpu_torch.ResidualFSQ(**kw, device='cpu').train()
    ref.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 500, 32), dtype=np.float32))
    before = trf.fused_residual_fsq_eval.launches
    q, idx = m(x.to(card), rand_quantize_dropout_index=2)
    q.square().mean().backward()
    q_ref, idx_ref = ref(x, rand_quantize_dropout_index=2)
    q_ref.square().mean().backward()
    torch.cuda.synchronize()
    assert trf.fused_residual_fsq_eval.launches == before
    assert (idx[..., 3:] == -1).all() and torch.equal(idx.cpu()[..., :2], idx_ref[..., :2])
    torch.testing.assert_close(q.detach().cpu(), q_ref.detach(), rtol=0, atol=1e-4)
    for (name, p), (_, pr) in zip(m.named_parameters(), ref.named_parameters()):
        assert _max_rel(p.grad.cpu(), pr.grad.double()) <= 1e-5, name

    fsq = vqtpu_torch.FSQ([8, 5, 5, 5, 5], preserve_symmetry=True, bound_hard_clamp=True, device=card).eval()
    xs = torch.from_numpy(np.random.default_rng(10).standard_normal((4, 999, 5), dtype=np.float32))
    got, got_idx = fsq(xs.to(card))
    want, want_idx = fsq.cpu()(xs)
    assert torch.equal(got_idx.cpu(), want_idx) and torch.equal(got.cpu(), want)
