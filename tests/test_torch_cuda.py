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
    # two calls bit-identical, and the indices of the selection kernel bit for
    # bit: K4 runs nearest_code's own split-TF32 tile on the same operands
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


@pytest.mark.parametrize('sweep', ('a', 'b', 'c', 'd'))
@pytest.mark.parametrize('case', ((8192, 18, 100.0), (8192, 18, 1.0), (4096, 8, 100.0), (3000, 10, 1.0),
                                  (777, 10, 100.0), (300, 22, 100.0)),
                         ids=('main_t100', 'main_t1', 'd8', 'd10', 'd10_ragged', 'd22_ragged'))
def test_log_free_sweeps_match_plain(card, case, sweep):
    """The four sweeps, without a log or an accurate exp (base 2 on ex2),
    against their plain versions in float64 on the same statistics: A's
    logz = m + log s within the forward tolerance of max(|logz|, 1) (1e-5 at
    inv_temp 1, 1e-4 at 100), B's ent and avgp within it of their largest
    entry, C's sigma and gdot and D's dx within 2e-5 of theirs, or 4x the
    plain f32 sweep's own error, the limit under a tenth of the largest
    entry; two calls bit-identical. d = 22 runs the two-token tier of
    sweeps A, B and C (d > 18) on a ragged N."""
    n, d, inv_temp = case
    k = 1 << d
    x, w = _lfq_operands(n, d, True, True, card, seed=11)
    kw = dict(k=k, v=tle.code_magnitude(d, 1.0, True), inv_temp=inv_temp, eps=1e-5)
    x64, w64 = x.double(), w.double()
    m64, s64 = tle.sweep_a_plain(x64, k=k, v=kw['v'], inv_temp=inv_temp)
    logz64 = m64 + torch.log(s64)
    logz = logz64.float()
    fwd_tol = 1e-5 if inv_temp == 1.0 else 1e-4
    if sweep in 'cd':
        if inv_temp == 1.0:
            gen = np.random.default_rng(12)
            entbar = torch.from_numpy(gen.standard_normal(n).astype(np.float32)).to(card)
            gbar = torch.from_numpy(gen.standard_normal(k).astype(np.float32)).to(card)
        else:
            # the cotangents LFQ's aux loss sends (weight 0.1, gamma 1)
            a = tle.sweep_b_plain(x64, w64, logz64, **kw)[1] / w64.sum()
            entbar = (0.1 * w / w.sum()).float()
            gbar = (0.1 * (torch.log(a.clamp_min(1e-5)) + (a > 1e-5).double()) / w64.sum()).float()
    if sweep == 'a':
        args, call_kw, tols = (x,), dict(k=k, v=kw['v'], inv_temp=inv_temp), ((fwd_tol, 1.0),)
    elif sweep == 'b':
        args, call_kw, tols = (x, w, logz), kw, ((fwd_tol, 0.0),) * 2
    elif sweep == 'c':
        args, call_kw, tols = (x, w, logz, entbar, gbar), kw, ((2e-5, 0.0),) * 2
    else:
        sigma = tle.sweep_c_plain(x64, w64, logz64, entbar.double(), gbar.double(), **kw)[0].float()
        args, call_kw, tols = (x, w, logz, entbar, gbar, sigma), kw, ((2e-5, 0.0),)
    fn, plain_fn = tle.SWEEPS[sweep], getattr(tle, f'sweep_{sweep}_plain')

    def outputs(out):
        return out if isinstance(out, tuple) else (out,)

    def compared(out):
        """What is held: logz = m + log s for A, each output otherwise."""
        out = outputs(out)
        return (out[0] + torch.log(out[1]),) if sweep == 'a' else out
    refs = compared(plain_fn(*(a.double() for a in args), **call_kw))
    plains = compared(plain_fn(*args, **call_kw))
    before = fn.launches
    got = fn(*args, **call_kw)
    again = fn(*args, **call_kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(outputs(got), outputs(again)))
    for out, plain, ref, (tol, floor) in zip(compared(got), plains, refs, tols):
        scale = float(ref.abs().max())
        limit = max(tol * max(scale, floor), 4 * float((plain.double() - ref).abs().max()))
        assert limit < 0.1 * scale
        assert float((out.double() - ref).abs().max()) <= limit


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


def test_lfq_auto_streams_beyond_the_sweeps(card):
    """LFQ(dim=25, codebook_size=2**25) at 'auto' trains a step on the card
    on the streamed route (the sweeps take d <= 24): no sweep launches, the
    indices are the sign bits, the aux loss and x.grad finite. 'on' raises."""
    torch.manual_seed(0)
    lfq = vqtpu_torch.LFQ(dim=25, codebook_size=2 ** 25, entropy_loss_weight=0.1, device=card).train()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 256, 25), dtype=np.float32)).to(card)
    xg = x.clone().requires_grad_()
    before = {name: f.launches for name, f in tle.SWEEPS.items()}
    q, idx, aux = lfq(xg)
    (q.square().mean() + aux).backward()
    torch.cuda.synchronize()
    assert {name: f.launches - before[name] for name, f in tle.SWEEPS.items()} == {k: 0 for k in 'abcd'}
    bits = ((x > 0).long() << torch.arange(24, -1, -1, device=card)).sum(-1).int()
    assert torch.equal(idx, bits)
    assert bool(torch.isfinite(aux)) and bool(torch.isfinite(xg.grad).all())
    on = vqtpu_torch.LFQ(dim=25, codebook_size=2 ** 25, entropy_loss_weight=0.1, entropy_fused='on',
                         device=card).train()
    with pytest.raises(ValueError, match='1 <= d <= 24'):
        on(x)


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
    # a non-dyadic step (2 / 6), a deep stack, and a configuration beyond the
    # integer index proof (prod(levels) = 2^22: the digit by the division sequence)
    'l777_q8': ((7, 7, 7), 8, (4096,)),
    'l5555_q16': ((5, 5, 5, 5), 16, (4096,)),
    'l256_256_64_q3': ((256, 256, 64), 3, (4096,)),
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


def _rfsq_bits_equal(got, want):
    """Bit for bit, NaN where the other is NaN."""
    if got.dtype == torch.float32:
        nan = got.isnan()
        return torch.equal(nan, want.isnan()) and torch.equal(got.view(torch.int32)[~nan],
                                                              want.view(torch.int32)[~nan])
    return torch.equal(got, want)


def _rfsq_hold(x, levels, q, scales=None):
    m = vqtpu_torch.ResidualFSQ(levels=list(levels), num_quantizers=q, device=x.device)
    kw = dict(levels=levels, clamp=m.soft_clamp_input_value, num_quantizers=q)
    scales = m._scales() if scales is None else scales
    got = trf.fused_residual_fsq_eval(x, scales, **kw)
    again = trf.fused_residual_fsq_eval(x, scales, **kw)
    want = trf.fused_residual_fsq_eval_plain(x, scales, **kw)
    torch.cuda.synchronize()
    for a, b in ((got[0], again[0]), (got[1], again[1]), (got[0], want[0]), (got[1], want[1])):
        assert _rfsq_bits_equal(a, b), float((a != b).float().mean())


def test_rfsq_kernel_on_large_infinite_and_tiny_inputs(card):
    """Infinite, huge, tiny (the IEEE route), NaN and signed-zero inputs
    among random ones: bit for bit, NaN for NaN."""
    levels, q = (8, 5, 5, 5), 8
    rng = np.random.default_rng(11)
    x = 1.5 * rng.standard_normal((4096, 4)).astype(np.float32)
    special = np.array([np.inf, -np.inf, 3e38, -3.4e38, 1e30, -1e20, 0.0, -0.0, 1e-40, -1e-45, 2.0 ** -100,
                        2.0 ** -79, 2.0 ** -80, np.nan, 1.0, -1.0], np.float32)
    x.reshape(-1)[rng.choice(x.size, 2048, replace=False)] = np.resize(special, 2048)
    _rfsq_hold(torch.from_numpy(x).to(card), levels, q)


def test_rfsq_kernel_ieee_route_with_other_scales(card):
    """Scales that are not the module's take the IEEE route for every token
    (the wrapper's proofs were made for the module's): bit for bit on the
    same inputs as the special-value test, with scales 1.1x the module's and
    the two deepest layers' at 1e-38 and 2^-120 (quotients near the top of
    the f32 range, and the overflow to infinity of the clip's input)."""
    levels, q = (8, 5, 5, 5), 8
    rng = np.random.default_rng(12)
    x = 1.5 * rng.standard_normal((4096, 4)).astype(np.float32)
    x.reshape(-1)[rng.choice(x.size, 512, replace=False)] = np.resize(
        np.array([np.inf, -np.inf, 3e38, 0.0, -0.0, 1e-40, np.nan, 2.0 ** -100], np.float32), 512)
    m = vqtpu_torch.ResidualFSQ(levels=list(levels), num_quantizers=q, device=card)
    scales = m._scales() * 1.1
    scales[-2], scales[-1] = 1e-38, 2.0 ** -120
    _rfsq_hold(torch.from_numpy(x).to(card), levels, q, scales=scales)


@pytest.mark.parametrize('level', (5, 7, 8))
def test_rfsq_kernel_on_a_whole_binade(card, level):
    """Every f32 value in [1, 2) and in [-2, -1) as a one-dim token (2^24
    tokens), 16 layers: bit for bit."""
    ones = (torch.arange(1 << 23, dtype=torch.int32, device=card) | (127 << 23)).view(torch.float32)
    _rfsq_hold(torch.cat([ones, -ones])[:, None], (level,), 16)


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


# -- ResidualVQ and GroupedResidualVQ: K1 and K4 per layer --------------------------


def _rvq_pair(card, route, **kw):
    torch.manual_seed(20)
    models = [vqtpu_torch.ResidualVQ(**kw, train_fused=r, device=card) for r in route]
    for m in models[1:]:
        m.load_state_dict(models[0].state_dict())
    return models


def test_rvq_launches_per_layer(card):
    """An eval forward launches K1 once per layer; a training step K4 once
    per layer on 'on' (and the default 'auto'), dropped layers included, and
    K1 once per layer on 'off'; GroupedResidualVQ once per layer and group."""
    kw = dict(dim=64, num_quantizers=4, codebook_size=128, quantize_dropout=True)
    on, off, auto = _rvq_pair(card, ('on', 'off', 'auto'), **kw)
    x = torch.randn(4, 256, 64, device=card, requires_grad=True)
    launches = {}
    for name, model, mode in (('eval', on, 'eval'), ('on', on, 'train'), ('off', off, 'train'),
                              ('auto', auto, 'train')):
        getattr(model, mode)()
        td.nearest_code.launches = ttf.fused_train_quantize.launches = 0
        q, idx, losses = model(x, rand_quantize_dropout_index=1)
        if mode == 'train':
            (q.square().mean() + losses.sum()).backward()
        torch.cuda.synchronize()
        launches[name] = (td.nearest_code.launches, ttf.fused_train_quantize.launches)
    assert launches == {'eval': (4, 0), 'on': (0, 4), 'off': (4, 0), 'auto': (0, 4)}, launches
    grouped = vqtpu_torch.GroupedResidualVQ(dim=64, groups=2, num_quantizers=4, codebook_size=128,
                                            device=card).eval()
    td.nearest_code.launches = 0
    with torch.no_grad():
        q, idx, _ = grouped(x.detach())
        assert torch.equal(grouped.get_output_from_indices(idx), q)
    assert td.nearest_code.launches == 8 and idx.shape == (2, 4, 256, 4)


def test_rvq_training_routes_identical_at_step_zero(card):
    """K4 runs K1's tile with its rows: from one state the 'on' and 'off'
    routes pick the same indices at every layer of the first step and give
    the same output."""
    on, off = _rvq_pair(card, ('on', 'off'), dim=64, num_quantizers=4, codebook_size=128)
    x = torch.randn(4, 512, 64, device=card)
    out = [m.train()(x) for m in (on, off)]
    torch.cuda.synchronize()
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][2], out[1][2])


def test_rvq_beam_ranking_ignores_tf32_setting(card):
    """The beam's distances are full f32 whatever the matmul precision
    setting: under 'high' (TF32) the beam indices equal those under
    'highest', and the setting is left as it was."""
    torch.manual_seed(21)
    rvq = vqtpu_torch.ResidualVQ(dim=64, num_quantizers=4, codebook_size=256, beam_size=4, device=card).eval()
    x = torch.randn(2, 1024, 64, device=card)
    before = torch.get_float32_matmul_precision()
    try:
        out = {}
        for precision in ('highest', 'high'):
            torch.set_float32_matmul_precision(precision)
            td.nearest_code.launches = 0
            with torch.no_grad():
                out[precision] = rvq(x)
            assert td.nearest_code.launches == 0
            assert torch.get_float32_matmul_precision() == precision
        assert torch.equal(out['high'][1], out['highest'][1])
        assert torch.equal(out['high'][0], out['highest'][0])
    finally:
        torch.set_float32_matmul_precision(before)
        torch.backends.cuda.matmul.allow_tf32 = False


# -- the learnable family: K1's rows with their codebook gradient (code_sums) ----


def _float64_code_sums(g, idx, c):
    """(h, n, d) rows and (h, n) codes -> (h, c, d) float64 sums, and the
    sums of |g| for the f32 bound."""
    h, n, d = g.shape
    flat = (idx.long() + torch.arange(h, device=g.device)[:, None] * c).reshape(-1)
    out = torch.zeros(h * c, d, dtype=torch.float64, device=g.device)
    absum = torch.zeros_like(out)
    out.index_put_((flat,), g.reshape(-1, d).double(), accumulate=True)
    absum.index_put_((flat,), g.reshape(-1, d).double().abs(), accumulate=True)
    counts = torch.bincount(flat, minlength=h * c).double()
    return out.reshape(h, c, d), absum.reshape(h, c, d), counts.reshape(h, c)


@pytest.mark.parametrize('shape', ((20000, 512, 256), (3, 1000, 257, 40), (300, 130, 96), (4099, 1024, 3)))
def test_learnable_lookup_codebook_grad(card, shape):
    """The learnable lookup: K1's rows, and a codebook gradient that is the
    float64 per-code sum of the rows' gradients within the f32 summation
    bound, bit-identical across two backward passes, with one code_sums
    launch each."""
    x, e = _operands(shape, 'euclidean', card)
    g = torch.randn(x.shape, device=card)
    c = e.shape[-2]
    grads = []
    for _ in range(2):
        before = (td.nearest_code.launches, ttf.code_sums.launches)
        ec = e.clone().requires_grad_()
        idx, rows = ttf.lookup_with_code_grad(x, ec)
        (rows * g).sum().backward()
        torch.cuda.synchronize()
        assert (td.nearest_code.launches - before[0], ttf.code_sums.launches - before[1]) == (1, 1)
        grads.append(ec.grad)
    assert torch.equal(grads[0], grads[1])
    want_idx, want_rows = td.quantize_lookup(x, e)
    assert torch.equal(idx, want_idx) and torch.equal(rows, want_rows)
    heads = (lambda t: t) if x.ndim == 3 else (lambda t: t[None])
    ref, absum, counts = _float64_code_sums(heads(g), heads(idx), c)
    bound = (counts[..., None] + 128) * 2.0 ** -24 * absum
    assert bool(((heads(grads[0]).double() - ref).abs() <= bound).all())


def test_code_sums_matches_plain_and_rejects(card):
    """code_sums against the plain version (index_put_) and float64, with
    weights; what the kernel does not take raises."""
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal((2, 5000, 64), dtype=np.float32)).to(card)
    idx = torch.from_numpy(rng.integers(0, 300, (2, 5000)).astype(np.int32)).to(card)
    w = torch.from_numpy((rng.random((2, 5000)) > 0.4).astype(np.float32)).to(card)
    bins, esum = ttf.code_sums(g, idx, 300, w)
    pbins, pesum = ttf.code_statistics_plain(g, idx, 300, w)
    torch.cuda.synchronize()
    assert torch.equal(bins, pbins)
    torch.testing.assert_close(esum, pesum, rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError, match='int32'):
        ttf.code_sums(g, idx.long(), 300)
    with pytest.raises(ValueError, match='contiguous'):
        ttf.code_sums(g.transpose(0, 1).contiguous().transpose(0, 1), idx, 300)


def test_learnable_vq_step_is_deterministic(card):
    """Two learnable steps with the in-place Adam from one state give the
    same bits: indices, codebook, its gradient and x.grad; K1 three times
    and code_sums twice a step, no K4."""
    out = []
    for _ in range(2):
        torch.manual_seed(5)
        vq = vqtpu_torch.VectorQuantize(dim=64, codebook_size=256, learnable_codebook=True, ema_update=False,
                                        in_place_codebook_optimizer=lambda p: torch.optim.Adam(p, lr=1e-3),
                                        device=card).train()
        x = torch.from_numpy(np.random.default_rng(6).standard_normal((4, 2000, 64), dtype=np.float32))
        xc = x.to(card).requires_grad_()
        before = (td.nearest_code.launches, ttf.code_sums.launches, ttf.fused_train_quantize.launches)
        q, idx, loss = vq(xc)
        (q.square().mean() + loss).backward()
        torch.cuda.synchronize()
        after = (td.nearest_code.launches, ttf.code_sums.launches, ttf.fused_train_quantize.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (3, 2, 0)
        out.append((idx, vq._codebook.embed.detach().clone(), vq._codebook.embed.grad, xc.grad))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_affine_param_routes_agree(card):
    """affine_param on K4 ('on': raw-x statistics, then the post-transform)
    against 'off' (statistics of the mapped x): the same indices, and the
    EMA state to f32 summation rounding."""
    models = {}
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 3000, 64), dtype=np.float32) + 0.3).to(card)
    for route in ('on', 'off'):
        torch.manual_seed(8)
        vq = vqtpu_torch.VectorQuantize(dim=64, codebook_size=256, affine_param=True, train_fused=route,
                                        device=card).train()
        before = (td.nearest_code.launches, ttf.fused_train_quantize.launches)
        _, idx, _ = vq(x)
        torch.cuda.synchronize()
        launched = (td.nearest_code.launches - before[0], ttf.fused_train_quantize.launches - before[1])
        assert launched == ((0, 1) if route == 'on' else (1, 0))
        models[route] = (vq, idx)
    (on, idx_on), (off, idx_off) = models['on'], models['off']
    assert torch.equal(idx_on, idx_off)
    for name in ('cluster_size', 'batch_mean', 'batch_variance', 'codebook_mean', 'codebook_variance'):
        assert torch.equal(getattr(on._codebook, name), getattr(off._codebook, name)), name
    torch.testing.assert_close(on._codebook.embed_avg, off._codebook.embed_avg, rtol=1e-5, atol=1e-6)


def test_qinco_layer_matches_cpu(card):
    """A QINCo ResidualVQ on the card against the same weights on the CPU:
    the indices, the output and, in training, the gradients."""
    torch.manual_seed(9)
    kw = dict(dim=32, num_quantizers=3, codebook_size=64, implicit_neural_codebook=True)
    m = vqtpu_torch.ResidualVQ(**kw, device=card)
    ref = vqtpu_torch.ResidualVQ(**kw, device='cpu')
    ref.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 50, 32), dtype=np.float32))
    for mode in ('eval', 'train'):
        getattr(m, mode)()
        getattr(ref, mode)()
        xc = x.to(card).requires_grad_()
        xr = x.clone().requires_grad_()
        q, idx, losses = m(xc)
        q_ref, idx_ref, losses_ref = ref(xr)
        assert torch.equal(idx.cpu(), idx_ref)
        torch.testing.assert_close(q.detach().cpu(), q_ref.detach(), rtol=1e-5, atol=1e-5)
        if mode == 'train':
            (q.square().mean() + losses.sum()).backward()
            (q_ref.square().mean() + losses_ref.sum()).backward()
            torch.testing.assert_close(xc.grad.cpu(), xr.grad, rtol=1e-4, atol=1e-6)
            for (name, p), (_, pr) in zip(m.named_parameters(), ref.named_parameters()):
                assert _max_rel(p.grad.cpu(), pr.grad.double()) <= 1e-4, name


def _copy_to_cpu(model, factory):
    """A CPU twin of a card module built by `factory(device)`, with its state."""
    twin = factory('cpu')
    twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return twin


def test_simvq_launches_and_matches_cpu(card):
    """SimVQ: K1 once a forward (selection and rows), code_sums once in the
    backward, the transform's gradient as on the CPU from the same picks;
    eval rows bit-equal to the implicit codebook's, the decode from indices
    within 1e-6 of them (a Linear over one row or over c rows)."""
    factory = lambda dev: vqtpu_torch.SimVQ(dim=64, codebook_size=256, device=dev)  # noqa: E731
    torch.manual_seed(0)
    model = factory(card)
    cpu = _copy_to_cpu(model, factory)
    x = torch.randn(4, 512, 64, device=card)
    td.nearest_code.launches = ttf.code_sums.launches = 0
    xg = x.clone().requires_grad_()
    q, idx, loss = model(xg)
    (q.square().mean() + loss).backward()
    torch.cuda.synchronize()
    assert (td.nearest_code.launches, ttf.code_sums.launches) == (1, 1)
    xc = x.cpu().requires_grad_()
    qc, idxc, lossc = cpu(xc)
    (qc.square().mean() + lossc).backward()
    with torch.no_grad():
        implicit = model.codebook
    r = td.selection_disagreements(x.reshape(-1, 64), implicit, td.selection_bias(implicit, 'euclidean'),
                                   idx.reshape(-1), idxc.reshape(-1).to(card))
    assert r['non_tie'] == 0, r
    if r['disagree'] == 0:
        w, wc = model.code_transform.weight.grad, cpu.code_transform.weight.grad
        assert float((w.cpu() - wc).abs().max()) <= 1e-4 * float(wc.abs().max())
        assert float((xg.grad.cpu() - xc.grad).abs().max()) <= 1e-4 * float(xc.grad.abs().max())
    model.eval()
    td.nearest_code.launches = 0
    with torch.no_grad():
        q, idx, _ = model(x)
        assert td.nearest_code.launches == 1 and torch.equal(q, model.codebook[idx.long()])
        assert float((model.indices_to_codes(idx) - q).abs().max()) <= 1e-6 * float(q.abs().max())


def test_residual_simvq_launches_per_layer(card):
    """ResidualSimVQ: K1 once a layer in eval and in a training step
    (dropped layers included), code_sums once a layer in the backward."""
    model = vqtpu_torch.ResidualSimVQ(dim=64, num_quantizers=4, codebook_size=128, quantize_dropout=True,
                                      device=card)
    x = torch.randn(4, 256, 64, device=card, requires_grad=True)
    td.nearest_code.launches = ttf.code_sums.launches = 0
    q, idx, losses = model(x, rand_quantize_dropout_index=1)
    (q.square().mean() + losses.sum()).backward()
    torch.cuda.synchronize()
    assert (td.nearest_code.launches, ttf.code_sums.launches) == (4, 4)
    assert (idx[..., 2:] == -1).all() and (idx[..., :2] >= 0).all()
    model.eval()
    td.nearest_code.launches = 0
    with torch.no_grad():
        q, idx, _ = model(x.detach())
        dec = model.get_output_from_indices(idx)
    assert td.nearest_code.launches == 4
    assert float((dec - q).abs().max()) <= 1e-5 * float(q.abs().max())


def test_rpq_one_launch_over_heads(card):
    """RandomProjectionQuantizer: one K1 launch over every head (cosine),
    each head against the plain selection (near-ties only); the cross
    entropy against given indices launches none."""
    model = vqtpu_torch.RandomProjectionQuantizer(dim=64, codebook_size=128, codebook_dim=32, num_codebooks=4,
                                                  device=card)
    x = torch.randn(2, 256, 64, device=card)
    td.nearest_code.launches = 0
    with torch.no_grad():
        idx = model(x)
        assert td.nearest_code.launches == 1 and idx.shape == (2, 256, 4)
        t = torch.einsum('bnd,hde->bnhe', model.norm(x), model.rand_projs).reshape(2, 256, -1)
        xc = model.vq.codebook_input(t)
        embed = model.vq._codebook.embed
        for h in range(4):
            xh = xc[h].reshape(-1, xc.shape[-1]).contiguous()
            bias = td.selection_bias(embed[h], 'cosine')
            r = td.selection_disagreements(xh, embed[h], bias, idx[..., h].reshape(-1),
                                           td.nearest_code_plain(xh, embed[h], bias))
            assert r['non_tie'] == 0, r
        ce = model(x, indices=idx)
    assert td.nearest_code.launches == 1 and bool(torch.isfinite(ce))


def test_hierarchical_vq_launches_per_scale(card):
    """HierarchicalVQ: K1 once a scale in eval, K4 once a scale in an EMA
    training step ('on'), the 1x1 and 2x2 scales under one tile included."""
    model = vqtpu_torch.HierarchicalVQ(dim=32, codebook_size=512, scales=(1, 2, 4, 7), accept_image_fmap=True,
                                       train_fused='on', device=card)
    x = torch.randn(64, 32, 7, 7, device=card, requires_grad=True)
    td.nearest_code.launches = ttf.fused_train_quantize.launches = 0
    rec, idx, loss = model(x)
    (rec.square().mean() + loss).backward()
    torch.cuda.synchronize()
    assert (td.nearest_code.launches, ttf.fused_train_quantize.launches) == (0, 4)
    assert [tuple(i.shape) for i in idx] == [(64, s, s) for s in (1, 2, 4, 7)]
    model.eval()
    td.nearest_code.launches = 0
    with torch.no_grad():
        rec, idx, _ = model(x.detach())
        dec = model.get_output_from_indices(idx)
    assert td.nearest_code.launches == 4 and bool(torch.isfinite(rec).all())
    assert float((dec - rec).abs().max()) <= 1e-5 * float(rec.abs().max())


def test_dp_vq_train_two_gloo_ranks(card):
    """The data-parallel VQ step at a small size: two gloo ranks on one card
    (tests/torch_dist.py), K4 once a rank a step, the ranks' codebooks
    bit-identical every step, and from step 1 on one process over the whole
    batch from the same state picks the same indices and cluster sizes."""
    import torch_dist

    ranks = torch_dist.run_world(torch_dist.vq_dp_card_body, steps=3)
    for steps in ranks:
        assert [st['launches'] for st in steps] == [1, 1, 1]
        assert all(st['identical'] for st in steps)
    for st in ranks[0][1:]:
        assert st['one_process_indices'] and st['one_process_cluster_size']


def test_dp_compiled_step_one_nccl_rank(card):
    """DataParallelTrainer's step compiled whole on the card (its default
    there) on one NCCL rank, the collectives in the graph, against its
    eager twin from the same state: kmeans init, then the step after it;
    K4 once a compiled step, every flipped index a near-tie in float64,
    loss, gain and codebook within 1e-5 of eager over the unflipped codes."""
    import torch_dist
    from vqtpu_torch.parallel import run_ranks

    (steps,) = run_ranks(torch_dist.dp_compiled_card_body, 1, backend='nccl', device='cuda', timeout=600)
    for st in steps:
        assert st['compiled'] and st['launches'] == 1, st
        assert st['ties']['non_tie'] == 0, st
        assert max(st['errors'].values()) <= 1e-5, st


@pytest.mark.parametrize('metric', td.METRICS)
@pytest.mark.parametrize('shape', ((300, 130, 96), (3, 1000, 257, 40), (4099, 1024, 256), (500, 300, 30)))
def test_kernel_return_best_matches_plain(card, metric, shape):
    """K1 with `return_best`: the same indices as without it, and the best
    score within the worst-case bound of the float64 score at the chosen
    code ((6d + 64) * 2^-24 of sum |x e| + |bias|: the split's remainders and
    3d f32 additions that may truncate); the plain version's best is its own
    score at its pick."""
    x, e = _operands(shape, metric, card)
    bias = td.selection_bias(e, metric)
    idx = td.nearest_code(x, e, metric, bias)
    got, best = td.nearest_code(x, e, metric, bias, return_best=True)
    pidx, pbest = td.nearest_code_plain(x, e, bias, return_best=True)
    torch.cuda.synchronize()
    assert torch.equal(got, idx) and best.dtype == torch.float32 and best.shape == idx.shape
    xd, ed, bd = x.double(), e.double(), bias.double()
    if x.ndim == 2:
        xd, ed, bd, got, best = xd[None], ed[None], bd[None], got[None], best[None]
        pidx, pbest = pidx[None], pbest[None]
    picked = ed.gather(1, got.long()[..., None].expand(*got.shape, ed.shape[-1]))
    score = (xd * picked).sum(-1) + bd.gather(1, got.long())
    bound = (6 * x.shape[-1] + 64) * 2.0 ** -24 * ((xd * picked).abs().sum(-1) + bd.gather(1, got.long()).abs())
    assert bool(((best.double() - score).abs() <= bound).all())
    pscore = (xd @ ed.transpose(-1, -2) + bd[:, None]).gather(-1, pidx.long()[..., None])[..., 0]
    assert bool(((pbest.double() - pscore).abs() <= bound.max()).all())


@pytest.mark.parametrize('world', (2, 4, 8))
def test_simulated_shard_selection_matches_unsharded(card, world):
    """The codebook in `world` row blocks, K1 with its best on each, the
    winners reduced as `_global_winner_index` reduces them: indices and
    best scores bit-equal to unsharded K1 (a column's score does not depend
    on its block), rows of the sharded lookup bit-equal to codebook rows."""
    from vqtpu_torch.parallel.shard import _RowGather, local_or_dump
    x, e = _operands((20000, 4096, 256), 'euclidean', card)
    e[4095] = e[0]                                    # a tie across the first and last block
    x[:3] = e[0]
    idx, best = td.nearest_code(x, e, return_best=True)
    c_local = e.shape[0] // world
    parts = [td.nearest_code(x, e[r * c_local:(r + 1) * c_local].contiguous(), return_best=True)
             for r in range(world)]
    scores = torch.stack([p[1] for p in parts])
    top = scores.max(0).values
    win = (scores == top).int().argmax(0)
    got = (torch.stack([p[0] for p in parts]).gather(0, win[None])[0] + win * c_local).to(torch.int32)
    rows = sum(_RowGather.apply(e[r * c_local:(r + 1) * c_local], local_or_dump(got, c_local, r * c_local))
               for r in range(world))
    torch.cuda.synchronize()
    assert torch.equal(got, idx) and torch.equal(top, best)
    assert torch.equal(got[:3], torch.zeros(3, dtype=torch.int32, device=card))
    assert torch.equal(rows, e[idx.long()])


def test_code_sums_with_a_dump_row(card):
    """The statistics of a shard's rows: tokens of other shards' codes sent
    to a dump row c_local, whose sums are dropped; the rest equal
    code_statistics_plain of the shard's own tokens (bins exact, sums to
    1e-5)."""
    from vqtpu_torch.parallel.shard import local_or_dump
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 30000, 64), dtype=np.float32)).to(card)
    gidx = torch.from_numpy(rng.integers(0, 1024, (1, 30000)).astype(np.int32)).to(card)
    c_local, row0 = 256, 512
    local = local_or_dump(gidx, c_local, row0)
    bins, esum = ttf.code_sums(x, local, c_local + 1)
    mine = (gidx >= row0) & (gidx < row0 + c_local)
    pbins, pesum = ttf.code_statistics_plain(x[mine][None], (gidx[mine] - row0)[None], c_local)
    torch.cuda.synchronize()
    assert torch.equal(bins[:, :c_local], pbins)
    torch.testing.assert_close(esum[:, :c_local], pesum, rtol=1e-5, atol=1e-5)
    assert float(bins[0, c_local]) == float((~mine).sum())


def test_tp_vq_train_two_gloo_ranks(card):
    """A row-sharded VectorQuantize on two ('code',) gloo ranks of one card
    at a small size: K1 and code_sums once a rank a step, and the eval
    forward equal to the unsharded module's. Then TensorParallelTrainer's
    step compiled on the card (its default there), the collectives in the
    graph, against its eager twin from the same state: kmeans init (10
    more K1 and code_sums launches), then the step after it; every flipped
    index a near-tie in float64, the loss, gain and codebook within 1e-5 of
    eager over the unflipped codes."""
    import torch_dist
    ranks = torch_dist.run_world(torch_dist.tp_card_body, axes=('code',), timeout=600)
    for r in ranks:
        assert r['launches'] == [dict(nearest_code=1, code_sums=1)] * 3
        assert r['eval_equal']
        for s, st in enumerate(r['compiled_steps']):
            extra = 10 if s == 0 else 0
            assert st['compiled'] and st['launches'] == dict(nearest_code=1 + extra, code_sums=1 + extra), st
            assert st['ties']['non_tie'] == 0, st
            assert max(st['errors'].values()) <= 1e-5, st


def test_tp_apply_compiled_two_gloo_ranks(card):
    """tp_apply of a row-sharded VectorQuantize's eval forward and decode on
    two ('code',) gloo ranks of the card, compiled (its default there):
    K1 once a rank a call, bit-equal to the eager call and the unsharded
    eval, the decode its rows, the module as before, and a second call on
    another batch capturing no graph."""
    import torch_dist
    ranks = torch_dist.run_world(torch_dist.tp_apply_card_body, axes=('code',), timeout=600)
    for r in ranks:
        assert r['launches'] == dict(eager=1, compiled=1, again=1), r
        assert r['frames'] == 1, r
        assert r['compiled_equal'] and r['unsharded_equal'] and r['decode_equal'] and r['unchanged'], r


def test_group_parallel_compiled_two_gloo_ranks(card):
    """group_parallel_forward compiled on two ('group',) gloo ranks of the
    card (its default there): GroupedResidualVQ eval bit-equal to eager and
    serial with K1 once a layer a rank; a training call with
    update_state=False leaves the state as it was (F4) and returns the
    step's outputs; the 'on' step with K4 once a layer a rank, its indices
    eager's and serial's, its rows and loss within 1e-6 and its state within
    1e-5 of eager's; GroupedResidualFSQ eval with K9 once a rank; the
    decodes round trip (FSQ's within 1e-6)."""
    import torch_dist
    ranks = torch_dist.run_world(torch_dist.gp_card_body, axes=('group',), timeout=600)
    for r in ranks:
        assert r['vq_eval_launches'] == r['vq_eval_compiled_launches'] == (2, 0, 0), r
        assert r['vq_train_launches'] == r['vq_train_compiled_launches'] == r['vq_kept_launches'] == (0, 2, 0), r
        assert r['fsq_eval_launches'] == r['fsq_eval_compiled_launches'] == (0, 0, 1), r
        for key in ('vq_eval_equal', 'vq_decode_equal', 'vq_kept_unchanged', 'vq_kept_equals_step',
                    'vq_train_indices_equal', 'fsq_eval_equal'):
            assert r[key], (key, r)
        assert r['vq_train_rows_rel_err'] <= 1e-6 and r['vq_train_loss_rel_err'] <= 1e-6, r
        # FSQ's decode is arithmetic, which inductor may contract into FMAs
        assert r['fsq_decode_rel_err'] <= 1e-6, r
        assert r['vq_train_state_rel_err'] <= 1e-5, r


def test_group_parallel_example_compiled_two_gloo_ranks(card):
    """vqtpu_torch.examples.group_parallel_grvq on two ('group',) gloo ranks
    of the card, as it runs there by default: its group-parallel calls
    compiled, step 0 the serial loop's (indices bit for bit, the output
    and the loss within 1e-6), the decode round trip."""
    import torch_dist
    ranks = torch_dist.run_world(torch_dist.gp_example_card_body, axes=('group',), timeout=600)
    for r in ranks:
        assert r['compiled'] and all(r['step0'].values()), r
        assert r['decode_max_err'] < 1e-5, r


def test_selection_tape_on_the_card(card):
    """chip_smoke.py's replay of a compiled step's picks (`selection_tape`)
    on the card: K1's and K4's launches record their picks; picks forced in
    place of a launch's own come back with their codebook rows and, for K4,
    the statistics of those picks (K4's statistics passes alone,
    `code_sums`), whose bins equal K4's own on its own picks and whose sums
    agree with them to f32 rounding; every changed pick is judged in
    float64 on the launch's operands (here none is a near-tie)."""
    import chip_smoke as cs

    x, e = _operands((4096, 512, 64), 'euclidean', card)
    w = (torch.arange(4096, device=card) % 3 > 0).float()
    rec = []
    with cs.selection_tape('cuda', record=rec):
        idx = td.nearest_code(x, e)
        idx4, _, bins4, esum4 = ttf.fused_train_quantize(x, e, weights=w)
    assert len(rec) == 2 and torch.equal(rec[0], idx) and torch.equal(rec[1], idx4)
    bins, esum = ttf.code_sums(x, idx4, 512, w)
    assert torch.equal(bins, bins4)
    assert float((esum - esum4).abs().max()) <= 1e-5 * float(esum4.abs().max())
    forced = idx.clone()
    forced[:7] = (forced[:7] + 1) % 512
    with cs.selection_tape('cuda', force=[forced, forced]) as verdicts:
        gidx, gq = td.quantize_lookup(x, e)
        fidx, fq, fbins, fesum = ttf.fused_train_quantize(x, e, weights=w)
    torch.cuda.synchronize()
    rows = e[forced.long()]
    assert torch.equal(gidx, forced) and torch.equal(gq, rows)
    assert torch.equal(fidx, forced) and torch.equal(fq, rows)
    bins, esum = ttf.code_sums(x, forced, 512, w)
    assert torch.equal(fbins, bins) and torch.equal(fesum, esum)
    assert sum(v['disagree'] for v in verdicts) == 14 and sum(v['non_tie'] for v in verdicts) == 14, verdicts


@pytest.mark.parametrize('metric', td.METRICS)
def test_native_oracle_agrees_with_kernel(card, metric):
    """K1 against the float64 C oracle (native/vqcheck.c): the picks equal
    but at near-ties; on a tie probe (codes repeated, tokens on codes and
    zero tokens) exactly, the first copy."""
    from vqtpu_torch.kernels import native_check

    assert native_check.available(), 'native/vqcheck.c does not build here'
    x, e = _operands((4096, 512, 256), metric, card, seed=7)
    idx = td.nearest_code(x, e, metric)
    ref = torch.from_numpy(native_check.nearest_code_ref(x, e, metric)).to(card)
    r = td.selection_disagreements(x, e, td.selection_bias(e, metric), idx, ref)
    assert r['non_tie'] == 0, r
    base = e[:64]
    ties_e = torch.cat([base, base, base]).contiguous()
    ties_x = torch.cat([base[::5], torch.zeros(16, 256, device=card)]).contiguous()
    got = td.nearest_code(ties_x, ties_e, metric).cpu().numpy()
    want = native_check.nearest_code_ref(ties_x, ties_e, metric)
    assert np.array_equal(got, want) and (got < 64).all()


def test_vq_example_main_on_the_card(card, capsys):
    """vqtpu_torch.examples.autoencoder's main on the card: its model there,
    K4 once a training step (train_fused='auto'), finite logged losses."""
    from vqtpu_torch.examples import autoencoder

    before = (ttf.fused_train_quantize.launches, td.nearest_code.launches)
    model = autoencoder.main(train_iter=3, batch_size=32, device='cuda')
    torch.cuda.synchronize()
    assert (ttf.fused_train_quantize.launches - before[0], td.nearest_code.launches - before[1]) == (3, 0)
    assert all(p.is_cuda for p in model.parameters())
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith('iter')]
    assert len(lines) == 2
    for line in lines:
        assert np.isfinite(float(line.split('rec loss:')[1].split('|')[0]))


def test_entry_forward_on_the_card(card):
    """vqtpu_torch.entry.entry() on the card: K4 once a call of its training
    forward (train_fused='auto'), two calls bit-identical and the state
    left as it was (the forward's EMA update runs on copies)."""
    from vqtpu_torch.entry import entry

    fn, (state, x) = entry()
    assert x.is_cuda and all(v.is_cuda for v in state.values())
    before = {k: v.clone() for k, v in state.items()}
    outs, launches = [], []
    for _ in range(2):
        k4, k1 = ttf.fused_train_quantize.launches, td.nearest_code.launches
        outs.append(fn(state, x))
        torch.cuda.synchronize()
        launches.append((ttf.fused_train_quantize.launches - k4, td.nearest_code.launches - k1))
    assert launches == [(1, 0), (1, 0)]
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert all(torch.equal(before[k], v) for k, v in state.items())
    recon, indices, commit_loss = outs[0]
    assert recon.shape == x.shape and indices.shape == (8, 49) and bool(torch.isfinite(recon).all())


def test_module_moved_to_the_card_draws_as_on_the_cpu(card):
    """A VectorQuantize built on the CPU and moved to the card takes its
    random stream's state (the buffer `rng_state`) with it, and the stream
    draws the same bits on the card as on the CPU, so its kmeans init and
    dead-code expiry draw the same rows as its twin left on the CPU: the
    codebooks after two training forwards agree within 1e-5 of their
    largest entry, and the indices exactly."""
    from vqtpu_torch import VectorQuantize

    kw = dict(dim=16, codebook_size=64, kmeans_init=True, threshold_ema_dead_code=2, device='cpu')
    torch.manual_seed(0)
    on_cpu = VectorQuantize(**kw).train()
    torch.manual_seed(0)
    moved = VectorQuantize(**kw).to(card).train()
    assert moved._codebook.generator.device.type == 'cuda'
    xs = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 2, 50, 16), dtype=np.float32))
    for x in xs:
        _, want, _ = on_cpu(x)
        _, got, _ = moved(x.to(card))
        assert torch.equal(got.cpu(), want)
    embed = on_cpu._codebook.embed
    assert bool(on_cpu._codebook.initted) and bool(moved._codebook.initted)
    assert float((moved._codebook.embed.cpu() - embed).abs().max()) <= 1e-5 * float(embed.abs().max())


# -- dtypes: low-precision inputs and autocast ---------------------------------------


def _launch_counts():
    return dict(nearest_code=td.nearest_code.launches, train_fused=ttf.fused_train_quantize.launches,
                lfq=sum(f.launches for f in tle.SWEEPS.values()),
                residual_fsq=trf.fused_residual_fsq_eval.launches)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _tensors(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def _card_vq(card, **kw):
    return vqtpu_torch.VectorQuantize(dim=64, codebook_size=512, decay=0.8, device=card, **kw)


# name -> (module factory, training?, call, the kernel the call launches)
AUTOCAST_CASES = {
    'vq_eval': (lambda c: _card_vq(c), False, lambda m, x: m(x), 'nearest_code'),
    'vq_step_on': (lambda c: _card_vq(c, train_fused='on'), True, lambda m, x: m(x), 'train_fused'),
    'vq_step_off': (lambda c: _card_vq(c, train_fused='off'), True, lambda m, x: m(x), 'nearest_code'),
    'vq_stochastic_step': (lambda c: _card_vq(c, stochastic_sample_codes=True), True, lambda m, x: m(x), None),
    # the orthogonal loss reads the codebook the forward left: K1, not K4
    'vq_orthogonal_loss_step': (lambda c: _card_vq(c, orthogonal_reg_weight=1.0), True,
                                lambda m, x: m(x, return_loss_breakdown=True), 'nearest_code'),
    'rvq_eval': (lambda c: vqtpu_torch.ResidualVQ(dim=64, codebook_size=256, num_quantizers=4, device=c), False,
                 lambda m, x: m(x), 'nearest_code'),
    'simvq_eval': (lambda c: vqtpu_torch.SimVQ(dim=64, codebook_size=512, device=c), False, lambda m, x: m(x),
                   'nearest_code'),
    'simvq_step': (lambda c: vqtpu_torch.SimVQ(dim=64, codebook_size=512, device=c), True, lambda m, x: m(x),
                   'nearest_code'),
    'lfq_fused_step': (lambda c: vqtpu_torch.LFQ(dim=12, codebook_size=4096, entropy_fused='on', device=c), True,
                       lambda m, x: m(x[..., :12], return_loss_breakdown=True), 'lfq'),
    'fsq_eval': (lambda c: vqtpu_torch.FSQ(levels=[8, 5, 5, 5], device=c), False, lambda m, x: m(x[..., :4]), None),
    'residual_fsq_eval': (lambda c: vqtpu_torch.ResidualFSQ(dim=4, levels=[8, 5, 5, 5], num_quantizers=4,
                                                            device=c), False, lambda m, x: m(x[..., :4]),
                          'residual_fsq'),
}


@pytest.mark.parametrize('case', sorted(AUTOCAST_CASES))
def test_core_is_bit_equal_under_cuda_autocast(card, case):
    """The same call on two copies of one module, once plainly and once
    under torch.autocast('cuda', dtype=torch.bfloat16), on f32 inputs:
    every output and the state after it bit-equal, and the kernel route
    taken in both."""
    import copy

    make, train, call, kernel = AUTOCAST_CASES[case]
    torch.manual_seed(0)
    model = make(card).train(train)
    plain, cast = copy.deepcopy(model), copy.deepcopy(model)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((8, 256, 64), dtype=np.float32)).to(card)
    before = _launch_counts()
    want = _tensors(call(plain, x))
    middle = _launch_counts()
    with torch.autocast('cuda', dtype=torch.bfloat16):
        got = _tensors(call(cast, x))
    torch.cuda.synchronize()
    after = _launch_counts()
    if kernel is not None:
        assert middle[kernel] > before[kernel] and after[kernel] - middle[kernel] == middle[kernel] - before[kernel]
    assert len(want) == len(got) > 0
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and torch.equal(w, g), (case, i)
    for key, w in plain.state_dict().items():
        assert torch.equal(w, cast.state_dict()[key]), (case, key)


# name -> (module factory, input shape, the kernel a training step launches, the kernel eval launches)
LOW_PRECISION_CASES = {
    'lfq': (lambda c: vqtpu_torch.LFQ(dim=16, codebook_size=4096, entropy_fused='on', device=c), (4, 128, 16),
            'lfq', None),
    'residual_lfq': (lambda c: vqtpu_torch.ResidualLFQ(dim=16, codebook_size=4096, num_quantizers=2,
                                                       entropy_fused='on', device=c), (4, 128, 16), 'lfq', None),
    'residual_fsq': (lambda c: vqtpu_torch.ResidualFSQ(dim=4, levels=[8, 5, 5, 5], num_quantizers=4, device=c),
                     (4, 128, 4), None, 'residual_fsq'),
    'residual_vq': (lambda c: vqtpu_torch.ResidualVQ(dim=64, codebook_size=256, num_quantizers=2, codebook_dim=32,
                                                     device=c), (4, 128, 64), 'train_fused', 'nearest_code'),
    # no LayerNorm: it would normalize in the input's dtype, before the cast
    'rpq': (lambda c: vqtpu_torch.RandomProjectionQuantizer(dim=64, codebook_size=256, codebook_dim=16,
                                                            num_codebooks=2, norm=False, device=c), (4, 128, 64),
            'nearest_code', 'nearest_code'),
    'fsq': (lambda c: vqtpu_torch.FSQ(levels=[8, 5, 5], dim=16, device=c), (4, 128, 16), None, None),
    'fsp': (lambda c: vqtpu_torch.FSP([8, 5, 5], dim=16, device=c), (4, 128, 16), None, None),
}


@pytest.mark.parametrize('dtype', (torch.bfloat16, torch.float16), ids=('bf16', 'fp16'))
@pytest.mark.parametrize('case,mode', [(c, m) for c in sorted(LOW_PRECISION_CASES) for m in ('eval', 'train')
                                       # without a projection its training loop clamps in the input's dtype
                                       if (c, m) != ('residual_fsq', 'train')])
def test_low_precision_input_takes_the_kernel_route(card, case, mode, dtype):
    """A bf16 or fp16 input is cast where it meets the module's f32
    weights (ResidualFSQ's K9 casts it), so the kernels take f32 operands
    as for the input's values in f32: the same launches, and the same
    outputs bit for bit once cast to the low-precision run's dtypes."""
    import copy

    make, shape, train_kernel, eval_kernel = LOW_PRECISION_CASES[case]
    kernel = train_kernel if mode == 'train' else eval_kernel
    torch.manual_seed(0)
    model = make(card).train(mode == 'train')
    low, ref = copy.deepcopy(model), copy.deepcopy(model)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(shape, dtype=np.float32)).to(card).to(dtype)
    x.requires_grad_(mode == 'train')
    before = _launch_counts()
    got = _tensors(low(x))
    middle = _launch_counts()
    want = _tensors(ref(x.detach().float()))
    after = _launch_counts()
    if kernel is not None:
        assert middle[kernel] > before[kernel] and after[kernel] - middle[kernel] == middle[kernel] - before[kernel]
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype)) and (not g.dtype.is_floating_point or torch.isfinite(g).all())
    if mode == 'train':
        floats = [g for g in got if g.dtype.is_floating_point and g.requires_grad]
        if floats:
            sum(g.float().sum() for g in floats).backward()
            assert x.grad.dtype == dtype and torch.isfinite(x.grad).all()


# -- the compiled step: inductor, fullgraph, the kernels by symbol --------------------------

# the kernels' symbols in csrc/*.cu (K1 and K4 share the tensor-core tile; K4
# adds the statistics by sorted code)
_SYMBOLS = dict(select='select_tf32_kernel', sorted_stats='sort_split_kernel', sweep_a='sweep_a_kernel',
                sweep_b='sweep_b_kernel', sweep_c='sweep_c_kernel', sweep_d='sweep_d_kernel',
                k9='residual_fsq_eval_kernel')


def _kernel_symbols(fn) -> tuple[dict, list]:
    """The hand-written kernels of one call of `fn` by symbol, and the
    names of any event that holds 'argmax' (torch.profiler after one
    warm-up call under it, the call padded by spin kernels of about 25 ms
    on either side: a window loses the device events of its first
    milliseconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.cuda._sleep(50_000_000)
        fn()
        torch.cuda.synchronize()
        prof.step()
        torch.cuda._sleep(50_000_000)
        fn()
        torch.cuda._sleep(50_000_000)
        torch.cuda.synchronize()
        prof.step()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    counts = {k: sum(sym in n for n in names) for k, sym in _SYMBOLS.items()}
    return {k: v for k, v in counts.items() if v}, [e.name for e in prof.events() if 'argmax' in e.name.lower()]


def _rel(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _compiled_entry(card):
    from vqtpu_torch.entry import entry

    fn, (state, x) = entry()
    x = x + 0.5
    return lambda: fn(state, x), lambda c: (lambda: c(state, x)), fn, dict(select=1, sorted_stats=1), 1e-5


def _compiled_vq_example(card):
    from vqtpu_torch.examples import autoencoder
    from vqtpu_torch.examples.common import adamw, train_step

    torch.manual_seed(0)
    models = [autoencoder.main(train_iter=0, device='cuda') for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    xb = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (32, 28, 28, 1)).astype(np.float32)).to(card)
    eager = train_step(models[0], adamw(models[0].parameters(), 3e-4), autoencoder.loss_from_outputs, 10.0)
    compiled = train_step(models[1], adamw(models[1].parameters(), 3e-4), autoencoder.loss_from_outputs, 10.0,
                          compiled=True)
    return lambda: eager(xb), lambda: compiled(xb), None, dict(select=1, sorted_stats=1), 1e-5


def _served(make, shape, call, symbols, requires_grad=False, grad_rel=1e-5):
    def build(card):
        torch.manual_seed(0)
        models = [make(card) for _ in range(2)]
        models[1].load_state_dict(models[0].state_dict())
        x = torch.from_numpy(np.random.default_rng(9).standard_normal(shape, dtype=np.float32)).to(card)
        x.requires_grad_(requires_grad)
        from vqtpu_torch.core.compile import compile_step
        compiled = compile_step(lambda xs: call(models[1], xs))
        return lambda: call(models[0], x), lambda: compiled(x), None, symbols, grad_rel
    return build


def _vq_train_call(m, x):
    q, idx, loss = m(x)
    gx, = torch.autograd.grad(q.square().sum() + loss, [x])
    return q.detach(), idx, loss.detach(), gx


def _lfq_train_call(m, x):
    (q, idx, aux), _ = m(x, inv_temperature=100.0, return_loss_breakdown=True)
    gx, = torch.autograd.grad(aux + q.square().mean(), [x])
    return q.detach(), idx, aux.detach(), gx


def _eval_call(m, x):
    with torch.no_grad():
        return m(x)[:2]


COMPILED_PATHS = {
    'entry_forward': _compiled_entry,
    'vq_example_step': _compiled_vq_example,
    'vq_eval': _served(lambda dev: vqtpu_torch.VectorQuantize(dim=64, codebook_size=128, device=dev).eval(),
                       (2, 256, 64), _eval_call, dict(select=1)),
    'vq_on_step': _served(lambda dev: vqtpu_torch.VectorQuantize(dim=64, codebook_size=128, train_fused='on',
                                                                 device=dev).train(),
                          (2, 256, 64), _vq_train_call, dict(select=1, sorted_stats=1), requires_grad=True),
    'lfq_on_step': _served(lambda dev: vqtpu_torch.LFQ(dim=12, codebook_size=2 ** 12, spherical=True,
                                                       entropy_loss_weight=0.1, entropy_fused='on',
                                                       device=dev).train(),
                           (2, 256, 12), _lfq_train_call, dict(sweep_a=1, sweep_b=1, sweep_c=1, sweep_d=1),
                           requires_grad=True, grad_rel=1e-3),
    'rfsq_eval': _served(lambda dev: vqtpu_torch.ResidualFSQ(dim=4, levels=[8, 5, 5, 5], num_quantizers=8,
                                                             device=dev).eval(),
                         (64, 256, 4), _eval_call, dict(k9=1)),
}


@pytest.mark.parametrize('path', list(COMPILED_PATHS))
def test_compiled_path_runs_the_kernels(card, path):
    """Each compiled path under inductor with fullgraph=True: held to its
    eager call from the same state (indices equal, values within 1e-5 of
    their largest entry; LFQ's x.grad within 1e-3 of its largest entry, as
    between its entropy routes: a code whose batch probability lies within
    rounding of the entropy's eps takes the other side of its kink when
    inductor sums the glue in another order), and a profiler trace of one
    compiled call shows its hand-written kernels by symbol at eager's
    launch counts, and no argmax."""
    from vqtpu_torch.core.compile import compile_step

    torch._dynamo.reset()
    eager, compiled, fn, symbols, grad_rel = COMPILED_PATHS[path](card)
    if fn is not None:
        compiled = compiled(compile_step(fn))
    want, got = eager(), compiled()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype.is_floating_point:
            assert _rel(g, w) <= (grad_rel if i == 3 else 1e-5), (path, i, _rel(g, w))
        else:
            assert torch.equal(g, w), (path, i, int((g != w).sum()))
    counts, argmax = _kernel_symbols(compiled)
    assert counts == symbols and not argmax, (counts, argmax)
    torch._dynamo.reset()


# -- the random stream and the compiled steps that draw ------------------------------------

STREAM_DRAWS = {
    'bits': lambda g, dev: (g.bits(1 << 16),),
    'uniform_noise': lambda g, dev: (_sampling().uniform_noise(g, (256, 256)),),
    'gumbel_noise': lambda g, dev: (_sampling().gumbel_noise(g, (256, 256)),),
    'normal_noise': lambda g, dev: (_sampling().normal_noise(g, (256, 256)),),
    'bernoulli': lambda g, dev: (_sampling().bernoulli(g, torch.full((4096,), 0.3, device=dev)),),
    'random_permutation': lambda g, dev: (_sampling().random_permutation(g, 5000),),
    'bernoulli_and_uniform': lambda g, dev: _sampling().bernoulli_and_uniform(g, 0.3, (4096,)),
    'masked_sample_indices': lambda g, dev: (_sampling().masked_sample_indices(
        g, 3000, (torch.arange(3000, device=dev) % 5 == 1), 4096),),
    'quantize_dropout_index': lambda g, dev: tuple(_sampling().quantize_dropout_index(g, 2, 8, 2)
                                                   for _ in range(32)),
}


def _sampling():
    from vqtpu_torch.core import sampling
    return sampling


@pytest.mark.parametrize('draw', sorted(STREAM_DRAWS))
def test_stream_draws_on_the_card_equal_the_cpu(card, draw):
    """Every draw of core.sampling from the same stream state: the card's
    values equal the CPU's bit for bit (gumbel and normal noise are
    float64 rounded once), and both counters advance alike."""
    cpu, on_card = _sampling().new_stream(77), _sampling().new_stream(77, card)
    want = STREAM_DRAWS[draw](cpu, 'cpu')
    got = STREAM_DRAWS[draw](on_card, card)
    assert all(g.device.type == 'cuda' and torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert torch.equal(on_card.get_state().cpu(), cpu.get_state())


# the kernels of a compiled step by symbol: FVQ's inner forward selects from
# the same codebook for the same tokens as its outer forward, and the
# compiled graph calls the pure op once for both (eager launches K1 3 times)
DRAWING_EXAMPLES = {'autoencoder_rvq': {}, 'autoencoder_hq': dict(select=4, sorted_stats=4),
                    'autoencoder_fvq': dict(select=2, sorted_stats=2), 'autoencoder_fsp': {}}


@pytest.mark.parametrize('name', sorted(DRAWING_EXAMPLES))
def test_drawing_example_step_compiled_matches_eager(card, name, monkeypatch):
    """The RQ-VAE, HQ, FVQ and FSP example steps compiled whole under
    inductor (fullgraph), 3 steps, each from an eager twin's state on the
    same batch of 256 images (the examples' batch: the graphs are the ones
    chip_smoke.py compiles, so its inductor cache serves them; the first
    runs kmeans init inside both steps for the RQ-VAE and HQ, the compiled
    one given the eager one's means, as kmeans breaks near-ties apart on
    inputs an ulp apart): the same draws (the streams' states equal), the
    same indices (HQ's and FVQ's but at near-ties of their selection,
    scored again in float64 against the tokens and codebook the eager step
    selected from: FVQ's codebook collapses onto a few codes), the losses
    within 1e-5 of their largest entry plus the flipped tokens' share,
    the buffers within 1e-5 of their largest entry (a codebook's over the
    codes no token picked differently), Adam's moments within 1e-4 of the
    model's largest, parameters within 2 lr; a profiler trace of a
    compiled step shows its kernels by symbol (HQ: K4 once a scale; FVQ:
    K1 2 and code_sums 2; none in the RQ-VAE's distance path and FSP)."""
    import importlib

    from vqtpu_torch.examples.common import adamw, train_step

    torch._dynamo.reset()
    tkmeans = importlib.import_module('vqtpu_torch.codebook.kmeans')
    first = {}
    kmeans = tkmeans.kmeans

    def same_kmeans(*args, **kwargs):
        if 'out' not in first:
            first['out'] = kmeans(*args, **kwargs)
        return tuple(t.clone() for t in first['out'])
    monkeypatch.setattr(tkmeans, 'kmeans', same_kmeans)
    mod = importlib.import_module(f'vqtpu_torch.examples.{name}')
    models = [mod.main(train_iter=0, device='cuda') for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    opts = [adamw(m.parameters(), 3e-4) for m in models]
    eager = train_step(models[0], opts[0], mod.loss_from_outputs, 10.0)
    compiled = train_step(models[1], opts[1], mod.loss_from_outputs, 10.0, compiled=True)
    # the tokens and codebook of the selection whose indices the step
    # returns (HQ: the last scale's; FVQ: after the inner step, through the
    # bridge), as the eager step saw them
    seen = []
    if name == 'autoencoder_hq':
        models[0].hq.vq.register_forward_pre_hook(lambda module, args: seen.append(
            [args[0].detach().movedim(1, -1).reshape(-1, args[0].shape[1]),
             module._codebook.embed.detach()[0].clone()]))
    elif name == 'autoencoder_fvq':
        cb = models[0].quantizer._codebook
        cb.register_forward_pre_hook(lambda module, args: seen.append(
            [args[0].detach().reshape(-1, args[0].shape[-1]), None]))
        cb.vq_bridge.register_forward_hook(lambda module, args, out: seen[-1].__setitem__(1, out.detach()[0]))
    rng = np.random.default_rng(10)
    for s in range(3):
        xb = torch.from_numpy(rng.uniform(-1, 1, (256, 28, 28, 1)).astype(np.float32)).to(card)
        models[0].load_state_dict(models[1].state_dict())
        for p, q in zip(models[0].parameters(), models[1].parameters()):
            for key, t in opts[0].state[p].items():
                t.copy_(opts[1].state[q][key])
        params = [p.detach().clone() for p in models[0].parameters()]
        seen.clear()
        want, got = eager(xb), compiled(xb)
        flipped = (got[2] != want[2]).reshape(-1)
        if seen:
            tokens, embed = seen[-1]
            ties = td.selection_disagreements(tokens, embed, td.selection_bias(embed, 'euclidean'), want[2], got[2])
            assert ties['non_tie'] == 0, (s, ties)
        else:
            assert not flipped.any(), (s, int(flipped.sum()))
        for g, w in zip(got[:2], want[:2]):
            assert _rel(g, w) <= 1e-5 + float(flipped.float().mean()), (s, _rel(g, w))
        # a flipped token moves its two codes' rows of a codebook's buffers
        touched = torch.cat([got[2].reshape(-1)[flipped], want[2].reshape(-1)[flipped]]).long().unique()
        for (key, w), g in zip(models[0].state_dict().items(), models[1].state_dict().values()):
            if key in dict(models[0].named_parameters()):
                assert float((g - w).abs().max()) <= 2 * 3e-4, (s, key)
            elif w.is_floating_point():
                if '_codebook.' in key and w.ndim >= 2 and touched.numel():
                    keep = torch.ones(w.shape[1], dtype=torch.bool, device=w.device)
                    keep[touched] = False
                    g, w = g[:, keep], w[:, keep]
                assert _rel(g, w) <= 1e-5, (s, key)
            else:
                assert torch.equal(g, w), (s, key)
        for key in ('exp_avg', 'exp_avg_sq'):
            pairs = [(opts[1].state[q][key], opts[0].state[p][key])
                     for p, q in zip(models[0].parameters(), models[1].parameters())]
            largest = max(float(w.abs().max()) for _, w in pairs)
            assert max(float((g - w).abs().max()) for g, w in pairs) <= 1e-4 * largest, (s, key)
        assert max(float((p - q).abs().max()) for p, q in zip(models[0].parameters(), params)) > 0
    counts, _ = _kernel_symbols(lambda: compiled(xb))
    assert counts == DRAWING_EXAMPLES[name], counts
    torch._dynamo.reset()


# -- the LFQ sweeps (K5-K8) after other work ------------------------------------------------


@pytest.mark.parametrize('n,d', [(2000, 12), (8192, 18)])
def test_lfq_sweeps_bit_identical_over_poisoned_memory(card, n, d):
    """The four sweeps of `lfq_entropy_stats` (forward and backward, the
    watched test's operands: weighted, spherical, k = 2^d) 20 times in one
    process, each after other work and after the caching allocator's free
    blocks were filled with a poison (0, NaN, +-1e30, in turn), which the
    sweeps' `torch.empty` scratch and outputs then take: a sweep that read
    a word it had not written would give another result, or a NaN. Every
    run is bit-identical to the first."""
    x, w = _lfq_operands(n, d, True, True, card, seed=2)
    v = tle.code_magnitude(d, 1.0, True)
    gen = np.random.default_rng(3)
    entbar = torch.from_numpy(gen.standard_normal(n).astype(np.float32)).to(card)
    gbar = torch.from_numpy(gen.standard_normal(1 << d).astype(np.float32)).to(card)

    def run():
        xs = x.clone().requires_grad_()
        ent, avgp = tle.lfq_entropy_stats(xs, w, k=1 << d, v=v, inv_temp=1.0)
        dx, = torch.autograd.grad((ent, avgp), xs, (entbar, gbar))
        return [t.detach().clone() for t in (ent, avgp, dx)]

    first = run()
    poisons = (0.0, float('nan'), 1e30, -1e30)
    other = _operands((3000, 256, 64), 'euclidean', card, seed=5)
    for i in range(20):
        td.nearest_code(*other)
        torch.cuda.synchronize()
        # fill the free blocks the sweeps' allocations will take, small and large
        blocks = [torch.full((size,), poisons[i % 4], device=card) for size in (1 << 8, 1 << 12, 1 << 16, 1 << 22)
                  for _ in range(8)]
        del blocks
        got = run()
        torch.cuda.synchronize()
        for g, f in zip(got, first):
            assert torch.equal(g, f), (i, poisons[i % 4])
