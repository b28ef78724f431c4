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
