#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vqtpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (on PATH or under /usr/local/cuda), and runs
from the root of a checkout. It builds the port's kernels from the sources
in the checkout, holds each kernel against its plain PyTorch version on the
card, drives the port's eval forward through its public entry points at
full width, times the kernel, and prints one JSON line per phase:

1. device: card name and count, `nvidia-smi` name and power limit, build time;
2. kernel_vs_plain: the selection kernel against `nearest_code_plain` on the
   same inputs and bias, at the main shape (both metrics), ragged, tiny,
   batched-head and large-codebook shapes, plus exact tie probes;
3. main_path: VectorQuantize(dim=256, codebook_size=512).eval() on
   (1024, 1024, 256) f32, exact and bf16 tiers;
4. flagship: SimpleQuantizeAutoEncoder around VectorQuantize(dim=32,
   codebook_size=256) on 256 images of 28x28, against the same weights on
   the CPU;
5. times: CUDA events after warm-up at the main shape;
6. the {"kernels": [...]} line.

Indices from two formulations may differ only at near-ties: tokens whose two
picks, scored again in float64, differ by at most 1e-5 relative
(vqtpu_torch.kernels.distance.selection_disagreements); any other
disagreement fails. TF32 is off in every phase
(torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32),
so the plain versions run in full f32. Any failed check raises and the
script exits non-zero; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# VectorQuantize(dim=256, codebook_size=512) on (1024, 1024, 256): n, c, d
MAIN = (1 << 20, 512, 256)
# published H100 SXM peaks at 700 W: f32 without tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
KERNEL_SOURCE = 'vqtpu_torch/kernels/csrc/nearest_code.cu'
REPLACES = [
    'vqtpu/kernels/distance.py:266 _pipelined_select_kernel',
    'vqtpu/kernels/distance.py:255 _grid_select_kernel',
    'vqtpu/kernels/distance.py:156 _tiled_select_kernel',
]


def emit(phase: str, **fields) -> None:
    print(json.dumps({'phase': phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f'check failed: {what}')


def sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def selection_bound_ms(n: int, c: int, d: int) -> tuple[float, str]:
    """Least time for the selection: 2ncd f32 FLOP at peak, or reading x,
    the codebook and bias once and writing the int32 indices."""
    ops_ms = 2 * n * c * d / PEAK_F32_FLOPS * 1e3
    bytes_ms = 4 * (n * d + c * d + c + n) / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), 'operations' if ops_ms >= bytes_ms else 'bytes'


def phase_device():
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    from vqtpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(['nearest_code'])
    build_s = time.perf_counter() - t0
    ptxas = [line.strip() for line in _build.build_log('nearest_code').splitlines()
             if 'registers' in line or 'spill' in line]
    emit('device', kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s, ptxas=ptxas,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return kind, count, smi


def compare_selection(case, x, e, metric, device, exact=None):
    """Kernel against plain version on the same inputs and bias."""
    from vqtpu_torch.kernels.distance import (
        nearest_code, nearest_code_plain, selection_bias, selection_disagreements,
    )
    bias = selection_bias(e, metric)
    got = nearest_code(x, e, metric, bias)
    want = nearest_code_plain(x, e, bias)
    sync(device)
    if exact is not None:
        check(torch.equal(got.cpu(), exact) and torch.equal(want.cpu(), exact),
              f'{case}: tie probe expects the first index')
    if x.ndim == 2:
        x, e, bias, got, want = x[None], e[None], bias[None], got[None], want[None]
    totals = {'tokens': 0, 'disagree': 0, 'non_tie': 0, 'max_score_gap': 0.0}
    for h in range(x.shape[0]):
        r = selection_disagreements(x[h], e[h], bias[h], got[h], want[h])
        for k in ('tokens', 'disagree', 'non_tie'):
            totals[k] += r[k]
        totals['max_score_gap'] = max(totals['max_score_gap'], r['max_score_gap'])
    check(totals['non_tie'] == 0, f'{case}: kernel and plain version disagree beyond ties {totals}')
    emit('kernel_vs_plain', case=case, shape=list(x.shape[:-1]) + [e.shape[-2], x.shape[-1]],
         metric=metric, agree_share=1 - totals['disagree'] / totals['tokens'], **totals)
    return totals


def phase_kernel_vs_plain(x_main, device, sizes):
    from vqtpu_torch.core.utils import l2norm
    n, c, d = sizes['main']
    gen = np.random.default_rng(1)
    e_main = torch.from_numpy(gen.standard_normal((c, d), dtype=np.float32)).to(device)
    results = {'main': compare_selection('main', x_main, e_main, 'euclidean', device)}
    compare_selection('main_cosine', l2norm(x_main), l2norm(e_main), 'cosine', device)

    def rand(*shape):
        return torch.from_numpy(gen.standard_normal(shape, dtype=np.float32)).to(device)

    for case, shape in sizes['others'].items():
        *heads, n_, c_, d_ = shape
        compare_selection(case, rand(*heads, n_, d_), rand(*heads, c_, d_), 'euclidean', device)

    # tie probes, exact: every code ties -> index 0; duplicated rows -> the
    # first copy, with copies in one thread's columns, one tile and other tiles
    tn, tc, td = sizes['ties']
    zeros_x = torch.zeros(tn, td, device=device)
    compare_selection('ties_all_zero', zeros_x, torch.zeros(tc, td, device=device), 'euclidean',
                      device, exact=torch.zeros(tn, dtype=torch.int32))
    compare_selection('ties_zero_x_cosine', zeros_x, l2norm(rand(tc, td)), 'cosine',
                      device, exact=torch.zeros(tn, dtype=torch.int32))
    for copies in (2, 8):
        base = rand(tc // copies, td)
        compare_selection(f'ties_{copies}_copies', base, torch.cat([base] * copies), 'euclidean',
                          device, exact=torch.arange(tc // copies, dtype=torch.int32))
    return results, e_main


def phase_main_path(x_main, device, sizes):
    from vqtpu_torch import VectorQuantize
    from vqtpu_torch.kernels.distance import (
        nearest_code, nearest_code_plain, selection_bias, selection_disagreements,
    )
    n, c, d = sizes['main']
    xin = x_main.reshape(sizes['batch'], n // sizes['batch'], d)
    torch.manual_seed(0)
    vq = VectorQuantize(dim=d, codebook_size=c, device=device).eval()
    main_launches = None
    for tier in ('exact', 'bf16'):
        model = vq
        if tier == 'bf16':
            model = VectorQuantize(dim=d, codebook_size=c, quantize_tier='bf16', device=device).eval()
            model.load_state_dict(vq.state_dict())
        nearest_code.launches = 0
        with torch.no_grad():
            q, idx, loss = model(xin)
        sync(device)
        launches = nearest_code.launches
        if tier == 'exact':
            main_launches = launches
            check(launches > 0, 'the main path launched the selection kernel')
        check(q.shape == xin.shape and idx.shape == xin.shape[:-1] and idx.dtype == torch.int32,
              f'{tier}: output shapes')
        codebook = model.codebook
        x_sel = x_main
        if tier == 'bf16':
            codebook = codebook.bfloat16().float()
            x_sel = x_main.bfloat16().float()
        check(torch.equal(q.reshape(-1, d), codebook[idx.reshape(-1).long()]),
              f'{tier}: rows bit-equal to codebook[idx]')
        with torch.no_grad():
            decoded = model.get_output_from_indices(idx)
        check(torch.equal(decoded.float(), q), f'{tier}: get_output_from_indices(idx) equals the output')
        bias = selection_bias(codebook, 'euclidean')
        r = selection_disagreements(x_sel, codebook, bias, idx, nearest_code_plain(x_sel, codebook, bias))
        check(r['non_tie'] == 0, f'{tier}: indices disagree with the plain version beyond ties {r}')
        del q, decoded
        emit('main_path', model=f'VectorQuantize(dim={d}, codebook_size={c}, quantize_tier={tier!r}).eval()',
             input=list(xin.shape), launches=launches, loss=float(loss),
             agree_share=1 - r['disagree'] / r['tokens'], **r)
    return vq, xin, main_launches


def phase_flagship(device, sizes):
    from vqtpu_torch import SimpleQuantizeAutoEncoder, VectorQuantize
    from vqtpu_torch.kernels.distance import nearest_code, selection_bias, selection_disagreements

    def build(dev):
        return SimpleQuantizeAutoEncoder(
            VectorQuantize(dim=32, codebook_size=256, device=dev), dim=32, device=dev,
        ).eval()

    torch.manual_seed(1)
    model = build(device)
    ref = build('cpu')
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    imgs = np.random.default_rng(2).random((sizes['images'], 28, 28, 1), dtype=np.float32)
    x = torch.from_numpy(imgs).to(device)
    nearest_code.launches = 0
    with torch.no_grad():
        recon, idx, loss = model(x)
    sync(device)
    launches = nearest_code.launches
    check(launches > 0, 'the flagship launched the selection kernel')
    check(recon.shape == x.shape and idx.shape == (x.shape[0], 49), 'flagship shapes')
    check(bool(torch.isfinite(recon).all()), 'flagship reconstruction is finite')

    with torch.no_grad():
        recon_ref, idx_ref, _ = ref(x.cpu())
        z = model.encoder(x).reshape(-1, 32)
    embed = model.quantizer.codebook
    r = selection_disagreements(z, embed, selection_bias(embed, 'euclidean'),
                                idx.reshape(-1), idx_ref.reshape(-1).to(device))
    check(r['non_tie'] == 0, f'flagship indices disagree with the CPU beyond ties {r}')
    same = (idx.cpu() == idx_ref).all(-1)
    err = float((recon.cpu()[same] - recon_ref[same]).abs().max()) if same.any() else 0.0
    check(int(same.sum()) >= 0.9 * x.shape[0] and err <= 1e-4,
          f'flagship reconstruction matches the CPU to 1e-4 ({err}, {int(same.sum())} images)')
    emit('flagship', model='SimpleQuantizeAutoEncoder(VectorQuantize(dim=32, codebook_size=256)).eval()',
         input=list(x.shape), launches=launches,
         images_compared=int(same.sum()), recon_max_abs_err_vs_cpu=err, **r)
    return launches


def profile_forward(vq, xin, forwards: int = 3) -> None:
    """Device time per eval forward by kernel name, and the device's idle
    share over the span of `forwards` back-to-back forwards (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            vq(xin)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        name = e.name[:120]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / forwards
    idle = None
    if kernels:
        span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
        idle = 1 - sum(e.time_range.elapsed_us() for e in kernels) / span
    emit('profile', forwards=forwards, device_events=len(kernels), device_idle_share=idle,
         device_ms_per_forward=dict(sorted(by_name.items(), key=lambda kv: -kv[1])))


def phase_times(vq, xin, x_main, e_main, sizes):
    from vqtpu_torch.kernels.distance import nearest_code, nearest_code_plain, selection_bias
    n, c, d = sizes['main']
    bias = selection_bias(e_main, 'euclidean')
    reps = sizes['reps']

    def kernel():
        nearest_code(x_main, e_main, 'euclidean', bias)

    def plain():
        nearest_code_plain(x_main, e_main, bias)

    def library():
        torch.addmm(bias, x_main, e_main.T).argmax(-1)

    # plain, kernel, kernel, plain: one card, alternating
    plain_a, kernel_a, kernel_b, plain_b = (cuda_ms(f, reps) for f in (plain, kernel, kernel, plain))
    library_ms = cuda_ms(library, reps)
    with torch.no_grad():
        forward_ms = cuda_ms(lambda: vq(xin), reps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        vq(xin)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    profile_forward(vq, xin)
    kernel_ms = (kernel_a + kernel_b) / 2
    plain_ms = (plain_a + plain_b) / 2
    bound_ms, bound_by = selection_bound_ms(n, c, d)
    emit('times', shape=[n, c, d], reps=reps, kernel_ms=kernel_ms, kernel_ms_runs=[kernel_a, kernel_b],
         plain_ms=plain_ms, plain_ms_runs=[plain_a, plain_b],
         library_ms=library_ms, library_call='torch.addmm(bias, x, e.T).argmax(-1): two calls, not on the port path',
         vq_forward_ms=forward_ms, vq_vectors_per_s=n / (forward_ms / 1e3),
         peak_allocated_bytes=peak, peak_note='one forward, with the 1 GiB input and the other live tensors of this script',
         bound_ms=bound_ms, bound_by=bound_by, kernel_share_of_bound=bound_ms / kernel_ms,
         bound_basis='published H100 SXM peaks at 700 W: 67 TFLOP/s f32, 3.35 TB/s')
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script needs one', file=sys.stderr)
        return 1
    import vqtpu_torch  # noqa: F401  -- fails before any output outside a checkout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda')
    sizes = {
        'main': MAIN,
        'batch': 1024,
        'others': {
            'ragged': (300, 130, 96),
            'tiny': (64, 8, 32),
            'heads': (3, 1000, 257, 40),
            'large_codebook': (16384, 65536, 32),
        },
        'ties': (1000, 512, 256),
        'images': 256,
        'reps': 20,
    }

    kind, count, smi = phase_device()
    n, c, d = sizes['main']
    x_main = torch.from_numpy(
        np.random.default_rng(0).standard_normal((n, d), dtype=np.float32)).to(device)
    selection, e_main = phase_kernel_vs_plain(x_main, device, sizes)
    vq, xin, main_launches = phase_main_path(x_main, device, sizes)
    flagship_launches = phase_flagship(device, sizes)
    times = phase_times(vq, xin, x_main, e_main, sizes)

    print(json.dumps({'kernels': [{
        'name': 'nearest_code',
        'route': 'cuda',
        'source': KERNEL_SOURCE,
        'replaces': 'vqtpu/kernels/distance.py:266',
        'replaces_all': REPLACES,
        'launches': main_launches,
        'launches_flagship': flagship_launches,
        'max_abs_err': selection['main']['max_score_gap'],
        'max_abs_err_of': 'float64 score gap between the kernel and plain picks at the main shape',
        **times,
        'check': 'indices equal the plain version except near-ties (float64 gap <= 1e-5 relative), '
                 'exact on tie probes, rows bit-equal to codebook rows',
        'power_limit': smi,
    }]}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind, 'count': count}}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
