#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vqtpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (on PATH or under /usr/local/cuda), and runs
from the root of a checkout. It builds the port's kernels from the sources
in the checkout, holds each kernel against its plain PyTorch version on the
card, drives the port's eval forward and its training step through their
public entry points at full width, times the kernels and the step, and
prints one JSON line per phase:

1. device: card name and count, `nvidia-smi` name and power limit, build
   time of the four kernel sources (built in parallel), the compiler's
   registers and spills per source, and on their own for the tensor-core
   selection kernel (in nearest_code.cu and in train_fused.cu), the f32 tile
   it replaced, every instantiation of the four LFQ sweeps, one per
   d <= 24, and of K9, one per d <= 8 and q <= 16 and the general one (no
   spill in any but the general one);
2. kernel_vs_plain: the selection kernel (split-TF32 wgmma) against
   `nearest_code_plain` on the same inputs and bias, at the main shape (both
   metrics), ragged, tiny, batched-head, ragged-d (d = 30, d = 3) and
   large-codebook shapes, plus exact tie probes; two calls bit-identical,
   and `quantize_lookup`'s rows (the kernel's row copy) bit-equal to
   codebook rows;
3. main_path: VectorQuantize(dim=256, codebook_size=512).eval() on
   (1024, 1024, 256) f32, exact (one kernel launch a forward) and bf16 tiers;
4. flagship: SimpleQuantizeAutoEncoder around VectorQuantize(dim=32,
   codebook_size=256) on 256 images of 28x28, against the same weights on
   the CPU;
5. times: CUDA events after warm-up at the main shape and K3's: the kernel,
   the replaced f32 tile (same inputs), the plain version, addmm + argmax,
   the f32 and the 3xTF32 bounds, and the eval forward, whose profile must
   show no separate index_select;
6. train_fused_vs_plain: the fused train kernel against `nearest_code`
   (the same indices, bit for bit) and `fused_train_quantize_plain` at the
   main shape (euclidean, cosine, with a 0/1 weight), the ragged, tiny and
   3-head shapes of phase 2, (16384, 65536, 32) and tie probes; two kernel
   calls must be bit-identical;
7. train_path: VectorQuantize(dim=256, codebook_size=512).train() at full
   width, 3 forward + backward steps with train_fused='on' and a twin with
   'off' from the same state; step 0 identical on both routes; each route's
   loss and EMA step held every step to float64 from its own indices and
   state, and the routes to each other by a bound derived from the tokens
   that flip between them (each step's flips reported);
8. flagship_train: the flagship with train_fused='on', 50 AdamW steps, step
   0 held against the same weights on the CPU;
9. train_times: CUDA events on a codebook of random rows and one of data
   rows: the fused kernel against the step it replaced (same run) and the
   'off' route's composition, each of their passes on its own, the largest
   cluster's share; one training step on each route, peak memory and a
   torch.profiler breakdown of a step;
10. lfq_kernels_vs_plain: the four LFQ entropy sweeps (csrc/lfq_entropy.cu)
   against their plain versions on the same inputs, errors against float64,
   two calls bit-identical, at the main LFQ shape (inv_temp 100 and 1),
   non-spherical at scale 0.25, 0/1 weights, ragged N, K = 2^8 and three
   heads at K = 2^12;
11. lfq_train_path: LFQ(dim=18, codebook_size=2**18, spherical=True).train()
   on (8, 1024, 18), one step per entropy_fused route ('on' and 'auto' run
   the sweeps, 'off' does not), held against each other; then 3 SGD steps
   of ResidualLFQ(dim=64, codebook_size=2**10, num_quantizers=4) on 8192
   tokens, 'on' against 'off';
12. lfq_flagship_train: the LFQ autoencoder (examples/autoencoder_lfq.py,
   entropy_fused='on'), 50 AdamW steps, step 0 held against the CPU;
13. lfq_times: CUDA events at the main LFQ shape: each sweep (all four
   without a log or an accurate exp, on the card's ex2), its plain version,
   its bound (one MUFU op a pair) and its share of it, the fused statistics
   against the 'off' route's streamed ones, one training step per route
   with peak memory and a torch.profiler breakdown;
14. rfsq_kernel_vs_plain: the fused ResidualFSQ eval kernel
   (csrc/residual_fsq_fused.cu) against `fused_residual_fsq_eval_plain` on
   the same inputs: the main shape (4,194,304 tokens, levels (8, 5, 5, 5),
   q = 8), the level sets of tests/test_residual_fsq_fused.py, a ragged
   count, a leading shape, the general instantiation (d = 9; q = 17), a
   non-dyadic step (7, 7, 7), a deep stack (5, 5, 5, 5) at q = 16, a
   configuration beyond the integer index proof (256, 256, 64), infinite,
   huge, tiny and NaN inputs, the same with scales that are not the
   module's (every token on the IEEE route), and every f32 value of [1, 2)
   and [-2, -1) as one-dim tokens at levels 5, 7 and 8, q = 16; values and
   indices bit-identical (NaN for NaN), two calls bit-identical;
15. rfsq_eval_path: ResidualFSQ(dim=4, levels=[8, 5, 5, 5],
   num_quantizers=8).eval() on (2048, 2048, 4), eval_fused 'auto' (one
   launch) against 'off' (none), the decode from indices; the two-group
   GroupedResidualFSQ (two launches); an ineligible 'on' configuration and
   a training forward (none); FSQ with 8 dims on (2048, 2048, 8), its
   codes decoded from its indices bit for bit;
16. fsq_train_path: a full-width ResidualFSQ(dim=64) training step with an
   injected quantize-dropout index against the same weights on the CPU, and
   the FSQ autoencoder (examples/autoencoder_fsq.py), 50 AdamW steps, step
   0 held against the CPU;
17. rfsq_times: CUDA events at the main ResidualFSQ shape: the kernel, its
   plain version and bound, the eval forward on 'auto' and 'off' with a
   torch.profiler breakdown of each, the 'auto' forward's time beyond the
   kernel's, and the opcode counts of the main instantiation's SASS (no
   IEEE division's range check and no call may appear);
18. rvq_eval_path: ResidualVQ(dim=256, num_quantizers=8,
   codebook_size=1024).eval() on (32, 2048, 256): one K1 launch a layer,
   each layer's indices on that layer's input against the kernel's plain
   version on the CPU (near-ties only) and the CPU's -cdist route (K1's
   pick no worse in float64 but for near-ties), the whole model against the
   same weights on the CPU's -cdist route, the output the sum of the
   looked-up rows and the decode bit for bit; GroupedResidualVQ(dim=256, groups=2, num_quantizers=4) on the same
   input, one launch a layer and group;
19. rvq_beam_path: the same weights with beam_size=4 on 8192 tokens, no
   kernel launch, indices against the beam search in float64 (a path may
   differ only with a near-tie on its search); beam_size=1 is the greedy
   forward;
20. rvq_train_path: the same configuration with quantize_dropout=True, 3
   training steps at dropout index 5 per train_fused route: K4 once a layer
   a step on 'on' (dropped layers included), K1 on 'off'; step 0 identical
   on both routes; every kept layer held to the plain selection and to one
   float64 EMA step, the dropped layers' codebooks unchanged;
21. rvq_flagship_train: the RQ-VAE of examples/autoencoder_rvq.py (8
   layers, kmeans init, one shared codebook, stochastic codes), 50 AdamW
   steps, step 0 against the CPU with the same noise and kmeans rows; no
   kernel in training, K1 once a layer in the trained model's eval forward;
22. rvq_times: CUDA events: the eval forward and K1 on one layer against
   its 3xTF32 bound, the beam forward, a training step per route and a
   flagship step;
23. code_sums: K4's statistics by sorted code alone (`code_sums`), the
   backward of the learnable lookup (`lookup_with_code_grad`), at the
   learnable step's shape and the DiVeQ stack's, against float64 (within
   the f32 summation bound) and two calls bit-identical; the lookup's
   codebook gradient likewise; times against index_add_ and the bound;
24. learnable_path: the README's VectorQuantize(dim=256, codebook_size=512,
   learnable_codebook=True, ema_update=False, in_place_codebook_optimizer=
   Adam(lr=1e-3)) on (1024, 1024, 256): K1 three times and code_sums twice a
   step, a twin step bit-identical, the in-place Adam step within its f32
   bound of float64 from K1's selection, the final indices against the
   plain selection (near-ties only), the commitment loss and the codebook's
   gradient against float64; times with K1's and code_sums' shares;
25. ortho_path: orthogonal_reg_weight=10, orthogonal_reg_max_codes=128 on
   an EMA codebook (with and without active_codes_only): K1 once, no K4,
   K1's indices against the plain selection (near-ties only), the EMA state
   against a float64 EMA step, the loss against float64 on the same drawn
   codes;
26. affine_path: affine_param=True, one step per train_fused route: K4 on
   'on', K1 on 'off', the same indices, each route's batch sums within the
   f32 bound of float64 sums of the mapped tokens;
27. fvq_flagship: the FVQ autoencoder (examples/autoencoder_fvq.py: a
   MiniEncoder bridge, in-place SGD), step 0 against the CPU, 50 AdamW
   steps, its code utilization reported;
28. qinco_path: ResidualVQ(dim=256, num_quantizers=8, codebook_size=1024,
   implicit_neural_codebook=True): an eval forward on 1024 tokens and its
   decode; a training step on 256 tokens, step 0 against a CPU copy that
   takes the card's picks (output, losses, x.grad, every MLP and codebook
   gradient); every layer's pick within 1e-5 of the float64 best on 256
   eval tokens and the 256 training tokens;
29. diveq_rvq_path: ResidualVQ(..., diveq=True) on (32, 2048, 256), one step:
   K1 and code_sums once a layer, each layer against the plain selection;
30. the {"kernels": [...]} line.

Indices from two formulations may differ only at near-ties: tokens whose two
picks, scored again in float64, differ by at most 1e-5 relative
(vqtpu_torch.kernels.distance.selection_disagreements); any other
disagreement fails. Statistics are held to the worst-case f32 summation
bound against a float64 sum. TF32 is off in every phase
(torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32),
so the plain versions run in full f32, except where a check turns it on to
show a result does not depend on it. cuDNN is set deterministic (no
benchmark search), so the flagships' convolutions pick the same algorithm in
every run. Any failed check raises and the script exits non-zero; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

# VectorQuantize(dim=256, codebook_size=512) on (1024, 1024, 256): n, c, d
MAIN = (1 << 20, 512, 256)
# published H100 SXM peaks at 700 W: f32 without tensor cores, dense TF32
# on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
KERNEL_SOURCE = 'vqtpu_torch/kernels/csrc/nearest_code.cu'
KERNEL_DESIGN = '3xTF32 wgmma + TMA'
REPLACES = [
    'vqtpu/kernels/distance.py:266 _pipelined_select_kernel',
    'vqtpu/kernels/distance.py:255 _grid_select_kernel',
    'vqtpu/kernels/distance.py:156 _tiled_select_kernel',
]
TRAIN_SOURCE = 'vqtpu_torch/kernels/csrc/train_fused.cu'
TRAIN_REPLACES = 'vqtpu/kernels/train_fused.py:61'
TRAIN_DESIGN = "nearest_code's 3xTF32 wgmma tile with its rows, then statistics by sorted code"
# f32 unit roundoff, and the most partial sums the fused kernel's merge adds
# per entry (kMaxSplits in train_fused.cu)
U32 = 2.0 ** -24
MERGE_PARTIALS = 128
LFQ_SOURCE = 'vqtpu_torch/kernels/csrc/lfq_entropy.cu'
LFQ_REPLACES = {
    'a': 'vqtpu/kernels/lfq_entropy.py:76 _kernel_a',
    'b': 'vqtpu/kernels/lfq_entropy.py:95 _kernel_b',
    'c': 'vqtpu/kernels/lfq_entropy.py:116 _kernel_c',
    'd': 'vqtpu/kernels/lfq_entropy.py:139 _kernel_d',
}
# the JAX package's LFQ 2^18 shape (benchmarks/lfq_entropy_tpu.py:25-31):
# N tokens of d = 18 dims, K = 2^18 implicit codes, spherical, inv_temp 100
LFQ_MAIN = (8192, 18)
LFQ_INV_TEMP = 100.0
# H100 SXM: 16 exp/log (MUFU) results per clock per SM, 132 SMs, 1.98 GHz boost
PEAK_MUFU_PER_S = 16 * 132 * 1.98e9
# the four sweeps' designs (K5-K8)
LFQ_DESIGNS = {
    'a': 'ex2, its shift the largest logit in closed form (no running max), tokens a lane',
    'b': 'log-free ex2, tokens a lane, one butterfly a run for avgp',
    'c': 'log-free ex2, g factored out of the pair loop, tokens a lane',
    'd': 'log-free ex2, one token a thread',
}


RFSQ_SOURCE = 'vqtpu_torch/kernels/csrc/residual_fsq_fused.cu'
RFSQ_REPLACES = 'vqtpu/kernels/residual_fsq_fused.py:70 _kernel'
RFSQ_DESIGN = ('no IEEE division on the proven route (Markstein correction from the reciprocals), bracket from '
               'one FFMA.SAT, integer index where proven, constants in the parameter bank, two tokens a thread')
# ResidualFSQ(dim=4, levels=[8, 5, 5, 5], num_quantizers=8).eval() on
# (2048, 2048, 4) f32 (benchmarks/composites_tpu.py:136-140,
# benchmarks/rfsq_fused_tpu.py:17-18): levels, q, leading shape
RFSQ_MAIN = ((8, 5, 5, 5), 8, (2048, 2048))


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


def selection_bound_tc_ms(n: int, c: int, d: int) -> tuple[float, str]:
    """Least time for the selection on the tensor cores at f32 accuracy:
    three TF32 products (xs.eb, xb.es, xb.eb) of 2ncd FLOP each at the dense
    TF32 peak, or the bytes of `selection_bound_ms`."""
    ops_ms = 3 * 2 * n * c * d / PEAK_TF32_FLOPS * 1e3
    bytes_ms = 4 * (n * d + c * d + c + n) / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), 'operations' if ops_ms >= bytes_ms else 'bytes'


def ptxas_summary(log: str) -> dict:
    """Kernels, the range of registers a thread, and each distinct
    stack-frame and spill line with its count, from `-Xptxas -v`."""
    registers = [int(line.split('Used ')[1].split()[0]) for line in log.splitlines() if 'registers' in line]
    frames: dict[str, int] = {}
    for line in log.splitlines():
        if 'spill' in line:
            frames[line.strip()] = frames.get(line.strip(), 0) + 1
    return dict(kernels=len(registers), registers=[min(registers), max(registers)] if registers else None,
                stack_and_spills=frames)


def ptxas_entries(log: str, marker: str) -> dict:
    """Registers, stack frame and spills of each entry function whose
    (mangled) name contains `marker`, from `-Xptxas -v`, and any line of the
    compiler's about wgmma (serialization warnings)."""
    entries: dict[str, dict] = {}
    current = None
    wgmma = []
    for line in log.splitlines():
        if 'wgmma' in line:
            wgmma.append(line.strip())
        if 'Compiling entry function' in line:
            name = line.split("'")[1]
            current = name if marker in name else None
            if current:
                entries[current] = {}
        elif current and 'spill' in line:
            stores, loads = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line).groups()
            entries[current]['spills'] = line.strip()
            entries[current]['spill_bytes'] = int(stores) + int(loads)
        elif current and 'Used' in line and 'registers' in line:
            entries[current]['registers'] = int(line.split('Used ')[1].split()[0])
    return dict(entries=entries, wgmma_lines=wgmma)


def sass_functions(name: str) -> dict[str, list[str]]:
    """The SASS instructions of each function in the built library of
    csrc/<name>.cu, from `cuobjdump -sass` (beside nvcc)."""
    from pathlib import Path

    from vqtpu_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name('cuobjdump')
    out = subprocess.run([str(tool), '-sass', str(_build.library_path(name))], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    functions: dict[str, list[str]] = {}
    current = None
    for line in out.splitlines():
        header = re.match(r'\s*Function : (\S+)', line)
        if header:
            current = functions.setdefault(header.group(1), [])
            continue
        instr = re.match(r'\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;', line)
        if instr and current is not None:
            current.append(instr.group(1))
    return functions


def sass_opcodes(instructions: list[str]) -> dict[str, int]:
    """Count of each opcode (its modifiers kept, its predicate dropped)."""
    counts: dict[str, int] = {}
    for ins in instructions:
        op = re.sub(r'^@!?U?P[T0-9]+\s+', '', ins).split()[0]
        counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


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
    sources = ['nearest_code', 'train_fused', 'lfq_entropy', 'residual_fsq_fused']
    _build.build(sources)
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_summary(_build.build_log(name)) for name in sources}
    # the redesigned kernels on their own: K1's tensor-core tile beside the
    # replaced f32 tile, and every instantiation of the LFQ sweeps (K5-K8)
    ptxas['nearest_code_tf32'] = ptxas_entries(_build.build_log('nearest_code'), 'select_tf32_kernel')
    ptxas['nearest_code_simt'] = ptxas_entries(_build.build_log('nearest_code'), 'select_codes_kernel')
    # K4: the same tensor-core tile, built into train_fused.cu, and its
    # statistics' kernels
    ptxas['train_fused_tf32'] = ptxas_entries(_build.build_log('train_fused'), 'select_tf32_kernel')
    ptxas['train_fused_stats'] = ptxas_entries(_build.build_log('train_fused'), 'train_fused_cu')
    for sweep in 'abcd':
        entries = ptxas_entries(_build.build_log('lfq_entropy'), f'sweep_{sweep}_kernel')
        ptxas[f'lfq_sweep_{sweep}'] = entries
        check(len(entries['entries']) == 24,
              f"sweep {sweep.upper()} is built for every d <= 24 ({len(entries['entries'])})")
    # K9: every d <= 8 x q <= 16 instantiation and the general one
    ptxas['residual_fsq_kernel'] = ptxas_entries(_build.build_log('residual_fsq_fused'), 'residual_fsq_eval_kernel')
    check(len(ptxas['residual_fsq_kernel']['entries']) == 8 * 16 + 1,
          f"K9 is built for every d <= 8, q <= 16 and the general case ({len(ptxas['residual_fsq_kernel']['entries'])})")
    emit('device', kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s, ptxas=ptxas,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return kind, count, smi, ptxas


def check_no_spill(ptxas: dict) -> None:
    """The four LFQ sweeps, the fused train step's statistics kernels and
    K9's fixed instantiations (d <= 8, q <= 16) must not spill (checked at
    the end of the run, so that a spill does not hide the other phases'
    numbers)."""
    for key in ('lfq_sweep_a', 'lfq_sweep_b', 'lfq_sweep_c', 'lfq_sweep_d', 'train_fused_stats',
                'residual_fsq_kernel'):
        spilled = {k: v for k, v in ptxas[key]['entries'].items()
                   if v.get('spill_bytes', 1) != 0 and 'ILi0ELi0E' not in k}
        check(not spilled, f'{key} spills no register {spilled}')


def compare_selection(case, x, e, metric, device, exact=None):
    """Kernel against plain version on the same inputs and bias; two calls
    bit-identical; `quantize_lookup` (the same kernel with its row copy)
    gives the same indices and rows bit-equal to codebook rows."""
    from vqtpu_torch.kernels.distance import (
        nearest_code, nearest_code_plain, quantize_lookup, selection_bias, selection_disagreements,
    )
    bias = selection_bias(e, metric)
    got = nearest_code(x, e, metric, bias)
    again = nearest_code(x, e, metric, bias)
    idx_rows, rows = quantize_lookup(x, e, metric)
    want = nearest_code_plain(x, e, bias)
    sync(device)
    check(torch.equal(got, again), f'{case}: two kernel calls bit-identical')
    check(torch.equal(idx_rows, got), f'{case}: quantize_lookup picks the indices of nearest_code')
    if exact is not None:
        check(torch.equal(got.cpu(), exact) and torch.equal(want.cpu(), exact),
              f'{case}: tie probe expects the first index')
    if x.ndim == 2:
        x, e, bias, got, want, rows = x[None], e[None], bias[None], got[None], want[None], rows[None]
    totals = {'tokens': 0, 'disagree': 0, 'non_tie': 0, 'max_score_gap': 0.0}
    for h in range(x.shape[0]):
        check(torch.equal(rows[h], e[h][got[h].long()]), f'{case}: quantize_lookup rows bit-equal to codebook rows')
        r = selection_disagreements(x[h], e[h], bias[h], got[h], want[h])
        for k in ('tokens', 'disagree', 'non_tie'):
            totals[k] += r[k]
        totals['max_score_gap'] = max(totals['max_score_gap'], r['max_score_gap'])
    check(totals['non_tie'] == 0, f'{case}: kernel and plain version disagree beyond ties {totals}')
    del again, idx_rows, rows
    emit('kernel_vs_plain', case=case, shape=list(x.shape[:-1]) + [e.shape[-2], x.shape[-1]],
         metric=metric, agree_share=1 - totals['disagree'] / totals['tokens'], bit_identical_calls=True,
         rows_bit_equal=True, **totals)
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
            check(launches == 1, f'the exact forward launched the selection kernel once ({launches})')
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


def profile_device(fn, calls: int) -> dict:
    """Device time per call by kernel name, and the device's idle share over
    the span of `calls` back-to-back calls of `fn` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        name = e.name[:120]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    idle = None
    if kernels:
        span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
        idle = 1 - sum(e.time_range.elapsed_us() for e in kernels) / span
    return dict(device_events=len(kernels), device_idle_share=idle,
                device_ms_per_call=dict(sorted(by_name.items(), key=lambda kv: -kv[1])))


def profile_forward(vq, xin, forwards: int = 3) -> dict:
    """Device time per eval forward by kernel name, and the device's idle
    share over `forwards` back-to-back forwards. The row lookup is the
    selection kernel's epilogue: no index_select kernel may appear."""
    with torch.no_grad():
        r = profile_device(lambda: vq(xin), forwards)
    lookups = [name for name in r['device_ms_per_call'] if 'index_select' in name or 'indexSelect' in name]
    check(not lookups, f'the eval forward runs no separate row lookup {lookups}')
    emit('profile', forwards=forwards, device_events=r['device_events'],
         device_idle_share=r['device_idle_share'], device_ms_per_forward=r['device_ms_per_call'],
         index_select_kernels=lookups)
    return r


def phase_times(vq, xin, x_main, e_main, sizes):
    from vqtpu_torch.kernels.distance import (
        nearest_code, nearest_code_plain, _nearest_code_simt, quantize_lookup, selection_bias,
    )
    n, c, d = sizes['main']
    bias = selection_bias(e_main, 'euclidean')
    reps = sizes['reps']

    def kernel():
        nearest_code(x_main, e_main, 'euclidean', bias)

    def previous():
        _nearest_code_simt(x_main, e_main, bias)

    def plain():
        nearest_code_plain(x_main, e_main, bias)

    def library():
        torch.addmm(bias, x_main, e_main.T).argmax(-1)

    def with_rows():
        quantize_lookup(x_main, e_main)

    # plain, kernel, the replaced f32 tile twice, kernel, plain: one card, alternating
    plain_a, kernel_a, prev_a, prev_b, kernel_b, plain_b = (
        cuda_ms(f, reps) for f in (plain, kernel, previous, previous, kernel, plain))
    library_ms = cuda_ms(library, reps)
    rows_ms = cuda_ms(with_rows, reps)

    # K3's own shape: the kernel's c-loop over a 65536-code codebook
    ln, lc, ld = sizes['others']['large_codebook']
    gen = np.random.default_rng(14)
    x_large = torch.from_numpy(gen.standard_normal((ln, ld), dtype=np.float32)).to(x_main.device)
    e_large = torch.from_numpy(gen.standard_normal((lc, ld), dtype=np.float32)).to(x_main.device)
    b_large = selection_bias(e_large, 'euclidean')
    large = [lambda: nearest_code(x_large, e_large, 'euclidean', b_large),
             lambda: nearest_code_plain(x_large, e_large, b_large),
             lambda: torch.addmm(b_large, x_large, e_large.T).argmax(-1),
             lambda: _nearest_code_simt(x_large, e_large, b_large)]
    lk_a, lp_a, ls_a, ls_b, lp_b, lk_b = (cuda_ms(large[i], reps) for i in (0, 1, 3, 3, 1, 0))
    large_bound, large_by = selection_bound_ms(ln, lc, ld)
    large_tc, _ = selection_bound_tc_ms(ln, lc, ld)
    large_codebook = dict(shape=[ln, lc, ld], ms=(lk_a + lk_b) / 2, ms_runs=[lk_a, lk_b],
                          previous_ms=(ls_a + ls_b) / 2, previous_ms_runs=[ls_a, ls_b],
                          plain_ms=(lp_a + lp_b) / 2, plain_ms_runs=[lp_a, lp_b],
                          library_ms=cuda_ms(large[2], reps), bound_ms=large_bound, bound_by=large_by,
                          bound_tc_ms=large_tc, share_of_bound=large_tc / ((lk_a + lk_b) / 2))
    del x_large, e_large
    with torch.no_grad():
        forward_ms = cuda_ms(lambda: vq(xin), reps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        vq(xin)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    profile = profile_forward(vq, xin)
    kernel_ms = (kernel_a + kernel_b) / 2
    previous_ms = (prev_a + prev_b) / 2
    plain_ms = (plain_a + plain_b) / 2
    bound_ms, bound_by = selection_bound_ms(n, c, d)
    bound_tc_ms, _ = selection_bound_tc_ms(n, c, d)
    check(kernel_ms < previous_ms, f'the tensor-core kernel beats the f32 tile it replaced ({kernel_ms}, {previous_ms})')
    emit('times', shape=[n, c, d], reps=reps, kernel_ms=kernel_ms, kernel_ms_runs=[kernel_a, kernel_b],
         design=KERNEL_DESIGN, previous_ms=previous_ms, previous_ms_runs=[prev_a, prev_b],
         previous='the replaced register-blocked f32 FMA tile (vqtpu_nearest_code_f32_simt), same inputs',
         with_rows_ms=rows_ms, with_rows='quantize_lookup: the same kernel with its row-copy epilogue',
         plain_ms=plain_ms, plain_ms_runs=[plain_a, plain_b],
         library_ms=library_ms, library_call='torch.addmm(bias, x, e.T).argmax(-1): two calls, not on the port path',
         vq_forward_ms=forward_ms, vq_vectors_per_s=n / (forward_ms / 1e3),
         vq_forward_device_idle_share=profile['device_idle_share'],
         peak_allocated_bytes=peak, peak_note='one forward, with the 1 GiB input and the other live tensors of this script',
         bound_ms=bound_ms, bound_by=bound_by, kernel_share_of_bound=bound_ms / kernel_ms,
         bound_tc_ms=bound_tc_ms, share_of_bound=bound_tc_ms / kernel_ms,
         bound_basis='published H100 SXM peaks at 700 W: 67 TFLOP/s f32 (bound_ms), 495 TFLOP/s dense TF32 '
                     'times three products (bound_tc_ms), 3.35 TB/s',
         large_codebook=large_codebook)
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, previous_ms=previous_ms, bound_tc_ms=bound_tc_ms,
                share_of_bound=bound_tc_ms / kernel_ms, with_rows_ms=rows_ms, vq_forward_ms=forward_ms,
                large_codebook=large_codebook)


def train_bound_ms(n: int, c: int, d: int, weighted: bool) -> dict:
    """Least time for the fused train step at f32 accuracy: the selection's
    three TF32 products (2ncd FLOP each) at the dense TF32 peak, or reading
    x, the codebook, bias (and the weights) once and writing idx, q, bins and
    esum once; beside it the same with the 2ncd f32 FLOP on the FMA pipes."""
    nbytes = 4 * (2 * n * d + n + 2 * c * d + 2 * c + (n if weighted else 0))
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    tc_ms = 3 * 2 * n * c * d / PEAK_TF32_FLOPS * 1e3
    fma_ms = 2 * n * c * d / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(tc_ms, bytes_ms), bound_by='operations' if tc_ms >= bytes_ms else 'bytes',
                bound_f32_fma_ms=max(fma_ms, bytes_ms))


def stats_reference(x, idx, c, w):
    """float64 sums from given indices: esum, sum |w x| per entry, and the
    number of tokens of nonzero weight per code. x (h, n, d), idx (h, n)."""
    h, n, d = x.shape
    flat = (idx.long() + torch.arange(h, device=x.device)[:, None] * c).reshape(-1)
    wx = x.reshape(-1, d).double()
    if w is not None:
        wx = wx * w.reshape(-1, 1).double()
    nonzero = torch.ones(h * n, dtype=torch.float64, device=x.device)
    if w is not None:
        nonzero = (w.reshape(-1) != 0).double()
    esum = torch.zeros(h * c, d, dtype=torch.float64, device=x.device).index_put_((flat,), wx, accumulate=True)
    asum = torch.zeros(h * c, d, dtype=torch.float64, device=x.device).index_put_(
        (flat,), wx.abs(), accumulate=True)
    count = torch.zeros(h * c, dtype=torch.float64, device=x.device).index_put_((flat,), nonzero, accumulate=True)
    return esum.reshape(h, c, d), asum.reshape(h, c, d), count.reshape(h, c)


def esum_within_bound(esum, ref):
    """(max |esum - float64 sum|, its largest share of the worst-case f32
    summation bound (tokens of the code + merge partials) * 2^-24 * sum |w x|)."""
    ref_esum, ref_abs, count = ref
    err = (esum.double() - ref_esum).abs()
    bound = (count[..., None] + MERGE_PARTIALS) * U32 * ref_abs
    share = float((err / bound.clamp_min(1e-300)).max())
    return float(err.max()), share


def ema_step_reference(x, idx, prev_cs, prev_ea, decay):
    """One EMA step of the codebook in float64, from a route's own indices
    and its own previous f32 state, with the rounding the f32 step may carry:
    cluster_size and embed_avg move by (1 - decay) towards the batch's counts
    (exact in f32) and sums (within the f32 summation bound), and the lerp
    rounds three times. x (n, d), idx (n,), prev_cs (c,), prev_ea (c, d) ->
    (cluster_size, embed_avg, their bounds)."""
    c = prev_cs.shape[-1]
    esum, asum, count = (t[0] for t in stats_reference(x[None], idx.reshape(1, -1), c, None))
    w = 1.0 - decay
    pcs, pea = prev_cs.double(), prev_ea.double()
    cs = pcs + (count - pcs) * w
    ea = pea + (esum - pea) * w
    cs_bound = 4 * U32 * (w * (count + pcs.abs()) + cs.abs())
    sum_bound = (count[:, None] + MERGE_PARTIALS) * U32 * asum
    ea_bound = w * sum_bound * (1 + 4 * U32) + 4 * U32 * (w * (esum.abs() + pea.abs()) + ea.abs())
    return cs, ea, cs_bound, ea_bound


def smoothed_sizes(cs, eps):
    """float64 laplace-smoothed cluster sizes of f32 `cs` (c,), as
    `Codebook.update_ema` divides embed_avg by them, and total / (total + c eps)."""
    cs = cs.double()
    total = cs.sum()
    ratio = total / (total + cs.shape[-1] * eps)
    return (cs + eps) * ratio, ratio


def flips_explained(x, route_a, route_b, rel=1e-5):
    """Tokens that two routes send to different codes, each route with its
    own (codebook, bias, indices): on route a's codebook, a's pick may beat
    b's pick by no more than the two codes' scores moved between the
    codebooks, plus the near-tie margin of `selection_disagreements` (on one
    codebook: near-ties only). Returns (flips, flips not so explained,
    largest unexplained gap)."""
    (embed_a, bias_a, idx_a), (embed_b, bias_b, idx_b) = route_a, route_b
    idx_a, idx_b = idx_a.reshape(-1).long(), idx_b.reshape(-1).long()
    differ = (idx_a != idx_b).nonzero().reshape(-1)
    if differ.numel() == 0:
        return 0, 0, 0.0
    xd = x.reshape(-1, x.shape[-1])[differ].double()
    pa, pb = idx_a[differ], idx_b[differ]

    def scores(embed, bias, j):
        e = embed[j].double()
        return (xd * e).sum(-1) + bias[j].double(), xd.norm(dim=-1) * e.norm(dim=-1)

    (sa_a, na_a), (sa_b, na_b) = scores(embed_a, bias_a, pa), scores(embed_a, bias_a, pb)
    (sb_a, nb_a), (sb_b, nb_b) = scores(embed_b, bias_b, pa), scores(embed_b, bias_b, pb)
    moved = ((sa_a - sb_a) - (sa_b - sb_b)).abs()
    scale = torch.stack([sa_a.abs(), sa_b.abs(), sb_a.abs(), sb_b.abs(), na_a, na_b, nb_a, nb_b]).amax(0)
    excess = (sa_a - sa_b) - moved - rel * scale
    return int(differ.numel()), int((excess > 0).sum()), float(excess.max().clamp_min(0))


def compare_train(case, x, e, metric, w, device, exact=None):
    """The fused train kernel against nearest_code (indices bit for bit) and
    its plain version (near-ties) on the same inputs."""
    from vqtpu_torch.kernels.distance import nearest_code, selection_bias, selection_disagreements
    from vqtpu_torch.kernels.train_fused import fused_train_quantize, fused_train_quantize_plain
    bias = selection_bias(e, metric)
    out = fused_train_quantize(x, e, metric, w, bias=bias)
    again = fused_train_quantize(x, e, metric, w, bias=bias)
    plain = fused_train_quantize_plain(x, e, bias, w)
    nc = nearest_code(x, e, metric, bias)
    sync(device)
    check(all(torch.equal(a, b) for a, b in zip(out, again)), f'{case}: two kernel calls bit-identical')
    # K4 runs nearest_code's own split-TF32 tile on the same operands: the
    # same indices, bit for bit (not the near-tie rule)
    check(torch.equal(out[0], nc), f'{case}: indices equal nearest_code on the same operands')
    del again, nc
    if x.ndim == 2:
        x, e, bias = x[None], e[None], bias[None]
        w = None if w is None else w[None]
        out = tuple(t[None] for t in out)
        plain = tuple(t[None] for t in plain)
    idx, q, bins, esum = out
    pidx, _, pbins, pesum = plain
    if exact is not None:
        check(torch.equal(idx.cpu(), exact[0]) and torch.equal(pidx.cpu(), exact[0]),
              f'{case}: tie probe indices')
        check(torch.equal(bins.cpu(), exact[1]) and torch.equal(pbins.cpu(), exact[1]),
              f'{case}: tie probe bins equal the counts')
    totals = {'tokens': 0, 'disagree': 0, 'non_tie': 0, 'max_score_gap': 0.0}
    for h in range(x.shape[0]):
        check(torch.equal(q[h], e[h][idx[h].long()]), f'{case}: q rows bit-equal to codebook rows')
        # the plain version's f32 matmul is another formulation: the same
        # indices but for near-ties
        r = selection_disagreements(x[h], e[h], bias[h], idx[h], pidx[h])
        for k in ('tokens', 'disagree', 'non_tie'):
            totals[k] += r[k]
        totals['max_score_gap'] = max(totals['max_score_gap'], r['max_score_gap'])
    check(totals['non_tie'] == 0, f'{case}: kernel and plain indices disagree beyond ties {totals}')
    c = e.shape[1]
    ref = stats_reference(x, idx, c, w)
    wsum = torch.zeros_like(ref[2]).reshape(-1).index_put_(
        ((idx.long() + torch.arange(x.shape[0], device=x.device)[:, None] * c).reshape(-1),),
        torch.ones(idx.numel(), dtype=torch.float64, device=x.device) if w is None else w.reshape(-1).double(),
        accumulate=True).reshape(bins.shape)
    check(torch.equal(bins.double(), wsum), f'{case}: kernel bins equal the weight sums')
    if totals['disagree'] == 0:
        check(torch.equal(bins, pbins), f'{case}: kernel and plain bins equal')
    err, share = esum_within_bound(esum, ref)
    check(share <= 1.0, f'{case}: kernel esum within the f32 summation bound ({share})')
    perr, pshare = esum_within_bound(pesum, ref if totals['disagree'] == 0 else stats_reference(x, pidx, c, w))
    check(pshare <= 1.0, f'{case}: plain esum within the f32 summation bound ({pshare})')
    emit('train_fused_vs_plain', case=case, shape=[x.shape[0], x.shape[1], c, x.shape[2]], metric=metric,
         weighted=w is not None, bit_identical_calls=True, indices_equal_nearest_code=True,
         esum_max_abs_err=err, esum_share_of_bound=share,
         plain_esum_max_abs_err=perr, plain_esum_share_of_bound=pshare, **totals)
    return err


def phase_train_fused_vs_plain(x_main, e_main, device, sizes):
    from vqtpu_torch.core.utils import l2norm
    gen = np.random.default_rng(11)

    def rand(*shape):
        return torch.from_numpy(gen.standard_normal(shape, dtype=np.float32)).to(device)

    n = x_main.shape[0]
    main_err = compare_train('main', x_main, e_main, 'euclidean', None, device)
    compare_train('main_cosine', l2norm(x_main), l2norm(e_main), 'cosine', None, device)
    w = torch.from_numpy((gen.random(n) > 0.3).astype(np.float32)).to(device)
    compare_train('main_weighted', x_main, e_main, 'euclidean', w, device)
    for case, shape in sizes['others'].items():
        *heads, n_, c_, d_ = shape
        compare_train(case, rand(*heads, n_, d_), rand(*heads, c_, d_), 'euclidean', None, device)

    tn, tc, td = sizes['ties']
    zeros_bins = torch.zeros(1, tc)
    zeros_bins[0, 0] = tn
    compare_train('ties_all_zero', torch.zeros(tn, td, device=device), torch.zeros(tc, td, device=device),
                  'euclidean', None, device,
                  exact=(torch.zeros(1, tn, dtype=torch.int32), zeros_bins))
    for copies in (2, 8):
        base = rand(tc // copies, td)
        bins = torch.zeros(1, tc)
        bins[0, :tc // copies] = 1
        compare_train(f'ties_{copies}_copies', base, torch.cat([base] * copies), 'euclidean', None, device,
                      exact=(torch.arange(tc // copies, dtype=torch.int32)[None], bins))
    return main_err


def _max_rel_row_err(q, rows):
    return float(((q - rows).abs().amax(-1) / rows.abs().amax(-1).clamp_min(1e-30)).max())


def phase_train_path(device, sizes):
    """VectorQuantize(dim=256, codebook_size=512).train() at full width, 3
    forward + backward steps on each route from the same state."""
    from vqtpu_torch import VectorQuantize
    from vqtpu_torch.kernels.distance import (
        nearest_code, nearest_code_plain, selection_bias, selection_disagreements,
    )
    from vqtpu_torch.kernels.train_fused import code_statistics_plain, fused_train_quantize
    n, c, d = sizes['main']
    b = sizes['batch']
    torch.manual_seed(3)
    models = {route: VectorQuantize(dim=d, codebook_size=c, train_fused=route, device=device).train()
              for route in ('on', 'off')}
    models['off'].load_state_dict(models['on'].state_dict())
    state0 = {k: v.clone() for k, v in models['on'].state_dict().items()}
    gen = np.random.default_rng(12)
    batches = [torch.from_numpy(gen.standard_normal((b, n // b, d), dtype=np.float32)).to(device)
               for _ in range(sizes['train_steps'])]

    runs = {}
    for route, vq in models.items():
        nearest_code.launches = 0
        fused_train_quantize.launches = 0
        steps = []
        for s, batch in enumerate(batches):
            embed = vq.codebook.clone()
            prev_cs, prev_ea = vq._codebook.cluster_size.clone(), vq._codebook.embed_avg.clone()
            x = batch.clone().requires_grad_()
            q, idx, loss = vq(x)
            (loss + q.square().mean()).backward()
            sync(device)
            check(bool(torch.isfinite(x.grad).all()), f'{route} step {s}: x.grad is finite')
            rows = embed[idx.reshape(-1).long()]
            rel = _max_rel_row_err(q.detach().reshape(-1, d), rows)
            check(rel <= 1e-5, f'{route} step {s}: q within 1e-5 of codebook[idx] ({rel})')
            step = dict(embed=embed, idx=idx, loss=loss.detach(), q_rel_err=rel, prev_cs=prev_cs, prev_ea=prev_ea,
                        cluster_size=vq._codebook.cluster_size.clone(),
                        embed_avg=vq._codebook.embed_avg.clone(), embed_after=vq.codebook.clone())
            if s == 0:
                step['grad'] = x.grad
            steps.append(step)
            del x, q
        sync(device)
        runs[route] = dict(steps=steps, launches=dict(train_fused=fused_train_quantize.launches,
                                                      nearest_code=nearest_code.launches))
    on, off = runs['on'], runs['off']
    # train_fused='auto' (the default) takes the fused kernel on the card:
    # one step from the routes' first state gives the 'on' route's step 0
    auto = VectorQuantize(dim=d, codebook_size=c, device=device).train()
    auto.load_state_dict(state0)
    nearest_code.launches = 0
    fused_train_quantize.launches = 0
    with torch.no_grad():
        _, auto_idx, _ = auto(batches[0])
    sync(device)
    auto_launches = dict(train_fused=fused_train_quantize.launches, nearest_code=nearest_code.launches)
    check(auto_launches == dict(train_fused=1, nearest_code=0) and torch.equal(auto_idx, on['steps'][0]['idx']),
          f"'auto' takes the fused kernel on the card {auto_launches}")
    del auto
    check(on['launches']['train_fused'] == len(batches) and on['launches']['nearest_code'] == 0,
          f"'on' route launched the fused kernel and not the selection kernel {on['launches']}")
    check(off['launches']['nearest_code'] == len(batches) and off['launches']['train_fused'] == 0,
          f"'off' route launched the selection kernel and not the fused kernel {off['launches']}")

    # each route on its own, every step: indices are the plain selection on
    # its codebook but for near-ties, the loss is the float64 MSE to its own
    # rows, and cluster_size, embed_avg and embed are one float64 EMA step
    # from its own indices and previous state, within the f32 rounding
    decay, eps = models['on']._codebook.decay, models['on']._codebook.eps
    bounds = {}
    ema_share = 0.0
    for route, run in runs.items():
        for s, step in enumerate(run['steps']):
            xs = batches[s].reshape(-1, d)
            bias = selection_bias(step['embed'], 'euclidean')
            own = selection_disagreements(xs, step['embed'], bias, step['idx'],
                                          nearest_code_plain(xs, step['embed'], bias))
            check(own['non_tie'] == 0, f'{route} step {s}: indices disagree with the plain selection {own}')
            idx = step['idx'].reshape(-1).long()
            loss64 = float((xs.double() - step['embed'][idx].double()).square().mean())
            loss_err = abs(float(step['loss']) - loss64) / loss64
            check(loss_err <= 1e-5, f'{route} step {s}: loss within 1e-5 of the float64 MSE ({loss_err})')
            cs, ea, cs_bound, ea_bound = ema_step_reference(xs, idx, step['prev_cs'][0], step['prev_ea'][0], decay)
            smoothed, _ = smoothed_sizes(step['cluster_size'][0], eps)
            e_ref = step['embed_avg'][0].double() / smoothed[:, None]
            e_bound = 8 * U32 * e_ref.abs()
            for name, got, ref, bound in (('cluster_size', step['cluster_size'][0], cs, cs_bound),
                                          ('embed_avg', step['embed_avg'][0], ea, ea_bound),
                                          ('embed', step['embed_after'], e_ref, e_bound)):
                share = float(((got.double() - ref).abs() / bound.clamp_min(1e-300)).max())
                check(share <= 1.0, f'{route} step {s}: {name} within the f32 bound of one float64 EMA step '
                                    f'from its own indices and state ({share})')
                ema_share = max(ema_share, share)
            bounds[route, s] = cs_bound, ea_bound

    # step 0: one state and one selection kernel (K4 runs nearest_code's own
    # split-TF32 tile with its row copy, as the 'off' route does), so the
    # routes pick the same indices and give the same loss, x.grad and
    # cluster_size; only esum's order of summation differs between them
    s0_on, s0_off = on['steps'][0], off['steps'][0]
    check(torch.equal(s0_on['embed'], s0_off['embed']), 'step 0: the routes start from one codebook')
    check(torch.equal(s0_on['idx'], s0_off['idx']), 'step 0: the routes pick the same indices')
    check(torch.equal(s0_on['loss'], s0_off['loss']), 'step 0: the routes give the same loss')
    check(torch.equal(s0_on['grad'], s0_off['grad']), 'step 0: the routes give the same x.grad')
    check(torch.equal(s0_on['cluster_size'], s0_off['cluster_size']), 'step 0: cluster_size equal')
    step0_identical = ['indices', 'loss', 'x.grad', 'cluster_size']

    # the routes against each other: from step 1 on their codebooks differ by
    # esum's summation order, which can flip a near-tie; a flip moves two
    # codes' counts by one and their sums by the token, each scaled by
    # (1 - decay), so the difference of the routes' states is bounded from
    # the flips alone (plus each route's rounding above), step after step,
    # for every code; and each flip is explained by the codebooks'
    # difference at that step
    w = 1.0 - decay
    d_cs = torch.zeros(c, dtype=torch.float64, device=device)
    d_ea = torch.zeros(c, d, dtype=torch.float64, device=device)
    disagree, unexplained, embed_share = [], 0, 0.0
    for s in range(len(batches)):
        a, b_ = on['steps'][s], off['steps'][s]
        xs = batches[s].reshape(-1, d)
        flips, bad, gap = flips_explained(
            xs, (a['embed'], selection_bias(a['embed'], 'euclidean'), a['idx']),
            (b_['embed'], selection_bias(b_['embed'], 'euclidean'), b_['idx']))
        check(bad == 0, f'step {s}: {bad} of {flips} flips beyond near-ties and the codebooks\' difference ({gap})')
        disagree.append(flips)
        unexplained += bad
        flipped = (a['idx'] != b_['idx']).reshape(-1)
        picks = torch.cat([a['idx'].reshape(-1)[flipped], b_['idx'].reshape(-1)[flipped]]).long()
        mass = xs[flipped].double().abs().repeat(2, 1)
        d_cs = decay * d_cs + w * torch.bincount(picks, minlength=c) + bounds['on', s][0] + bounds['off', s][0]
        d_ea = (decay * d_ea + w * torch.zeros_like(d_ea).index_add_(0, picks, mass)
                + bounds['on', s][1] + bounds['off', s][1])
        cs_a, cs_b = a['cluster_size'][0], b_['cluster_size'][0]
        ea_a, ea_b = a['embed_avg'][0].double(), b_['embed_avg'][0].double()
        check(bool(((cs_a - cs_b).double().abs() <= d_cs).all()), f'step {s}: cluster_size within the flips\' bound')
        check(bool(((ea_a - ea_b).abs() <= d_ea).all()), f'step {s}: embed_avg within the flips\' bound')
        # embed = embed_avg / smoothed, smoothed = (cs + eps) * ratio
        (sm_a, ratio_a), (sm_b, ratio_b) = smoothed_sizes(cs_a, eps), smoothed_sizes(cs_b, eps)
        d_sm = d_cs * ratio_a + (cs_b.double() + eps) * (ratio_a - ratio_b).abs()
        e_a, e_b = a['embed_after'].double(), b_['embed_after'].double()
        d_e = (d_ea / sm_a[:, None] + ea_b.abs() * (d_sm / (sm_a * sm_b))[:, None]
               + 9 * U32 * (e_a.abs() + e_b.abs()))
        share = float(((e_a - e_b).abs() / d_e.clamp_min(1e-300)).max())
        check(share <= 1.0, f"step {s}: the routes' codebooks within the flips' bound ({share})")
        embed_share = max(embed_share, share)
    last_on, last_off = on['steps'][-1], off['steps'][-1]
    embed_rel = float((last_on['embed_after'] - last_off['embed_after']).abs().max()
                      / last_on['embed_after'].abs().max())
    loss_rel = max(abs(float(a['loss']) - float(b_['loss'])) / abs(float(a['loss']))
                   for a, b_ in zip(on['steps'], off['steps']))
    check(loss_rel <= 1e-4, f"the routes' losses agree to 1e-4 ({loss_rel})")

    # the 'off' statistics: deterministic, and the same with TF32 on
    x0 = batches[0].reshape(1, -1, d)
    idx0 = s0_off['idx'].reshape(1, -1)
    stats = code_statistics_plain(x0, idx0, c)
    again = code_statistics_plain(x0, idx0, c)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = code_statistics_plain(x0, idx0, c)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(all(torch.equal(a, b_) for a, b_ in zip(stats, again)), "'off' statistics deterministic")
    check(all(torch.equal(a, b_) for a, b_ in zip(stats, tf32)), "'off' statistics the same with TF32 on")
    emit('train_path', model=f'VectorQuantize(dim={d}, codebook_size={c}).train()',
         input=list(batches[0].shape), steps=len(batches),
         launches_on=on['launches'], launches_off=off['launches'], launches_auto_one_step=auto_launches,
         loss_on=[float(t['loss']) for t in on['steps']], loss_off=[float(t['loss']) for t in off['steps']],
         disagreements_per_step=disagree, unexplained_flips=unexplained, embed_rel_diff_after=embed_rel,
         ema_step_share_of_bound=ema_share, embed_diff_share_of_flip_bound=embed_share, loss_rel_diff=loss_rel,
         q_rel_err_vs_codebook_rows=max(t['q_rel_err'] for t in on['steps'] + off['steps']),
         step0_identical=step0_identical,
         off_stats_deterministic=True, off_stats_tf32_invariant=True)
    return on['launches']['train_fused'], off['launches']['nearest_code']


def phase_flagship_train(device, sizes):
    """The flagship with train_fused='on': step 0 against the CPU from the
    same weights, then AdamW steps with a falling loss."""
    from vqtpu_torch import SimpleQuantizeAutoEncoder, VectorQuantize
    from vqtpu_torch.core.metrics import codebook_perplexity, ema_perplexity
    from vqtpu_torch.kernels.distance import nearest_code, selection_bias, selection_disagreements
    from vqtpu_torch.kernels.train_fused import fused_train_quantize
    alpha = 10.0    # examples/autoencoder.py

    def build(dev):
        return SimpleQuantizeAutoEncoder(
            VectorQuantize(dim=32, codebook_size=256, train_fused='on', device=dev), dim=32, device=dev,
        ).train()

    def loss_of(model, x):
        recon, idx, cmt_loss = model(x)
        rec = (recon.clamp(-1, 1) - x).abs().mean()
        return rec + alpha * cmt_loss, idx

    torch.manual_seed(4)
    model = build(device)
    ref = build('cpu')
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    rng = np.random.default_rng(5)
    images = [rng.random((sizes['images'], 28, 28, 1), dtype=np.float32) for _ in range(sizes['flagship_steps'])]

    # step 0 on both devices
    x = torch.from_numpy(images[0])
    with torch.no_grad():
        z = model.encoder(x.to(device)).reshape(-1, 32)
    embed = model.quantizer.codebook.clone()
    nearest_code.launches = 0
    fused_train_quantize.launches = 0
    loss, idx = loss_of(model, x.to(device))
    loss.backward()
    ref_loss, ref_idx = loss_of(ref, x)
    ref_loss.backward()
    sync(device)
    r = selection_disagreements(z, embed, selection_bias(embed, 'euclidean'),
                                idx.reshape(-1), ref_idx.reshape(-1).to(device))
    check(r['non_tie'] == 0, f'flagship step 0: indices disagree with the CPU beyond ties {r}')
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    check(loss_rel <= 1e-4, f'flagship step 0: loss matches the CPU ({loss_rel})')
    cb, rcb = model.quantizer._codebook, ref.quantizer._codebook
    cs_err = float((cb.cluster_size.cpu() - rcb.cluster_size).abs().max())
    check(cs_err <= 2 * (1 - cb.decay) * r['disagree'] + 1e-6, f'flagship step 0: cluster_size ({cs_err})')
    ea_err = float((cb.embed_avg.cpu() - rcb.embed_avg).abs().max() / rcb.embed_avg.abs().max())
    check(r['disagree'] > 0 or ea_err <= 1e-5, f'flagship step 0: embed_avg matches the CPU ({ea_err})')
    grad_err = 0.0
    for (name, p), (_, rp) in zip(model.named_parameters(), ref.named_parameters()):
        err = float((p.grad.cpu() - rp.grad).abs().max() / rp.grad.abs().max().clamp_min(1e-30))
        grad_err = max(grad_err, err)
    check(r['disagree'] > 0 or grad_err <= 1e-4, f'flagship step 0: gradients match the CPU ({grad_err})')
    opt.step()
    opt.zero_grad()

    losses = [loss.item()]
    for step in range(1, len(images)):
        loss, idx = loss_of(model, torch.from_numpy(images[step]).to(device))
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())
    sync(device)
    launches = fused_train_quantize.launches
    check(launches == len(images) and nearest_code.launches == 0,
          f'the flagship trained through the fused kernel ({launches}, {nearest_code.launches})')
    check(all(np.isfinite(losses)), 'flagship losses are finite')
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f'the flagship loss falls ({first} -> {last})')
    emit('flagship_train',
         model="SimpleQuantizeAutoEncoder(VectorQuantize(dim=32, codebook_size=256, train_fused='on'))",
         optimizer='AdamW(lr=3e-4, weight_decay=1e-4)', input=[sizes['images'], 28, 28, 1],
         steps=len(images), launches=launches, loss_first=losses[0], loss_last=losses[-1],
         loss_mean_first5=first, loss_mean_last5=last,
         step0_vs_cpu=dict(loss_rel_err=loss_rel, cluster_size_max_abs_err=cs_err,
                           embed_avg_rel_err=ea_err, grad_max_rel_err=grad_err, **r),
         codebook_perplexity=float(codebook_perplexity(idx, 256)),
         ema_perplexity=float(ema_perplexity(cb.cluster_size)))
    return launches


def data_rows_codebook(x, c, seed=13):
    """c rows of x drawn without replacement, as kmeans init and dead-code
    expiry draw codes: a codebook whose clusters are less even than random
    rows'."""
    return x[torch.from_numpy(np.random.default_rng(seed).choice(x.shape[0], c, replace=False)).to(x.device)]


def stats_bound_ms(n, c, d):
    """Least time for the statistics passes: read x and the indices once,
    write bins and esum once (bytes; they do n d adds)."""
    return 4 * (n * d + n + c * d + c) / PEAK_BYTES_PER_S * 1e3


SORTED_PASSES = ('sort', 'row_scan', 'code_scan', 'scatter', 'segment_sums', 'segment_merge')
SPLIT_PASSES = ('split_partial', 'split_merge')


def train_pass_times(x, e, reps):
    """Device ms of each pass of the fused step on (x, e) alone (CUDA
    events): the two selections with their rows in turns (a, b, b, a), then,
    on the split-TF32 indices, each statistics' passes in order (each reads
    what the pass before it left), in two rounds; and the largest cluster's
    share of the tokens. The small passes' times include the host's launch
    through ctypes."""
    from vqtpu_torch.kernels.distance import nearest_code, selection_bias
    from vqtpu_torch.kernels.train_fused import _fused_train_stages
    selections = ('select_tf32', 'select_simt')
    stats = (SORTED_PASSES, SPLIT_PASSES)
    n, c, d = x.shape[0], e.shape[0], x.shape[1]
    runs = _fused_train_stages(x, e, selection_bias(e, 'euclidean'))
    times: dict[str, list] = {}
    for name in (*selections, *selections[::-1]):
        times.setdefault(name, []).append(cuda_ms(runs[name], reps))
    runs[selections[0]]()
    for _ in range(2):
        for passes in stats:
            for name in passes:
                times.setdefault(name, []).append(cuda_ms(runs[name], reps))
    ms = {name: sum(t) / len(t) for name, t in times.items()}
    bound = stats_bound_ms(n, c, d)
    sums = {f'{passes[0]}..{passes[-1]}': sum(ms[p] for p in passes) for passes in stats}
    largest = float(torch.bincount(nearest_code(x, e).long(), minlength=c).max()) / n
    return dict(ms=ms, ms_runs=times, stats_ms=sums, stats_bound_ms=bound,
                stats_share_of_bound={k: bound / v for k, v in sums.items()}, largest_code_share=largest)


def phase_train_times(x_main, e_main, sizes, smi):
    """K4 against the step it replaced (same run) and the 'off' route's
    composition, with each pass on its own, on two codebooks: random rows,
    and rows of x (as kmeans init and dead-code expiry draw them), whose
    clusters are less even; then a training step per route."""
    from vqtpu_torch import VectorQuantize
    from vqtpu_torch.kernels.distance import quantize_lookup, selection_bias
    from vqtpu_torch.kernels.train_fused import (
        _fused_train_simt, code_statistics_plain, fused_train_quantize, fused_train_quantize_plain,
    )
    n, c, d = sizes['main']
    reps = sizes['train_reps']
    codebooks = {'random_rows': e_main, 'data_rows': data_rows_codebook(x_main, c)}
    per_codebook = {}
    for name, e in codebooks.items():
        bias = selection_bias(e, 'euclidean')
        idx, _ = quantize_lookup(x_main, e)
        calls = {
            'kernel': lambda: fused_train_quantize(x_main, e, 'euclidean', bias=bias),
            'previous': lambda: _fused_train_simt(x_main, e, bias),
            # the 'off' route: the selection kernel with its row copy, then
            # index_put_ statistics
            'composition': lambda: code_statistics_plain(x_main[None], quantize_lookup(x_main, e)[0][None], c),
            'composition_stats': lambda: code_statistics_plain(x_main[None], idx[None], c),
        }
        runs: dict[str, list] = {}
        # one card, in turns
        for key in ('kernel', 'previous', 'composition', 'composition_stats',
                    'composition_stats', 'composition', 'previous', 'kernel'):
            runs.setdefault(key, []).append(cuda_ms(calls[key], reps))
        ms = {key: sum(t) / len(t) for key, t in runs.items()}
        check(ms['kernel'] < ms['previous'],
              f"{name}: K4 beats the step it replaced ({ms['kernel']}, {ms['previous']})")
        per_codebook[name] = dict(ms=ms, ms_runs=runs, passes=train_pass_times(x_main, e, reps))
    plain_ms = cuda_ms(lambda: fused_train_quantize_plain(x_main, e_main, selection_bias(e_main, 'euclidean')),
                       reps)

    torch.manual_seed(6)
    models = {route: VectorQuantize(dim=d, codebook_size=c, train_fused=route, device=x_main.device).train()
              for route in ('on', 'off')}
    models['off'].load_state_dict(models['on'].state_dict())
    xin = x_main.reshape(sizes['batch'], n // sizes['batch'], d)

    def step(route):
        def run():
            x = xin.detach().requires_grad_()
            q, _, loss = models[route](x)
            (loss + q.square().mean()).backward()
        return run

    step_ms = {'on': [], 'off': []}
    for route in ('on', 'off', 'off', 'on'):
        step_ms[route].append(cuda_ms(step(route), sizes['step_reps'], warmup=1))
    peak = {}
    profiles = {}
    for route in ('on', 'off'):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(route)()
        torch.cuda.synchronize()
        peak[route] = torch.cuda.max_memory_allocated()
        profiles[route] = profile_device(step(route), 1)
    bound = train_bound_ms(n, c, d, weighted=False)
    step_mean = {r: sum(v) / len(v) for r, v in step_ms.items()}
    main, data = per_codebook['random_rows'], per_codebook['data_rows']
    emit('train_times', shape=[n, c, d], reps=reps, card=smi, per_codebook=per_codebook,
         kernel='fused_train_quantize (split-TF32 selection with its rows, then the statistics)',
         previous='the replaced step (f32 FMA tile with its rows, then the same statistics; '
                  'vqtpu_train_fused_f32_simt), same inputs',
         composition="quantize_lookup (selection kernel with its row copy) + code_statistics_plain (the 'off' "
                     'route); composition_stats the latter alone',
         passes='each pass on its own (vqtpu_train_fused_stage); the statistics read the split-TF32 indices',
         plain_ms=plain_ms, **bound, share_of_bound=bound['bound_ms'] / main['ms']['kernel'],
         step_ms_on=step_mean['on'], step_ms_on_runs=step_ms['on'],
         step_ms_off=step_mean['off'], step_ms_off_runs=step_ms['off'],
         step='forward + backward of VectorQuantize(dim=256, codebook_size=512).train() on (1024, 1024, 256)',
         vectors_per_s_on=n / (step_mean['on'] / 1e3), vectors_per_s_off=n / (step_mean['off'] / 1e3),
         peak_allocated_bytes=peak,
         profile_step_on=profiles['on'], profile_step_off=profiles['off'])
    return dict(ms=main['ms']['kernel'], previous_ms=main['ms']['previous'], plain_ms=plain_ms, **bound,
                share_of_bound=bound['bound_ms'] / main['ms']['kernel'], library_ms=None,
                composition_ms=main['ms']['composition'], passes_ms=main['passes']['ms'],
                largest_code_share=main['passes']['largest_code_share'],
                ms_data_rows=data['ms']['kernel'], previous_ms_data_rows=data['ms']['previous'],
                composition_ms_data_rows=data['ms']['composition'], passes_ms_data_rows=data['passes']['ms'],
                largest_code_share_data_rows=data['passes']['largest_code_share'],
                step_ms_on=step_mean['on'], step_ms_off=step_mean['off'])


# -- LFQ: the entropy sweeps K5-K8 -------------------------------------------------


def lfq_operands(n, d, spherical, weighted, device, seed):
    gen = np.random.default_rng(seed)
    x = gen.standard_normal((n, d), dtype=np.float32)
    if spherical:
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    w = (gen.random(n) > 0.3).astype(np.float32) if weighted else np.ones(n, np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(w).to(device)


def lfq_cotangents(w, avgp, weight=0.1, gamma=1.0):
    """The cotangents LFQ's aux loss weight * (sum w ent / W - gamma H(avgp / W))
    sends to (ent, avgp)."""
    denom = w.sum().clamp_min(1e-6)
    a = avgp.double() / denom
    entbar = (weight * w / denom).float()
    gbar = (weight * gamma * (torch.log(a.clamp_min(1e-5)) + (a > 1e-5).double()) / denom).float()
    return entbar, gbar


def lfq_sweep_outputs(x, w, kw, entbar, gbar, plain=False):
    """(logz, ent, avgp, sigma, gdot, dx) through the kernels, or through the
    plain sweeps (in the dtype of x) when `plain`."""
    from vqtpu_torch.kernels import lfq_entropy as tle
    a, b, c, d_ = ((tle.sweep_a_plain, tle.sweep_b_plain, tle.sweep_c_plain, tle.sweep_d_plain) if plain
                   else (tle.sweep_a, tle.sweep_b, tle.sweep_c, tle.sweep_d))
    eb, gb = entbar.to(x.dtype), gbar.to(x.dtype)
    m, s = a(x, **kw)
    logz = m + torch.log(s)
    ent, avgp = b(x, w.to(x.dtype), logz, eps=1e-5, **kw)
    sigma, gdot = c(x, w.to(x.dtype), logz, eb, gb, eps=1e-5, **kw)
    dx = d_(x, w.to(x.dtype), logz, eb, gb, sigma, eps=1e-5, **kw)
    return dict(logz=logz, ent=ent, avgp=avgp, sigma=sigma, gdot=gdot, dx=dx)


def compare_lfq(case, n, d, spherical, scale, weighted, inv_temp, device, seed, heads=1):
    """The four sweeps against the plain sweeps on the same inputs, both held
    to a float64 plain run; two kernel calls bit-identical. The kernel's
    error must be within the stated tolerance of the largest float64 entry
    (forward: 1e-5 at inv_temp 1, 1e-4 at 100; sigma, gdot and dx: 2e-5) or
    within 4x the plain f32 sweep's own error, where a sum over 2^18 codes
    cancels. Each limit must lie below a tenth of the largest entry (where
    that entry is within f32's range), so that an output that is zero, or
    off by a tenth, fails."""
    from vqtpu_torch.kernels import lfq_entropy as tle
    k = 1 << d
    v = tle.code_magnitude(d, scale, spherical)
    kw = dict(k=k, v=v, inv_temp=inv_temp)
    errors = {}
    for h in range(heads):
        x, w = lfq_operands(n, d, spherical, weighted, device, seed + h)
        if inv_temp == 1.0:
            gen = np.random.default_rng(seed + 100 + h)
            entbar = torch.from_numpy(gen.standard_normal(n).astype(np.float32)).to(device)
            gbar = torch.from_numpy(gen.standard_normal(k).astype(np.float32)).to(device)
        else:
            entbar, gbar = lfq_cotangents(w, tle.entropy_fwd_plain(x.double(), w.double(), **kw)[1])
        ref = lfq_sweep_outputs(x.double(), w, kw, entbar, gbar, plain=True)
        got = lfq_sweep_outputs(x, w, kw, entbar, gbar)
        again = lfq_sweep_outputs(x, w, kw, entbar, gbar)
        plain = lfq_sweep_outputs(x, w, kw, entbar, gbar, plain=True)
        sync(device)
        check(all(torch.equal(got[key], again[key]) for key in got), f'{case}: two kernel calls bit-identical')
        for key in got:
            scale_ref = float(ref[key].abs().max())
            err = float((got[key].double() - ref[key]).abs().max())
            plain_err = float((plain[key].double() - ref[key]).abs().max())
            if key in ('logz', 'ent', 'avgp'):
                tol = (1e-5 if inv_temp == 1.0 else 1e-4) * max(scale_ref, 1e-30 if key != 'logz' else 1.0)
            else:
                tol = 2e-5 * scale_ref
            limit = max(tol, 4 * plain_err)
            check(limit < 0.1 * scale_ref or scale_ref < torch.finfo(torch.float32).tiny,
                  f'{case} head {h}: the {key} limit {limit} bites (largest entry {scale_ref})')
            check(err <= limit,
                  f'{case} head {h}: kernel {key} within {tol} or 4x the plain error ({err}, plain {plain_err})')
            prev = errors.get(key, dict(max_abs_err=0.0, plain_max_abs_err=0.0, ref_max_abs=0.0, limit=0.0))
            errors[key] = dict(max_abs_err=max(prev['max_abs_err'], err),
                               plain_max_abs_err=max(prev['plain_max_abs_err'], plain_err),
                               ref_max_abs=max(prev['ref_max_abs'], scale_ref), limit=max(prev['limit'], limit))
        del ref, got, again, plain
    emit('lfq_kernels_vs_plain', case=case, n=n, d=d, k=k, heads=heads, spherical=spherical, codebook_scale=scale,
         v=v, weighted=weighted, inv_temp=inv_temp, bit_identical_calls=True,
         cotangents='N(0, 1)' if inv_temp == 1.0 else "LFQ aux loss's (weight 0.1, gamma 1)",
         errors_vs_float64=errors)
    return errors


def phase_lfq_kernels_vs_plain(device):
    n, d = LFQ_MAIN
    main = compare_lfq('main_t100', n, d, True, 1.0, False, LFQ_INV_TEMP, device, 20)
    compare_lfq('main_t1', n, d, True, 1.0, False, 1.0, device, 21)
    compare_lfq('main_scale025', n, d, False, 0.25, False, LFQ_INV_TEMP, device, 22)
    compare_lfq('main_weighted', n, d, True, 1.0, True, LFQ_INV_TEMP, device, 23)
    compare_lfq('ragged_300_k1024', 300, 10, True, 1.0, True, LFQ_INV_TEMP, device, 24)
    compare_lfq('k256', 12544, 8, True, 1.0, False, LFQ_INV_TEMP, device, 25)
    compare_lfq('heads3_k4096', 4096, 12, False, 1.0, False, LFQ_INV_TEMP, device, 26, heads=3)
    return main


def lfq_launches():
    from vqtpu_torch.kernels import lfq_entropy as tle
    return {name: f.launches for name, f in tle.SWEEPS.items()}


def reset_lfq_launches():
    from vqtpu_torch.kernels import lfq_entropy as tle
    for f in tle.SWEEPS.values():
        f.launches = 0


def lfq_main_input(device, seed=30):
    n, d = LFQ_MAIN
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((8, n // 8, d), dtype=np.float32)).to(device)


def lfq_main_model(route, device):
    from vqtpu_torch import LFQ
    n, d = LFQ_MAIN
    return LFQ(dim=d, codebook_size=1 << d, spherical=True, entropy_loss_weight=0.1, diversity_gamma=1.0,
               entropy_fused=route, device=device).train()


def phase_lfq_train_path(device):
    """The full-width LFQ training step on each entropy route, and 3 SGD
    steps of ResidualLFQ on 'on' and 'off'. The aux loss's own gradient is
    taken apart from the quantization term's (which no route changes), so
    that the routes are held to each other on the part the sweeps make."""
    from vqtpu_torch import ResidualLFQ
    n, d = LFQ_MAIN
    xin = lfq_main_input(device)
    runs = {}
    for route in ('on', 'auto', 'off'):
        lfq = lfq_main_model(route, device)
        x = xin.clone().requires_grad_()
        reset_lfq_launches()
        q, idx, aux = lfq(x, inv_temperature=LFQ_INV_TEMP)
        aux_grad, = torch.autograd.grad(aux, x, retain_graph=True)
        q.square().mean().backward()
        grad = x.grad + aux_grad
        sync(device)
        runs[route] = dict(launches=lfq_launches(), idx=idx, aux=aux.detach(), grad=grad, aux_grad=aux_grad,
                           q=q.detach())
        check(bool(torch.isfinite(grad).all()) and bool(torch.isfinite(aux)), f'{route}: finite aux and x.grad')
        del lfq, x, q
    for route in ('on', 'auto'):
        check(all(v == 1 for v in runs[route]['launches'].values()),
              f"'{route}' ran each sweep once {runs[route]['launches']}")
    check(all(v == 0 for v in runs['off']['launches'].values()), f"'off' ran no sweep {runs['off']['launches']}")
    bits = ((xin > 0).long() << torch.arange(d - 1, -1, -1, device=device)).sum(-1).int()
    for route, r in runs.items():
        check(torch.equal(r['idx'], bits), f'{route}: indices equal the sign bits of x')
        check(torch.equal(r['q'], runs['on']['q']), f'{route}: the same quantized output')
    check(all(torch.equal(runs['auto'][key], runs['on'][key]) for key in ('aux', 'grad', 'aux_grad')),
          "'auto' equals 'on' bit for bit")
    aux_rel = float((runs['on']['aux'] - runs['off']['aux']).abs() / runs['off']['aux'].abs())
    check(aux_rel <= 1e-4, f"'on' and 'off' aux agree to 1e-4 ({aux_rel})")
    grads = {}
    for key in ('aux_grad', 'grad'):
        ref_max = float(runs['off'][key].abs().max())
        rel = float((runs['on'][key] - runs['off'][key]).abs().max()) / ref_max
        check(rel <= 1e-3, f"'on' and 'off' {key} agree to 1e-3 of the largest entry {ref_max} ({rel})")
        grads[key] = dict(max_rel_diff_on_vs_off=rel, off_max_abs=ref_max)
    main_launches = runs['on']['launches']

    # ResidualLFQ: 3 SGD steps per route from the same state
    torch.manual_seed(31)
    kw = dict(dim=64, codebook_size=2 ** 10, num_quantizers=4, entropy_loss_weight=0.1)
    models = {route: ResidualLFQ(**kw, entropy_fused=route, device=device).train() for route in ('on', 'off')}
    models['off'].load_state_dict(models['on'].state_dict())
    gen = np.random.default_rng(32)
    batches = [torch.from_numpy(gen.standard_normal((8, 1024, 64), dtype=np.float32)).to(device) for _ in range(3)]
    res = {}
    for route, model in models.items():
        opt = torch.optim.SGD(model.parameters(), lr=1e-2)
        reset_lfq_launches()
        steps = []
        for batch in batches:
            q, idx, losses = model(batch)
            loss = (q - batch).square().mean() + losses.sum()
            loss.backward()
            opt.step()
            opt.zero_grad()
            steps.append(dict(idx=idx, loss=loss.item(), losses=losses.detach()))
        sync(device)
        res[route] = dict(steps=steps, launches=lfq_launches())
    check(all(v == 3 * 4 for v in res['on']['launches'].values()), f"ResidualLFQ 'on' launches {res['on']['launches']}")
    check(all(v == 0 for v in res['off']['launches'].values()), f"ResidualLFQ 'off' launches {res['off']['launches']}")
    check(torch.equal(res['on']['steps'][0]['idx'], res['off']['steps'][0]['idx']), 'ResidualLFQ step 0: same indices')
    flips, loss_rel = [], []
    for a, b in zip(res['on']['steps'], res['off']['steps']):
        flips.append(int((a['idx'] != b['idx']).sum()))
        loss_rel.append(abs(a['loss'] - b['loss']) / abs(b['loss']))
    check(max(loss_rel) <= 1e-3, f"ResidualLFQ 'on' and 'off' losses agree to 1e-3 ({loss_rel})")
    check(max(flips) <= 1e-3 * res['on']['steps'][0]['idx'].numel(), f'ResidualLFQ index flips {flips}')
    emit('lfq_train_path', model=f'LFQ(dim={d}, codebook_size=2**{d}, spherical=True, entropy_loss_weight=0.1).train()',
         input=list(xin.shape), inv_temperature=LFQ_INV_TEMP, launches={r: v['launches'] for r, v in runs.items()},
         aux={r: float(v['aux']) for r, v in runs.items()}, aux_rel_on_vs_off=aux_rel,
         x_grad=grads, x_grad_of=dict(aux_grad="the aux loss's gradient alone", grad='the whole loss'),
         indices_equal_sign_bits=True, auto_equals_on=True,
         residual=dict(model='ResidualLFQ(dim=64, codebook_size=2**10, num_quantizers=4)', input=[8, 1024, 64],
                       optimizer='SGD(lr=1e-2)', steps=3, launches={r: v['launches'] for r, v in res.items()},
                       loss_on=[t['loss'] for t in res['on']['steps']], loss_off=[t['loss'] for t in res['off']['steps']],
                       loss_rel_diff=loss_rel, index_flips_per_step=flips))
    return main_launches


def phase_lfq_flagship_train(device, sizes):
    """examples/autoencoder_lfq.py's model with entropy_fused='on': step 0
    against the CPU from the same weights, then AdamW steps."""
    from vqtpu_torch import LFQ, SimpleQuantizeAutoEncoder
    alpha = 10.0

    def build(dev):
        return SimpleQuantizeAutoEncoder(
            LFQ(dim=32, codebook_size=256, entropy_loss_weight=0.02, diversity_gamma=1.0, entropy_fused='on',
                device=dev), dim=32, device=dev).train()

    def loss_of(model, x):
        recon, idx, aux = model(x)
        return (recon.clamp(-1, 1) - x).abs().mean() + alpha * aux, idx, aux

    torch.manual_seed(33)
    model = build(device)
    ref = build('cpu')
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    rng = np.random.default_rng(34)
    images = [rng.random((sizes['images'], 28, 28, 1), dtype=np.float32) for _ in range(sizes['flagship_steps'])]

    x = torch.from_numpy(images[0])
    reset_lfq_launches()
    loss, idx, aux = loss_of(model, x.to(device))
    loss.backward()
    ref_loss, ref_idx, ref_aux = loss_of(ref, x)
    ref_loss.backward()
    with torch.no_grad():
        z = model.quantizer.project_in(model.encoder(x.to(device)).reshape(-1, 32)).cpu()
    sync(device)
    bits = ((z > 0).long() << torch.arange(7, -1, -1)).sum(-1).int().reshape(idx.shape)
    check(torch.equal(idx.cpu(), bits), 'LFQ flagship step 0: indices are the sign bits of the projection')
    flips = int((idx.cpu() != ref_idx).sum())
    # a token may flip only where a projected value lies within rounding of 0
    near_zero = (z.abs() < 1e-5).any(-1).reshape(idx.shape)
    check(bool(((idx.cpu() != ref_idx) <= near_zero).all()), 'LFQ flagship step 0: flips only at near-zero values')
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    check(loss_rel <= 1e-4, f'LFQ flagship step 0: loss matches the CPU to 1e-4 ({loss_rel})')
    compared_on = len(x)
    if flips:
        # the gradients are compared on the images with no flipped token
        keep = (idx.cpu() == ref_idx).reshape(len(x), -1).all(-1)
        compared_on = int(keep.sum())
        check(compared_on > len(x) // 2, f'LFQ flagship step 0: {compared_on} images without a flip')
        model.zero_grad()
        ref.zero_grad()
        sub_loss, sub_idx, _ = loss_of(model, x[keep].to(device))
        sub_loss.backward()
        ref_sub_loss, ref_sub_idx, _ = loss_of(ref, x[keep])
        ref_sub_loss.backward()
        check(torch.equal(sub_idx.cpu(), ref_sub_idx), 'LFQ flagship step 0: no flip on the images compared')
    grad_err = 0.0
    for (name, p), (_, rp) in zip(model.named_parameters(), ref.named_parameters()):
        err = float((p.grad.cpu() - rp.grad).abs().max() / rp.grad.abs().max().clamp_min(1e-30))
        grad_err = max(grad_err, err)
    check(grad_err <= 1e-3, f'LFQ flagship step 0: gradients match the CPU to 1e-3 on {compared_on} images ({grad_err})')
    if flips:
        # the step itself takes the whole batch
        model.zero_grad()
        loss, idx, aux = loss_of(model, x.to(device))
        loss.backward()
    opt.step()
    opt.zero_grad()

    losses, auxes = [loss.item()], [aux.item()]
    for step in range(1, len(images)):
        loss, idx, aux = loss_of(model, torch.from_numpy(images[step]).to(device))
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())
        auxes.append(aux.item())
    sync(device)
    launches = lfq_launches()
    expected = len(images) + (2 if flips else 0)  # with flips, the sub-batch and the step's rerun
    check(all(v == expected for v in launches.values()), f'the LFQ flagship ran each sweep every step {launches}')
    check(all(np.isfinite(losses)), 'LFQ flagship losses are finite')
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f'the LFQ flagship loss falls ({first} -> {last})')
    emit('lfq_flagship_train',
         model="SimpleQuantizeAutoEncoder(LFQ(dim=32, codebook_size=256, entropy_loss_weight=0.02, "
               "diversity_gamma=1.0, entropy_fused='on'))",
         optimizer='AdamW(lr=3e-4, weight_decay=1e-4)', loss='|clip(out, -1, 1) - x|.mean() + 10 aux',
         input=[sizes['images'], 28, 28, 1], steps=len(images), launches=launches,
         loss_first=losses[0], loss_last=losses[-1], aux_first=auxes[0], aux_last=auxes[-1],
         loss_mean_first5=first, loss_mean_last5=last,
         step0_vs_cpu=dict(loss_rel_err=loss_rel, grad_max_rel_err=grad_err, index_flips=flips,
                           grad_compared=True, grad_compared_on_images=compared_on),
         codes_used_last_step=int(torch.unique(idx).numel()))
    return launches


def lfq_bound_ms(n, d, sweep):
    """Least time for a sweep at n tokens, K = 2^d: the largest of the FMA
    term, the MUFU term (one exp per pair at 16/clk/SM) and the bytes
    (inputs read once, outputs written once).

    One MUFU op a pair in every sweep: the function needs no log. Where
    p > eps, log p = l - logz, so the entropy term and its slope
    f'(p) = -log max(p, eps) - [p > eps] come from the logit with FMAs;
    where p <= eps the slope is the constant -log(eps); and A's shift, the
    largest logit, is known in closed form, so A needs no running max and
    no rescale. All four sweeps compute it that way.

    The FMA term counts the dots as the function needs them, not as d FMAs
    a pair: codes come in runs of 2^L (L = min(d, 4)) that share their top
    d - L signs, so a run's 2^L dots take d - L FMAs for the shared prefix
    and 2^(L+1) - 2 for the tree over the last L dims (2.75 a pair at
    d = 18). Sweep D folds p (g - sigma) back through the same tree, its
    transpose, as many adds again. At 67 TFLOP/s f32."""
    k = 1 << d
    pairs = n * k
    lo = min(d, 4)
    dot_fmas = (d - lo + (1 << (lo + 1)) - 2) / (1 << lo)
    fma_ms = 2 * dot_fmas * pairs * (2 if sweep == 'd' else 1) / PEAK_F32_FLOPS * 1e3
    mufu_ms = pairs / PEAK_MUFU_PER_S * 1e3
    floats = {'a': n * d + 2 * n, 'b': n * d + 3 * n + k, 'c': n * d + 5 * n + k, 'd': 2 * n * d + 4 * n + k}[sweep]
    bytes_ms = 4 * floats / PEAK_BYTES_PER_S * 1e3
    ops_ms = max(fma_ms, mufu_ms)
    return dict(bound_ms=max(ops_ms, bytes_ms), bound_by='operations' if ops_ms >= bytes_ms else 'bytes',
                fma_term_ms=fma_ms, mufu_term_ms=mufu_ms, bytes_term_ms=bytes_ms)


def phase_lfq_times(sizes, smi):
    from vqtpu_torch.kernels import lfq_entropy as tle
    n, d = LFQ_MAIN
    k = 1 << d
    device = torch.device('cuda')
    reps = sizes['lfq_reps']
    x, w = lfq_operands(n, d, True, False, device, 40)
    v = tle.code_magnitude(d, 1.0, True)
    kw = dict(k=k, v=v, inv_temp=LFQ_INV_TEMP)
    m, s = tle.sweep_a(x, **kw)
    logz = m + torch.log(s)
    ent, avgp = tle.sweep_b(x, w, logz, eps=1e-5, **kw)
    entbar, gbar = lfq_cotangents(w, avgp)
    sigma, _ = tle.sweep_c(x, w, logz, entbar, gbar, eps=1e-5, **kw)
    calls = {
        'a': (lambda: tle.sweep_a(x, **kw), lambda: tle.sweep_a_plain(x, **kw)),
        'b': (lambda: tle.sweep_b(x, w, logz, eps=1e-5, **kw), lambda: tle.sweep_b_plain(x, w, logz, eps=1e-5, **kw)),
        'c': (lambda: tle.sweep_c(x, w, logz, entbar, gbar, eps=1e-5, **kw),
              lambda: tle.sweep_c_plain(x, w, logz, entbar, gbar, eps=1e-5, **kw)),
        'd': (lambda: tle.sweep_d(x, w, logz, entbar, gbar, sigma, eps=1e-5, **kw),
              lambda: tle.sweep_d_plain(x, w, logz, entbar, gbar, sigma, eps=1e-5, **kw)),
    }
    per_kernel = {}
    for name, (kernel, plain) in calls.items():
        # kernel, plain, kernel: one card, alternating
        ka = cuda_ms(kernel, reps)
        pm = cuda_ms(plain, sizes['lfq_plain_reps'], warmup=1)
        kb = cuda_ms(kernel, reps)
        per_kernel[name] = dict(ms=(ka + kb) / 2, ms_runs=[ka, kb], plain_ms=pm, **lfq_bound_ms(n, d, name))

    # K5's library yardstick: the (N, K) logits materialized by one GEMM, then logsumexp
    codes_t = tle.code_tile(0, k, d, v, device=device).T.contiguous()
    zero = torch.zeros(k, device=device)

    def library_a():
        torch.logsumexp(torch.addmm(zero, x, codes_t, beta=0, alpha=2 * LFQ_INV_TEMP), -1)
    per_kernel['a']['library_ms'] = cuda_ms(library_a, sizes['lfq_plain_reps'], warmup=1)
    per_kernel['a']['library_call'] = 'torch.addmm(0, x, C.T, alpha=2 inv_temp) then torch.logsumexp: (8192, 2^18) f32 logits, 8.6 GB'
    lse_err = float((torch.logsumexp(torch.addmm(zero, x, codes_t, beta=0, alpha=2 * LFQ_INV_TEMP), -1)
                     - logz).abs().max())
    del codes_t
    for name in 'bcd':
        per_kernel[name]['library_ms'] = None

    # the statistics as LFQ's routes compute them: fused (the four sweeps)
    # against the 'off' route's streamed chunks under checkpoint
    lfq = lfq_main_model('off', device)
    flat = x[:, None, :]

    def loss_from(ent_sum, avgp_num):
        a = avgp_num.reshape(-1) / n
        return ent_sum / n - (-a * torch.log(a.clamp_min(1e-5))).sum()

    def fused_fwd():
        with torch.no_grad():
            tle.lfq_entropy_stats(x, w, k=k, v=v, inv_temp=LFQ_INV_TEMP)

    def fused_fwd_bwd():
        xg = x.detach().requires_grad_()
        ent_, avgp_ = tle.lfq_entropy_stats(xg, w, k=k, v=v, inv_temp=LFQ_INV_TEMP)
        loss_from((ent_ * w).sum(), avgp_).backward()

    def streamed_fwd():
        with torch.no_grad():
            lfq._streamed_entropy_stats(flat, w, LFQ_INV_TEMP, 1 << 14)

    def streamed_fwd_bwd():
        xg = flat.detach().requires_grad_()
        loss_from(*lfq._streamed_entropy_stats(xg, w, LFQ_INV_TEMP, 1 << 14)).backward()

    stats = {}
    for name, fn in (('fused_fwd', fused_fwd), ('streamed_fwd', streamed_fwd), ('streamed_fwd', streamed_fwd),
                     ('fused_fwd', fused_fwd), ('fused_fwd_bwd', fused_fwd_bwd),
                     ('streamed_fwd_bwd', streamed_fwd_bwd), ('streamed_fwd_bwd', streamed_fwd_bwd),
                     ('fused_fwd_bwd', fused_fwd_bwd)):
        stats.setdefault(name, []).append(cuda_ms(fn, sizes['lfq_step_reps'], warmup=1))

    # one whole training step per route
    xin = lfq_main_input(device)
    models = {route: lfq_main_model(route, device) for route in ('on', 'auto', 'off')}

    def step(route):
        def run():
            xs = xin.detach().requires_grad_()
            q, _, aux = models[route](xs, inv_temperature=LFQ_INV_TEMP)
            (q.square().mean() + aux).backward()
        return run

    step_ms = {'on': [], 'auto': [], 'off': []}
    for route in ('on', 'off', 'auto', 'auto', 'off', 'on'):
        step_ms[route].append(cuda_ms(step(route), sizes['lfq_step_reps'], warmup=1))
    peak, profiles = {}, {}
    for route in ('on', 'auto', 'off'):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(route)()
        torch.cuda.synchronize()
        peak[route] = torch.cuda.max_memory_allocated()
        profiles[route] = profile_device(step(route), 1)
    reset_lfq_launches()
    step('on')()
    sync(device)
    launches_per_step = lfq_launches()
    step_mean = {r: sum(t) / len(t) for r, t in step_ms.items()}
    for name in per_kernel:
        per_kernel[name]['launches_per_step'] = launches_per_step[name]
    emit('lfq_times', shape=dict(n=n, d=d, k=k, inv_temp=LFQ_INV_TEMP, spherical=True), card=smi, reps=reps,
         per_kernel=per_kernel, library_logsumexp_max_abs_diff_vs_kernel_logz=lse_err,
         stats_ms={name: sum(t) / len(t) for name, t in stats.items()}, stats_ms_runs=stats,
         stats_note="fused = lfq_entropy_stats (sweeps A+B, +C+D backward); streamed = the 'off' route's "
                    'chunks of 2^14 codes under torch.utils.checkpoint; the loss is the entropy aux loss',
         step_ms=step_mean, step_ms_runs=step_ms,
         step='forward + backward of LFQ(dim=18, codebook_size=2**18, spherical=True).train() on (8, 1024, 18), '
              'loss mean(q^2) + aux',
         tokens_per_s={r: n / (t / 1e3) for r, t in step_mean.items()}, peak_allocated_bytes=peak,
         launches_per_step=launches_per_step, profile_step=profiles,
         bound_basis='H100 SXM at 700 W: 67 TFLOP/s f32 (FMA), 16 MUFU results/clk/SM x 132 SMs x 1.98 GHz '
                     '(one exp a pair, no log), 3.35 TB/s',
         log_free_sweeps=['a', 'b', 'c', 'd'])
    return dict(per_kernel=per_kernel, stats_ms={name: sum(t) / len(t) for name, t in stats.items()},
                step_ms=step_mean)


# -- ResidualFSQ: the fused eval kernel K9 ------------------------------------------


def all_launches() -> dict:
    """Every kernel wrapper's launch count."""
    from vqtpu_torch.kernels import lfq_entropy as tle
    from vqtpu_torch.kernels.distance import nearest_code
    from vqtpu_torch.kernels.residual_fsq_fused import fused_residual_fsq_eval
    from vqtpu_torch.kernels.train_fused import code_sums, fused_train_quantize
    return dict(nearest_code=nearest_code.launches, train_fused=fused_train_quantize.launches,
                code_sums=code_sums.launches,
                **{f'lfq_sweep_{k}': f.launches for k, f in tle.SWEEPS.items()},
                residual_fsq_fused=fused_residual_fsq_eval.launches)


def reset_all_launches() -> None:
    from vqtpu_torch.kernels import lfq_entropy as tle
    from vqtpu_torch.kernels.distance import nearest_code
    from vqtpu_torch.kernels.residual_fsq_fused import fused_residual_fsq_eval
    from vqtpu_torch.kernels.train_fused import code_sums, fused_train_quantize
    for f in (nearest_code, fused_train_quantize, code_sums, fused_residual_fsq_eval, *tle.SWEEPS.values()):
        f.launches = 0


def deepest_quantum(levels, q) -> float:
    lv = np.asarray(levels, np.float64)
    return float((2.0 / (lv - 1) * lv ** -(q - 1)).max())


def rfsq_input(levels, lead, device, seed):
    x = np.random.default_rng(seed).standard_normal((*lead, len(levels)), dtype=np.float32)
    return torch.from_numpy(x).to(device)


def rfsq_layer_shares(idx, ref, q):
    return [float((idx[..., i] == ref[..., i]).float().mean()) for i in range(q)]


def rfsq_bits_equal(got, want) -> bool:
    """Bit for bit, NaN where the other is NaN."""
    if got.dtype == torch.float32:
        nan = got.isnan()
        return torch.equal(nan, want.isnan()) and torch.equal(got.view(torch.int32)[~nan],
                                                              want.view(torch.int32)[~nan])
    return torch.equal(got, want)


def compare_rfsq(case, levels, q, lead, device, seed, x=None, scales=None):
    """K9 against its plain version on the card, same inputs (`rfsq_input`
    from the seed, unless x is given; the module's scales, unless given):
    values and indices bit for bit, NaN for NaN, two calls bit-identical."""
    from vqtpu_torch import ResidualFSQ
    from vqtpu_torch.kernels.residual_fsq_fused import (
        fused_residual_fsq_eval, fused_residual_fsq_eval_plain, kernel_plan,
    )
    m = ResidualFSQ(levels=list(levels), num_quantizers=q, device=device)
    kw = dict(levels=tuple(levels), clamp=m.soft_clamp_input_value, num_quantizers=q)
    plan = kernel_plan(tuple(levels), tuple(m.soft_clamp_input_value), q)
    x = rfsq_input(levels, lead, device, seed) if x is None else x
    scales = m._scales() if scales is None else scales
    got = fused_residual_fsq_eval(x, scales, **kw)
    again = fused_residual_fsq_eval(x, scales, **kw)
    plain = fused_residual_fsq_eval_plain(x, scales, **kw)
    sync(device)
    check(got[1].dtype == torch.int32 and got[1].shape == (*x.shape[:-1], q) and got[0].shape == x.shape,
          f'{case}: output shapes')
    check(rfsq_bits_equal(got[0], again[0]) and rfsq_bits_equal(got[1], again[1]),
          f'{case}: two kernel calls bit-identical')
    values_equal = rfsq_bits_equal(got[0], plain[0])
    indices_equal = rfsq_bits_equal(got[1], plain[1])
    finite = got[0].isfinite() & plain[0].isfinite()
    err = float((got[0] - plain[0])[finite].abs().max()) if bool(finite.any()) else 0.0
    shares = rfsq_layer_shares(got[1], plain[1], q)
    emit('rfsq_kernel_vs_plain', case=case, levels=list(levels), q=q, shape=list(x.shape),
         exact_division=plan.exact_division, integer_index=plan.integer_index,
         index_error_bound=plan.index_error_bound, values_bit_identical=values_equal,
         indices_bit_identical=indices_equal, index_share_equal_per_layer=shares, max_abs_err=err,
         bit_identical_calls=True)
    check(values_equal and indices_equal, f'{case}: values and indices bit-identical to the plain version '
                                          f'(max |err| {err}, index shares {shares})')
    return dict(bit_identical=values_equal and indices_equal, max_abs_err=err)


def rfsq_special_input(device, n=1 << 20, seed=57):
    """(n, 4) tokens at 1.5 sigma with a quarter of their entries replaced by
    infinite, huge, tiny (the IEEE route), NaN and signed-zero values."""
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal((n, 4))).astype(np.float32)
    special = np.array([np.inf, -np.inf, 3e38, -3.4e38, 1e30, -1e20, 0.0, -0.0, 1e-40, -1e-45, 2.0 ** -100,
                        2.0 ** -79, 2.0 ** -80, np.nan, 1.0, -1.0], np.float32)
    x.reshape(-1)[rng.choice(x.size, x.size // 4, replace=False)] = np.resize(special, x.size // 4)
    return torch.from_numpy(x).to(device)


def binade_input(device):
    """Every f32 value in [1, 2) and in [-2, -1) as a one-dim token: 2^24 tokens."""
    ones = (torch.arange(1 << 23, dtype=torch.int32, device=device) | (127 << 23)).view(torch.float32)
    return torch.cat([ones, -ones])[:, None]


def phase_rfsq_kernel_vs_plain(device):
    levels, q, lead = RFSQ_MAIN
    cases = {
        'main': (levels, q, lead),
        'l865_q3': ((8, 6, 5), 3, (2048, 1024)),
        'l75555_q6': ((7, 5, 5, 5, 5), 6, (2048, 1024)),
        'l44_q2': ((4, 4), 2, (2048, 1024)),
        'l8555_q3': ((8, 5, 5, 5), 3, (2048, 1024)),
        'ragged_1234': ((8, 6, 5), 4, (1234,)),
        'lead_2x999': ((8, 5, 5, 5), 8, (2, 999)),
        'd9_general': ((5,) * 9, 5, (300, 1000)),
        'q17_general': ((8, 5, 5, 5), 17, (300, 1000)),
        # a non-dyadic step (2 / 6), a deep stack, and beyond the integer
        # index proof (prod(levels) = 2^22: the digit by the division sequence)
        'l777_q8': ((7, 7, 7), 8, (2048, 1024)),
        'l5555_q16': ((5, 5, 5, 5), 16, (2048, 1024)),
        'l256_256_64_q3': ((256, 256, 64), 3, (2048, 1024)),
    }
    results = {case: compare_rfsq(case, *args, device, 50 + i) for i, (case, args) in enumerate(cases.items())}
    special = rfsq_special_input(device)
    results['large_infinite_tiny_nan'] = compare_rfsq('large_infinite_tiny_nan', levels, q, None, device, None,
                                                      x=special)
    # scales that are not the module's: every token takes the IEEE route
    from vqtpu_torch.kernels.residual_fsq_fused import canonical_scales
    other = canonical_scales(levels, q).to(device) * 1.1
    other[-2], other[-1] = 1e-38, 2.0 ** -120
    results['ieee_route_other_scales'] = compare_rfsq('ieee_route_other_scales', levels, q, None, device, None,
                                                      x=special, scales=other)
    binade = binade_input(device)
    for level in (5, 7, 8):
        results[f'binade_l{level}_q16'] = compare_rfsq(f'binade_l{level}_q16', (level,), 16, None, device, None,
                                                       x=binade)
    return results


def phase_rfsq_eval_path(device):
    """The served path at full width, each route, with the launch counts of
    every kernel set to 0 just before each forward and read just after."""
    from vqtpu_torch import FSQ, GroupedResidualFSQ, ResidualFSQ
    levels, q, lead = RFSQ_MAIN
    torch.manual_seed(50)
    m = ResidualFSQ(dim=4, levels=list(levels), num_quantizers=q, device=device).eval()
    x = rfsq_input(levels, lead, device, 60)

    def forward(model, xs, **kw):
        reset_all_launches()
        with torch.no_grad():
            out = model(xs, **kw)
        sync(device)
        return out, all_launches()

    (q_auto, idx_auto), launches_auto = forward(m, x)
    check(launches_auto['residual_fsq_fused'] == 1 and sum(launches_auto.values()) == 1,
          f"'auto' eval launched K9 once and nothing else {launches_auto}")
    m.eval_fused = 'off'
    (q_off, idx_off), launches_off = forward(m, x)
    check(sum(launches_off.values()) == 0, f"'off' eval launched nothing {launches_off}")
    check(q_auto.shape == x.shape and idx_auto.shape == (*lead, q) and idx_auto.dtype == torch.int32,
          'ResidualFSQ output shapes')
    shares = rfsq_layer_shares(idx_auto, idx_off, q)
    check(all(s == 1.0 for s in shares[:3]), f"'auto' and 'off' indices equal on the first three layers {shares}")
    auto_off_err = float((q_auto - q_off).abs().max())
    check(auto_off_err <= 2 * deepest_quantum(levels, q), f"'auto' and 'off' values within two quanta ({auto_off_err})")
    with torch.no_grad():
        decoded = m.get_output_from_indices(idx_auto)
    decode_err = float((decoded - q_auto).abs().max())
    check(decode_err <= 1e-6, f'get_output_from_indices(indices) equals the output within 1e-6 ({decode_err})')
    auto_equals_off = torch.equal(q_auto, q_off) and torch.equal(idx_auto, idx_off)
    m.train()
    _, launches_train = forward(m, x)
    check(sum(launches_train.values()) == 0, f'a training forward launched nothing {launches_train}')
    del q_off, idx_off, decoded

    g = GroupedResidualFSQ(dim=8, groups=2, levels=list(levels), num_quantizers=q, device=device).eval()
    xg = torch.cat([x, rfsq_input(levels, lead, device, 61)], -1)
    (gq, gidx), launches_grouped = forward(g, xg)
    check(launches_grouped['residual_fsq_fused'] == 2 and sum(launches_grouped.values()) == 2,
          f'GroupedResidualFSQ (2 groups) launched K9 twice {launches_grouped}')
    with torch.no_grad():
        grouped_decode_err = float((g.get_output_from_indices(gidx) - gq).abs().max())
    check(grouped_decode_err <= 1e-6, f'grouped decode within 1e-6 ({grouped_decode_err})')
    del g, xg, gq, gidx

    rot = ResidualFSQ(dim=4, levels=[5, 5, 5, 5], num_quantizers=q, eval_fused='on', orthogonal_rotation=True,
                      device=device).eval()
    rot_off = ResidualFSQ(dim=4, levels=[5, 5, 5, 5], num_quantizers=q, eval_fused='off', orthogonal_rotation=True,
                          device=device).eval()
    rot_off.load_state_dict(rot.state_dict())
    (rq, ridx), launches_rot = forward(rot, x)
    (rq_off, ridx_off), _ = forward(rot_off, x)
    check(sum(launches_rot.values()) == 0, f"an ineligible 'on' configuration launched nothing {launches_rot}")
    check(torch.equal(rq, rq_off) and torch.equal(ridx, ridx_off), "the ineligible 'on' equals 'off' exactly")
    del rq, ridx, rq_off, ridx_off

    fsq_levels = [8, 5, 5, 5, 5, 5, 5, 5]          # benchmarks/composites_tpu.py:99-102
    fsq = FSQ(fsq_levels, device=device).eval()
    xf = rfsq_input(fsq_levels, lead, device, 62)
    (fq, fidx), launches_fsq = forward(fsq, xf)
    with torch.no_grad():
        fdecoded = fsq.indices_to_codes(fidx)
    check(fidx.shape == lead and fidx.dtype == torch.int32 and torch.equal(fdecoded, fq),
          'FSQ: indices_to_codes(indices) equals the output bit for bit')
    emit('rfsq_eval_path', model=f'ResidualFSQ(dim=4, levels={list(levels)}, num_quantizers={q}).eval()',
         input=list(x.shape), launches_auto=launches_auto, launches_off=launches_off, launches_train=launches_train,
         index_share_equal_auto_vs_off=shares, values_max_abs_diff_auto_vs_off=auto_off_err,
         auto_equals_off_bitwise=auto_equals_off,
         decode_max_abs_err=decode_err,
         grouped=dict(model=f'GroupedResidualFSQ(dim=8, groups=2, levels={list(levels)}, num_quantizers={q}).eval()',
                      input=list(lead) + [8], launches=launches_grouped, decode_max_abs_err=grouped_decode_err),
         ineligible=dict(model="ResidualFSQ(dim=4, levels=[5, 5, 5, 5], eval_fused='on', orthogonal_rotation=True)",
                         launches=launches_rot, equals_off=True),
         fsq=dict(model=f'FSQ({fsq_levels}).eval()', input=list(xf.shape), launches=launches_fsq,
                  decode_bit_identical=True))
    return launches_auto['residual_fsq_fused'], launches_grouped['residual_fsq_fused']


def phase_fsq_train_path(device, sizes):
    """A full-width ResidualFSQ training step against the CPU, and the FSQ
    autoencoder's AdamW steps, step 0 against the CPU."""
    from vqtpu_torch import FSQ, ResidualFSQ, SimpleQuantizeAutoEncoder
    torch.manual_seed(70)
    kw = dict(dim=64, levels=[8, 5, 5, 5], num_quantizers=8, quantize_dropout=True)
    m = ResidualFSQ(**kw, device=device).train()
    ref = ResidualFSQ(**kw, device='cpu').train()
    ref.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(71).standard_normal((8, 1024, 64), dtype=np.float32))
    dropout_index = 3                # layers 0-3 kept, scales down to 5^-3
    dz = {}                          # the gradient at project_in's output, per device

    def keep_dz(name):
        def hook(module, inputs, out):
            out.register_hook(lambda g: dz.__setitem__(name, g.detach()))
        return hook
    m.project_in.register_forward_hook(keep_dz('card'))
    ref.project_in.register_forward_hook(keep_dz('cpu'))
    reset_all_launches()
    xd = x.to(device).requires_grad_()
    q, idx = m(xd, rand_quantize_dropout_index=dropout_index)
    q.square().mean().backward()
    sync(device)
    launches = all_launches()
    check(sum(launches.values()) == 0, f'a ResidualFSQ training step launched nothing {launches}')
    xr = x.detach().clone().requires_grad_()
    q_ref, idx_ref = ref(xr, rand_quantize_dropout_index=dropout_index)
    q_ref.square().mean().backward()
    idx_c = idx.cpu()
    check(bool((idx_c[..., dropout_index + 1:] == -1).all()) and bool((idx_c[..., :dropout_index + 1] >= 0).all()),
          'layers after the dropout index give -1, the others codes')
    shares = rfsq_layer_shares(idx_c, idx_ref, kw['num_quantizers'])
    check(all(s == 1.0 for s in shares[:3]), f'card and CPU indices equal on the layers at scale > 1e-2 {shares}')
    q_err = float((q.detach().cpu() - q_ref.detach()).abs().max())
    check(q_err <= 1e-4, f'card and CPU outputs within 1e-4 ({q_err})')

    def rel(a, ref_):
        return float((a.double() - ref_.double()).abs().max() / ref_.abs().max().clamp_min(1e-30))
    # project_out's gradients follow the quantized values: against the CPU
    out_err = max(rel(p.grad.cpu(), rp.grad) for p, rp in ((m.project_out.weight, ref.project_out.weight),
                                                           (m.project_out.bias, ref.project_out.bias)))
    check(out_err <= 1e-5, f"project_out's gradients match the CPU to 1e-5 ({out_err})")
    # the gradient reaching project_in passes each layer's clip mask, which
    # flips where |r / s| lies within a last-bit difference of 1: the tokens
    # whose dz differs from the CPU's must be few, and the card's backward
    # through project_in is held to float64 on its own dz
    dz_card = dz['card'].cpu().reshape(-1, 4).double()
    dz_diff = ((dz_card - dz['cpu'].reshape(-1, 4).double()).abs() > 1e-5 * dz_card.abs().max()).any(-1)
    check(int(dz_diff.sum()) <= 1e-3 * dz_diff.numel(), f'{int(dz_diff.sum())} tokens with another clip mask')
    x64 = x.reshape(-1, 64).double()
    in_err = max(rel(m.project_in.weight.grad.cpu(), dz_card.T @ x64),
                 rel(m.project_in.bias.grad.cpu(), dz_card.sum(0)),
                 rel(xd.grad.cpu().reshape(-1, 64), dz_card @ m.project_in.weight.detach().cpu().double()))
    check(in_err <= 1e-5, f"project_in's and x's gradients match float64 from the card's dz to 1e-5 ({in_err})")
    residual = dict(model='ResidualFSQ(dim=64, levels=[8, 5, 5, 5], num_quantizers=8, quantize_dropout=True).train()',
                    input=list(x.shape), dropout_index=dropout_index, launches=launches,
                    index_share_equal_vs_cpu=shares, q_max_abs_err_vs_cpu=q_err,
                    project_out_grad_max_rel_err_vs_cpu=out_err, tokens_with_another_clip_mask=int(dz_diff.sum()),
                    project_in_and_x_grad_max_rel_err_vs_float64=in_err)
    del m, ref, xd, xr, q, q_ref

    def build(dev):
        return SimpleQuantizeAutoEncoder(FSQ([8, 6, 5], dim=32, device=dev), dim=32, device=dev).train()

    def loss_of(model, xs):
        recon, indices = model(xs)
        return (recon.clamp(-1, 1) - xs).abs().mean(), indices

    torch.manual_seed(72)
    model = build(device)
    cpu = build('cpu')
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4)
    rng = np.random.default_rng(73)
    images = [rng.random((sizes['images'], 28, 28, 1), dtype=np.float32) for _ in range(sizes['flagship_steps'])]
    x0 = torch.from_numpy(images[0])
    reset_all_launches()
    loss, indices = loss_of(model, x0.to(device))
    loss.backward()
    ref_loss, ref_indices = loss_of(cpu, x0)
    ref_loss.backward()
    sync(device)
    flips = int((indices.cpu() != ref_indices).sum())
    check(flips <= 1e-3 * indices.numel(), f'FSQ flagship step 0: {flips} index flips against the CPU')
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    check(loss_rel <= 1e-4, f'FSQ flagship step 0: loss matches the CPU to 1e-4 ({loss_rel})')
    compared_on = len(x0)
    if flips:
        # a flipped code moves the decoder's input: compare the gradients on the images without one
        keep = (indices.cpu() == ref_indices).all(-1)
        compared_on = int(keep.sum())
        model.zero_grad()
        cpu.zero_grad()
        loss_of(model, x0[keep].to(device))[0].backward()
        loss_of(cpu, x0[keep])[0].backward()
    # the L1 loss's gradient is the sign of clip(recon) - x, which flips on
    # pixels where the card's and the CPU's reconstructions (their
    # convolutions sum in other orders) straddle x: 1e-3 of each gradient's
    # largest entry, as the LFQ flagship
    grad_errs = {name: float((p.grad.cpu() - rp.grad).abs().max() / rp.grad.abs().max().clamp_min(1e-30))
                 for (name, p), (_, rp) in zip(model.named_parameters(), cpu.named_parameters())}
    grad_err = max(grad_errs.values())
    check(grad_err <= 1e-3, f'FSQ flagship step 0: gradients match the CPU to 1e-3 on {compared_on} images ({grad_errs})')
    if flips:
        model.zero_grad()
        loss, indices = loss_of(model, x0.to(device))
        loss.backward()
    opt.step()
    opt.zero_grad()
    losses = [loss.item()]
    for step in range(1, len(images)):
        loss, indices = loss_of(model, torch.from_numpy(images[step]).to(device))
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())
    sync(device)
    flagship_launches = all_launches()
    check(sum(flagship_launches.values()) == 0, f'FSQ has no kernel: the flagship launched nothing {flagship_launches}')
    check(all(np.isfinite(losses)), 'FSQ flagship losses are finite')
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f'the FSQ flagship loss falls ({first} -> {last})')
    emit('fsq_train_path', residual=residual,
         flagship=dict(model='SimpleQuantizeAutoEncoder(FSQ([8, 6, 5], dim=32), dim=32)', optimizer='AdamW(lr=3e-4)',
                       loss='|clip(out, -1, 1) - x|.mean()', input=[sizes['images'], 28, 28, 1], steps=len(images),
                       launches=flagship_launches, loss_first=losses[0], loss_last=losses[-1],
                       loss_mean_first5=first, loss_mean_last5=last,
                       step0_vs_cpu=dict(loss_rel_err=loss_rel, index_flips=flips, grad_max_rel_err=grad_err,
                                         grad_rel_err_by_parameter=grad_errs, grad_compared_on_images=compared_on),
                       codes_used_last_step=int(torch.unique(indices).numel())))


def rfsq_bound_ms(n, d, q):
    """Least time for K9 at n tokens: reading x and writing the values and
    the int32 indices once over 3.35 TB/s, or its f32 operations over
    67 TFLOP/s: per dim a division, a tanh (counted as one) and a multiply
    for the clamp, and per dim and layer two divisions, two compares and
    eleven multiplies, adds and floors."""
    bytes_ms = 4 * (2 * n * d + n * q) / PEAK_BYTES_PER_S * 1e3
    ops_ms = n * d * (3 + 15 * q) / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
                bytes_term_ms=bytes_ms, ops_term_ms=ops_ms)


def rfsq_sass_counts(d, q) -> dict:
    """Opcode counts of K9's (d, q) instantiation from `cuobjdump -sass`. An
    IEEE division by `__fdiv_rn` compiles to an FCHK (its range check) and a
    call of its slow path; the parent kernel had 2 d q + d of each. Neither
    route has one now: the exact route divides by the Markstein sequence and
    the IEEE route by `ieee_quotient` (f64 DFMA, no call), so the count of
    both must be 0. FFMA.SAT counts the exact route's (dim, layer) pairs:
    two index routes x two tokens a thread x d q. Scalar global loads are the
    IEEE route's (its constants, in loops that are not unrolled) and the
    exact route's one check of the scales; the exact route reads its
    constants from the parameter bank (ULDC, or operands c[0x0][...])."""
    funcs = sass_functions('residual_fsq_fused')
    name = next(k for k in funcs if f'residual_fsq_eval_kernelILi{d}ELi{q}E' in k)
    ops = sass_opcodes(funcs[name])
    calls = sum(n for op, n in ops.items() if op.startswith('CALL'))
    check(ops.get('FCHK', 0) == 0 and calls == 0,
          f"K9 ({d}, {q}): no IEEE division subroutine and no call ({ops.get('FCHK', 0)} FCHK, {calls} CALL)")
    return dict(function=name, instructions=sum(ops.values()), fchk=ops.get('FCHK', 0), calls=calls,
                exact_route_pairs_ffma_sat=ops.get('FFMA.SAT', 0), exact_route_pairs=2 * 2 * d * q,
                scalar_global_loads=ops.get('LDG.E.CONSTANT', 0), opcodes=ops)


def phase_rfsq_times(sizes, smi):
    from vqtpu_torch import ResidualFSQ
    from vqtpu_torch.kernels.residual_fsq_fused import fused_residual_fsq_eval, fused_residual_fsq_eval_plain
    levels, q, lead = RFSQ_MAIN
    device = torch.device('cuda')
    n, d = lead[0] * lead[1], len(levels)
    torch.manual_seed(80)
    m = ResidualFSQ(dim=d, levels=list(levels), num_quantizers=q, device=device).eval()
    x = rfsq_input(levels, lead, device, 81)
    xt = x.reshape(n, d)
    kw = dict(levels=levels, clamp=m.soft_clamp_input_value, num_quantizers=q)
    reps = sizes['rfsq_reps']

    def kernel():
        fused_residual_fsq_eval(xt, m._scales(), **kw)

    def plain():
        fused_residual_fsq_eval_plain(xt, m._scales(), **kw)

    # kernel, plain, plain, kernel: one card, alternating
    ka = cuda_ms(kernel, reps)
    pa, pb = (cuda_ms(plain, sizes['rfsq_plain_reps']) for _ in range(2))
    kb = cuda_ms(kernel, reps)

    def forward(route):
        def run():
            m.eval_fused = route
            with torch.no_grad():
                m(x)
        return run

    fwd = {'auto': [], 'off': []}
    for route in ('auto', 'off', 'off', 'auto'):
        fwd[route].append(cuda_ms(forward(route), sizes['rfsq_plain_reps']))
    peak, profiles, launches = {}, {}, {}
    for route in ('auto', 'off'):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        forward(route)()
        torch.cuda.synchronize()
        peak[route] = torch.cuda.max_memory_allocated()
        launches[route] = all_launches()['residual_fsq_fused']
        profiles[route] = profile_device(forward(route), 3)
    check(launches == {'auto': 1, 'off': 0}, f"one K9 launch per 'auto' forward, none per 'off' {launches}")
    fwd_mean = {r: sum(t) / len(t) for r, t in fwd.items()}
    kernel_ms = (ka + kb) / 2
    bound = rfsq_bound_ms(n, d, q)
    sass = rfsq_sass_counts(d, q)
    emit('rfsq_times', shape=dict(tokens=n, d=d, q=q, levels=list(levels)), card=smi, reps=reps,
         kernel_ms=kernel_ms, kernel_ms_runs=[ka, kb], plain_ms=(pa + pb) / 2, plain_ms_runs=[pa, pb], **bound,
         kernel_share_of_bound=bound['bound_ms'] / kernel_ms,
         library_ms=None, library_note='no single PyTorch call computes the chain; forward_ms off is the '
                                       "'off' loop, its composition in PyTorch's elementwise kernels",
         forward_ms=fwd_mean, forward_ms_runs=fwd, tokens_per_s={r: n / (t / 1e3) for r, t in fwd_mean.items()},
         launches_per_forward=launches, peak_allocated_bytes=peak,
         kernel_share_of_auto_forward=kernel_ms / fwd_mean['auto'],
         auto_forward_minus_kernel_ms=fwd_mean['auto'] - kernel_ms, sass_main=sass, profile_forward=profiles,
         profile_note="torch.profiler records no device event in a window whose only kernel is K9 (launched "
                      "through ctypes); kernel_share_of_auto_forward is K9's CUDA-event time over the forward's",
         bound_basis='H100 SXM at 700 W: 3.35 TB/s, 67 TFLOP/s f32')
    return dict(ms=kernel_ms, plain_ms=(pa + pb) / 2, bound_ms=bound['bound_ms'], bound_by=bound['bound_by'],
                library_ms=None, composition_ms=fwd_mean['off'], forward_ms_auto=fwd_mean['auto'],
                forward_ms_off=fwd_mean['off'], auto_forward_minus_kernel_ms=fwd_mean['auto'] - kernel_ms,
                launches_per_forward=launches, instructions_in_code=sass['instructions'])


# -- ResidualVQ and GroupedResidualVQ: K1 and K4 once per layer -----------------------

# ResidualVQ(dim=256, num_quantizers=8, codebook_size=1024) on (32, 2048, 256)
# f32, 65,536 tokens (benchmarks/rvq_overhead_tpu.py:32,53-54): b, n, d, q, c
RVQ_MAIN = (32, 2048, 256, 8, 1024)
# the beam search at 8192 tokens, beam 4 (vqtpu/composite/residual_vq.py:231-233): b, n, beam
RVQ_BEAM = (4, 2048, 4)
# the quantize-dropout index of rvq_train_path: layers 6 and 7 are dropped
RVQ_DROP = 5


def rvq_input(lead, d, device, seed):
    x = np.random.default_rng(seed).standard_normal((*lead, d), dtype=np.float32)
    return torch.from_numpy(x).to(device)


def rvq_scaled_codebooks(model, seed):
    """Codebooks of random rows at the scale a trained residual stack has:
    layer l's rows N(0, 1) * 0.25 * 0.7^l, so that every layer's candidates
    differ in score by far more than rounding (the constructor's uniform
    rows are some 0.003 in each dim, and leave every candidate of a beam
    within 1e-5 of the others in score)."""
    gen = torch.Generator(device='cpu').manual_seed(seed)
    with torch.no_grad():
        for layer, vq in enumerate(model.layers):
            embed = vq._codebook.embed
            rows = torch.randn(embed.shape, generator=gen) * (0.25 * 0.7 ** layer)
            embed.copy_(rows)
            vq._codebook.embed_avg.copy_(rows)


def rvq_with_layer_inputs(model, x, **kw):
    """One forward of a ResidualVQ, and each layer's input (its residual),
    detached: (outputs, [input of layer 0, ...])."""
    inputs = []
    handles = [layer.register_forward_pre_hook(lambda m, args: inputs.append(args[0].detach().clone()))
               for layer in model.layers]
    try:
        out = model(x, **kw)
    finally:
        for h in handles:
            h.remove()
    return out, inputs


def k1_picks_worse(x, embed, bias, idx_k1, idx_other, rel=1e-5):
    """Tokens where K1's pick scores below another selection's pick in
    float64 by more than the near-tie margin of selection_disagreements."""
    a, b = idx_k1.reshape(-1).long(), idx_other.reshape(-1).long()
    differ = (a != b).nonzero().reshape(-1)
    if differ.numel() == 0:
        return 0
    xd = x.reshape(-1, x.shape[-1])[differ].double()
    ea, eb = embed[a[differ]].double(), embed[b[differ]].double()
    sa = (xd * ea).sum(-1) + bias[a[differ]].double()
    sb = (xd * eb).sum(-1) + bias[b[differ]].double()
    xn = xd.norm(dim=-1)
    scale = torch.stack([sa.abs(), sb.abs(), xn * ea.norm(dim=-1), xn * eb.norm(dim=-1)]).amax(0)
    return int((sb - sa > rel * scale).sum())


def rvq_layers_vs_plain(model, idx, inputs, device):
    """Each layer's K1 selection on that layer's input against two CPU
    selections: the kernel's plain version (the same formulation), equal
    but for near-ties; and the JAX package's formulation (argmax of
    -cdist_sq, the `use_pallas=False` route), whose f32 rounding of
    ||x||^2 can exceed the near-tie margin when ||x|| >> ||e||, so there K1's
    pick must score no worse in float64 but for near-ties. Returns the
    per-layer reports and the second selection's indices."""
    from vqtpu_torch.kernels.distance import (
        nearest_code_plain, nearest_code_xla, selection_bias, selection_disagreements,
    )
    reports, xla_idx = [], []
    for layer, (vq, xl) in enumerate(zip(model.layers, inputs)):
        embed = vq.codebook
        bias = selection_bias(embed, 'euclidean')
        xs = xl.reshape(-1, xl.shape[-1])
        picks = idx[..., layer].reshape(-1)
        plain = nearest_code_plain(xs.cpu(), embed.cpu(), bias.cpu()).to(device)
        r = selection_disagreements(xs, embed, bias, picks, plain)
        check(r['non_tie'] == 0, f'layer {layer}: indices disagree with the CPU plain version beyond near-ties {r}')
        xla = nearest_code_xla(xs.cpu(), embed.cpu()).to(device)
        worse = k1_picks_worse(xs, embed, bias, picks, xla)
        check(worse == 0, f'layer {layer}: {worse} K1 picks score below the CPU -cdist route\'s beyond near-ties')
        r['vs_cdist_route'] = dict(disagree=int((picks != xla).sum()), k1_worse=worse)
        reports.append(r)
        xla_idx.append(xla)
    return reports, torch.stack(xla_idx, -1)


def phase_rvq_eval_path(device):
    """ResidualVQ(dim=256, num_quantizers=8, codebook_size=1024).eval() on
    65,536 tokens: one K1 launch a layer; each layer's indices against the
    CPU selections on that layer's input (rvq_layers_vs_plain), and the
    whole model against the same weights on the CPU's -cdist route
    (use_pallas=False); the output the sum of the looked-up rows and the
    decode bit for bit; then GroupedResidualVQ(dim=256, groups=2,
    num_quantizers=4, codebook_size=1024) on the same input."""
    from vqtpu_torch import GroupedResidualVQ, ResidualVQ
    b, n, d, q, c = RVQ_MAIN
    torch.manual_seed(90)
    rvq = ResidualVQ(dim=d, num_quantizers=q, codebook_size=c, device=device).eval()
    rvq_scaled_codebooks(rvq, 89)
    x = rvq_input((b, n), d, device, 91)
    reset_all_launches()
    with torch.no_grad():
        (out, idx, losses), inputs = rvq_with_layer_inputs(rvq, x)
    sync(device)
    launches = all_launches()
    check(launches['nearest_code'] == q and sum(launches.values()) == q,
          f'the eval forward launched K1 once a layer and nothing else {launches}')
    check(out.shape == x.shape and idx.shape == (b, n, q) and idx.dtype == torch.int32 and losses.shape == (q,),
          'ResidualVQ output shapes')
    rows_sum = None
    for layer, codebook in enumerate(rvq.codebooks):
        rows = codebook[idx[..., layer].long()]
        rows_sum = rows if rows_sum is None else rows_sum + rows
    check(torch.equal(out, rows_sum), 'the output is the sum of the looked-up rows')
    with torch.no_grad():
        decoded = rvq.get_output_from_indices(idx)
    check(torch.equal(decoded, out), 'get_output_from_indices(indices) equals the forward bit for bit')
    reports, layer_cpu = rvq_layers_vs_plain(rvq, idx, inputs, device)

    # the whole model on the CPU's -cdist route: a token may differ only
    # from a layer where the two selections on the same input differ
    cpu = ResidualVQ(dim=d, num_quantizers=q, codebook_size=c, use_pallas=False, device='cpu').eval()
    cpu.load_state_dict({k: v.cpu() for k, v in rvq.state_dict().items()})
    with torch.no_grad():
        _, cpu_idx, _ = cpu(x.cpu())
    differ = (cpu_idx.to(device) != idx).reshape(-1, q)
    tokens_differ = differ.any(-1)
    first = differ.float().argmax(-1)
    flat, flat_cpu = idx.reshape(-1, q), layer_cpu.reshape(-1, q)
    at_first = flat.gather(1, first[:, None]) != flat_cpu.gather(1, first[:, None])
    unexplained = int((tokens_differ & ~at_first[:, 0]).sum())
    check(unexplained == 0, f'{unexplained} tokens differ from the CPU model without a layer selection to explain it')
    del cpu, inputs

    grouped = GroupedResidualVQ(dim=d, groups=2, num_quantizers=4, codebook_size=c, device=device).eval()
    reset_all_launches()
    with torch.no_grad():
        gq, gidx, _ = grouped(x)
    sync(device)
    grouped_launches = all_launches()
    check(grouped_launches['nearest_code'] == 8 and sum(grouped_launches.values()) == 8,
          f'GroupedResidualVQ launched K1 once a layer and group {grouped_launches}')
    with torch.no_grad():
        check(torch.equal(grouped.get_output_from_indices(gidx), gq), 'grouped decode equals the forward')
    emit('rvq_eval_path', model=f'ResidualVQ(dim={d}, num_quantizers={q}, codebook_size={c}).eval()',
         input=list(x.shape), launches=launches['nearest_code'], launches_all=launches,
         per_layer_vs_cpu=reports, tokens_differing_from_cpu_cdist_model=int(tokens_differ.sum()),
         grouped_model=f'GroupedResidualVQ(dim={d}, groups=2, num_quantizers=4, codebook_size={c}).eval()',
         grouped_launches=grouped_launches['nearest_code'], output_is_sum_of_rows=True, decode_bit_for_bit=True)
    return rvq, x, launches['nearest_code'], grouped_launches['nearest_code']


def beam_search_reference64(x, codebooks, beam, weights, rel=1e-5):
    """The beam search of ResidualVQ in float64, independent of the port:
    each beam's `beam` nearest codes, scored by the running score minus the
    weighted MSE of the candidate to the beam's residual, the best `beam`
    kept (stable order), then the best beam. x (N, d), codebooks [(c, d)] ->
    (indices (N, q), score (N,), the smallest relative margin a near-tie
    could flip (N,): between the k-th and (k+1)-th candidate of a beam,
    the beam-th and next score at a prune, the best and second beam)."""
    n, d = x.shape
    r = x.double()[:, None, :]
    scores = torch.zeros(n, 1, dtype=torch.float64, device=x.device)
    paths = torch.zeros(n, 1, 0, dtype=torch.long, device=x.device)
    margin = torch.full((n,), float('inf'), dtype=torch.float64, device=x.device)

    def gap(a, b):
        return (a - b).abs() / torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)

    for layer, (e, w) in enumerate(zip(codebooks, weights)):
        e = e.double()
        j = r.shape[1]
        d2 = (r ** 2).sum(-1, keepdim=True) - 2 * r @ e.T + (e ** 2).sum(-1)      # (N, j, c)
        near, cand = torch.sort(d2, dim=-1, stable=True)
        margin = torch.minimum(margin, gap(near[..., beam], near[..., beam - 1]).amin(-1))
        cand = cand[..., :beam]                                                   # (N, j, k)
        rows = e[cand]                                                            # (N, j, k, d)
        loss = ((rows - r[:, :, None, :]) ** 2).mean(-1)
        s = (scores[:, :, None] - w * loss).reshape(n, j * beam)
        new_r = (r[:, :, None, :] - rows).reshape(n, j * beam, d)
        new_paths = torch.cat((paths[:, :, None, :].expand(n, j, beam, layer), cand[..., None]), -1)
        new_paths = new_paths.reshape(n, j * beam, layer + 1)
        if j * beam > beam:
            ranked, order = torch.sort(s, dim=-1, descending=True, stable=True)
            margin = torch.minimum(margin, gap(ranked[:, beam - 1], ranked[:, beam]))
            keep = order[:, :beam]
            scores = ranked[:, :beam]
            r = new_r.gather(1, keep[..., None].expand(n, beam, d))
            paths = new_paths.gather(1, keep[..., None].expand(n, beam, layer + 1))
        else:
            scores, r, paths = s, new_r, new_paths
    ranked, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    margin = torch.minimum(margin, gap(ranked[:, 0], ranked[:, 1]))
    best = order[:, 0]
    return paths[torch.arange(n, device=x.device), best], ranked[:, 0], margin


def phase_rvq_beam_path(rvq, device, rel=1e-5):
    """ResidualVQ(dim=256, num_quantizers=8, codebook_size=1024,
    beam_size=4).eval() on 8192 tokens, the eval model's weights (its
    codebooks from rvq_scaled_codebooks): no kernel
    launch (the beam materializes its distances); indices against the beam
    search in float64, equal but for tokens with a near-tie on their search;
    beam_size=1 gives the greedy forward."""
    from vqtpu_torch import ResidualVQ
    b, n, beam = RVQ_BEAM
    _, _, d, q, c = RVQ_MAIN
    model = ResidualVQ(dim=d, num_quantizers=q, codebook_size=c, beam_size=beam, device=device).eval()
    model.load_state_dict(rvq.state_dict())
    x = rvq_input((b, n), d, device, 95)
    reset_all_launches()
    with torch.no_grad():
        out, idx, losses = model(x)
    sync(device)
    launches = all_launches()
    check(sum(launches.values()) == 0, f'the beam forward launched no kernel {launches}')
    check(out.shape == x.shape and idx.shape == (b, n, q) and losses.shape == (q,), 'beam output shapes')
    ref_idx, ref_score, margin = beam_search_reference64(x.reshape(-1, d), list(model.codebooks), beam,
                                                         model.beam_score_weights)
    differ = (idx.reshape(-1, q).long() != ref_idx).any(-1)
    near_tie = margin <= rel
    unexplained = int((differ & ~near_tie).sum())
    check(unexplained == 0, f'{unexplained} beam paths differ from float64 without a near-tie on their search')
    # the port's paths scored in float64 against the reference's best
    r64 = x.reshape(-1, d).double()
    own = torch.zeros_like(ref_score)
    for layer, (cb, w) in enumerate(zip(model.codebooks, model.beam_score_weights)):
        rows = cb.double()[idx.reshape(-1, q)[:, layer].long()]
        own -= w * ((rows - r64) ** 2).mean(-1)
        r64 = r64 - rows
    score_gap = ((own - ref_score) / ref_score.abs()).abs()
    rows_sum = sum(cb[idx[..., layer].long()] for layer, cb in enumerate(model.codebooks))
    check(bool(torch.allclose(out, rows_sum, atol=1e-5)), 'the beam output is the sum of its rows')

    reset_all_launches()
    with torch.no_grad():
        _, one_idx, _ = model(x, beam_size=1)
    sync(device)
    greedy_launches = all_launches()['nearest_code']
    with torch.no_grad():
        _, greedy_idx, _ = rvq(x)
    check(torch.equal(one_idx, greedy_idx) and greedy_launches == q,
          f'beam_size=1 gives the greedy forward, one K1 launch a layer ({greedy_launches})')
    with torch.no_grad():
        greedy_mse = float(((rvq.get_output_from_indices(greedy_idx) - x) ** 2).mean())
    beam_mse = float(((out - x) ** 2).mean())
    emit('rvq_beam_path', model=f'ResidualVQ(dim={d}, num_quantizers={q}, codebook_size={c}, beam_size={beam}).eval()',
         input=list(x.shape), launches=launches, tokens=b * n, paths_differing_from_float64=int(differ.sum()),
         near_tie_tokens=int(near_tie.sum()), unexplained=unexplained,
         max_rel_score_gap_of_differing_paths=float(score_gap[differ].max()) if bool(differ.any()) else 0.0,
         beam_mse=beam_mse, greedy_mse=greedy_mse,
         beam_size_one_launches=greedy_launches, beam_size_one_is_greedy=True)
    return model, x


def phase_rvq_train_path(device, sizes):
    """ResidualVQ(dim=256, num_quantizers=8, codebook_size=1024,
    quantize_dropout=True).train() on 65,536 tokens, dropout index 5, 3
    forward + backward steps with train_fused='on' and a twin with 'off'
    from the same state: K4 once a layer a step on 'on', K1 on 'off'; step 0
    identical on both routes; each route's kept layers every step held to
    the plain selection and to one float64 EMA step from their own indices
    and state; the dropped layers' codebooks unchanged."""
    from vqtpu_torch import ResidualVQ
    from vqtpu_torch.kernels.distance import nearest_code_plain, selection_bias, selection_disagreements
    b, n, d, q, c = RVQ_MAIN
    torch.manual_seed(92)
    models = {route: ResidualVQ(dim=d, num_quantizers=q, codebook_size=c, quantize_dropout=True,
                                train_fused=route, device=device).train() for route in ('on', 'off')}
    models['off'].load_state_dict(models['on'].state_dict())
    gen = np.random.default_rng(93)
    batches = [torch.from_numpy(gen.standard_normal((b, n, d), dtype=np.float32)).to(device)
               for _ in range(sizes['train_steps'])]
    decay, eps = models['on'].layers[0]._codebook.decay, models['on'].layers[0]._codebook.eps
    runs, ema_share, loss_err = {}, 0.0, 0.0
    for route, model in models.items():
        reset_all_launches()
        steps = []
        for s, batch in enumerate(batches):
            prev = [(vq.codebook.clone(), vq._codebook.cluster_size[0].clone(), vq._codebook.embed_avg[0].clone())
                    for vq in model.layers]
            xg = batch.clone().requires_grad_()
            (out, idx, losses), inputs = rvq_with_layer_inputs(model, xg, rand_quantize_dropout_index=RVQ_DROP)
            (out.square().mean() + losses.sum()).backward()
            sync(device)
            check(bool(torch.isfinite(xg.grad).all()), f'{route} step {s}: x.grad is finite')
            for layer, (vq, (embed0, cs0, ea0), xl) in enumerate(zip(model.layers, prev, inputs)):
                cb = vq._codebook
                if layer > RVQ_DROP:
                    check(bool((idx[..., layer] == -1).all()) and float(losses[layer].detach()) == 0.0,
                          f'{route} step {s} layer {layer}: dropped (index -1, loss 0)')
                    check(torch.equal(vq.codebook, embed0) and torch.equal(cb.cluster_size[0], cs0)
                          and torch.equal(cb.embed_avg[0], ea0), f'{route} step {s} layer {layer}: codebook unchanged')
                    continue
                xs = xl.reshape(-1, d)
                il = idx[..., layer].reshape(-1)
                bias = selection_bias(embed0, 'euclidean')
                r = selection_disagreements(xs, embed0, bias, il, nearest_code_plain(xs, embed0, bias))
                check(r['non_tie'] == 0, f'{route} step {s} layer {layer}: indices vs the plain selection {r}')
                loss64 = float((xs.double() - embed0[il.long()].double()).square().mean())
                err = abs(float(losses[layer].detach()) - loss64) / loss64
                check(err <= 1e-5, f'{route} step {s} layer {layer}: loss within 1e-5 of float64 ({err})')
                loss_err = max(loss_err, err)
                cs, ea, cs_bound, ea_bound = ema_step_reference(xs, il, cs0, ea0, decay)
                smoothed, _ = smoothed_sizes(cb.cluster_size[0], eps)
                e_ref = cb.embed_avg[0].double() / smoothed[:, None]
                for name, got, ref, bound in (('cluster_size', cb.cluster_size[0], cs, cs_bound),
                                              ('embed_avg', cb.embed_avg[0], ea, ea_bound),
                                              ('embed', vq.codebook, e_ref, 8 * U32 * e_ref.abs())):
                    share = float(((got.double() - ref).abs() / bound.clamp_min(1e-300)).max())
                    check(share <= 1.0, f'{route} step {s} layer {layer}: {name} within the f32 bound of one '
                                        f'float64 EMA step ({share})')
                    ema_share = max(ema_share, share)
            steps.append(dict(idx=idx, out=out.detach(), losses=losses.detach(),
                              grad=xg.grad if s == 0 else None,
                              cluster_size=[vq._codebook.cluster_size.clone() for vq in model.layers] if s == 0 else None))
            del inputs, xg
        runs[route] = dict(steps=steps, launches=all_launches())
    on, off = runs['on'], runs['off']
    steps_n = len(batches)
    check(on['launches']['train_fused'] == q * steps_n and on['launches']['nearest_code'] == 0,
          f"'on' launched K4 once a layer a step, dropped layers included, and no K1 {on['launches']}")
    check(off['launches']['nearest_code'] == q * steps_n and off['launches']['train_fused'] == 0,
          f"'off' launched K1 once a layer a step and no K4 {off['launches']}")
    a, b0 = on['steps'][0], off['steps'][0]
    for name in ('idx', 'out', 'losses', 'grad'):
        check(torch.equal(a[name], b0[name]), f'step 0: the routes give the same {name}')
    check(all(torch.equal(x_, y_) for x_, y_ in zip(a['cluster_size'], b0['cluster_size'])),
          'step 0: the routes give the same cluster sizes')
    flips = [int((x_['idx'] != y_['idx']).sum()) for x_, y_ in zip(on['steps'], off['steps'])]
    emit('rvq_train_path', model=f'ResidualVQ(dim={d}, num_quantizers={q}, codebook_size={c}, '
                                 'quantize_dropout=True).train()',
         input=list(batches[0].shape), steps=steps_n, dropout_index=RVQ_DROP,
         launches_on=on['launches'], launches_off=off['launches'],
         losses_on=[t['losses'].tolist() for t in on['steps']], losses_off=[t['losses'].tolist() for t in off['steps']],
         index_flips_between_routes_per_step=flips, step0_identical=['indices', 'output', 'losses', 'x.grad',
                                                                     'cluster_size'],
         ema_step_share_of_bound=ema_share, loss_rel_err_vs_float64=loss_err, dropped_layers_unchanged=True)
    return models, batches[0], on['launches']['train_fused'] // steps_n, off['launches']['nearest_code'] // steps_n


def phase_rvq_flagship_train(device, sizes):
    """The RQ-VAE of examples/autoencoder_rvq.py (BASELINE.json config 4):
    SimpleQuantizeAutoEncoder(ResidualVQ(dim=32, num_quantizers=8,
    codebook_size=256, kmeans_init=True, shared_codebook=True,
    stochastic_sample_codes=True, sample_codebook_temp=0.1), dim=32), 50
    AdamW steps at batch 256. Step 0 against the same weights on the CPU,
    with the gumbel noise and kmeans' rows given to both; no kernel in
    training (stochastic codes take the distance path); the eval forward
    after training launches K1 once a layer."""
    import vqtpu_torch.codebook.kmeans as tkmeans
    import vqtpu_torch.core.sampling as tsampling
    from vqtpu_torch import ResidualVQ, SimpleQuantizeAutoEncoder
    from vqtpu_torch.core.metrics import codebook_perplexity
    alpha = 10.0    # examples/autoencoder_rvq.py
    q = 8

    def build(dev):
        return SimpleQuantizeAutoEncoder(
            ResidualVQ(dim=32, num_quantizers=q, codebook_size=256, kmeans_init=True, shared_codebook=True,
                       stochastic_sample_codes=True, sample_codebook_temp=0.1, device=dev),
            dim=32, device=dev,
        ).train()

    def loss_of(model, x):
        out, idx, cmt = model(x)
        rec = (out.clamp(-1, 1) - x).abs().mean()
        return rec + alpha * cmt.sum(), rec, idx

    torch.manual_seed(96)
    model = build(device)
    ref = build('cpu')
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    rng = np.random.default_rng(97)
    images = [rng.random((sizes['images'], 28, 28, 1), dtype=np.float32) for _ in range(sizes['flagship_steps'])]

    # step 0 on both devices, with the same noise (drawn on the CPU, call by
    # call on each side) and the same kmeans rows
    calls = {'n': 0}
    draw_noise, draw_means = tsampling.gumbel_noise, tkmeans.sample_means

    def same_noise(gen, shape, device=None):
        calls['n'] += 1
        return draw_noise(torch.Generator().manual_seed(1000 + calls['n']), shape).to(device)

    def same_means(gen, samples, mask, num):
        rows = torch.from_numpy(np.random.default_rng(98).integers(0, samples.shape[1], num)).to(samples.device)
        return samples[:, rows]

    tsampling.gumbel_noise, tkmeans.sample_means = same_noise, same_means
    try:
        x = torch.from_numpy(images[0])
        reset_all_launches()
        loss, rec, idx = loss_of(model, x.to(device))
        loss.backward()
        sync(device)
        step0_launches = all_launches()
        draws = [calls['n']]
        calls['n'] = 0
        ref_loss, ref_rec, ref_idx = loss_of(ref, x)
        ref_loss.backward()
        draws.append(calls['n'])
    finally:
        tsampling.gumbel_noise, tkmeans.sample_means = draw_noise, draw_means
    check(draws == [q, q], f'each side drew the noise once a layer {draws}')
    agree = float((idx.cpu() == ref_idx).float().mean())
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    cb, rcb = model.quantizer.layers[0]._codebook, ref.quantizer.layers[0]._codebook
    embed_err = float((cb.embed.cpu() - rcb.embed).abs().max() / rcb.embed.abs().max())
    check(agree >= 0.99 and loss_rel <= 1e-3,
          f'flagship step 0 matches the CPU (index agreement {agree}, loss {loss_rel})')
    grad_err = 0.0
    if agree == 1.0:
        for (name, p), (_, rp) in zip(model.named_parameters(), ref.named_parameters()):
            err = float((p.grad.cpu() - rp.grad).abs().max() / rp.grad.abs().max().clamp_min(1e-30))
            grad_err = max(grad_err, err)
        check(grad_err <= 1e-3 and embed_err <= 1e-4,
              f'flagship step 0: gradients and the shared codebook match the CPU ({grad_err}, {embed_err})')
    check(all(layer._codebook is cb for layer in model.quantizer.layers), 'one codebook shared by every layer')
    opt.step()
    opt.zero_grad()

    losses, recs = [loss.item()], [rec.item()]
    reset_all_launches()
    for step in range(1, len(images)):
        loss, rec, idx = loss_of(model, torch.from_numpy(images[step]).to(device))
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())
        recs.append(rec.item())
    sync(device)
    train_launches = all_launches()
    check(sum(step0_launches.values()) == 0 and sum(train_launches.values()) == 0,
          f'training takes the distance path, no kernel ({step0_launches}, {train_launches})')
    check(all(np.isfinite(losses)), 'flagship losses are finite')
    first, last = float(np.mean(recs[:5])), float(np.mean(recs[-5:]))
    check(last < first, f'the reconstruction loss falls ({first} -> {last})')
    model.eval()
    reset_all_launches()
    with torch.no_grad():
        recon, eval_idx, _ = model(torch.from_numpy(images[0]).to(device))
    sync(device)
    eval_launches = all_launches()
    check(eval_launches['nearest_code'] == q and sum(eval_launches.values()) == q,
          f'the trained flagship eval forward launched K1 once a layer {eval_launches}')
    check(bool(torch.isfinite(recon).all()) and eval_idx.shape == (sizes['images'], 49, q), 'flagship eval output')
    emit('rvq_flagship_train',
         model='SimpleQuantizeAutoEncoder(ResidualVQ(dim=32, num_quantizers=8, codebook_size=256, kmeans_init=True, '
               'shared_codebook=True, stochastic_sample_codes=True, sample_codebook_temp=0.1), dim=32)',
         optimizer='AdamW(lr=3e-4, weight_decay=1e-4)', input=[sizes['images'], 28, 28, 1], steps=len(images),
         loss='|clip(out) - x|.mean() + 10 * commit.sum()', loss_first=losses[0], loss_last=losses[-1],
         rec_mean_first5=first, rec_mean_last5=last, train_launches=train_launches, eval_launches=eval_launches,
         step0_vs_cpu=dict(index_agreement=agree, loss_rel_err=loss_rel, shared_embed_rel_err=embed_err,
                           grad_max_rel_err=grad_err),
         codebook_perplexity_per_layer=[float(codebook_perplexity(eval_idx[..., i], 256)) for i in range(q)])
    return model, eval_launches['nearest_code']


def phase_rvq_times(rvq, x, beam_model, xb, train_models, train_x, sizes, smi):
    """CUDA events at the slice's shapes: the ResidualVQ eval forward, K1 on
    one layer's operands against its 3xTF32 bound, their share, a profile of
    the forward; the beam forward; a training step per route; a flagship
    AdamW step."""
    from vqtpu_torch import ResidualVQ, SimpleQuantizeAutoEncoder
    from vqtpu_torch.kernels.distance import quantize_lookup
    b, n, d, q, c = RVQ_MAIN
    tokens = b * n
    reps = sizes['rvq_reps']

    def forward():
        with torch.no_grad():
            rvq(x)

    layer0 = x.reshape(-1, d).contiguous()
    embed = rvq.layers[0]._codebook.embed[0].contiguous()

    def k1():
        quantize_lookup(layer0, embed)

    fa = cuda_ms(forward, reps)
    ka, kb = cuda_ms(k1, 2 * reps), cuda_ms(k1, 2 * reps)
    fb = cuda_ms(forward, reps)
    fwd_ms, k1_ms = (fa + fb) / 2, (ka + kb) / 2
    bound, bound_by = selection_bound_tc_ms(tokens, c, d)
    profile = profile_device(forward, 3)

    def beam():
        with torch.no_grad():
            beam_model(xb)
    beam_ms = cuda_ms(beam, sizes['rvq_beam_reps'], warmup=1)
    beam_profile = profile_device(beam, 1)

    train_x = train_x.clone().requires_grad_()

    def train_step(model):
        def run():
            out, _, losses = model(train_x, rand_quantize_dropout_index=RVQ_DROP)
            (out.square().mean() + losses.sum()).backward()
        return run
    step_ms = {route: [] for route in train_models}
    for route in ('on', 'off', 'off', 'on'):
        step_ms[route].append(cuda_ms(train_step(train_models[route]), sizes['rvq_step_reps'], warmup=1))

    torch.manual_seed(99)
    flagship = SimpleQuantizeAutoEncoder(
        ResidualVQ(dim=32, num_quantizers=8, codebook_size=256, kmeans_init=True, shared_codebook=True,
                   stochastic_sample_codes=True, sample_codebook_temp=0.1, device='cuda'),
        dim=32, device='cuda').train()
    opt = torch.optim.AdamW(flagship.parameters(), lr=3e-4, weight_decay=1e-4)
    imgs = torch.from_numpy(np.random.default_rng(100).random((sizes['images'], 28, 28, 1), dtype=np.float32)).cuda()

    def flagship_step():
        out, _, cmt = flagship(imgs)
        ((out.clamp(-1, 1) - imgs).abs().mean() + 10.0 * cmt.sum()).backward()
        opt.step()
        opt.zero_grad()
    flagship_ms = cuda_ms(flagship_step, sizes['rvq_step_reps'], warmup=2)
    step_mean = {r: sum(t) / len(t) for r, t in step_ms.items()}
    emit('rvq_times', card=smi, shape=dict(tokens=tokens, d=d, q=q, c=c), reps=reps,
         forward_ms=fwd_ms, forward_ms_runs=[fa, fb], vectors_per_s=tokens / (fwd_ms / 1e3),
         k1_layer_ms=k1_ms, k1_layer_ms_runs=[ka, kb], k1_layer_bound_ms=bound, k1_bound_by=bound_by,
         k1_share_of_bound=bound / k1_ms, k1_forward_ms=q * k1_ms, k1_forward_bound_ms=q * bound,
         k1_share_of_forward=q * k1_ms / fwd_ms, forward_outside_k1_ms=fwd_ms - q * k1_ms,
         profile_forward=profile,
         profile_note='K1 is launched through ctypes, and torch.profiler may show no event of it; '
                      'k1_share_of_forward is CUDA-event time',
         beam_model=f'beam_size={RVQ_BEAM[2]} on {RVQ_BEAM[0] * RVQ_BEAM[1]} tokens', beam_forward_ms=beam_ms,
         profile_beam_forward=beam_profile,
         train_step_ms=step_mean, train_step_ms_runs=step_ms, train_step='forward + backward, loss mean(q^2) + '
         f'losses.sum(), dropout index {RVQ_DROP}',
         flagship_step_ms=flagship_ms, flagship_step='AdamW step of the RQ-VAE at batch 256',
         bound_basis='H100 SXM at 700 W: 495 TFLOP/s dense TF32 (3 products), 3.35 TB/s')
    return dict(rvq_forward_ms=fwd_ms, rvq_k1_layer_ms=k1_ms, rvq_k1_layer_bound_ms=bound,
                rvq_beam_forward_ms=beam_ms, rvq_train_step_ms=step_mean, rvq_flagship_step_ms=flagship_ms)


# -- the learnable-codebook slice: paths 1-6 ---------------------------------------

# the README's learnable VectorQuantize on the shape of
# benchmarks/train_step_tpu.py:19: batch, tokens, dim, codes
LEARN_MAIN = (1024, 1024, 256, 512)
# QINCo ResidualVQ (README.md:235-237): layers, dim, codes
QINCO_MAIN = (8, 256, 1024)
CODE_SUMS_REPLACES = 'vqtpu/kernels/train_fused.py:61'
CODE_SUMS_DESIGN = ("train_fused.cu's statistics by sorted code (passes a-f) on the rows' gradients: a stable "
                    'counting sort by code, then warps over pieces of 64 tokens in token order; no float atomic')


def code_sums_bound_ms(n: int, c: int, d: int) -> tuple[float, str]:
    """Least time for the per-code sums of (n, d) rows: reading the rows and
    their n int32 codes once and writing (c, d) sums and (c,) counts once,
    or the n d adds at the f32 peak."""
    bytes_ms = 4 * (n * d + n + c * d + c) / PEAK_BYTES_PER_S * 1e3
    ops_ms = n * d / PEAK_F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), 'bytes' if bytes_ms >= ops_ms else 'operations'


def code_sums_check(case, g, idx, c):
    """code_sums on CUDA rows `g` (n, d) and their codes against a float64
    per-code sum (within the f32 summation bound) and the plain version
    (index_put_), two calls bit-identical; returns the report."""
    from vqtpu_torch.kernels.train_fused import code_statistics_plain, code_sums
    before = code_sums.launches
    bins, esum = code_sums(g, idx, c)
    bins2, esum2 = code_sums(g, idx, c)
    sync(g.device)
    check(code_sums.launches == before + 2, f'{case}: code_sums launched its kernel twice')
    check(torch.equal(bins, bins2) and torch.equal(esum, esum2), f'{case}: two calls bit-identical')
    ref = stats_reference(g[None], idx[None], c, None)
    check(torch.equal(bins.double(), ref[2][0]), f'{case}: bins are the exact counts')
    err, share = esum_within_bound(esum[None], ref)
    check(share <= 1.0, f'{case}: sums within the f32 summation bound of float64 ({share})')
    pbins, pesum = code_statistics_plain(g[None], idx[None], c)
    plain_err, plain_share = esum_within_bound(pesum, ref)
    return dict(case=case, rows=list(g.shape), codes=c, max_abs_err=err, share_of_bound=share,
                plain_max_abs_err=plain_err, plain_share_of_bound=plain_share, bit_identical=True)


def phase_code_sums(device, sizes):
    """K4's statistics as the backward of the learnable lookup
    (`code_sums`, `lookup_with_code_grad`) at the learnable path's shape,
    codes from K1 on a codebook of data rows, and at the DiVeQ stack's
    (65,536 rows, 1024 codes): against float64 and the plain version, two
    calls bit-identical; the lookup's codebook gradient against a float64
    per-code sum and bit-identical across two backward passes; times of the
    kernel, the plain version, index_add_ and the bound."""
    from vqtpu_torch.kernels.distance import quantize_lookup
    from vqtpu_torch.kernels.train_fused import code_statistics_plain, code_sums, lookup_with_code_grad
    b, t, d, c = sizes['learn_main']
    n = b * t
    x_main = torch.from_numpy(np.random.default_rng(39).standard_normal((n, d), dtype=np.float32)).to(device)
    e_main = data_rows_codebook(x_main, c)
    idx, _ = quantize_lookup(x_main, e_main)
    g = torch.from_numpy(np.random.default_rng(40).standard_normal((n, d), dtype=np.float32)).to(device)
    reports = [code_sums_check('learnable main shape', g, idx, c)]
    small = sizes['code_sums_rvq']
    gi = torch.from_numpy(np.random.default_rng(41).integers(0, small[1], small[0]).astype(np.int32)).to(device)
    reports.append(code_sums_check('DiVeQ stack shape', g[:small[0]].contiguous(), gi, small[1]))

    # the lookup: rows from K1, the codebook's gradient by code_sums
    grads = []
    for _ in range(2):
        e = e_main.clone().requires_grad_()
        li, rows = lookup_with_code_grad(x_main, e)
        (rows * g).sum().backward()
        grads.append(e.grad)
    sync(device)
    check(torch.equal(li, idx), 'the learnable lookup selects as quantize_lookup')
    check(torch.equal(grads[0], grads[1]), 'the learnable codebook gradient is bit-identical across two calls')
    err, share = esum_within_bound(grads[0][None], stats_reference(g[None], idx[None], c, None))
    check(share <= 1.0, f'the lookup gradient within the f32 bound of a float64 per-code sum ({share})')

    reps = sizes['reps']
    lib = torch.zeros(c, d, device=device)
    idx64 = idx.long()

    def kernel():
        code_sums(g, idx, c)

    def plain():
        code_statistics_plain(g[None], idx[None], c)

    def library():
        lib.zero_().index_add_(0, idx64, g)
    launches = code_sums.launches
    ka = cuda_ms(kernel, reps)
    pa = cuda_ms(plain, reps)
    la = cuda_ms(library, reps)
    kb = cuda_ms(kernel, reps)
    code_sums.launches = launches
    bound, bound_by = code_sums_bound_ms(n, c, d)
    ms = (ka + kb) / 2
    emit('code_sums', cases=reports, lookup_grad=dict(max_abs_err=err, share_of_bound=share, bit_identical=True),
         ms=ms, ms_runs=[ka, kb], plain_ms=pa, library_ms=la, library='index_add_ (index_select backward)',
         bound_ms=bound, bound_by=bound_by, share_of_bound=bound / ms, shape=dict(n=n, c=c, d=d))
    return dict(ms=ms, plain_ms=pa, library_ms=la, bound_ms=bound, bound_by=bound_by,
                max_abs_err=max(r['max_abs_err'] for r in reports), lookup_max_abs_err=err)


def learnable_step(model, x, g, **kw):
    """One training forward + backward with the cotangent g on the output;
    returns (x.grad, quantized, indices, loss, breakdown)."""
    xg = x.clone().requires_grad_()
    q, idx, loss, breakdown = model(xg, return_loss_breakdown=True, **kw)
    ((q * g).sum() + loss).backward()
    return xg.grad, q.detach(), idx, loss.detach(), [float(t.detach()) for t in breakdown]


def rel_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


def timed_step(step, reps, warmup=1) -> dict:
    """A step's mean CUDA-event time, and a device profile of one step."""
    ms = cuda_ms(step, reps, warmup=warmup)
    return dict(step_ms=ms, profile=profile_device(step, 1))


def commit_grad_reference(embed, x, idx, c):
    """float64 codebook gradient of the MSE commitment loss mean((e[idx] -
    x)^2) over (n, d) tokens, and its f32 bound (the terms' rounding and
    their summation by code)."""
    n, d = x.shape
    terms = 2.0 * (embed.double()[idx.long()] - x.double()) / (n * d)
    g = torch.zeros(c, d, dtype=torch.float64, device=x.device).index_add_(0, idx.long(), terms)
    gabs = torch.zeros_like(g).index_add_(0, idx.long(), terms.abs())
    count = torch.bincount(idx.long(), minlength=c).double()
    return g, (count[:, None] + MERGE_PARTIALS + 4) * U32 * gabs


def adam_step_reference(embed0, x, idx, c, lr):
    """The in-place optimizer's first Adam step in float64 from the inner
    selection: g = the per-code sum of 2 (e - x) / numel over the tokens of
    each code, the update lr g / (|g| + 1e-8) (Adam's first step with its
    bias corrections), and a bound on the f32 step's error: g's f32
    summation error moves the update by at most 2 lr |dg| / (|g| + 1e-8),
    and the step rounds the codebook entry."""
    g, dg = commit_grad_reference(embed0, x, idx, c)
    ref = embed0.double() - lr * g / (g.abs() + 1e-8)
    bound = (2 * lr * dg / (g.abs() + 1e-8)).clamp(max=2 * lr) + 4 * U32 * (embed0.double().abs() + lr)
    return ref, bound


def phase_learnable_path(device, sizes, code_sums_ms):
    """Path 1: the README's VectorQuantize(dim=256, codebook_size=512,
    learnable_codebook=True, ema_update=False, in_place_codebook_optimizer=
    Adam(lr=1e-3)) on (1024, 1024, 256): one training step launches K1 three
    times (the forward, the inner step's forward, the forward after the
    inner step) and code_sums twice (the inner gradient, the outer
    backward); a twin from the same seed gives the same step bit for bit;
    the in-place Adam step held to float64 from K1's selection, the final
    indices to the plain selection on the stepped codebook (near-ties
    only), the commitment loss and the codebook's gradient to float64; then
    times."""
    from vqtpu_torch import VectorQuantize
    from vqtpu_torch.kernels.distance import nearest_code_plain, quantize_lookup, selection_bias, \
        selection_disagreements
    b, n, d, c = sizes['learn_main']
    lr = 1e-3

    def build():
        torch.manual_seed(21)
        return VectorQuantize(dim=d, codebook_size=c, learnable_codebook=True, ema_update=False,
                              in_place_codebook_optimizer=lambda p: torch.optim.Adam(p, lr=lr),
                              device=device).train()
    vq, twin = build(), build()
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.standard_normal((b, n, d), dtype=np.float32)).to(device)
    g = torch.from_numpy(rng.standard_normal((b, n, d), dtype=np.float32) * 1e-3).to(device)
    xs = x.reshape(-1, d)
    embed0 = vq.codebook.detach().clone()
    idx0, _ = quantize_lookup(xs, embed0)
    reset_all_launches()
    gx, q, idx, loss, br = learnable_step(vq, x, g)
    sync(device)
    launches = all_launches()
    check(launches['nearest_code'] == 3 and launches['code_sums'] == 2 and launches['train_fused'] == 0,
          f'the learnable step launched K1 three times and code_sums twice {launches}')
    gx2, q2, idx2, _, br2 = learnable_step(twin, x, g)
    sync(device)
    cb, cb2 = vq._codebook.embed, twin._codebook.embed
    check(torch.equal(cb.grad, cb2.grad) and torch.equal(cb.detach(), cb2.detach()) and torch.equal(idx, idx2)
          and torch.equal(gx, gx2) and br == br2, 'two learnable steps from one state are bit-identical')
    check(bool(torch.isfinite(gx).all()) and bool(torch.isfinite(cb.grad).all()), 'finite gradients')
    del twin, gx2, q2

    embed1 = cb.detach()[0]
    ref, bound = adam_step_reference(embed0, xs, idx0, c, lr)
    adam_share = float(((embed1.double() - ref).abs() / bound).max())
    check(adam_share <= 1.0, f'the in-place Adam step within its f32 bound of float64 ({adam_share})')
    moved = int((embed1 != embed0).any(-1).sum())
    check(moved == int(idx0.unique().numel()), f'the Adam step moved the {moved} codes the batch chose')
    bias1 = selection_bias(embed1, 'euclidean')
    r = selection_disagreements(xs, embed1, bias1, idx.reshape(-1), nearest_code_plain(xs, embed1, bias1))
    check(r['non_tie'] == 0, f'the final indices against the plain selection {r}')
    loss64 = float((embed1.double()[idx.reshape(-1).long()] - xs.double()).square().mean())
    loss_err = abs(br[0] - loss64) / loss64
    check(loss_err <= 1e-5, f'the commitment loss within 1e-5 of float64 ({loss_err})')
    gref, gbound = commit_grad_reference(embed1, xs, idx.reshape(-1), c)
    grad_share = float(((cb.grad[0].double() - gref).abs() / gbound.clamp_min(1e-300)).max())
    check(grad_share <= 1.0, f'the codebook gradient within its f32 bound of float64 ({grad_share})')

    def step():
        learnable_step(vq, x, g)
    reset_all_launches()
    t = timed_step(step, sizes['step_reps'])
    per_step = {k: v // (sizes['step_reps'] + 2) for k, v in all_launches().items() if v}
    k1_ms = cuda_ms(lambda: quantize_lookup(xs, embed1), sizes['reps'])
    t.update(k1_ms=k1_ms, k1_share=3 * k1_ms / t['step_ms'], code_sums_ms=code_sums_ms,
             code_sums_share=2 * code_sums_ms / t['step_ms'])
    emit('learnable_path', model='VectorQuantize(dim=256, codebook_size=512, learnable_codebook=True, '
                                 'ema_update=False, in_place_codebook_optimizer=Adam(lr=1e-3))',
         input=[b, n, d], launches=launches, launches_per_timed_step=per_step, loss=float(loss), breakdown=br,
         adam_step_share_of_bound=adam_share, codes_moved=moved, final_indices_vs_plain=r,
         commit_loss_rel_err=loss_err, codebook_grad_share_of_bound=grad_share,
         bit_identical_twin=True, peak_gib=torch.cuda.max_memory_allocated() / 2**30, **t)
    return launches, t


def ortho_loss_reference(embed, ids, active):
    """Eq. (2) in float64 over the codebook rows `ids` (h, c, d), with the
    active-code mask (c,) or None."""
    e = embed.double()[:, ids]
    normed = e / e.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    h = e.shape[0]
    if active is None:
        n_codes = float(e.shape[1])
    else:
        mask = active[ids].double()
        normed = normed * mask[None, :, None]
        n_codes = max(float(mask.sum()), 1.0)
    cos = normed @ normed.transpose(-1, -2)
    return float((cos ** 2).sum() / (h * n_codes ** 2) - 1.0 / n_codes)


def phase_ortho_path(device, sizes):
    """Path 2: VectorQuantize(dim=256, codebook_size=512,
    orthogonal_reg_weight=10, orthogonal_reg_max_codes=128), with and
    without orthogonal_reg_active_codes_only, one EMA training step on
    (1024, 1024, 256): the codebook a parameter that the EMA writes, so K4
    is off and K1 selects (one launch), the statistics plain; K1's indices
    against the plain selection (near-ties only), the EMA state against one
    float64 EMA step from them, the orthogonal loss against float64 on the
    updated codebook with the same drawn codes, and no gradient to the
    EMA-written codebook (the JAX package's rule)."""
    from vqtpu_torch import VectorQuantize
    from vqtpu_torch.kernels.distance import nearest_code_plain, selection_bias, selection_disagreements
    from vqtpu_torch.quantizers.vq import orthogonal_reg_code_ids
    b, n, d, c = sizes['learn_main']
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.standard_normal((b, n, d), dtype=np.float32)).to(device)
    g = torch.from_numpy(rng.standard_normal((b, n, d), dtype=np.float32) * 1e-3).to(device)
    xs = x.reshape(-1, d)
    out = {}
    for active in (False, True):
        torch.manual_seed(24)
        vq = VectorQuantize(dim=d, codebook_size=c, orthogonal_reg_weight=10.0, orthogonal_reg_max_codes=128,
                            orthogonal_reg_active_codes_only=active, device=device).train()
        cb = vq._codebook
        embed0, cs0, ea0 = vq.codebook.detach().clone(), cb.cluster_size[0].clone(), cb.embed_avg[0].clone()
        rng_state = cb.generator.get_state()
        reset_all_launches()
        gx, _, idx, loss, br = learnable_step(vq, x, g)
        sync(device)
        launches = all_launches()
        check(launches['nearest_code'] == 1 and launches['train_fused'] == 0 and launches['code_sums'] == 0,
              f'the orthogonal EMA step selected with K1 alone {launches}')
        il = idx.reshape(-1)
        bias0 = selection_bias(embed0, 'euclidean')
        r = selection_disagreements(xs, embed0, bias0, il, nearest_code_plain(xs, embed0, bias0))
        check(r['non_tie'] == 0, f'active={active}: indices against the plain selection {r}')
        cs, ea, cs_bound, ea_bound = ema_step_reference(xs, il, cs0, ea0, cb.decay)
        ema_share = max(float(((cb.cluster_size[0].double() - cs).abs() / cs_bound.clamp_min(1e-300)).max()),
                        float(((cb.embed_avg[0].double() - ea).abs() / ea_bound.clamp_min(1e-300)).max()))
        check(ema_share <= 1.0, f'active={active}: the EMA state within its f32 bound of float64 ({ema_share})')
        gen = torch.Generator(device=device)
        gen.set_state(rng_state)
        mask = torch.zeros(c, dtype=torch.bool, device=device)
        mask[il.long()] = True
        ids = orthogonal_reg_code_ids(gen, c, 128, mask if active else None)
        ortho64 = ortho_loss_reference(cb.embed.detach(), ids, mask if active else None)
        ortho_err = abs(br[2] - ortho64) / abs(ortho64)
        check(ortho_err <= 1e-4, f'active={active}: the orthogonal loss within 1e-4 of float64 ({ortho_err})')
        check(cb.embed.grad is None, f'active={active}: no gradient reaches the EMA-written codebook')
        check(bool(torch.isfinite(gx).all()), 'finite x.grad')

        def step():
            learnable_step(vq, x, g)
        t = timed_step(step, sizes['step_reps'])
        out[f'active_codes_only={active}'] = dict(launches=launches, loss=float(loss), breakdown=br,
                                                  indices_vs_plain=r, ema_share_of_bound=ema_share,
                                                  ortho_rel_err_vs_float64=ortho_err, **t)
        del vq
    emit('ortho_path', model='VectorQuantize(dim=256, codebook_size=512, orthogonal_reg_weight=10, '
                             'orthogonal_reg_max_codes=128[, orthogonal_reg_active_codes_only=True])',
         input=[b, n, d], runs=out)
    return out


def phase_affine_path(device, sizes):
    """Path 3: VectorQuantize(dim=256, codebook_size=512, affine_param=True),
    one EMA training step on (1024, 1024, 256) per train_fused route from
    the same state: 'on' launches K4 once (statistics of raw x, then the
    exact post-transform), 'off' K1 once (statistics of the mapped x); the
    same indices bit for bit (K1's tile on the same operands), and each
    route's batch sums within the f32 summation bound of a float64 sum of
    the mapped tokens."""
    from vqtpu_torch import VectorQuantize
    b, n, d, c = sizes['learn_main']
    rng = np.random.default_rng(25)
    x = torch.from_numpy(rng.standard_normal((b, n, d), dtype=np.float32) * 0.5 + 0.2).to(device)
    g = torch.from_numpy(rng.standard_normal((b, n, d), dtype=np.float32) * 1e-3).to(device)
    runs = {}
    for route in ('on', 'off'):
        torch.manual_seed(26)
        vq = VectorQuantize(dim=d, codebook_size=c, affine_param=True, train_fused=route, device=device).train()
        cb = vq._codebook
        seen = {}
        apply = cb._apply_batch_stats

        def record(cluster_size, embed_sum, *args, _apply=apply, _seen=seen):
            _seen['bins'], _seen['esum'] = cluster_size.clone(), embed_sum.clone()
            return _apply(cluster_size, embed_sum, *args)
        cb._apply_batch_stats = record
        reset_all_launches()
        gx, _, idx, loss, br = learnable_step(vq, x, g)
        sync(device)
        del cb._apply_batch_stats
        launches = all_launches()
        want = dict(on=(0, 1), off=(1, 0))[route]
        check((launches['nearest_code'], launches['train_fused']) == want,
              f"'{route}': K1 and K4 launches {launches}")
        # float64 sums of the mapped tokens, from the statistics the step used
        scale = (cb.codebook_variance.double().clamp_min(1e-5).sqrt()
                 / cb.batch_variance.double().clamp_min(1e-5).sqrt())[0]
        bmean, cmean = cb.batch_mean.double()[0], cb.codebook_mean.double()[0]
        xs = x.reshape(-1, d)
        mapped = (xs.double() - bmean) * scale + cmean
        esum64, asum64, count = (t_[0] for t_ in stats_reference(mapped[None], idx.reshape(1, -1), c, None))
        raw_abs = stats_reference(xs[None], idx.reshape(1, -1), c, None)[1][0]
        # the summation's rounding, and a few roundings of each mapped term
        # (or of the kernel's post-transform s esum + bins t)
        bound = (count[:, None] + MERGE_PARTIALS + 4) * U32 * (
            asum64 + scale * raw_abs + count[:, None] * (cmean.abs() + scale * bmean.abs()))
        err = (seen['esum'][0].double() - esum64).abs()
        share = float((err / bound.clamp_min(1e-300)).max())
        check(share <= 1.0, f"'{route}': batch sums within the f32 bound of float64 ({share})")
        check(torch.equal(seen['bins'][0].double(), count), f"'{route}': bins are the exact counts")

        def step():
            learnable_step(vq, x, g)
        runs[route] = dict(idx=idx, esum=seen['esum'], launches=launches, loss=float(loss), breakdown=br,
                           esum_max_abs_err=float(err.max()), esum_share_of_bound=share,
                           **timed_step(step, sizes['step_reps']))
        del vq
    check(torch.equal(runs['on']['idx'], runs['off']['idx']), "'on' and 'off' select the same codes bit for bit")
    route_err = float((runs['on']['esum'] - runs['off']['esum']).abs().max())
    emit('affine_path', model='VectorQuantize(dim=256, codebook_size=512, affine_param=True)', input=[b, n, d],
         on_vs_off_esum_max_abs_err=route_err,
         runs={r: {k: v for k, v in run.items() if k not in ('idx', 'esum')} for r, run in runs.items()})
    return {r: run['launches'] for r, run in runs.items()}, {r: run['step_ms'] for r, run in runs.items()}


def phase_fvq_flagship(device, sizes):
    """Path 4: the FVQ autoencoder of examples/autoencoder_fvq.py,
    SimpleQuantizeAutoEncoder(VectorQuantize(dim=32, codebook_size=256,
    vq_bridge=MiniEncoder(dim=256, input_dim=32, depth=1, heads=4),
    learnable_codebook=True, ema_update=False, rotation_trick=False,
    in_place_codebook_optimizer=SGD(lr=1e-3))), batch 256: step 0 against
    the CPU from the same weights, then AdamW steps; the code utilization
    is reported (the configuration collapses in both frameworks,
    PARITY_FVQ.json) and not gated."""
    from vqtpu_torch import SimpleQuantizeAutoEncoder, VectorQuantize
    from vqtpu_torch.kernels.distance import selection_bias, selection_disagreements
    from vqtpu_torch.models import MiniEncoder

    def build(dev):
        return SimpleQuantizeAutoEncoder(VectorQuantize(
            dim=32, codebook_size=256, vq_bridge=MiniEncoder(dim=256, input_dim=32, depth=1, heads=4, device=dev),
            learnable_codebook=True, ema_update=False, rotation_trick=False,
            in_place_codebook_optimizer=lambda p: torch.optim.SGD(p, lr=1e-3), device=dev), dim=32, device=dev).train()

    def loss_of(model, x):
        recon, idx, cmt = model(x)
        return (recon.clamp(-1, 1) - x).abs().mean() + 10.0 * cmt, idx

    torch.manual_seed(27)
    model = build(device)
    ref = build('cpu')
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(28)
    images = [rng.random((sizes['images'], 28, 28, 1), dtype=np.float32) for _ in range(sizes['flagship_steps'])]
    x = torch.from_numpy(images[0])
    cbm = model.quantizer._codebook
    with torch.no_grad():
        z = model.encoder(x.to(device)).reshape(-1, 32)
    reset_all_launches()
    loss, idx = loss_of(model, x.to(device))
    loss.backward()
    sync(device)
    with torch.no_grad():
        # the codebook the last selection ran against: after the inner step
        sel = cbm.vq_bridge(cbm.embed)[0]
    launches = all_launches()
    check(launches['nearest_code'] == 3 and launches['code_sums'] == 2,
          f'an FVQ step launched K1 three times and code_sums twice {launches}')
    ref_loss, ref_idx = loss_of(ref, x)
    ref_loss.backward()
    r = selection_disagreements(z, sel, selection_bias(sel, 'euclidean'), idx.reshape(-1), ref_idx.reshape(-1).to(device))
    check(r['non_tie'] == 0, f'FVQ step 0: indices disagree with the CPU beyond ties {r}')
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    check(loss_rel <= 1e-4, f'FVQ step 0: loss as on the CPU ({loss_rel})')
    param_err = max(rel_err(p.detach().cpu(), rp.detach()) for (_, p), (_, rp) in
                    zip(cbm.named_parameters(), ref.quantizer._codebook.named_parameters()))
    check(r['disagree'] > 0 or param_err <= 1e-5, f'FVQ step 0: the in-place SGD step as on the CPU ({param_err})')
    # each parameter's error over its largest gradient, or 1e-4 of the
    # model's when that is smaller: the attention's key bias takes a gradient
    # that is 0 in exact arithmetic (a softmax ignores a constant added to
    # all of a query's logits), rounding alone on either device
    scale = max(float(rp.grad.abs().max()) for rp in ref.parameters() if rp.grad is not None)
    grad_errs = {name: float((p.grad.cpu().double() - rp.grad.double()).abs().max()
                             / max(float(rp.grad.abs().max()), 1e-4 * scale))
                 for (name, p), (_, rp) in zip(model.named_parameters(), ref.named_parameters())
                 if rp.grad is not None}
    grad_name = max(grad_errs, key=grad_errs.get)
    grad_err = grad_errs[grad_name]
    if grad_err > 1e-3:
        emit('fvq_step0_grads', rel_err=grad_errs, ref_max={name: float(rp.grad.abs().max()) for name, rp in
                                                              ref.named_parameters() if rp.grad is not None},
             disagree=r['disagree'], codes=int(idx.unique().numel()))
    check(r['disagree'] > 0 or grad_err <= 1e-3, f'FVQ step 0: gradients as on the CPU ({grad_name}: {grad_err})')
    del ref
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    opt.step()
    opt.zero_grad()
    losses, used = [loss.item()], []
    for step in range(1, len(images)):
        loss, idx = loss_of(model, torch.from_numpy(images[step]).to(device))
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())
        used.append(int(idx.unique().numel()))
    sync(device)
    check(all(np.isfinite(losses)), 'FVQ losses are finite')
    imgs = torch.from_numpy(images[-1]).to(device)

    def step():
        loss_of(model, imgs)[0].backward()
        opt.step()
        opt.zero_grad()
    t = timed_step(step, sizes['step_reps'], warmup=2)
    emit('fvq_flagship', model='SimpleQuantizeAutoEncoder(VectorQuantize(dim=32, codebook_size=256, '
                               'vq_bridge=MiniEncoder(dim=256, input_dim=32, depth=1, heads=4), learnable_codebook=True, '
                               'ema_update=False, rotation_trick=False, in_place_codebook_optimizer=SGD(lr=1e-3)))',
         optimizer='AdamW(lr=3e-4, weight_decay=1e-4)', input=[sizes['images'], 28, 28, 1], steps=len(images),
         launches_step0=launches, loss_first=losses[0], loss_last=losses[-1],
         codes_used_first=used[0], codes_used_last=used[-1],
         utilization_note='reported, not gated: PARITY_FVQ.json records the collapse in both frameworks',
         step0_vs_cpu=dict(loss_rel_err=loss_rel, codebook_params_rel_err=param_err, grad_max_rel_err=grad_err, **r),
         **t)
    return launches, t['step_ms']


def qinco_float64_picks(model, x, idx):
    """For each QINCo layer, on tokens x (t, d) with the card's picks idx (t,
    q): the float64 distance of the layer's pick and of its best code, from
    the float64 copy `model` (on the CPU) and the picks of the layers before
    (so each layer is judged on the input the card gave it)."""
    x = x.double()
    quantized = torch.zeros_like(x)
    gaps = []
    with torch.no_grad():
        for q, vq in enumerate(model.layers):
            codes = vq._codebook.embed[0]
            residual = x - quantized
            if q == 0:
                cand = codes[None].expand(x.shape[0], *codes.shape)
            else:
                cand = model.mlps[q - 1](codes, condition=quantized[None])[0]       # (t, c, d)
            dist = (residual[:, None] - cand).norm(dim=-1)                           # (t, c)
            pick = idx[:, q].long()
            picked = dist.gather(1, pick[:, None])[:, 0]
            best = dist.min(1).values
            gaps.append(((picked - best) / best.clamp_min(1e-30)))
            quantized = quantized + cand[torch.arange(x.shape[0]), pick]
    return torch.stack(gaps, 1)


@contextmanager
def forced_qinco_picks(model, idx):
    """Inside, the ResidualVQ `model` (on the CPU) takes the codes `idx` (b,
    n, q), the card's picks, in place of its own: layer 0 through
    `lookup_with_code_grad` (its rows by gather, whose backward sums by
    code), layers 1-(q-1) through each codebook's `gumbel_sample_fn` (a 0/1
    one-hot, as the sampler gives without stochastic codes). So the step-0
    comparison does not hinge on a near-tie flipping between the devices;
    the picks themselves are held to float64 apart. Yields the count, per
    layer, of tokens whose own pick differed."""
    import vqtpu_torch.codebook.codebook as codebook_module
    from vqtpu_torch.core.sampling import one_hot_float
    flips = [0] * len(model.layers)
    lookup = codebook_module.lookup_with_code_grad

    def layer0(flatten, embed, metric='euclidean'):
        own, _ = lookup(flatten, embed, metric)
        forced = idx[..., 0].reshape(own.shape).to(own.dtype)
        flips[0] += int((own != forced).sum())
        rows = embed.gather(-2, forced.long()[..., None].expand(*forced.shape, embed.shape[-1]))
        return forced, rows

    def sampler(layer):
        def pick(generator, dist, **kw):
            own = dist.argmax(-1)
            forced = idx[..., layer].reshape(own.shape).to(torch.int32)
            flips[layer] += int((own != forced).sum())
            return forced, one_hot_float(forced, dist.shape[-1], dist.dtype)
        return pick

    samplers = [vq._codebook.gumbel_sample_fn for vq in model.layers]
    codebook_module.lookup_with_code_grad = layer0
    for layer, vq in enumerate(model.layers):
        if layer:
            vq._codebook.gumbel_sample_fn = sampler(layer)
    try:
        yield flips
    finally:
        codebook_module.lookup_with_code_grad = lookup
        for vq, fn in zip(model.layers, samplers):
            vq._codebook.gumbel_sample_fn = fn


def phase_qinco_path(device, sizes):
    """Path 5: ResidualVQ(dim=256, num_quantizers=8, codebook_size=1024,
    implicit_neural_codebook=True): an eval forward on 1024 tokens and one
    training step on 256. Layer 0 selects with K1 (one launch a forward),
    layers 1-7 on the distance path against per-token codebooks of 1024 x
    256 (no kernel); the backward sums layer 0's rows by code (code_sums).
    Held: each layer's pick within 1e-5 relative of the float64 best (a
    near-tie), judged on a float64 copy on the CPU, on 256 of the eval
    tokens and on all 256 training tokens; the decode of the eval indices
    to 1e-4; and the training step against a CPU copy of the same state
    that takes the card's picks (`forced_qinco_picks`): the output to 1e-5
    and the losses and x.grad to 1e-4 of their largest entry, every
    parameter's gradient (MLPs and codebooks) to 1e-3 of its largest entry,
    or of 1e-4 of the model's largest when that is smaller, as in
    fvq_flagship (f32 sums over the tokens in another order on each
    device)."""
    from vqtpu_torch import ResidualVQ
    q, d, c = QINCO_MAIN
    eval_tokens, train_tokens, cpu_tokens = sizes['qinco_tokens']
    torch.manual_seed(29)
    model = ResidualVQ(dim=d, num_quantizers=q, codebook_size=c, implicit_neural_codebook=True, device=device)
    rvq_scaled_codebooks(model, seed=30)
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((1, eval_tokens, d), dtype=np.float32) * 0.5).to(device)
    model.eval()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    with torch.no_grad():
        out, idx, _ = model(x)
    sync(device)
    eval_launches = all_launches()
    eval_peak = torch.cuda.max_memory_allocated() / 2**30
    check(eval_launches['nearest_code'] == 1, f'the QINCo eval forward launched K1 once (layer 0) {eval_launches}')
    check(bool(torch.isfinite(out).all()), 'finite QINCo output')
    with torch.no_grad():
        decoded = model.get_output_from_indices(idx)
    decode_err = float((decoded - out).abs().max())
    check(decode_err <= 1e-4, f'the QINCo decode matches the eval output ({decode_err})')
    ref = ResidualVQ(dim=d, num_quantizers=q, codebook_size=c, implicit_neural_codebook=True, device='cpu')
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})

    def forward():
        with torch.no_grad():
            model(x)
    eval_t = timed_step(forward, sizes['rvq_step_reps'])

    model.train()
    xt = x[:, :train_tokens].contiguous()
    gt = torch.from_numpy(rng.standard_normal(xt.shape, dtype=np.float32) * 1e-3).to(device)
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()

    def train_step():
        xg = xt.clone().requires_grad_()
        o, i, losses = model(xg)
        ((o * gt).sum() + losses.sum()).backward()
        return xg.grad, o.detach(), i, losses.detach()
    gx, out_t, idx_t, losses_t = train_step()
    sync(device)
    train_launches = all_launches()
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    check(train_launches['nearest_code'] == 1 and train_launches['code_sums'] == 1,
          f'the QINCo training step: K1 and code_sums once (layer 0) {train_launches}')
    check(bool(torch.isfinite(gx).all()) and all(bool(torch.isfinite(p.grad).all())
                                                   for p in model.parameters() if p.grad is not None),
          'finite QINCo gradients')
    check(all(p.grad is not None for p in model.mlps.parameters()), 'every QINCo MLP takes a gradient')

    # step 0 against the CPU copy, under the card's picks
    started = time.perf_counter()
    ref.train()
    xr = xt.cpu().requires_grad_()
    with forced_qinco_picks(ref, idx_t.cpu()) as flips:
        out_r, idx_r, losses_r = ref(xr)
        ((out_r * gt.cpu()).sum() + losses_r.sum()).backward()
    check(torch.equal(idx_r, idx_t.cpu()), 'the CPU copy took the card\'s picks')
    out_err = rel_err(out_t.cpu(), out_r.detach())
    losses_err = rel_err(losses_t.cpu(), losses_r.detach())
    gx_err = rel_err(gx.cpu(), xr.grad)
    scale = max(float(rp.grad.abs().max()) for rp in ref.parameters() if rp.grad is not None)
    grad_errs = {name: float((p.grad.cpu().double() - rp.grad.double()).abs().max()
                             / max(float(rp.grad.abs().max()), 1e-4 * scale))
                 for (name, p), (_, rp) in zip(model.named_parameters(), ref.named_parameters())
                 if rp.grad is not None}
    check(set(grad_errs) == {name for name, p in model.named_parameters() if p.grad is not None},
          'the card and the CPU copy give gradients to the same parameters')
    grad_name = max(grad_errs, key=grad_errs.get)
    step0 = dict(output_rel_err=out_err, losses_rel_err=losses_err, x_grad_rel_err=gx_err,
                 grad_max_rel_err=grad_errs[grad_name], grad_max_rel_err_of=grad_name,
                 cpu_own_pick_flips=flips, cpu_s=time.perf_counter() - started)
    check(out_err <= 1e-5, f'QINCo step 0: the output as on the CPU ({step0})')
    check(losses_err <= 1e-4 and gx_err <= 1e-4, f'QINCo step 0: losses and x.grad as on the CPU ({step0})')
    check(grad_errs[grad_name] <= 1e-3, f'QINCo step 0: every gradient as on the CPU ({step0})')
    del out_r, losses_r, xr

    # the card's picks against the float64 best, eval tokens and training tokens
    started = time.perf_counter()
    ref64 = ref.double()
    eval_gaps = qinco_float64_picks(ref64, x[0, -cpu_tokens:].cpu(), idx[0, -cpu_tokens:].cpu())
    train_gaps = qinco_float64_picks(ref64, xt[0].cpu(), idx_t[0].cpu())
    worst = dict(eval=float(eval_gaps.max()), train=float(train_gaps.max()),
                 cpu_s=time.perf_counter() - started)
    check(max(worst['eval'], worst['train']) <= 1e-5,
          f'QINCo picks within 1e-5 of the float64 best on every layer ({worst})')
    del ref, ref64

    model.zero_grad()
    train_t = timed_step(lambda: train_step(), sizes['rvq_step_reps'])
    emit('qinco_path', model=f'ResidualVQ(dim={d}, num_quantizers={q}, codebook_size={c}, '
                             'implicit_neural_codebook=True)',
         eval_tokens=eval_tokens, train_tokens=train_tokens, float64_checked_tokens=dict(
             eval=cpu_tokens, train=train_tokens),
         cut='tokens only: the per-token codebook is (N, 1024, 256) f32, 1 GiB at N = 1024; training keeps '
             'every MLP activation of 7 layers for the backward',
         eval_launches=eval_launches, train_launches=train_launches, float64_worst_pick_gap=worst,
         decode_max_abs_err=decode_err, step0_vs_cpu=step0, eval_peak_gib=eval_peak, train_peak_gib=train_peak,
         eval=eval_t, train=train_t)
    return eval_launches, train_launches, eval_t['step_ms'], train_t['step_ms']


def phase_diveq_rvq_path(device, sizes):
    """Path 6: ResidualVQ(dim=256, num_quantizers=8, codebook_size=1024,
    diveq=True) on (32, 2048, 256), one training step: K1 once a layer and
    code_sums once a layer in the backward; each layer's indices against
    the plain selection on that layer's input; finite gradients to x and
    every codebook; then times."""
    from vqtpu_torch import ResidualVQ
    b, n, d, q, c = RVQ_MAIN
    torch.manual_seed(32)
    model = ResidualVQ(dim=d, num_quantizers=q, codebook_size=c, diveq=True, device=device).train()
    rvq_scaled_codebooks(model, seed=33)
    rng = np.random.default_rng(34)
    x = torch.from_numpy(rng.standard_normal((b, n, d), dtype=np.float32) * 0.5).to(device)
    g = torch.from_numpy(rng.standard_normal((b, n, d), dtype=np.float32) * 1e-3).to(device)
    reset_all_launches()
    xg = x.clone().requires_grad_()
    (out, idx, losses), inputs = rvq_with_layer_inputs(model, xg)
    ((out * g).sum() + losses.sum()).backward()
    sync(device)
    launches = all_launches()
    check(launches['nearest_code'] == q and launches['code_sums'] == q and launches['train_fused'] == 0,
          f'the DiVeQ step launched K1 and code_sums once a layer {launches}')
    with torch.no_grad():
        reports, _ = rvq_layers_vs_plain(model, idx, inputs, device)
    check(bool(torch.isfinite(xg.grad).all()), 'finite x.grad')
    check(all(vq._codebook.embed.grad is not None and bool(torch.isfinite(vq._codebook.embed.grad).all())
              for vq in model.layers), 'every DiVeQ codebook takes a finite gradient')
    del inputs

    def step():
        xs = x.clone().requires_grad_()
        o, _, ls = model(xs)
        ((o * g).sum() + ls.sum()).backward()
    t = timed_step(step, sizes['rvq_step_reps'])
    emit('diveq_rvq_path', model=f'ResidualVQ(dim={d}, num_quantizers={q}, codebook_size={c}, diveq=True)',
         input=[b, n, d], launches=launches, layers_vs_plain=reports, **t)
    return launches, t['step_ms']


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script needs one', file=sys.stderr)
        return 1
    import vqtpu_torch  # noqa: F401  -- fails before any output outside a checkout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the flagships' convolutions: one algorithm in every run, no benchmark search
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    device = torch.device('cuda')
    sizes = {
        'main': MAIN,
        'batch': 1024,
        'others': {
            'ragged': (300, 130, 96),
            'tiny': (64, 8, 32),
            'heads': (3, 1000, 257, 40),
            'ragged_d30': (500, 300, 30),
            'tiny_d3': (64, 5, 3),
            'large_codebook': (16384, 65536, 32),
        },
        'ties': (1000, 512, 256),
        'images': 256,
        'reps': 20,
        'train_steps': 3,
        'flagship_steps': 50,
        'train_reps': 10,
        'step_reps': 5,
        'lfq_reps': 10,
        'lfq_plain_reps': 2,
        'lfq_step_reps': 3,
        'rfsq_reps': 50,
        'rfsq_plain_reps': 5,
        'rvq_reps': 10,
        'rvq_beam_reps': 3,
        'rvq_step_reps': 3,
        'learn_main': LEARN_MAIN,
        'code_sums_rvq': (RVQ_MAIN[0] * RVQ_MAIN[1], RVQ_MAIN[4]),
        # QINCo: eval tokens, training tokens, eval tokens checked in float64 on the CPU
        'qinco_tokens': (1024, 256, 256),
    }

    kind, count, smi, ptxas = phase_device()
    n, c, d = sizes['main']
    x_main = torch.from_numpy(
        np.random.default_rng(0).standard_normal((n, d), dtype=np.float32)).to(device)
    selection, e_main = phase_kernel_vs_plain(x_main, device, sizes)
    vq, xin, main_launches = phase_main_path(x_main, device, sizes)
    flagship_launches = phase_flagship(device, sizes)
    times = phase_times(vq, xin, x_main, e_main, sizes)
    del vq, xin
    train_err = phase_train_fused_vs_plain(x_main, e_main, device, sizes)
    train_launches, off_route_launches = phase_train_path(device, sizes)
    flagship_train_launches = phase_flagship_train(device, sizes)
    train_times = phase_train_times(x_main, e_main, sizes, smi)
    del x_main, e_main
    lfq_errors = phase_lfq_kernels_vs_plain(device)
    lfq_main_launches = phase_lfq_train_path(device)
    lfq_flagship_launches = phase_lfq_flagship_train(device, sizes)
    lfq_times = phase_lfq_times(sizes, smi)
    per_kernel = lfq_times['per_kernel']
    lfq_per_kernel = [dict(sweep=name, replaces=LFQ_REPLACES[name], launches=lfq_main_launches[name],
                           **{key: per_kernel[name][key] for key in (
                               'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
                               'fma_term_ms', 'mufu_term_ms', 'bytes_term_ms')})
                      for name in 'abcd']
    # each sweep's design, the compiler's report at d = 18 and its share of the bound
    for entry, sweep in zip(lfq_per_kernel, 'abcd'):
        d18 = [v for k, v in ptxas[f'lfq_sweep_{sweep}']['entries'].items() if 'ILi18E' in k]
        entry.update(design=LFQ_DESIGNS[sweep], ptxas_d18=d18[0] if d18 else None,
                     share_of_bound=per_kernel[sweep]['bound_ms'] / per_kernel[sweep]['ms'])
    rfsq_cases = phase_rfsq_kernel_vs_plain(device)
    rfsq_launches, rfsq_grouped_launches = phase_rfsq_eval_path(device)
    phase_fsq_train_path(device, sizes)
    rfsq_times = phase_rfsq_times(sizes, smi)
    rvq, rvq_x, rvq_launches, grouped_rvq_launches = phase_rvq_eval_path(device)
    beam_model, beam_x = phase_rvq_beam_path(rvq, device)
    rvq_train_models, rvq_train_x, rvq_on_launches, rvq_off_launches = phase_rvq_train_path(device, sizes)
    rvq_flagship, rvq_flagship_launches = phase_rvq_flagship_train(device, sizes)
    rvq_times = phase_rvq_times(rvq, rvq_x, beam_model, beam_x, rvq_train_models, rvq_train_x, sizes, smi)
    del rvq, rvq_x, beam_model, beam_x, rvq_train_models, rvq_train_x, rvq_flagship
    code_sums_times = phase_code_sums(device, sizes)
    learn_launches, learn_times = phase_learnable_path(device, sizes, code_sums_times['ms'])
    ortho = phase_ortho_path(device, sizes)
    affine_launches, affine_ms = phase_affine_path(device, sizes)
    fvq_launches, fvq_ms = phase_fvq_flagship(device, sizes)
    qinco_eval_launches, qinco_train_launches, qinco_eval_ms, qinco_train_ms = phase_qinco_path(device, sizes)
    diveq_launches, diveq_ms = phase_diveq_rvq_path(device, sizes)
    check_no_spill(ptxas)

    print(json.dumps({'kernels': [{
        'name': 'nearest_code',
        'route': 'cuda',
        'source': KERNEL_SOURCE,
        'replaces': 'vqtpu/kernels/distance.py:266',
        'replaces_all': REPLACES,
        'launches': main_launches,
        'launches_flagship': flagship_launches,
        'launches_train_off_route': off_route_launches,
        'launches_rvq_eval': rvq_launches,
        'launches_grouped_rvq_eval': grouped_rvq_launches,
        'launches_rvq_train_off_per_step': rvq_off_launches,
        'launches_rvq_flagship_eval': rvq_flagship_launches,
        'launches_learnable_step': learn_launches['nearest_code'],
        'launches_ortho_step': {k: v['launches']['nearest_code'] for k, v in ortho.items()},
        'launches_affine_off_step': affine_launches['off']['nearest_code'],
        'launches_fvq_step': fvq_launches['nearest_code'],
        'launches_qinco_eval': qinco_eval_launches['nearest_code'],
        'launches_qinco_train_step': qinco_train_launches['nearest_code'],
        'launches_diveq_rvq_step': diveq_launches['nearest_code'],
        'rvq_layer_ms': rvq_times['rvq_k1_layer_ms'],
        'rvq_layer_bound_ms': rvq_times['rvq_k1_layer_bound_ms'],
        'max_abs_err': selection['main']['max_score_gap'],
        'max_abs_err_of': 'float64 score gap between the kernel and plain picks at the main shape',
        'design': KERNEL_DESIGN,
        **times,
        # the least time for f32-accurate selection is the 3xTF32 bound; the
        # kernel runs below the f32 FMA bound, which is kept beside it
        'bound_ms': times['bound_tc_ms'],
        'bound_f32_fma_ms': times['bound_ms'],
        'previous_ms_of': 'the replaced f32 FMA tile (vqtpu_nearest_code_f32_simt), measured in this run',
        'check': 'indices equal the plain version except near-ties (float64 gap <= 1e-5 relative), '
                 'exact on tie probes, two calls bit-identical, rows bit-equal to codebook rows',
        'power_limit': smi,
    }, {
        'name': 'train_fused',
        'route': 'cuda',
        'source': TRAIN_SOURCE,
        'replaces': TRAIN_REPLACES,
        'launches': train_launches,
        'launches_flagship_train': flagship_train_launches,
        'launches_rvq_train_on_per_step': rvq_on_launches,
        'launches_affine_on_step': affine_launches['on']['train_fused'],
        'max_abs_err': train_err,
        'max_abs_err_of': 'max |esum - float64 sum| at the main shape (indices and rows are exact)',
        'design': TRAIN_DESIGN,
        **train_times,
        'previous_ms_of': 'the replaced step (f32 FMA tile, then the same statistics; '
                          'vqtpu_train_fused_f32_simt), measured in this run',
        'library_ms_note': "no single PyTorch call computes the fused step; composition_ms is the 'off' route",
        'check': 'indices equal nearest_code bit for bit (the same kernel on the same operands) and the plain '
                 'version except near-ties, rows bit-equal, bins equal the weight sums, esum within the f32 '
                 'summation bound, two calls bit-identical',
        'power_limit': smi,
    }, {
        'name': 'lfq_entropy',
        'route': 'cuda',
        'source': LFQ_SOURCE,
        'replaces': LFQ_REPLACES['a'].split()[0],
        'replaces_all': list(LFQ_REPLACES.values()),
        'launches': sum(lfq_main_launches.values()),
        'launches_by_sweep': lfq_main_launches,
        'launches_flagship_train': lfq_flagship_launches,
        'max_abs_err': lfq_errors['dx']['max_abs_err'],
        'max_abs_err_of': 'max |dx - float64 plain| at the main LFQ shape, inv_temp 100, '
                          "LFQ aux loss cotangents (errors of every output: phase lfq_kernels_vs_plain)",
        'ms': sum(k['ms'] for k in lfq_per_kernel),
        'plain_ms': sum(k['plain_ms'] for k in lfq_per_kernel),
        'bound_ms': sum(k['bound_ms'] for k in lfq_per_kernel),
        'bound_by': 'operations',
        'library_ms': None,
        'library_ms_note': 'no single PyTorch call computes the four sweeps; per_kernel gives K5 against '
                           "addmm + logsumexp, and stats_ms the 'off' route's streamed statistics",
        'ms_of': 'the four sweeps of one LFQ training step at N = 8192, K = 2^18 (sum of per_kernel)',
        'per_kernel': lfq_per_kernel,
        'stats_ms': lfq_times['stats_ms'],
        'step_ms': lfq_times['step_ms'],
        'check': 'each sweep within its tolerance of a float64 plain run or 4x the plain f32 error, each limit '
                 "under a tenth of the largest entry, two calls bit-identical; 'on'/'auto' and 'off' aux to 1e-4, "
                 "the aux loss's x.grad and the whole x.grad to 1e-3 of their largest entry; indices equal sign bits",
        'power_limit': smi,
    }, {
        'name': 'residual_fsq_fused',
        'route': 'cuda',
        'source': RFSQ_SOURCE,
        'replaces': RFSQ_REPLACES.split()[0],
        'launches': rfsq_launches,
        'launches_grouped_two_groups': rfsq_grouped_launches,
        'max_abs_err': max(r['max_abs_err'] for r in rfsq_cases.values()),
        'max_abs_err_of': 'max |quantized - plain version| over the rfsq_kernel_vs_plain cases '
                          f"({sum(r['bit_identical'] for r in rfsq_cases.values())} of {len(rfsq_cases)} "
                          'bit-identical in values and indices)',
        **rfsq_times,
        'library_ms_note': "no single PyTorch call computes the chain; composition_ms is the 'off' loop's "
                           'eval forward',
        'ms_of': 'one call at 4,194,304 tokens, d = 4, q = 8 (the main ResidualFSQ shape)',
        'design': RFSQ_DESIGN,
        'check': 'values and indices bit-identical to the plain version on the card (NaN for NaN) in every case, '
                 "a whole binade at levels 5, 7 and 8 included, two calls bit-identical; 'auto' against 'off' "
                 'and the decode from indices',
        'power_limit': smi,
    }, {
        'name': 'code_sums',
        'route': 'cuda',
        'source': TRAIN_SOURCE,
        'replaces': CODE_SUMS_REPLACES,
        'replaces_note': "K4's statistics half, run alone as the backward of the learnable lookup; on the TPU that "
                         "backward is XLA's scatter-add (the gather's VJP, vqtpu/codebook/codebook.py:1028)",
        'launches': learn_launches['code_sums'],
        'launches_fvq_step': fvq_launches['code_sums'],
        'launches_qinco_train_step': qinco_train_launches['code_sums'],
        'launches_diveq_rvq_step': diveq_launches['code_sums'],
        'max_abs_err': code_sums_times['max_abs_err'],
        'max_abs_err_of': 'max |sums - float64 per-code sum| over the code_sums cases (each within the f32 '
                          'summation bound)',
        'ms': code_sums_times['ms'],
        'plain_ms': code_sums_times['plain_ms'],
        'bound_ms': code_sums_times['bound_ms'],
        'bound_by': code_sums_times['bound_by'],
        'library_ms': code_sums_times['library_ms'],
        'library': 'index_add_ (the backward of index_select)',
        'ms_of': 'the per-code sums of 2^20 rows of 256 against 512 codes (the learnable step\'s shape)',
        'design': CODE_SUMS_DESIGN,
        'step_ms': dict(learnable=learn_times['step_ms'], ortho={k: v['step_ms'] for k, v in ortho.items()},
                        affine=affine_ms, fvq=fvq_ms, qinco_eval=qinco_eval_ms, qinco_train=qinco_train_ms,
                        diveq_rvq=diveq_ms),
        'check': 'bins exact, sums within the f32 summation bound of float64, two calls bit-identical; the '
                 'learnable codebook gradient bit-identical across two calls and two steps',
        'power_limit': smi,
    }]}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind, 'count': count}}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
