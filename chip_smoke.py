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
30. simvq_path: SimVQ(dim=256, codebook_size=512, rotation_trick=True) on
   (1024, 1024, 256): eval, one K1 launch, the indices against the plain
   selection on the same implicit codebook, the rows bit-equal to its
   rows, the decode from indices within 1e-5; 3 AdamW steps, one K1 and
   one code_sums a step, the transform's gradient within the f32 summation
   bound of float64 from the card's picks, a twin step bit-identical; then
   the SimVQ autoencoder (examples/autoencoder_sim_vq.py), step 0 against
   the CPU and 50 AdamW steps (simvq_autoencoder); times with K1's and
   code_sums' shares;
31. rsimvq_path: ResidualSimVQ(dim=256, num_quantizers=4, codebook_size=512)
   on (32, 2048, 256): eval, K1 once a layer, each layer against the plain
   selection on its own input, the decode from indices; one training step
   with quantize dropout at index 2, K1 and code_sums once a layer, the
   dropped layer zero with index -1; times;
32. rpq_path: RandomProjectionQuantizer(dim=512, codebook_size=1024,
   codebook_dim=256, num_codebooks=16) on (8, 1024, 512): one K1 launch over
   the 16 heads (4096 wide, cosine), each head against the plain selection,
   the cross entropy against given indices (no launch) against float64;
   times;
33. hq_path: the HierarchicalVQ autoencoder (examples/autoencoder_hq.py,
   scales (1, 2, 4, 7), train_fused='on'): step 0 against the CPU with the
   same kmeans and expiry rows, K4 once a scale a step, 50 AdamW steps, an
   eval forward with K1 once a scale and its decode; times with the idle
   share;
34. zoo_path: the FSP autoencoder (examples/autoencoder_fsp.py, 50 AdamW
   steps), LatentQuantize(levels=[5, 5, 8], dim=9) with an in-place SGD,
   BinaryMapper(bits=8, deterministic_on_eval=True), each step 0 against
   the CPU with the same draws and no kernel launched; Sequential(ConvEncoder,
   SimVQ, ConvDecoder), one step against the CPU, K1 and code_sums once;
35. dp_vq_train: DataParallelTrainer over VectorQuantize(dim=256,
   codebook_size=512, decay=0.8, sync_axis='data', train_fused='on',
   kmeans_init=True, threshold_ema_dead_code=2) behind a scalar gain, the
   main batch (1024, 1024, 256) split 2 x (512, 1024, 256) over two gloo
   ranks on the card (one process each): 3 steps with K4 once a rank a
   step, then one step on 'off' (K1 once a rank, index_put_ statistics);
   the ranks' codebooks bit-identical every step (gathered over gloo);
   every step held to one process over the whole batch from the same state
   (the same indices and cluster sizes, both within the f32 bound of one
   float64 EMA step but for the codes the step expired); the step times of
   two ranks time-sharing one card;
36. dp_lfq_train: LFQ(dim=18, codebook_size=2**18, spherical=True,
   entropy_loss_weight=0.1, entropy_fused='on', sync_axis='data') on
   (8, 1024, 18) split over two gloo ranks: K5-K8 once a rank, the ranks'
   sweeps one gbar, their dx and one process's within the LFQ bound of the
   float64 plain sweeps with the cotangents each received, the mean aux and
   x.grad over the world size against one process;
37. dp_nccl1: the dp_vq_train step on a one-rank NCCL group: with kmeans
   and expiry a finite codebook and K4 once; without them bit-identical to
   the module without sync_axis; and the step compiled (kmeans init, then
   the step after it) against its eager twin, as dp_compiled holds it;
37a. dp_compiled: dp_vq_train's configuration with the trainer's step
   compiled whole by inductor (DataParallelTrainer's default on the card),
   its collectives in the graph, on two gloo ranks on the card: 2 'on'
   steps (kmeans init inside the first) and one 'off' step, each from an
   eager twin's state; the ranks bit-identical, every flipped index a
   near-tie in float64, loss, gain and codebook within 1e-5 of eager over
   the unflipped codes, K4 (or K1) once a rank a step, three graphs (two
   for 'on'), K4's symbols in each rank's profiler trace, an unbound axis
   raising NameError from a compiled call; compile seconds, eager and
   compiled ms a rank (CUDA events), idle shares, FX graph cache hits;
37b. tp_vq_train: TensorParallelTrainer over the README's row-sharded
   VectorQuantize(dim=256, codebook_size=65536, sync_axis='data',
   code_axis='code', kmeans_init=True, threshold_ema_dead_code=2) behind a
   scalar gain on a (2, 2) ('data', 'code') mesh of four gloo ranks on the
   card, global (128, 1024, 256), its step compiled whole by inductor (the
   trainer's default on the card), the collectives in the graph: 2 steps
   (kmeans init inside the first), each from an eager twin's state; K1 and
   code_sums once a rank a step (10 more at step 0), every flipped index a
   near-tie in float64, loss, gain and codebook within 1e-5 of eager over
   the unflipped codes, the data replicas bit-identical, at most two
   graphs, step 1 held to one process over the whole batch, K1's and
   code_sums' symbols in each rank's trace; compile seconds, eager and
   compiled ms a rank, idle shares, FX graph cache hits; its checkpoint
   restored by tp_vq_eval;
38. utils: timeit_chained on the VQ eval forward beside phase 5's time, a
   torch.profiler trace holding an annotate label, and dp_vq_train's module
   saved by rank 0 and restored here, its eval forward bit-equal;
39. native_data: native/vqdata.c built by the port into
   build/vqtpu_torch/native/ (no numpy fallback), 8192 synthetic images
   written as an IDX file by the port's write_idx, the native gather
   against the numpy decode bit for bit, the prefetch ring's first 4
   batches against a serial gather, host ms per 256-image batch of the
   native gather and the numpy paths;
40. native_oracle: native/vqcheck.c built the same way; K1 on 8192 of the
   main tokens against the main codebook (c = 512, d = 256), both metrics,
   held to the float64 C oracle but for near-ties, and a tie probe held
   exactly;
41. examples_path: the eight autoencoders of vqtpu_torch.examples, each
   main(train_iter=0) and main(train_iter=N) on the card (N = 200 for the
   VQ example, 50 for the others) on the synthetic images of
   image_batches: logged losses finite, the trained model's held-out L1 in
   eval below the untrained one's, a training step's and an eval forward's
   launches as PERF.md's table says, step ms, the idle share of 5 profiled
   steps and the loop's share in next(data) (for the VQ example also on the
   native loader's prefetch ring); then tp_large_codebook on a (2, 2)
   ('data', 'code') mesh (its step eagerly, as the script's time limit
   requires: PERF.md section 6) and group_parallel_grvq on two ranks, 3 steps
   each, as gloo ranks on the card, with their own checks;
42. entry_dryrun: vqtpu_torch.entry's entry() on the card, fn(state, x)
   twice: bit-identical, the state unchanged, K4 once a call, held to
   entry(device='cpu') on the same state, its ms and idle share; then
   dryrun_multichip over NCCL at torch.cuda.device_count() (one rank a
   card) and over gloo with four ranks on the card (every section, the 2D
   ones included), each rank's K1, K4 and code_sums launches a section
   exactly as predicted; the gloo run held to the same dryrun on four CPU
   ranks (losses, buffers, gradients, indices);
43. dtype_path: each module of the dtype repair (LFQ, ResidualLFQ, FSQ,
   ResidualFSQ and its grouped form, FSP, LatentQuantize, ResidualVQ and
   its grouped form with a codebook_dim, RPQ, HierarchicalVQ, BinaryMapper)
   on bf16 and fp16 inputs, in eval and one training step, on its kernel
   route against its plain route from the same state (dtype_case: the
   output dtypes, the same launches as an f32 input, indices but at
   near-ties and edges, values within 1e-4); then under
   torch.autocast('cuda', dtype=torch.bfloat16) the main VectorQuantize on
   (1024, 1024, 256) in eval and one step per train_fused route, the
   distance path's step, ResidualVQ(dim=256, num_quantizers=8,
   codebook_size=1024) and SimVQ eval, each bit-equal to the call without
   autocast (outputs, losses, the codebook's state) with the same launches;
44. compiled_path (run right after phase 1, while the process has profiled
   little): every kernel is a torch.ops.vqtpu custom op, opaque to
   torch.compile. Compiled whole (fullgraph, inductor) and held to the
   eager call from the same state: VectorQuantize(dim=256,
   codebook_size=512) eval and 3 train_fused='on' steps with x.grad on
   (1024, 1024, 256), the LFQ(dim=18, codebook_size=2**18)
   entropy_fused='on' step on (8, 1024, 18) (x.grad to 1e-3, the entropy
   routes' kink rule), ResidualFSQ(dim=4, levels=[8, 5, 5, 5],
   num_quantizers=8) eval on (2048, 2048, 4), the entry forward and the VQ
   example's training step (forward, torch.autograd.grad and the AdamW
   update in one graph), these two also as CUDA graphs
   (mode='reduce-overhead', no cudagraph skip). Each training step starts
   from eager's state (3 steps): indices but at near-ties, values within
   1e-5, the codebook after the step within 1e-5 over the codes no flipped
   token touched, parameters within 2 lr. A profiler trace of one compiled
   call (warmed, padded by spin kernels; a process whose windows lose
   events profiles the path again in a fresh one, `--profile NAME`) shows
   each path's kernels by symbol at eager's launches (K1 1, K4 1, K5-K8 1
   each, K9 1) and no argmax; compile seconds, eager, compiled and
   CUDA-graph ms (CUDA events, two rounds) and, for the entry forward and
   the example step, idle shares of 5 calls. Then the four example steps
   that draw (the RQ-VAE, HQ, FVQ and FSP autoencoders at batch 256):
   each `main()` trains through its compiled step (`example_run`, once a
   process; examples_path reuses the run), and that step is held to an
   eager twin from the same state for 3 steps, kmeans init inside both at
   step 0 for the RQ-VAE and HQ, the compiled step given eager's means
   (the same launches, indices equal but at near-ties; a step whose
   indices flip is held to the eager step replayed from the same state
   with the compiled step's picks, and the replayed steps are counted;
   losses and codebooks within 1e-5, Adam's moments within 1e-4,
   parameters within 2 lr, the random streams alike), with its kernels by
   symbol in
   a trace (K4 4 for HQ, K1 3 and code_sums 2 for FVQ, none for the
   RQ-VAE's distance path and FSP), compile seconds, eager and compiled
   ms and idle shares;
45. stream (run right after phase 1): the port's counter-based random
   stream (core.sampling.RandomStream), every draw function from the same
   state at 2^20 values on the card and on the CPU, bit for bit, and a
   ResidualVQ with kmeans init, stochastic codes and quantize dropout built
   on the CPU and moved to the card drawing what its CPU copy draws;
46. the {"kernels": [...]} line.

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

import concurrent.futures
import functools
import importlib
import json
import os
import re
import subprocess
import sys
import threading
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


# the script's clock: every phase line says when it was printed
_T0 = time.perf_counter()


_EMIT_LOCK = threading.Lock()
# phases that only wait on rank processes of their own run this many at a
# time (their ranks mostly wait on gloo and the card once compiled)
BESIDE = 4


def emit(phase: str, **fields) -> None:
    line = json.dumps({'phase': phase, 'script_s': time.perf_counter() - _T0, **fields}) + '\n'
    with _EMIT_LOCK:         # phases in threads (main()) print whole lines
        sys.stdout.write(line)
        sys.stdout.flush()


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


STREAM_DRAWS = 1 << 20


def phase_stream(device):
    """stream: the port's counter-based random stream (core.sampling, the
    port's nnx.Rngs stream), every draw function from the same state on the
    card and on the CPU at 2^20 values: the card's values equal the CPU's
    bit for bit (gumbel and normal noise are computed in float64 and
    rounded once; a difference is reported in float32 ulps) and the
    streams' states after it; then ResidualVQ(dim=32, num_quantizers=8,
    codebook_size=256, kmeans_init, stochastic codes, quantize dropout)
    built on the CPU and moved to the card: its streams moved with it, and
    its dropout draws, a codebook stream's gumbel noise and a training
    forward's draws (the streams' states after it) equal the CPU copy's."""
    import copy
    from vqtpu_torch import ResidualVQ
    from vqtpu_torch.core import sampling

    t0 = time.perf_counter()
    n = STREAM_DRAWS
    mask = torch.arange(n) % 7 == 3
    draws = dict(
        bits=lambda g, dev: (g.bits(n),),
        uniform_noise=lambda g, dev: (sampling.uniform_noise(g, (n,)),),
        uniform_noise_bf16=lambda g, dev: (sampling.uniform_noise(g, (n,), dtype=torch.bfloat16),),
        gumbel_noise=lambda g, dev: (sampling.gumbel_noise(g, (n,)),),
        normal_noise=lambda g, dev: (sampling.normal_noise(g, (n,)),),
        bernoulli=lambda g, dev: (sampling.bernoulli(g, torch.full((n,), 0.3, device=dev)),),
        random_permutation=lambda g, dev: (sampling.random_permutation(g, n),),
        bernoulli_and_uniform=lambda g, dev: sampling.bernoulli_and_uniform(g, 0.3, (n,)),
        randint=lambda g, dev: (sampling.randint(g, 1000, n),),
        masked_sample_indices=lambda g, dev: (sampling.masked_sample_indices(g, n, mask.to(dev), n),),
        quantize_dropout_index=lambda g, dev: tuple(sampling.quantize_dropout_index(g, 1, 8, 3)
                                                    for _ in range(64)),
        split=lambda g, dev: (g.split(),),
    )
    out = {}
    for i, (name, draw) in enumerate(draws.items()):
        cpu, card = sampling.new_stream(1234 + i), sampling.new_stream(1234 + i, device)
        want, got = draw(cpu, 'cpu'), [t.cpu() for t in draw(card, device)]
        sync(device)
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        ulps = max(float(((g.double() - w.double()).abs() / torch.finfo(w.dtype).eps
                          / w.double().abs().clamp_min(1.0)).max()) for g, w in zip(got, want)
                   if w.is_floating_point()) if want[0].is_floating_point() else 0.0
        out[name] = dict(equal=equal, max_ulps=ulps, counter=int(card.get_state()[2]))
        check(equal and torch.equal(card.get_state().cpu(), cpu.get_state()),
              f'stream: {name} on the card equals the CPU ({out[name]})')
    torch.manual_seed(91)
    cpu_model = ResidualVQ(dim=32, num_quantizers=8, codebook_size=256, kmeans_init=True,
                           stochastic_sample_codes=True, sample_codebook_temp=0.1, quantize_dropout=True,
                           device='cpu').train()
    card_model = copy.deepcopy(cpu_model).to(device)
    streams = [m.generator for m in card_model.modules() if hasattr(m, 'rng_state')]
    check(streams and all(g.device.type == torch.device(device).type for g in streams),
          'stream: Module.to moved every stream')
    want = [cpu_model.draw_dropout_index() for _ in range(64)]
    got = [card_model.draw_dropout_index().cpu() for _ in range(64)]
    check(all(torch.equal(g, w) for g, w in zip(got, want)), 'stream: the moved module draws its dropout alike')
    cb_cpu, cb_card = cpu_model.layers[0]._codebook, card_model.layers[0]._codebook
    check(torch.equal(sampling.gumbel_noise(cb_card.generator, (4096, 256)).cpu(),
                      sampling.gumbel_noise(cb_cpu.generator, (4096, 256))),
          "stream: the moved module's codebook draws its gumbel noise alike")
    x = torch.from_numpy(np.random.default_rng(92).standard_normal((4, 64, 32), dtype=np.float32))
    with torch.no_grad():
        cpu_model(x, rand_quantize_dropout_index=5)
        card_model(x.to(device), rand_quantize_dropout_index=5)
    sync(device)
    states = [(a.cpu(), b) for (k, a), b in zip(card_model.state_dict().items(), cpu_model.state_dict().values())
              if k.endswith('rng_state')]
    check(all(torch.equal(a, b) for a, b in states), 'stream: a training forward advanced the moved streams alike')
    emit('stream', draws=out, values=n, moved_module_streams=len(states), seconds=time.perf_counter() - t0)
    return out


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
    tkmeans = importlib.import_module('vqtpu_torch.codebook.kmeans')
    import vqtpu_torch.core.sampling as tsampling
    from vqtpu_torch import ResidualVQ, SimpleQuantizeAutoEncoder
    from vqtpu_torch.core.metrics import codebook_perplexity
    from vqtpu_torch.core.sampling import new_stream
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
        return draw_noise(new_stream(1000 + calls['n']), shape).to(device)

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
    from vqtpu_torch.core.sampling import RandomStream
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
        gen = RandomStream(rng_state)
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


# -- the rest of the zoo: SimVQ, ResidualSimVQ, RPQ, HierarchicalVQ, FSP, LatentQuantize, BinaryMapper,
# Sequential ----------------------------------------------------------------------------------------------

# SimVQ(dim=256, codebook_size=512) (README.md:344) at the VQ main shape: b, n, d, c
SIMVQ_MAIN = (1024, 1024, 256, 512)
# ResidualSimVQ(dim=256, num_quantizers=4, codebook_size=512) (README.md:345): b, n, d, q, c
RSIMVQ_MAIN = (32, 2048, 256, 4, 512)
RSIMVQ_DROP = 2
# RandomProjectionQuantizer(dim=512, codebook_size=1024, codebook_dim=256, num_codebooks=16), the
# upstream vector-quantize-pytorch README's example: b, n, dim, c, codebook_dim, heads
RPQ_MAIN = (8, 1024, 512, 1024, 256, 16)


def implicit_grad_reference(model, x, idx):
    """float64 gradient of SimVQ's commitment loss with respect to its
    transform's weight, from the card's picks and the card's implicit
    codebook, with its f32 bound. Only the loss's first term reaches the
    weight (the rotation trick and the second term carry no gradient to the
    rows): dW = G^T F, G the per-code sum of 2 (row - x) / numel
    (`commit_grad_reference`, bounded there), F the frozen codebook; the
    product adds the rounding of a c-term f32 sum."""
    with torch.no_grad():
        implicit = model.codebook.float()
    c = implicit.shape[0]
    g, gbound = commit_grad_reference(implicit, x, idx, c)
    frozen = model.frozen_codebook.double()
    ref = (g.T @ frozen) * model.commitment_weight
    bound = (gbound.T @ frozen.abs() + (c + 2) * U32 * (g.abs().T @ frozen.abs())) * model.commitment_weight
    return ref, bound


def grads_vs_cpu(model, ref) -> tuple[str, float]:
    """The parameter whose card gradient lies farthest from the CPU's, over
    the larger of its largest CPU gradient and 1e-4 of the model's, and
    that error."""
    scale = max(float(rp.grad.abs().max()) for rp in ref.parameters() if rp.grad is not None)
    errs = {name: float((p.grad.cpu().double() - rp.grad.double()).abs().max()
                        / max(float(rp.grad.abs().max()), 1e-4 * scale))
            for (name, p), (_, rp) in zip(model.named_parameters(), ref.named_parameters())
            if rp.grad is not None}
    name = max(errs, key=errs.get)
    return name, errs[name]


def layer_input_hooks(layers) -> tuple[list, list]:
    """Forward pre-hooks that keep each layer's (detached) input."""
    inputs = [None] * len(layers)

    def keep(i):
        def hook(module, args):
            inputs[i] = args[0].detach()
        return hook
    return inputs, [layer.register_forward_pre_hook(keep(i)) for i, layer in enumerate(layers)]


def simvq_vs_plain(model, xin, idx):
    """A SimVQ layer's picks on its input against the plain selection on
    its implicit codebook."""
    from vqtpu_torch.kernels.distance import nearest_code_plain, selection_bias, selection_disagreements
    with torch.no_grad():
        implicit = model.codebook.float().contiguous()
    xs = xin.reshape(-1, implicit.shape[-1]).float().contiguous()
    bias = selection_bias(implicit, 'euclidean')
    return selection_disagreements(xs, implicit, bias, idx.reshape(-1), nearest_code_plain(xs, implicit, bias))


def phase_simvq_path(device, sizes):
    """Path 1: SimVQ(dim=256, codebook_size=512, rotation_trick=True) on
    (1024, 1024, 256). Eval: one K1 launch (selection and rows of the
    implicit codebook), the indices against the plain selection on the same
    implicit codebook (near-ties only), the rows bit-equal to the implicit
    codebook's, the decode from indices (the transform over the gathered
    frozen rows) within 1e-5 of the largest entry. Training, 3 AdamW steps:
    one K1 and one code_sums a step, the transform's weight gradient within
    the f32 summation bound of a float64 reference from the card's picks, a
    twin step bit-identical. Then the SimVQ autoencoder of
    examples/autoencoder_sim_vq.py, 50 AdamW steps, step 0 against the CPU;
    then times."""
    from vqtpu_torch import SimVQ, SimpleQuantizeAutoEncoder
    from vqtpu_torch.kernels.distance import quantize_lookup, selection_bias, selection_disagreements
    from vqtpu_torch.kernels.train_fused import code_sums
    b, n, d, c = sizes['simvq_main']

    def build():
        torch.manual_seed(41)
        return SimVQ(dim=d, codebook_size=c, rotation_trick=True, device=device)
    model = build().eval()
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.standard_normal((b, n, d), dtype=np.float32)).to(device)
    g = torch.from_numpy(rng.standard_normal((b, n, d), dtype=np.float32) * 1e-3).to(device)
    xs = x.reshape(-1, d)
    reset_all_launches()
    with torch.no_grad():
        q, idx, loss = model(x)
    sync(device)
    eval_launches = all_launches()
    check(eval_launches['nearest_code'] == 1 and sum(eval_launches.values()) == 1,
          f'a SimVQ eval forward launched K1 once {eval_launches}')
    with torch.no_grad():
        implicit = model.codebook
        dec = model.indices_to_codes(idx)
    r_eval = simvq_vs_plain(model, x, idx)
    check(r_eval['non_tie'] == 0, f'SimVQ eval indices against the plain selection {r_eval}')
    check(torch.equal(q.reshape(-1, d), implicit[idx.reshape(-1).long()]) and float(loss) == 0.0,
          'SimVQ eval rows bit-equal to the implicit codebook rows, loss 0')
    dec_err = float((dec - q).abs().max() / q.abs().max())
    check(dec_err <= 1e-5, f'SimVQ decode from indices within 1e-5 of the output ({dec_err})')
    del dec

    model.train()
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    twin = build().train()
    step_launches, checks = [], {}
    for step in range(sizes['train_steps']):
        reset_all_launches()
        xg = x.clone().requires_grad_()
        q, idx, loss = model(xg)
        ((q * g).sum() + loss).backward()
        sync(device)
        step_launches.append(all_launches())
        check(step_launches[-1]['nearest_code'] == 1 and step_launches[-1]['code_sums'] == 1
              and sum(step_launches[-1].values()) == 2,
              f'SimVQ step {step} launched K1 and code_sums once {step_launches[-1]}')
        if step == 0:
            weight = model.code_transform.weight
            ref, bound = implicit_grad_reference(model, xs, idx.reshape(-1))
            share = float(((weight.grad.double() - ref).abs() / bound.clamp_min(1e-300)).max())
            check(share <= 1.0, f"SimVQ's transform gradient within its f32 bound of float64 ({share})")
            r = simvq_vs_plain(model, x, idx)
            check(r['non_tie'] == 0, f'SimVQ training indices against the plain selection {r}')
            xt = x.clone().requires_grad_()
            qt, idxt, losst = twin(xt)
            ((qt * g).sum() + losst).backward()
            sync(device)
            check(torch.equal(idx, idxt) and torch.equal(q, qt) and torch.equal(xg.grad, xt.grad)
                  and torch.equal(weight.grad, twin.code_transform.weight.grad),
                  'two SimVQ steps from one state are bit-identical')
            check(bool(torch.isfinite(xg.grad).all()), 'finite x.grad')
            checks = dict(grad_share_of_bound=share, indices_vs_plain=r, loss=loss.item(), bit_identical_twin=True)
            del twin, xt, qt, ref, bound
        opt.step()
        opt.zero_grad()
    del xg, q

    def step():
        xt = x.clone().requires_grad_()
        qt, _, lt = model(xt)
        ((qt * g).sum() + lt).backward()
    t = timed_step(step, sizes['step_reps'])
    model.eval()
    eval_ms = cuda_ms(lambda: model(x), sizes['reps'])
    with torch.no_grad():
        implicit = model.codebook.float().contiguous()
        idx = model.lookup(xs)[0]
    k1_ms = cuda_ms(lambda: quantize_lookup(xs, implicit), sizes['reps'])
    sums_ms = cuda_ms(lambda: code_sums(g.reshape(-1, d), idx, c), sizes['reps'])
    t.update(k1_ms=k1_ms, k1_share=k1_ms / t['step_ms'], code_sums_ms=sums_ms,
             code_sums_share=sums_ms / t['step_ms'], eval_forward_ms=eval_ms, eval_k1_share=k1_ms / eval_ms)
    emit('simvq_path', model=f'SimVQ(dim={d}, codebook_size={c}, rotation_trick=True)', input=[b, n, d],
         eval_launches=eval_launches, eval_indices_vs_plain=r_eval, decode_rel_err=dec_err,
         train_launches_per_step=step_launches, optimizer='AdamW(lr=3e-4, weight_decay=1e-4)', **checks, **t)
    del model, x, g, xs, opt

    # the SimVQ autoencoder (examples/autoencoder_sim_vq.py:17-21), alpha 10
    def build_ae(dev):
        return SimpleQuantizeAutoEncoder(SimVQ(dim=32, codebook_size=256, device=dev), dim=32, device=dev).train()

    def loss_of(model, x):
        recon, idx, cmt = model(x)
        return (recon.clamp(-1, 1) - x).abs().mean() + 10.0 * cmt, idx

    torch.manual_seed(43)
    ae = build_ae(device)
    ref = build_ae('cpu')
    ref.load_state_dict({k: v.cpu() for k, v in ae.state_dict().items()})
    rng = np.random.default_rng(44)
    images = [rng.random((sizes['images'], 28, 28, 1), dtype=np.float32) for _ in range(sizes['flagship_steps'])]
    x0 = torch.from_numpy(images[0])
    with torch.no_grad():
        z = ae.encoder(x0.to(device)).reshape(-1, 32)
        implicit = ae.quantizer.codebook
    reset_all_launches()
    loss0, idx0 = loss_of(ae, x0.to(device))
    loss0.backward()
    sync(device)
    ae_launches = all_launches()
    check(ae_launches['nearest_code'] == 1 and ae_launches['code_sums'] == 1,
          f'a SimVQ autoencoder step launched K1 and code_sums once {ae_launches}')
    ref_loss, ref_idx = loss_of(ref, x0)
    ref_loss.backward()
    r = selection_disagreements(z, implicit, selection_bias(implicit, 'euclidean'), idx0.reshape(-1),
                                ref_idx.reshape(-1).to(device))
    check(r['non_tie'] == 0, f'SimVQ autoencoder step 0: indices against the CPU {r}')
    loss_rel = abs(loss0.item() - ref_loss.item()) / abs(ref_loss.item())
    check(loss_rel <= 1e-4, f'SimVQ autoencoder step 0: loss as on the CPU ({loss_rel})')
    grad_name, grad_err = grads_vs_cpu(ae, ref)
    check(r['disagree'] > 0 or grad_err <= 1e-3,
          f'SimVQ autoencoder step 0: gradients as on the CPU ({grad_name}: {grad_err})')
    del ref
    ae_opt = torch.optim.AdamW(ae.parameters(), lr=3e-4, weight_decay=1e-4)
    ae_opt.step()
    ae_opt.zero_grad()
    losses, used = [loss0.item()], [int(idx0.unique().numel())]
    for step in range(1, len(images)):
        loss, idx = loss_of(ae, torch.from_numpy(images[step]).to(device))
        loss.backward()
        ae_opt.step()
        ae_opt.zero_grad()
        losses.append(loss.item())
        used.append(int(idx.unique().numel()))
    check(all(np.isfinite(losses)), 'SimVQ autoencoder losses are finite')
    imgs = torch.from_numpy(images[-1]).to(device)

    def ae_step():
        loss_of(ae, imgs)[0].backward()
        ae_opt.step()
        ae_opt.zero_grad()
    t_ae = timed_step(ae_step, sizes['step_reps'], warmup=2)
    emit('simvq_autoencoder', model='SimpleQuantizeAutoEncoder(SimVQ(dim=32, codebook_size=256), dim=32)',
         optimizer='AdamW(lr=3e-4, weight_decay=1e-4)', input=[sizes['images'], 28, 28, 1], steps=len(images),
         launches_step0=ae_launches, loss_first=losses[0], loss_last=losses[-1], codes_used_first=used[0],
         codes_used_last=used[-1], step0_vs_cpu=dict(loss_rel_err=loss_rel, grad_max_rel_err=grad_err,
                                                      grad_worst=grad_name, **r), **t_ae)
    return dict(eval=eval_launches, step=step_launches[0], ae_step=ae_launches), \
        dict(step_ms=t['step_ms'], eval_ms=eval_ms, k1_ms=k1_ms, code_sums_ms=sums_ms, ae_step_ms=t_ae['step_ms'])


def phase_rsimvq_path(device, sizes):
    """Path 2: ResidualSimVQ(dim=256, num_quantizers=4, codebook_size=512)
    on (32, 2048, 256). Eval: K1 once a layer, each layer's indices against
    the plain selection on that layer's input (near-ties only), the decode
    from indices within 1e-6 of the largest output entry (the same rows
    summed in another order). With quantize_dropout=True, one training step
    at dropout index 2: K1 and code_sums once a layer, dropped layers
    included; the dropped layer's codes zero, its indices -1, its loss 0
    and its transform's gradient exactly 0. Then times."""
    from vqtpu_torch import ResidualSimVQ
    b, n, d, q, c = sizes['rsimvq_main']
    torch.manual_seed(45)
    model = ResidualSimVQ(dim=d, num_quantizers=q, codebook_size=c, device=device).eval()
    rng = np.random.default_rng(46)
    x = torch.from_numpy(rng.standard_normal((b, n, d), dtype=np.float32)).to(device)
    g = torch.from_numpy(rng.standard_normal((b, n, d), dtype=np.float32) * 1e-3).to(device)
    inputs, hooks = layer_input_hooks(model.layers)
    reset_all_launches()
    with torch.no_grad():
        out, idx, losses = model(x)
    sync(device)
    eval_launches = all_launches()
    for h in hooks:
        h.remove()
    check(eval_launches['nearest_code'] == q and sum(eval_launches.values()) == q,
          f'a ResidualSimVQ eval forward launched K1 once a layer {eval_launches}')
    reports = [simvq_vs_plain(layer, xin, idx[..., i]) for i, (layer, xin) in enumerate(zip(model.layers, inputs))]
    check(all(r['non_tie'] == 0 for r in reports), f'ResidualSimVQ layers against the plain selection {reports}')
    del inputs
    with torch.no_grad():
        dec = model.get_output_from_indices(idx)
    dec_err = float((dec - out).abs().max() / out.abs().max())
    check(dec_err <= 1e-6, f'ResidualSimVQ decode from indices within 1e-6 ({dec_err})')
    eval_ms = cuda_ms(lambda: model(x), sizes['rvq_reps'])

    torch.manual_seed(47)
    train = ResidualSimVQ(dim=d, num_quantizers=q, codebook_size=c, quantize_dropout=True, device=device).train()
    reset_all_launches()
    xg = x.clone().requires_grad_()
    out, idx, losses, codes = train(xg, return_all_codes=True, rand_quantize_dropout_index=RSIMVQ_DROP)
    ((out * g).sum() + losses.sum()).backward()
    sync(device)
    step_launches = all_launches()
    check(step_launches['nearest_code'] == q and step_launches['code_sums'] == q
          and sum(step_launches.values()) == 2 * q,
          f'a ResidualSimVQ step launched K1 and code_sums once a layer {step_launches}')
    kept, dropped = slice(0, RSIMVQ_DROP + 1), slice(RSIMVQ_DROP + 1, q)
    check(bool((idx[..., dropped] == -1).all()) and bool((idx[..., kept] >= 0).all())
          and bool((losses[dropped] == 0).all()) and bool((codes[dropped] == 0).all()),
          'the dropped layers give index -1, loss 0 and zero codes')
    check(all(bool((layer.code_transform.weight.grad == 0).all()) for layer in train.layers[dropped])
          and all(float(layer.code_transform.weight.grad.abs().max()) > 0 for layer in train.layers[kept]),
          "the dropped layers' transforms take a zero gradient, the kept ones a nonzero one")
    check(bool(torch.isfinite(xg.grad).all()), 'finite x.grad')

    def step():
        xt = x.clone().requires_grad_()
        o, _, ls = train(xt, rand_quantize_dropout_index=RSIMVQ_DROP)
        ((o * g).sum() + ls.sum()).backward()
    t = timed_step(step, sizes['rvq_step_reps'])
    emit('rsimvq_path', model=f'ResidualSimVQ(dim={d}, num_quantizers={q}, codebook_size={c})', input=[b, n, d],
         eval_launches=eval_launches, layers_vs_plain=reports, decode_rel_err=dec_err, eval_forward_ms=eval_ms,
         dropout_index=RSIMVQ_DROP, step_launches=step_launches, **t)
    return dict(eval=eval_launches, step=step_launches), dict(eval_ms=eval_ms, step_ms=t['step_ms'])


def phase_rpq_path(device, sizes):
    """Path 3: RandomProjectionQuantizer(dim=512, codebook_size=1024,
    codebook_dim=256, num_codebooks=16) on (8, 1024, 512). As in the JAX
    package (and upstream), its VectorQuantize takes codebook_dim = dim =
    16 * 256 a head, so the heads are 4096 wide after a 4096 -> 65536
    projection. The forward launches K1 once over all 16 heads (cosine);
    each head's indices against the plain selection on the same
    codebook-space input (near-ties only); the cross entropy against given
    indices launches nothing and is held to float64 within 1e-5. Then
    times, with K1 alone against its bound."""
    from vqtpu_torch import RandomProjectionQuantizer
    from vqtpu_torch.kernels.distance import nearest_code, nearest_code_plain, selection_bias, \
        selection_disagreements
    b, n, dim, c, cd, h = sizes['rpq_main']
    torch.manual_seed(48)
    model = RandomProjectionQuantizer(dim=dim, codebook_size=c, codebook_dim=cd, num_codebooks=h, device=device)
    x = torch.from_numpy(np.random.default_rng(49).standard_normal((b, n, dim), dtype=np.float32)).to(device)
    reset_all_launches()
    with torch.no_grad():
        idx = model(x)
    sync(device)
    launches = all_launches()
    check(launches['nearest_code'] == 1 and sum(launches.values()) == 1,
          f'an RPQ forward launched K1 once over its {h} heads {launches}')
    check(tuple(idx.shape) == (b, n, h), f'RPQ indices of shape {tuple(idx.shape)}')
    embed = model.vq._codebook.embed
    with torch.no_grad():
        t = torch.einsum('bnd,hde->bnhe', model.norm(x), model.rand_projs).reshape(b, n, -1)
        xc = model.vq.codebook_input(t).reshape(h, b * n, -1).contiguous()
    heads, non_tie = [], 0
    for i in range(h):
        bias = selection_bias(embed[i], 'cosine')
        r = selection_disagreements(xc[i], embed[i], bias, idx[..., i].reshape(-1),
                                    nearest_code_plain(xc[i], embed[i], bias))
        heads.append(r['disagree'])
        non_tie += r['non_tie']
    check(non_tie == 0, f'RPQ heads against the plain selection (disagreements {heads})')
    targets = idx.roll(1, dims=1)
    reset_all_launches()
    with torch.no_grad():
        ce = model(x, indices=targets)
    sync(device)
    ce_launches = all_launches()
    check(sum(ce_launches.values()) == 0, f'the RPQ cross entropy launched no kernel {ce_launches}')
    nll = torch.zeros((), dtype=torch.float64, device=device)
    for i in range(h):
        logits = xc[i].double() @ embed[i].double().T
        tgt = targets[..., i].reshape(-1).long()
        nll += (torch.logsumexp(logits, -1) - logits.gather(-1, tgt[:, None])[:, 0]).sum()
    ce64 = float(nll) / (b * n * h)
    ce_err = abs(float(ce) - ce64) / abs(ce64)
    check(ce_err <= 1e-5, f'the RPQ cross entropy within 1e-5 of float64 ({ce_err})')
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model(x), 3, warmup=1)
        k1_ms = cuda_ms(lambda: nearest_code(xc, embed, 'cosine'), 5, warmup=1)
    bound, by = selection_bound_tc_ms(h * b * n, c, xc.shape[-1])
    emit('rpq_path', model=f'RandomProjectionQuantizer(dim={dim}, codebook_size={c}, codebook_dim={cd}, '
                           f'num_codebooks={h})', input=[b, n, dim], head_width=int(xc.shape[-1]),
         launches=launches, ce_launches=ce_launches, head_disagreements=heads, ce=float(ce), ce_rel_err=ce_err,
         forward_ms=fwd_ms, k1_ms=k1_ms, k1_bound_ms=bound, k1_bound_by=by, k1_share_of_forward=k1_ms / fwd_ms,
         k1_share_of_bound=bound / k1_ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return launches, dict(forward_ms=fwd_ms, k1_ms=k1_ms, k1_bound_ms=bound)


def hq_autoencoder(dev, train_fused):
    """The HierarchicalVQ autoencoder of examples/autoencoder_hq.py:21-45:
    a conv encoder, HierarchicalVQ(dim=32, codebook_size=512, scales=(1, 2,
    4, 7), kmeans_init=True, quant_resi=0.5, share_quant_resi=1) on the
    channel-first feature map, a conv decoder."""
    from vqtpu_torch import HierarchicalVQ
    from vqtpu_torch.models.autoencoder import ConvDecoder, ConvEncoder

    class HQAutoEncoder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = ConvEncoder(32, device=dev)
            self.hq = HierarchicalVQ(dim=32, codebook_size=512, scales=(1, 2, 4, 7), accept_image_fmap=True,
                                     kmeans_init=True, quant_resi=0.5, share_quant_resi=1,
                                     train_fused=train_fused, device=dev)
            self.decoder = ConvDecoder(32, device=dev)

        def forward(self, x):
            recon, indices, commit = self.hq(self.encoder(x).permute(0, 3, 1, 2))
            return self.decoder(recon.permute(0, 2, 3, 1)), indices, commit
    return HQAutoEncoder().train()


def phase_hq_path(device, sizes):
    """Path 4: the HierarchicalVQ autoencoder (examples/autoencoder_hq.py),
    train_fused='on', batch 256: step 0 against the CPU from the same
    weights with the same kmeans and expiry rows (each scale's picks on the
    card against the CPU's, near-ties only on the card's own input and
    codebook), K4 once a scale a step and no K1; 50 AdamW steps; then an
    eval forward, K1 once a scale, its decode from indices within 1e-5;
    times with the device's idle share."""
    import vqtpu_torch.codebook.codebook as tcodebook
    tkmeans = importlib.import_module('vqtpu_torch.codebook.kmeans')
    from vqtpu_torch.kernels.distance import selection_bias, selection_disagreements

    def loss_of(model, x):
        recon, idx, cmt = model(x)
        return (recon.clamp(-1, 1) - x).abs().mean() + 10.0 * cmt, idx

    torch.manual_seed(50)
    model = hq_autoencoder(device, 'on')
    ref = hq_autoencoder('cpu', 'on')
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(51)
    images = [rng.random((sizes['images'], 28, 28, 1), dtype=np.float32) for _ in range(sizes['flagship_steps'])]

    def rows(count, num):
        return torch.from_numpy(np.random.default_rng(52 + count).integers(0, count, num))

    draw_means, draw_rows, init = tkmeans.sample_means, tcodebook.masked_sample_vectors, tcodebook.Codebook.init_embed_
    # each scale's codebook-space tokens on the card and the codebook its
    # selection met (the first scale's after its kmeans init)
    seen = []

    def init_and_keep(self, flatten, mask=None):
        init(self, flatten, mask)
        if seen and seen[-1][1] is None:
            seen[-1] = (seen[-1][0], self.embed.detach()[0].clone())

    def keep_input(module, args):
        tokens = args[0].detach().movedim(1, -1).reshape(-1, 32)
        seen.append((tokens, module._codebook.embed.detach()[0].clone()
                     if bool(module._codebook.initted) else None))
    tkmeans.sample_means = lambda gen, s, mask, num: s[:, rows(s.shape[1], num).to(s.device)]
    tcodebook.masked_sample_vectors = lambda gen, s, mask, num: s[rows(s.shape[0], num).to(s.device)]
    tcodebook.Codebook.init_embed_ = init_and_keep
    hook = model.hq.vq.register_forward_pre_hook(keep_input)
    try:
        x0 = torch.from_numpy(images[0])
        reset_all_launches()
        loss0, idx0 = loss_of(model, x0.to(device))
        loss0.backward()
        sync(device)
        launches = all_launches()
        hook.remove()
        ref_loss, ref_idx = loss_of(ref, x0)
        ref_loss.backward()
    finally:
        tkmeans.sample_means, tcodebook.masked_sample_vectors, tcodebook.Codebook.init_embed_ = \
            draw_means, draw_rows, init
    check(launches['train_fused'] == 4 and sum(launches.values()) == 4,
          f'an HQ training step launched K4 once a scale {launches}')
    scale_reports = [selection_disagreements(tokens, embed, selection_bias(embed, 'euclidean'), ti.reshape(-1),
                                             ri.reshape(-1).to(device))
                     for (tokens, embed), ti, ri in zip(seen, idx0, ref_idx)]
    check(all(r['non_tie'] == 0 for r in scale_reports), f'HQ step 0: each scale against the CPU {scale_reports}')
    loss_rel = abs(loss0.item() - ref_loss.item()) / abs(ref_loss.item())
    check(loss_rel <= 1e-4, f'HQ step 0: loss as on the CPU ({loss_rel})')
    grad_name, grad_err = grads_vs_cpu(model, ref)
    disagree = sum(r['disagree'] for r in scale_reports)
    check(disagree > 0 or grad_err <= 1e-3, f'HQ step 0: gradients as on the CPU ({grad_name}: {grad_err})')
    del ref, seen
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    opt.step()
    opt.zero_grad()
    losses = [loss0.item()]
    reset_all_launches()
    for step in range(1, len(images)):
        loss, _ = loss_of(model, torch.from_numpy(images[step]).to(device))
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())
    train_launches = all_launches()
    check(train_launches['train_fused'] == 4 * (len(images) - 1)
          and sum(train_launches.values()) == train_launches['train_fused'],
          f'K4 once a scale in every HQ step {train_launches}')
    check(all(np.isfinite(losses)), 'HQ losses are finite')
    imgs = torch.from_numpy(images[-1]).to(device)

    def step():
        loss_of(model, imgs)[0].backward()
        opt.step()
        opt.zero_grad()
    t = timed_step(step, sizes['step_reps'], warmup=2)
    model.eval()
    reset_all_launches()
    with torch.no_grad():
        z = model.encoder(imgs).permute(0, 3, 1, 2)
        recon, idx, _ = model.hq(z)
        sync(device)
        eval_launches = all_launches()
        dec = model.hq.get_output_from_indices(idx)
        eval_ms = cuda_ms(lambda: model(imgs), sizes['reps'])
    check(eval_launches['nearest_code'] == 4 and sum(eval_launches.values()) == 4,
          f'an HQ eval forward launched K1 once a scale {eval_launches}')
    dec_err = float((dec - recon).abs().max() / recon.abs().max())
    check(dec_err <= 1e-5, f'HQ decode from indices within 1e-5 ({dec_err})')
    emit('hq_path', model='HQAutoEncoder(HierarchicalVQ(dim=32, codebook_size=512, scales=(1, 2, 4, 7), '
                          "kmeans_init=True, quant_resi=0.5, share_quant_resi=1, train_fused='on'))",
         optimizer='AdamW(lr=3e-4, weight_decay=1e-4)', input=[sizes['images'], 28, 28, 1], steps=len(images),
         launches_step0=launches, launches_steps_1_49=train_launches, eval_launches=eval_launches,
         step0_vs_cpu=dict(loss_rel_err=loss_rel, grad_max_rel_err=grad_err, grad_worst=grad_name,
                           scales=scale_reports),
         loss_first=losses[0], loss_last=losses[-1], decode_rel_err=dec_err, eval_forward_ms=eval_ms, **t)
    return dict(step=launches, eval=eval_launches), dict(step_ms=t['step_ms'], eval_ms=eval_ms,
                                                         idle=t['profile']['device_idle_share'])


def step0_vs_cpu(name, build, loss_of, x, device, extra=None, before=None):
    """One training step of `build(device)` and of a CPU twin with the same
    weights: the card's launches, the loss within 1e-4, every parameter
    gradient within 1e-3 of the larger of its largest CPU entry and 1e-4 of
    the model's (unless `extra`, which compares the two steps' aux outputs,
    reports picks that differ); `before()` runs before each side's
    forward."""
    torch.manual_seed(53)
    model = build(device)
    ref = build('cpu')
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    if before:
        before()
    reset_all_launches()
    loss, aux = loss_of(model, x.to(device))
    loss.backward()
    sync(device)
    launches = all_launches()
    if before:
        before()
    ref_loss, ref_aux = loss_of(ref, x)
    ref_loss.backward()
    loss_rel = abs(loss.item() - ref_loss.item()) / max(abs(ref_loss.item()), 1e-30)
    check(loss_rel <= 1e-4, f'{name} step 0: loss as on the CPU ({loss_rel})')
    grad_name, grad_err = grads_vs_cpu(model, ref)
    report = dict(launches=launches, loss=loss.item(), loss_rel_err=loss_rel, grad_max_rel_err=grad_err,
                  grad_worst=grad_name)
    if extra is not None:
        report.update(extra(model, ref, aux, ref_aux))
    check(grad_err <= 1e-3 or report.get('disagree', 0) > 0,
          f'{name} step 0: gradients as on the CPU ({grad_name}: {grad_err})')
    return model, report


def phase_zoo_path(device, sizes):
    """Path 5, no kernel: the FSP autoencoder (examples/autoencoder_fsp.py),
    50 AdamW steps, step 0 against the CPU with the perturbation's uniform
    draws given to both; LatentQuantize(levels=[5, 5, 8], dim=9) with an
    in-place SGD, one step against the CPU (the level values after the
    inner step within 1e-6); BinaryMapper(bits=8,
    deterministic_on_eval=True), one training step against the CPU with the
    same Bernoulli draws, and a deterministic eval; none of them launches a
    kernel. Then Sequential(ConvEncoder, SimVQ, ConvDecoder): one step
    against the CPU, K1 and code_sums once."""
    import vqtpu_torch.core.sampling as tsampling
    from vqtpu_torch import FSP, BinaryMapper, LatentQuantize, Sequential, SimVQ, SimpleQuantizeAutoEncoder
    from vqtpu_torch.models.autoencoder import ConvDecoder, ConvEncoder
    out = {}
    draw_uniform, draw_bernoulli = tsampling.uniform_noise, tsampling.bernoulli
    calls = {'n': 0}

    def restart_draws():
        calls['n'] = 0

    def same_uniform(gen, shape, dtype=torch.float32, device=None):
        calls['n'] += 1
        u = torch.rand(tuple(shape), generator=torch.Generator().manual_seed(2000 + calls['n']), dtype=dtype)
        return u.to(device)

    def same_bernoulli(gen, prob):
        u = torch.rand(tuple(prob.shape), generator=torch.Generator().manual_seed(3000), dtype=prob.dtype)
        return u.to(prob.device) < prob

    def mismatch_share(what):
        def extra(model, ref, idx, ref_idx):
            share = float((idx.cpu() != ref_idx).float().mean())
            check(share <= 1e-3, f'{what} step 0: indices as on the CPU but at bin edges and near-ties ({share})')
            return dict(index_mismatch_share=share)
        return extra

    # FSP autoencoder: levels (8, 6, 5), tanh, quantize_rate 0.5, var_tanh; loss rec + norm loss
    def fsp_ae(dev):
        return SimpleQuantizeAutoEncoder(FSP([8, 6, 5], dim=32, act_name='tanh', quantize_rate=0.5,
                                             vector_norm='var_tanh', device=dev), dim=32, device=dev).train()

    def fsp_loss(model, x):
        recon, idx, norm_loss, _ = model(x)
        return (recon.clamp(-1, 1) - x).abs().mean() + norm_loss, idx

    rng = np.random.default_rng(54)
    images = [rng.random((sizes['images'], 28, 28, 1), dtype=np.float32) for _ in range(sizes['flagship_steps'])]
    tsampling.uniform_noise = same_uniform
    try:
        fsp, out['fsp_step0'] = step0_vs_cpu('FSP autoencoder', fsp_ae, fsp_loss, torch.from_numpy(images[0]),
                                             device, mismatch_share('FSP'), before=restart_draws)
        check(calls['n'] == 2, f'FSP drew its offsets and its mask ({calls["n"]} draws)')
    finally:
        tsampling.uniform_noise = draw_uniform
    opt = torch.optim.AdamW(fsp.parameters(), lr=3e-4, weight_decay=1e-4)
    opt.step()
    opt.zero_grad()
    losses = [out['fsp_step0']['loss']]
    reset_all_launches()
    for step in range(1, len(images)):
        loss, _ = fsp_loss(fsp, torch.from_numpy(images[step]).to(device))
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())
    sync(device)
    check(sum(all_launches().values()) == 0 and sum(out['fsp_step0']['launches'].values()) == 0,
          'the FSP autoencoder launched no kernel')
    check(all(np.isfinite(losses)), 'FSP losses are finite')
    imgs = torch.from_numpy(images[-1]).to(device)

    def fsp_step():
        fsp_loss(fsp, imgs)[0].backward()
        opt.step()
        opt.zero_grad()
    t_fsp = timed_step(fsp_step, sizes['step_reps'], warmup=2)
    out.update(fsp_steps=len(images), fsp_loss_first=losses[0], fsp_loss_last=losses[-1],
               fsp_step_ms=t_fsp['step_ms'], fsp_idle_share=t_fsp['profile']['device_idle_share'])
    del fsp, opt

    # LatentQuantize(levels=[5, 5, 8], dim=9) (README.md:332) with an in-place SGD, channel-first input
    def lq(dev):
        return LatentQuantize(levels=[5, 5, 8], dim=9, device=dev,
                              in_place_codebook_optimizer=lambda p: torch.optim.SGD(p, lr=0.1)).train()

    def lq_loss(model, x):
        o, idx, loss = model(x)
        return (o * x).mean() + loss, idx

    def lq_extra(model, ref, idx, ref_idx):
        report = mismatch_share('LatentQuantize')(model, ref, idx, ref_idx)
        err = max(float((v.detach().cpu() - rv.detach()).abs().max())
                  for v, rv in zip(model.values_per_latent, ref.values_per_latent))
        check(err <= 1e-6, f'LatentQuantize: the in-place SGD step as on the CPU ({err})')
        return dict(report, values_err=err)
    xl = torch.from_numpy(np.random.default_rng(55).standard_normal((64, 9, 32, 32), dtype=np.float32))
    _, out['latent_step0'] = step0_vs_cpu('LatentQuantize', lq, lq_loss, xl, device, lq_extra)
    check(sum(out['latent_step0']['launches'].values()) == 0, 'LatentQuantize launched no kernel')

    # BinaryMapper(bits=8, deterministic_on_eval=True) (README.md:368), behind a learnable scale
    class ScaledLogits(torch.nn.Module):
        def __init__(self, dev):
            super().__init__()
            self.scale = torch.nn.Parameter(torch.ones(8, device=dev))
            self.mapper = BinaryMapper(bits=8, deterministic_on_eval=True, device=dev)

        def forward(self, x):
            return self.mapper(x * self.scale, return_indices=True)

    def bm_loss(model, x):
        one_hot, idx, aux = model(x)
        w = torch.linspace(-1, 1, 256, device=x.device)
        return (one_hot * w).sum(-1).mean() + aux, (idx, one_hot.detach())

    def bm_extra(model, ref, aux, ref_aux):
        """The card's sigmoid may round an ulp from the CPU's: a bit may
        differ only where its draw lies within 1e-6 of its probability; the
        one-hots (with the soft-G estimator's value, one_hot + g - g) within
        1e-6 where the codes agree."""
        (idx, hot), (ref_idx, ref_hot) = aux, ref_aux
        differ = idx.cpu() != ref_idx
        u = torch.rand(xb.shape, generator=torch.Generator().manual_seed(3000))
        near = ((u - torch.sigmoid(xb)).abs() < 1e-6).any(-1)
        check(bool(near[differ].all()) and float(differ.float().mean()) <= 1e-3,
              f'BinaryMapper step 0: {int(differ.sum())} codes differ from the CPU, not all at a drawn edge')
        hot_err = float((hot.cpu()[~differ] - ref_hot[~differ]).abs().max())
        check(hot_err <= 1e-6, f'BinaryMapper step 0: one-hots as on the CPU ({hot_err})')
        return dict(disagree=int(differ.sum()), one_hot_err=hot_err)
    xb = torch.from_numpy(np.random.default_rng(56).standard_normal((256, 1024, 8), dtype=np.float32) * 2)
    tsampling.bernoulli = same_bernoulli
    try:
        bm, out['binary_mapper_step0'] = step0_vs_cpu('BinaryMapper', ScaledLogits, bm_loss, xb, device, bm_extra)
    finally:
        tsampling.bernoulli = draw_bernoulli
    bm.eval()
    reset_all_launches()
    with torch.no_grad():
        _, i1, _ = bm(xb.to(device))
        _, i2, _ = bm(xb.to(device))
        want = ((torch.sigmoid(xb.to(device)) > 0.5).long() * 2 ** torch.arange(8, device=device)).sum(-1)
    check(torch.equal(i1, i2) and torch.equal(i1.long(), want), 'BinaryMapper eval is deterministic')
    check(sum(out['binary_mapper_step0']['launches'].values()) == 0 and sum(all_launches().values()) == 0,
          'BinaryMapper launched no kernel')

    # Sequential(ConvEncoder, SimVQ, ConvDecoder)
    def seq(dev):
        return Sequential(ConvEncoder(32, device=dev), SimVQ(dim=32, codebook_size=256, device=dev),
                          ConvDecoder(32, device=dev)).train()

    def seq_loss(model, x):
        recon, idx, cmt = model(x)
        return (recon.clamp(-1, 1) - x).abs().mean() + 10.0 * cmt, idx

    def seq_extra(model, ref, idx, ref_idx):
        disagree = int((idx.cpu() != ref_idx).sum())
        check(disagree <= 1e-3 * idx.numel(), f'Sequential step 0: {disagree} picks differ from the CPU')
        return dict(disagree=disagree)
    xs = torch.from_numpy(np.random.default_rng(57).random((sizes['images'], 28, 28, 1), dtype=np.float32))
    _, out['sequential_step0'] = step0_vs_cpu('Sequential', seq, seq_loss, xs, device, seq_extra)
    sl = out['sequential_step0']['launches']
    check(sl['nearest_code'] == 1 and sl['code_sums'] == 1 and sum(sl.values()) == 2,
          f'a Sequential(SimVQ) step launched K1 and code_sums once {sl}')
    emit('zoo_path', **out)
    return out


# -- data parallel (PR 12): two ranks on one card over gloo ---------------------

# VectorQuantize(dim=256, codebook_size=512) on the main batch (1024, 1024,
# 256), split over two ranks along the batch: b, n, d, c
DP_MAIN = (1024, 1024, 256, 512)
DP_WORLD = 2
DP_VQ_KW = dict(dim=256, codebook_size=512, decay=0.8, kmeans_init=True, threshold_ema_dead_code=2)
DP_STEPS = 3
DP_JOIN_S = 600
DP_DIR = 'build/chip_smoke_dp'


def dp_run_world(body, name, world=DP_WORLD, backend='gloo', device='cuda', axes=('data',), mesh_shape=None,
                 **kwargs):
    """Run `body(rank, world, mesh, out_dir, device=<the rank's device>,
    **kwargs)` on `world` ranks (vqtpu_torch.parallel.run_ranks: gloo ranks
    share card 0, or run on the CPU), the mesh `axes` of `mesh_shape` (one
    axis over every rank by default), TF32 off and cuDNN deterministic in
    each; `out_dir` is a
    fresh directory under build/. Returns what each rank returned. A rank
    that fails or hangs fails the phase."""
    import shutil
    from pathlib import Path
    from vqtpu_torch.parallel import run_ranks
    out = Path(DP_DIR) / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    try:
        return run_ranks(_dp_rank_body, world, backend=backend, device=device, axes=axes, shape=mesh_shape,
                         timeout=DP_JOIN_S, kwargs=dict(body=body, out=str(out.resolve()), body_kwargs=kwargs))
    except RuntimeError as e:
        check(False, f'{name}: every rank finished and exited 0\n{e}')


def _dp_rank_body(rank, world, mesh, device, body, out, body_kwargs):
    import faulthandler
    faulthandler.enable()            # a native abort then prints the rank's Python stacks
    # as main() sets them: full f32, and deterministic cuDNN, without which
    # two code ranks of one data row may sum a convolution's weight
    # gradient in different orders and their replicated weights drift apart
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    return body(rank, world, mesh, out, device=device, **body_kwargs)


class GainVQ(torch.nn.Module):
    """A scalar gain (1 at the start, so the first step quantizes the batch
    exactly) before a VectorQuantize: the trainer's one parameter."""

    def __init__(self, device, **vq_kwargs):
        from vqtpu_torch import VectorQuantize
        super().__init__()
        self.gain = torch.nn.Parameter(torch.ones((), device=device))
        self.vq = VectorQuantize(**vq_kwargs, device=device)

    def forward(self, x):
        return self.vq(x * self.gain)


def dp_batch(step, device, shape):
    """The global batch (b, n, d) of a step, made on the device from a seed
    (the same on every rank)."""
    gen = torch.Generator(device=device).manual_seed(1200 + step)
    return torch.randn(shape, generator=gen, device=device)


def dp_gather(t, axis='data'):
    """Every rank's `t`, stacked (gloo takes CUDA tensors)."""
    from vqtpu_torch.parallel import collectives
    return collectives.all_gather(t.contiguous()[None], axis)


def dp_state(model):
    cb = model.vq._codebook
    return {k: getattr(cb, k).detach().clone() for k in ('embed', 'embed_avg', 'cluster_size')}


def dp_vq_body(rank, world, mesh, out, route_steps, device, shape=DP_MAIN):
    """Rank body of dp_vq_train: the trainer over GainVQ(sync_axis='data'),
    kmeans init and expiry on; per step the K4 (or K1) launches on this
    rank, the state gathered from both ranks, and on rank 0 the same step
    of one process over the whole batch from the state before it."""
    import torch.distributed as dist
    from vqtpu_torch.kernels.distance import nearest_code
    from vqtpu_torch.kernels.train_fused import fused_train_quantize
    from vqtpu_torch.parallel import DataParallelTrainer, global_batch
    from vqtpu_torch.utils import save_checkpoint, state_dict
    torch.manual_seed(0)                         # the same model and generators on every rank
    b, n, d, c = shape
    model = GainVQ(device, **dict(DP_VQ_KW, dim=d, codebook_size=c), sync_axis='data', train_fused='on').train()
    picked = {}

    def loss_fn(m, batch):
        q, idx, loss = m(batch)
        picked['idx'] = idx
        return loss + q.square().mean()

    # the state kmeans init leaves (inside step 0), which step 0's one-process run starts from
    cb = model.vq._codebook
    init = cb.init_embed_

    def init_and_record(flatten, mask=None):
        fresh = not bool(cb.initted)
        init(flatten, mask)
        if fresh:
            picked['after_kmeans'] = state_dict(model)
    cb.init_embed_ = init_and_record

    steps = []
    trainer = DataParallelTrainer(model, torch.optim.SGD(model.parameters(), lr=1e-3), loss_fn, mesh,
                                  compiled=False)
    for route, s in route_steps:
        model.vq._codebook.train_fused = route
        full = dp_batch(s, device, (b, n, d))
        local = global_batch(mesh, ('data',), full, device)
        if rank != 0:
            del full
        before = state_dict(model)
        nearest_code.launches = fused_train_quantize.launches = 0
        dist.barrier()
        sync(device)
        t0 = time.perf_counter()
        loss = trainer.step(local)
        sync(device)
        step_s = time.perf_counter() - t0
        launches = dict(train_fused=fused_train_quantize.launches, nearest_code=nearest_code.launches)
        if 'after_kmeans' in picked:
            before = picked.pop('after_kmeans')
        with mesh:
            states = {k: dp_gather(v) for k, v in dp_state(model).items()}
            idx = dp_gather(picked['idx']).reshape(-1)
        step = dict(route=route, step=s, loss=float(loss), step_s=step_s, launches=launches,
                    ranks_identical={k: bool(torch.equal(v[0], v[1])) for k, v in states.items()})
        if rank == 0:
            step.update(dp_vq_reference(model, before, full, idx, {k: v[0] for k, v in states.items()}, route,
                                        device))
            del full
        steps.append(step)
    result = dict(steps=steps)
    if rank == 0:
        # the trained module, saved and read back on the card by the utils phase
        save_checkpoint(f'{out}/vq.pt', model.vq)
        probe = dp_batch(99, device, (64, n, d))
        model.eval()
        with torch.no_grad():
            q, idx, _ = model.vq(probe)
        result['probe'] = dict(x=probe.cpu(), q=q.cpu(), idx=idx.cpu())
    return result


def dp_vq_reference(model, before, full, dp_idx, dp, route, device):
    """One process, the same step over the whole batch from the state the
    ranks started from: its indices, its EMA state, and both held to one
    float64 EMA step from those indices and that state."""
    from vqtpu_torch.kernels.distance import nearest_code
    from vqtpu_torch.kernels.train_fused import fused_train_quantize
    from vqtpu_torch.utils import load_state_dict
    d = full.shape[-1]
    vq = model.vq
    ref = GainVQ(device, **dict(DP_VQ_KW, dim=d, codebook_size=vq.codebook_size), train_fused=route).train()
    load_state_dict(ref, before)
    nearest_code.launches = fused_train_quantize.launches = 0
    with torch.no_grad():
        _, idx, _ = ref(full)
    sync(device)
    ref_launches = dict(train_fused=fused_train_quantize.launches, nearest_code=nearest_code.launches)
    one = dp_state(ref)
    idx = idx.reshape(-1)
    cb = ref.vq._codebook
    xs = (full * before['gain']).reshape(-1, d)
    cs64, ea64, cs_bound, ea_bound = ema_step_reference(
        xs, idx.long(), before['vq._codebook.cluster_size'][0], before['vq._codebook.embed_avg'][0], cb.decay)
    # codes the step expired: their rows come from the batch's pooled draw,
    # which the ranks and one process draw differently
    expired = cs64 < cb.threshold_ema_dead_code
    keep = ~expired
    shares = {}
    for name, state in (('dp', dp), ('one_process', one)):
        smoothed, _ = smoothed_sizes(state['cluster_size'][0], cb.eps)
        e_ref = state['embed_avg'][0].double() / smoothed[:, None]
        for key, got, want, bound in (('cluster_size', state['cluster_size'][0], cs64, cs_bound),
                                      ('embed_avg', state['embed_avg'][0], ea64, ea_bound),
                                      ('embed', state['embed'][0], e_ref, 8 * U32 * e_ref.abs())):
            share = float(((got.double() - want).abs() / bound.clamp_min(1e-300))[keep].max())
            shares[f'{name}_{key}'] = share
        check(bool((state['cluster_size'][0][expired] == cb.threshold_ema_dead_code).all()),
              f'{name}: the expired codes were reset')
    return dict(indices_equal_one_process=bool(torch.equal(dp_idx, idx)),
                cluster_size_equal_one_process=bool(torch.equal(dp['cluster_size'], one['cluster_size'])),
                embed_avg_max_abs_diff=float((dp['embed_avg'] - one['embed_avg']).abs().max()),
                share_of_f32_bound=shares, expired=int(expired.sum()), one_process_launches=ref_launches)


def phase_dp_vq_train():
    """dp_vq_train: DataParallelTrainer over VectorQuantize(dim=256,
    codebook_size=512, decay=0.8, sync_axis='data', train_fused='on',
    kmeans_init=True, threshold_ema_dead_code=2) behind a scalar gain, the
    main batch (1024, 1024, 256) split 2 x (512, 1024, 256) over two gloo
    ranks on the card: 3 steps on 'on' (K4 once a rank a step), then one on
    'off' (K1 and index_put_ once a rank); the ranks' codebooks
    bit-identical every step; each step held to one process over the whole
    batch from the same state (the same indices and cluster sizes; both
    within the f32 bound of one float64 EMA step)."""
    route_steps = [('on', s) for s in range(DP_STEPS)] + [('off', DP_STEPS)]
    ranks = dp_run_world(dp_vq_body, 'dp_vq_train', route_steps=route_steps)
    for r, res in enumerate(ranks):
        for st in res['steps']:
            want = dict(train_fused=1, nearest_code=0) if st['route'] == 'on' else dict(train_fused=0, nearest_code=1)
            check(st['launches'] == want, f"rank {r} step {st['step']} ({st['route']}): launches {st['launches']}")
            check(all(st['ranks_identical'].values()), f"step {st['step']}: ranks bit-identical {st['ranks_identical']}")
    steps0 = ranks[0]['steps']
    for st in steps0:
        check(st['indices_equal_one_process'], f"step {st['step']}: indices equal one process's")
        check(st['cluster_size_equal_one_process'], f"step {st['step']}: cluster_size equals one process's")
        check(max(st['share_of_f32_bound'].values()) <= 1.0,
              f"step {st['step']}: within the f32 bound of one float64 EMA step {st['share_of_f32_bound']}")
        check(np.isfinite(st['loss']), f"step {st['step']}: finite loss")
    b, n, d, c = DP_MAIN
    emit('dp_vq_train', model=f'VectorQuantize(dim={d}, codebook_size={c}, decay=0.8, sync_axis=data, '
                              'kmeans_init=True, threshold_ema_dead_code=2) behind a scalar gain',
         trainer='DataParallelTrainer, SGD(lr=1e-3)', world=DP_WORLD, backend='gloo (both ranks on cuda:0)',
         global_input=[b, n, d], per_rank_input=[b // DP_WORLD, n, d],
         launches_per_rank_step={f"{st['route']}_{st['step']}": [r['steps'][i]['launches'] for r in ranks]
                                 for i, st in enumerate(steps0)},
         step_s_per_rank={f"{st['route']}_{st['step']}": [r['steps'][i]['step_s'] for r in ranks]
                          for i, st in enumerate(steps0)},
         step_s_note='two ranks time-sharing one card over gloo: a correctness run, not a data-parallel rate',
         losses=[st['loss'] for st in steps0], expired=[st['expired'] for st in steps0],
         embed_avg_max_abs_diff_vs_one_process=[st['embed_avg_max_abs_diff'] for st in steps0],
         share_of_f32_bound=[st['share_of_f32_bound'] for st in steps0],
         one_process_launches=[st['one_process_launches'] for st in steps0])
    return ranks


def dp_lfq_record(store):
    """Wrap LFQ's `lfq_entropy_stats` so that each call's input, weights and
    sweep arguments, the cotangents its outputs receive (entbar, gbar: the
    inputs of sweeps C and D) and the gradient that reaches its input
    (sweep D's dx) land in `store`. Returns the function that undoes it."""
    import vqtpu_torch.quantizers.lfq as tlfq
    stats = tlfq.lfq_entropy_stats

    def recorded(x, w, **kw):
        store.update(x=x.detach().clone(), w=w.detach().clone(), kw=kw)
        x.register_hook(lambda g: store.update(dx=g.detach().clone()))
        ent, avgp = stats(x, w, **kw)
        ent.register_hook(lambda g: store.update(entbar=g.detach().clone()))
        avgp.register_hook(lambda g: store.update(gbar=g.detach().clone()))
        return ent, avgp
    tlfq.lfq_entropy_stats = recorded

    def undo():
        tlfq.lfq_entropy_stats = stats
    return undo


def dp_lfq_body(rank, world, mesh, out, device, lead=8):
    """Rank body of dp_lfq_train: one LFQ(sync_axis='data') training
    forward and backward on this rank's half of the main LFQ batch; on rank
    0 the same over the whole batch in one process, and for each run the
    float64 plain sweeps on the whole batch with the cotangents that run's
    sweeps received (the reference of the LFQ checks in use)."""
    import torch.distributed as dist
    from vqtpu_torch.parallel import global_batch
    full = lfq_main_input(device)[:lead]
    local = global_batch(mesh, ('data',), full, device).clone().requires_grad_()
    lfq = dp_lfq_model(device, 'data')
    rec = {}
    undo = dp_lfq_record(rec)
    try:
        reset_all_launches()
        with mesh:
            _, idx, aux = lfq(local, inv_temperature=LFQ_INV_TEMP)
            aux.backward()
        sync(device)
        launches = all_launches()
        with mesh:
            dx = dp_gather(rec['dx']).reshape(-1, full.shape[-1])
            xs = dp_gather(rec['x']).reshape(-1, full.shape[-1])
            entbar = dp_gather(rec['entbar']).reshape(-1)
            gbars = dp_gather(rec['gbar'])
            auxes = dp_gather(aux.detach())
            idx = dp_gather(idx).reshape(full.shape[:-1])
            x_grad = dp_gather(local.grad).reshape(full.shape)
        # a second step, timed (host clock, both ranks started together)
        again = local.detach().clone().requires_grad_()
        dist.barrier()
        sync(device)
        t0 = time.perf_counter()
        with mesh:
            lfq(again, inv_temperature=LFQ_INV_TEMP)[2].backward()
        sync(device)
        result = dict(launches=launches, aux=float(aux.detach()), step_s=time.perf_counter() - t0)
        if rank != 0:
            return result
        x = full.clone().requires_grad_()
        _, ref_idx, ref_aux = dp_lfq_model(device, None)(x, inv_temperature=LFQ_INV_TEMP)
        ref_aux.backward()
    finally:
        undo()
    check(torch.equal(xs, rec['x']), 'the ranks\' sweep inputs are one process\'s')
    check(torch.equal(gbars[0], gbars[1]), 'the ranks\' sweeps received one gbar (the psum\'s summed cotangent)')
    w, kw = rec['w'], rec['kw']
    result.update(aux_mean=float(auxes.mean()), aux_one_process=float(ref_aux.detach()),
                  indices_equal=bool(torch.equal(idx, ref_idx)),
                  x_grad_max_abs_diff=float((x_grad / world - x.grad).abs().max()),
                  x_grad_max_abs=float(x.grad.abs().max()),
                  gbar_max_rel_diff=float((gbars[0] / world - rec['gbar']).abs().max() / rec['gbar'].abs().max()))
    for name, got, eb, gb in (('dp', dx, entbar, gbars[0]), ('one_process', rec['dx'], rec['entbar'], rec['gbar'])):
        dx64 = lfq_sweep_outputs(xs.double(), w, kw, eb, gb, plain=True)['dx']
        dx_plain = lfq_sweep_outputs(xs, w, kw, eb, gb, plain=True)['dx']
        ref_max = float(dx64.abs().max())
        plain_err = float((dx_plain.double() - dx64).abs().max())
        result[name] = dict(dx_err=float((got.double() - dx64).abs().max()), dx_max_abs=ref_max,
                            dx_plain_err=plain_err, dx_limit=max(2e-5 * ref_max, 4 * plain_err))
    return result


def dp_lfq_model(device, sync_axis):
    from vqtpu_torch import LFQ
    n, d = LFQ_MAIN
    return LFQ(dim=d, codebook_size=1 << d, spherical=True, entropy_loss_weight=0.1, diversity_gamma=1.0,
               entropy_fused='on', sync_axis=sync_axis, device=device).train()


def phase_dp_lfq_train():
    """dp_lfq_train: LFQ(dim=18, codebook_size=2**18, spherical=True,
    entropy_loss_weight=0.1, entropy_fused='on', sync_axis='data') on the
    main LFQ batch (8, 1024, 18), inv_temp 100, split 2 x (4, 1024, 18)
    over two gloo ranks: K5-K8 once a rank, the psum between their
    statistics and the codebook entropy, so that the ranks' sweeps C and D
    receive one gbar. The sweeps' dx on every token (the ranks', and one
    process's over the whole batch) within the LFQ bound in use of the
    float64 plain sweeps on the whole batch with the cotangents that run
    received: 2e-5 of the largest entry, or 4x the plain f32 sweeps'
    error; the mean of the ranks' aux losses within
    1e-5 of one process's, and x.grad over the world size within 1e-3 of
    its largest entry (the rule that holds two routes to each other)."""
    ranks = dp_run_world(dp_lfq_body, 'dp_lfq_train')
    for r, res in enumerate(ranks):
        check(all(res['launches'][f'lfq_sweep_{k}'] == 1 for k in 'abcd'),
              f"rank {r}: each sweep launched once {res['launches']}")
    r0 = ranks[0]
    aux_rel = abs(r0['aux_mean'] - r0['aux_one_process']) / abs(r0['aux_one_process'])
    grad_rel = r0['x_grad_max_abs_diff'] / r0['x_grad_max_abs']
    check(r0['indices_equal'], 'the ranks\' indices equal one process\'s')
    check(aux_rel <= 1e-5, f'the ranks\' mean aux within 1e-5 of one process ({aux_rel})')
    for name in ('dp', 'one_process'):
        e = r0[name]
        check(e['dx_limit'] < 0.1 * e['dx_max_abs'], f"{name}: the dx limit bites ({e['dx_limit']}, {e['dx_max_abs']})")
        check(e['dx_err'] <= e['dx_limit'], f"{name}: dx within the float64 bound ({e['dx_err']}, {e['dx_limit']})")
    check(grad_rel <= 1e-3, f'x.grad / world within 1e-3 of one process\'s largest entry ({grad_rel})')
    n, d = LFQ_MAIN
    emit('dp_lfq_train', model=f'LFQ(dim={d}, codebook_size=2**{d}, spherical=True, entropy_loss_weight=0.1, '
                               "entropy_fused='on', sync_axis='data')",
         world=DP_WORLD, backend='gloo (both ranks on cuda:0)', global_input=[8, n // 8, d],
         per_rank_input=[8 // DP_WORLD, n // 8, d], inv_temperature=LFQ_INV_TEMP,
         launches_per_rank=[{k: r['launches'][f'lfq_sweep_{k}'] for k in 'abcd'} for r in ranks],
         aux_per_rank=[r['aux'] for r in ranks], aux_one_process=r0['aux_one_process'], aux_rel_diff=aux_rel,
         step_s_per_rank=[r['step_s'] for r in ranks],
         step_s_note='the second step, two ranks time-sharing one card over gloo: not a data-parallel rate',
         dx_vs_float64=dict(dp=r0['dp'], one_process=r0['one_process']), x_grad_rel_diff=grad_rel,
         gbar_rel_diff_dp_over_world_vs_one_process=r0['gbar_max_rel_diff'])
    return ranks


def dp_nccl1_body(rank, world, mesh, out, device, shape=DP_MAIN):
    """Rank body of dp_nccl1: the dp_vq_train step on a one-rank NCCL
    group. With kmeans init and expiry it runs every collective of the
    path (their pooled draw is a second draw by design, as in the JAX
    package); without them it must equal the module without sync_axis, bit
    for bit."""
    import torch.distributed as dist
    from vqtpu_torch.kernels.train_fused import fused_train_quantize
    from vqtpu_torch.parallel import DataParallelTrainer
    b, n, d, c = shape
    full = dp_batch(0, device, (b, n, d))
    picked = {}

    def loss_fn(m, batch):
        q, i, l = m(batch)
        picked['idx'] = i
        return l + q.square().mean()

    def trained(kwargs, axis):
        torch.manual_seed(0)
        model = GainVQ(device, **dict(kwargs, dim=d, codebook_size=c), sync_axis=axis, train_fused='on').train()
        opt = torch.optim.SGD(model.parameters(), lr=1e-3)
        fused_train_quantize.launches = 0
        if axis is None:
            opt.zero_grad()
            loss_fn(model, full).backward()
            opt.step()
        else:
            DataParallelTrainer(model, opt, loss_fn, mesh, compiled=False).step(full)
        sync(device)
        return dict(idx=picked['idx'], gain=model.gain.detach().clone(), launches=fused_train_quantize.launches,
                    **dp_state(model))

    full_path = trained(DP_VQ_KW, 'data')
    plain_kw = dict(DP_VQ_KW, kmeans_init=False, threshold_ema_dead_code=0)
    synced, plain = trained(plain_kw, 'data'), trained(plain_kw, None)
    del full
    # the same step compiled over NCCL against its eager twin: kmeans init, then the step after it
    compiled_steps, _, _ = dp_twin_steps(mesh, device, shape, [('on', 0), ('on', 1)],
                                         lambda s: dp_batch(s, device, (b, n, d)))
    for st in compiled_steps:
        st.pop('state')
    return dict(backend=dist.get_backend(), launches=[full_path['launches'], synced['launches']],
                compiled_steps=compiled_steps,
                full_path_finite=all(bool(torch.isfinite(full_path[k]).all()) for k in ('embed', 'embed_avg')),
                identical={k: bool(torch.equal(synced[k], plain[k]))
                           for k in ('idx', 'gain', 'embed', 'embed_avg', 'cluster_size')})


def phase_dp_nccl1():
    """dp_nccl1: the dp_vq_train step on a one-rank NCCL group, so that the
    collectives run over NCCL on the card: with kmeans init and expiry, K4
    once and a finite codebook; without them, bit-identical to the module
    without sync_axis; and compiled (the kmeans step and the one after it)
    against its eager twin, as dp_compiled holds it."""
    (res,) = dp_run_world(dp_nccl1_body, 'dp_nccl1', world=1, backend='nccl')
    check_twin_steps('dp_nccl1 compiled', res['compiled_steps'])
    check(res['backend'] == 'nccl', f"the group runs NCCL ({res['backend']})")
    check(res['launches'] == [1, 1], f"K4 once a step ({res['launches']})")
    check(res['full_path_finite'], 'the kmeans and expiry step gives a finite codebook')
    check(all(res['identical'].values()), f'the one-rank NCCL step equals the un-synced one {res["identical"]}')
    emit('dp_nccl1', backend=res['backend'], world=1, identical_to_unsynced=res['identical'],
         launches_train_fused=res['launches'], compiled_steps=res['compiled_steps'])
    return res


# -- the data-parallel step compiled whole (DataParallelTrainer(compiled=None) on the card) --

# 'on' steps of dp_compiled, kmeans init at the first, then one 'off' step;
# 2, not 3: the script ran over its 1000 s aim on a slower host (PERF.md §4)
DP_COMPILED_ON_STEPS = 2


def copy_state_(model, ref) -> None:
    """`model`'s parameters and buffers take `ref`'s values in place: the
    tensors a compiled step holds stay the same, and so does the host
    mirror of kmeans init, which load_state_dict would clear."""
    with torch.no_grad():
        want = ref.state_dict()
        for k, v in model.state_dict().items():
            v.copy_(want[k])


def ranks_agree(mesh):
    """agree(ok) -> whether `ok` holds on every rank of the mesh, a pmin
    over each of its axes (warm_profile's window retries, taken by all
    ranks together)."""
    from vqtpu_torch.parallel import collectives

    def agree(ok):
        t = torch.tensor([float(ok)])
        with mesh:
            for axis in mesh.axis_names:
                t = collectives.pmin(t, axis)
        return bool(t[0] > 0)
    return agree


def dp_twin_steps(mesh, device, shape, route_steps, batch_of):
    """DataParallelTrainer over GainVQ(sync_axis='data', train_fused, kmeans
    init, expiry) with SGD(lr=1e-3), compiled (compiled=None: the card) and
    its eager twin (compiled=False) from one seed. Before each (route,
    step) the compiled model takes the twin's state; both then step on
    `batch_of(step)`. Per step: both losses and seconds, each one's K4 and
    K1 launches, the compiled indices judged against eager's in float64
    on the quantizer's input and the codebook the selection used, the
    codebook's and gain's errors against eager over the unflipped codes,
    the compiled versions of the step so far, and the compiled state.
    Returns (steps, models, trainers), each of the two by mode."""
    import torch.distributed as dist
    from torch._dynamo.eval_frame import _debug_get_cache_entry_list
    from vqtpu_torch.kernels.distance import nearest_code, selection_bias, selection_disagreements
    from vqtpu_torch.kernels.train_fused import fused_train_quantize
    from vqtpu_torch.parallel import DataParallelTrainer
    b, n, d, c = shape
    kw = dict(DP_VQ_KW, dim=d, codebook_size=c, sync_axis='data', train_fused='on')
    torch.manual_seed(0)
    models = dict(compiled=GainVQ(device, **kw).train(), eager=GainVQ(device, **kw).train())
    models['compiled'].load_state_dict(models['eager'].state_dict())
    picked = {}

    def loss_fn(m, batch):
        q, idx, loss = m(batch)
        picked['idx'] = idx
        return loss + q.square().mean()

    trainers = dict(compiled=DataParallelTrainer(models['compiled'], torch.optim.SGD(models['compiled'].parameters(),
                                                                                     lr=1e-3), loss_fn, mesh),
                    eager=DataParallelTrainer(models['eager'], torch.optim.SGD(models['eager'].parameters(), lr=1e-3),
                                              loss_fn, mesh, compiled=False))
    check(trainers['compiled'].compiled, 'compiled=None compiles the step on the card')
    cb = models['eager'].vq._codebook
    init, used = cb.init_embed_, {}

    def init_and_record(flatten, mask=None):
        init(flatten, mask)
        used['embed'] = cb.embed[0].detach().clone()
    cb.init_embed_ = init_and_record

    steps = []
    for route, s in route_steps:
        for m in models.values():
            m.vq._codebook.train_fused = route
        copy_state_(models['compiled'], models['eager'])
        local = batch_of(s)
        used['embed'] = cb.embed[0].detach().clone()
        x_in = (local * models['eager'].gain).detach().reshape(-1, d)
        st, idx, loss = dict(route=route, step=s), {}, {}
        for mode in ('eager', 'compiled'):
            nearest_code.launches = fused_train_quantize.launches = 0
            dist.barrier()
            sync(device)
            t0 = time.perf_counter()
            loss[mode] = trainers[mode].step(local)
            sync(device)
            st[f'{mode}_s'] = time.perf_counter() - t0
            st[f'{mode}_launches'] = dict(train_fused=fused_train_quantize.launches, nearest_code=nearest_code.launches)
            idx[mode] = picked['idx'].reshape(-1)
        # the compiled versions of the trainer's step so far (the random
        # stream's own compiled function on the card is not among them)
        st['step_graphs'] = len(_debug_get_cache_entry_list(DataParallelTrainer._step_body.__code__))
        embed = used['embed']
        st['ties'] = selection_disagreements(x_in, embed, selection_bias(embed, 'euclidean'), idx['compiled'],
                                             idx['eager'])
        cb_err, st['flips'] = codebook_vs_eager(models['compiled'].vq._codebook.state_dict(), cb.state_dict(),
                                                idx['compiled'], idx['eager'])
        st['errors'] = dict(loss=rel_err(loss['compiled'], loss['eager']),
                            gain=rel_err(models['compiled'].gain, models['eager'].gain), **cb_err)
        st['loss'] = float(loss['compiled'])
        st['state'] = {k: v.detach().clone() for k, v in models['compiled'].state_dict().items()}
        steps.append(st)
    return steps, models, trainers


def check_twin_steps(name, steps) -> None:
    """Each step of dp_twin_steps against its eager twin, and the step's
    compiled versions: one for the 'on' step with kmeans init, one for the
    'on' steps after it, one for 'off'."""
    seen = set()
    for st in steps:
        seen.add((st['route'], st['route'] == 'on' and st is steps[0]))
        check(st['step_graphs'] == len(seen), f"{name} step {st['step']}: {st['step_graphs']} compiled versions of "
                                              f"the step, expected {len(seen)}")
        at = f"{name} step {st['step']} ({st['route']})"
        want = dict(train_fused=1, nearest_code=0) if st['route'] == 'on' else dict(train_fused=0, nearest_code=1)
        check(st['compiled_launches'] == want and st['eager_launches'] == want,
              f"{at}: launches compiled {st['compiled_launches']}, eager {st['eager_launches']}")
        check(st['ties']['non_tie'] == 0, f'{at}: every flipped index a near-tie in float64 {st["ties"]}')
        check(max(st['errors'].values()) <= COMPILED_REL, f"{at}: within {COMPILED_REL} of eager {st['errors']}")
        check(np.isfinite(st['loss']), f'{at}: finite loss')


def dp_compiled_body(rank, world, mesh, out, device, shape=DP_MAIN, on_steps=DP_COMPILED_ON_STEPS):
    """Rank body of dp_compiled: dp_twin_steps on this rank's half of each
    global batch ('on' steps, then one 'off'), the compiled state gathered
    from both ranks after each step; then, on 'on', each trainer's step
    timed (CUDA events), the compiled step's kernels in a profiler trace,
    both idle shares, the compiles and FX graph cache hits, and the
    compiled NameError of an unbound axis. The ranks call every
    collective together, profiler retries included."""
    from torch._dynamo.utils import counters
    from vqtpu_torch.core.compile import compile_step
    from vqtpu_torch.parallel import collectives, global_batch
    b, n, d, c = shape
    torch._dynamo.reset()
    counters.clear()

    def batch_of(s):
        return global_batch(mesh, ('data',), dp_batch(s, device, (b, n, d)), device)

    route_steps = [('on', s) for s in range(on_steps)] + [('off', on_steps)]
    steps, models, trainers = dp_twin_steps(mesh, device, shape, route_steps, batch_of)
    for st in steps:
        state = st.pop('state')
        with mesh:
            st['ranks_identical'] = {k: bool(torch.equal(*dp_gather(state[k]))) for k in (
                'gain', 'vq._codebook.embed', 'vq._codebook.embed_avg', 'vq._codebook.cluster_size')}
    cache = {k: v for k, v in counters['inductor'].items() if 'fxgraph' in k}
    for m in models.values():
        m.vq._codebook.train_fused = 'on'
    local = batch_of(0)
    fns = {mode: (lambda t=t: t.step(local)) for mode, t in trainers.items()}
    times = mode_times(fns)
    agree = ranks_agree(mesh)
    trace = compiled_trace(fns['compiled'], agree=agree)
    idle = {mode: warm_idle_share(fn, agree=agree) for mode, fn in fns.items()}
    with mesh:
        try:
            compile_step(lambda t: collectives.psum(t, 'code'))(local[:1])
            unbound = 'no error'
        except NameError as e:
            unbound = f'NameError: {e}'
    return dict(steps=steps, fxgraph_cache=cache, trace=trace, idle=idle, unbound=unbound, **times)


def phase_dp_compiled():
    """dp_compiled: dp_vq_train's configuration (DataParallelTrainer over
    VectorQuantize(dim=256, codebook_size=512, decay=0.8, sync_axis='data',
    train_fused='on', kmeans_init=True, threshold_ema_dead_code=2) behind a
    scalar gain, (1024, 1024, 256) as 2 x (512, 1024, 256) on two gloo
    ranks on cuda:0) with the step compiled whole by inductor, the
    collectives in its graph: 2 'on' steps (kmeans init inside the first)
    and one 'off' step, each from its eager twin's state; the ranks
    bit-identical, every flipped index a near-tie in float64, the loss,
    gain and codebook within COMPILED_REL of eager over the unflipped
    codes, K4 (or K1) once a rank a step, K4's symbols in each rank's
    trace, at most two graphs for the 'on' steps."""
    ranks = dp_run_world(dp_compiled_body, 'dp_compiled')
    for r, res in enumerate(ranks):
        check_twin_steps(f'dp_compiled rank {r}', res['steps'])
        for st in res['steps']:
            check(all(st['ranks_identical'].values()), f"dp_compiled step {st['step']}: ranks bit-identical "
                                                       f"{st['ranks_identical']}")
        check_trace(f'dp_compiled rank {r}', res['trace'], K4_SYMBOLS, dict(train_fused=1))
        check(res['unbound'].startswith('NameError'), f"dp_compiled rank {r}: an unbound axis, compiled: "
                                                      f"{res['unbound']}")
    b, n, d, c = DP_MAIN
    per_rank = {k: [r[k] for r in ranks] for k in ('ms', 'ms_runs', 'idle', 'fxgraph_cache')}
    emit('dp_compiled', model=f'VectorQuantize(dim={d}, codebook_size={c}, decay=0.8, sync_axis=data, '
                              "train_fused='on', kmeans_init=True, threshold_ema_dead_code=2) behind a scalar gain",
         trainer='DataParallelTrainer(compiled=None: inductor, fullgraph), SGD(lr=1e-3); eager twin compiled=False',
         world=DP_WORLD, backend='gloo (both ranks on cuda:0)', global_input=[b, n, d],
         per_rank_input=[b // DP_WORLD, n, d],
         steps_per_rank=[r['steps'] for r in ranks],
         trace_per_rank=[r['trace'] for r in ranks], unbound_axis_compiled=ranks[0]['unbound'], **per_rank,
         step_ms_note='CUDA events over 10 steps a round, two ranks time-sharing one card over gloo: '
                      'a correctness run, not a data-parallel rate')
    return ranks


def phase_utils(dp_ranks, forward_ms):
    """utils: timeit_chained on the VQ eval forward at the main shape beside
    phase 5's CUDA-event time of the same forward; a torch.profiler trace
    holding an annotate label (the forward and a reduction; the profiler
    records no device event of a kernel launched through ctypes), with its
    events counted by category; the dp_vq_train module
    saved by rank 0 and restored here, its eval forward bit-equal."""
    import json as _json
    from pathlib import Path
    from vqtpu_torch import VectorQuantize
    from vqtpu_torch.utils import annotate, restore_checkpoint, timeit_chained, trace
    n, c, d = MAIN
    torch.manual_seed(5)
    vq = VectorQuantize(dim=d, codebook_size=c, device='cuda').eval()
    xin = torch.from_numpy(np.random.default_rng(0).standard_normal((1024, n // 1024, d), dtype=np.float32)).cuda()
    with torch.no_grad():
        chained_s = timeit_chained(vq, xin, lo=2, hi=12)
        logdir = Path(DP_DIR) / 'trace'
        with trace(logdir):
            with annotate('vqtpu_torch.vq_eval_forward'):
                q, _, _ = vq(xin)
                q.square().sum()
            torch.cuda.synchronize()
    events = _json.loads((logdir / 'trace.json').read_text())['traceEvents']
    check(any(e.get('name') == 'vqtpu_torch.vq_eval_forward' for e in events), 'the trace holds the annotate label')
    categories = {}
    for e in events:
        categories[str(e.get('cat'))] = categories.get(str(e.get('cat')), 0) + 1
    del vq, xin

    probe = dp_ranks[0]['probe']
    restored = VectorQuantize(**DP_VQ_KW, sync_axis='data', device='cuda').eval()
    restore_checkpoint(Path(DP_DIR) / 'dp_vq_train' / 'vq.pt', restored)
    with torch.no_grad():
        q, idx, _ = restored(probe['x'].cuda())
    check(torch.equal(q.cpu(), probe['q']) and torch.equal(idx.cpu(), probe['idx']),
          'the restored module\'s eval forward is bit-equal')
    emit('utils', timeit_chained_ms=chained_s * 1e3, times_vq_forward_ms=forward_ms,
         timeit_chained_of='VectorQuantize(dim=256, codebook_size=512).eval() on (1024, 1024, 256), slope of 2 and '
                           '12 back-to-back calls, CUDA events',
         trace_events=len(events), trace_event_categories=categories, checkpoint_round_trip='bit-equal')
    return chained_s


# -- row-sharded codebooks and group-parallel composites -------------------------

# the JAX package's TP selection shape (benchmarks/tp_selection_tpu.py:35): n, c, d
TP_SELECT = (1 << 17, 65536, 256)
TP_BLOCKS = (2, 4, 8)
# the README's row-sharded VectorQuantize (README.md:510-553) on a (2, 2)
# ('data', 'code') mesh of gloo ranks on the card; global batch b, n, d and c
TP_VQ_KW = dict(codebook_size=65536, sync_axis='data', code_axis='code', kmeans_init=True,
                threshold_ema_dead_code=2)
TP_TRAIN = (128, 1024, 256, 65536)
TP_MESH = (('data', 'code'), (2, 2))
# the compiled phase's steps (kmeans init, then one after it), each held to
# its eager twin; 3 eager steps until the step compiled
TP_STEPS = 2
# CUDA-event steps a mode and round of tp_vq_train's timing
TP_TIMED_REPS = 5
# tp_vq_eval: tokens (b, n) of the eval forward on two ('code',) ranks, and
# the CUDA-event calls a mode and round of its timing
TP_EVAL = (128, 1024)
TP_EVAL_REPS = 3
# GroupedResidualVQ(dim=256, groups=2, num_quantizers=4, codebook_size=1024) on
# 65,536 tokens (benchmarks/grouped_median_tpu.py:21-26), and
# GroupedResidualFSQ(dim=8, groups=2) with RFSQ_MAIN's levels and depth
GP_VQ_KW = dict(dim=256, groups=2, num_quantizers=4, codebook_size=1024)
GP_VQ_X = (32, 2048, 256)
GP_FSQ_X = (2048, 2048, 8)
# CUDA-event calls a mode and round of gp_grouped's timing
GP_REPS = 3


def score_bound(x, e, bias, idx):
    """float64 score of each token at its code and the worst-case bound a
    3xTF32 score of it may carry: the dropped xs.es products and the split's
    remainders (3 2^-22 of sum |x e|), the 3d additions of the products in
    f32 on the tensor cores (up to 2^-23 each, as they may truncate), and
    the bias's rounding."""
    xd = x.double()
    ed = e[idx.long()].double()
    absdot = (xd * ed).abs().sum(-1)
    score = (xd * ed).sum(-1) + bias[idx.long()].double()
    bound = (6 * x.shape[-1] + 64) * U32 * (absdot + bias[idx.long()].double().abs())
    return score, bound


def phase_tp_select(device):
    """tp_select: K1 with the winning score at the TP selection shape; the
    codebook in 2, 4 and 8 row blocks, K1 on each, the winners reduced in
    torch: indices and best scores bit-equal to unsharded K1, and the rows
    of the sharded lookup (each block's rows with its dump row, summed)
    bit-equal to codebook rows; K1 against its plain version; the CUDA-event
    time of sharded_nearest_code on a one-rank gloo group beside K1."""
    import tempfile
    import torch.distributed as dist
    from vqtpu_torch.kernels.distance import (
        nearest_code, nearest_code_plain, selection_bias, selection_disagreements,
    )
    from vqtpu_torch.parallel import make_mesh, sharded_nearest_code
    from vqtpu_torch.parallel.shard import _RowGather, local_or_dump
    n, c, d = TP_SELECT
    gen = torch.Generator(device=device).manual_seed(1300)
    x = torch.randn(n, d, generator=gen, device=device)
    e = torch.randn(c, d, generator=gen, device=device)
    bias = selection_bias(e, 'euclidean')
    nearest_code.launches = 0
    idx = nearest_code(x, e)
    idx_b, best = nearest_code(x, e, return_best=True)
    sync(device)
    check(torch.equal(idx, idx_b), 'tp_select: return_best picks the same indices')
    score, bound = score_bound(x, e, bias, idx)
    best_share = float(((best.double() - score).abs() / bound).max())
    check(best_share <= 1.0, f'tp_select: best within the f32 bound of the float64 score ({best_share})')
    plain = nearest_code_plain(x, e, bias)
    vs_plain = selection_disagreements(x, e, bias, idx, plain)
    check(vs_plain['non_tie'] == 0, f'tp_select: K1 and the plain version agree but for near-ties {vs_plain}')
    blocks = {}
    for world in TP_BLOCKS:
        c_local = c // world
        parts = [nearest_code(x, e[r * c_local:(r + 1) * c_local].contiguous(), return_best=True)
                 for r in range(world)]
        local_idx = torch.stack([p[0] for p in parts])
        scores = torch.stack([p[1] for p in parts])
        top = scores.max(0).values
        win = (scores == top).int().argmax(0)            # the first rank that holds the best
        gidx = (local_idx.gather(0, win[None])[0] + win * c_local).to(torch.int32)
        rows = sum(_RowGather.apply(e[r * c_local:(r + 1) * c_local], local_or_dump(gidx, c_local, r * c_local))
                   for r in range(world))
        sync(device)
        blocks[world] = dict(indices_bit_equal=bool(torch.equal(gidx, idx)),
                             best_bit_equal=bool(torch.equal(top, best)),
                             rows_bit_equal=bool(torch.equal(rows, e[idx.long()])))
        check(all(blocks[world].values()), f'tp_select: {world} row blocks against unsharded K1 {blocks[world]}')
    launches = nearest_code.launches
    check(launches == 2 + sum(TP_BLOCKS), f'tp_select: K1 once a block ({launches})')
    k1_ms = cuda_ms(lambda: nearest_code(x, e), 10)
    k1_best_ms = cuda_ms(lambda: nearest_code(x, e, return_best=True), 10)
    plain_ms = cuda_ms(lambda: nearest_code_plain(x, e, bias), 2, warmup=1)
    os.makedirs(DP_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=DP_DIR) as tmp:
        dist.init_process_group('gloo', init_method=f'file://{os.path.abspath(tmp)}/rendezvous', world_size=1, rank=0)
        try:
            mesh = make_mesh(('code',))
            with mesh:
                check(torch.equal(sharded_nearest_code(x, e, 'code'), idx), 'tp_select: world 1 equals K1')
                sharded_ms = cuda_ms(lambda: sharded_nearest_code(x, e, 'code'), 10)
        finally:
            dist.destroy_process_group()
    bound_ms, bound_by = selection_bound_tc_ms(n, c, d)
    emit('tp_select', shape=[n, c, d], blocks=blocks, best_share_of_f32_bound=best_share, vs_plain=vs_plain,
         launches=launches, k1_ms=k1_ms, k1_return_best_ms=k1_best_ms, plain_ms=plain_ms,
         sharded_world1_ms=sharded_ms, sharded_world1_of='sharded_nearest_code on a one-rank gloo group: K1 '
         'with its best, then pmax, pmin and psum through the host', tp_overhead_ms=sharded_ms - k1_ms,
         bound_ms=bound_ms, bound_by=bound_by)
    return dict(launches=launches, k1_ms=k1_ms, k1_return_best_ms=k1_best_ms, sharded_world1_ms=sharded_ms)


def tp_leaves(model):
    """The rank's rows of every sharded leaf of the model's codebook."""
    cb = model.vq._codebook
    return {k: getattr(cb, k).detach().clone() for k in ('embed', 'embed_avg', 'cluster_size')}


def tp_vq_reference(before, after, full, tp_idx, device, kw):
    """One process, the same step over the whole batch from the gathered
    state the ranks started from: its indices, and the gathered state after
    the step held to one float64 EMA step from those indices (the codes the
    step expired aside: their rows come from the batch's draw)."""
    from vqtpu_torch.utils import load_state_dict
    d = full.shape[-1]
    ref = GainVQ(device, **dict(kw, sync_axis=None, code_axis=None)).train()
    load_state_dict(ref, before)
    with torch.no_grad():
        _, idx, _ = ref(full)
    idx = idx.reshape(-1)
    cb = ref.vq._codebook
    xs = (full * before['gain']).reshape(-1, d)
    cs64, ea64, cs_bound, ea_bound = ema_step_reference(
        xs, tp_idx.long(), before['vq._codebook.cluster_size'][0], before['vq._codebook.embed_avg'][0], cb.decay)
    expired = cs64 < cb.threshold_ema_dead_code
    keep = ~expired
    cs = after['vq._codebook.cluster_size'][0]
    ea = after['vq._codebook.embed_avg'][0]
    check(bool((cs[expired] == cb.threshold_ema_dead_code).all()), 'tp_vq_train: the expired codes were reset')
    return dict(indices_equal_one_process=bool(torch.equal(tp_idx, idx)),
                cluster_size_share_of_f32_bound=float(((cs.double() - cs64).abs() / cs_bound)[keep].max()),
                embed_avg_share_of_f32_bound=float(((ea.double() - ea64).abs()
                                                    / ea_bound.clamp_min(1e-300))[keep].max()),
                expired=int(expired.sum()))


def tp_vq_body(rank, world, mesh, out, device, shape=TP_TRAIN, steps=TP_STEPS, vq_kw=TP_VQ_KW):
    """Rank body of tp_vq_train: TensorParallelTrainer over GainVQ with the
    README's row-sharded VectorQuantize, its step compiled (compiled=None:
    the card), and an eager twin (compiled=False) from one seed. Before
    each step the compiled model takes the twin's state, then both step on
    this rank's block of the global batch. Per step: each one's seconds
    and K1, code_sums and K4 launches on this rank, the compiled indices
    judged against eager's in float64 on the quantizer's input and the
    whole codebook the selection used, the loss, gain and codebook against
    eager over the codes no flipped token of either data rank touched,
    whether the two data ranks of this code shard hold bit-identical
    state, the compiled versions of the step so far, and (from step 1,
    after kmeans' draws) on rank 0 the step of one process over the whole
    batch from the gathered state. Then the gathered checkpoint, each
    trainer's step timed (CUDA events), the compiled step's kernels in a
    profiler trace, both idle shares and the FX graph cache's counters.
    The ranks call every collective together, profiler retries included."""
    import torch.distributed as dist
    from torch._dynamo.eval_frame import _debug_get_cache_entry_list
    from torch._dynamo.utils import counters
    from vqtpu_torch.kernels.distance import nearest_code, selection_bias, selection_disagreements
    from vqtpu_torch.kernels.train_fused import code_sums, fused_train_quantize
    from vqtpu_torch.parallel import TensorParallelTrainer, collectives, gathered_state_dict, global_batch
    from vqtpu_torch.utils import save_checkpoint
    torch._dynamo.reset()
    counters.clear()
    b, n, d, c = shape
    kw = dict(vq_kw, dim=d, codebook_size=c)
    torch.manual_seed(0)                         # the same models and streams on every rank
    models = dict(compiled=GainVQ(device, **kw).train(), eager=GainVQ(device, **kw).train())
    models['compiled'].load_state_dict(models['eager'].state_dict())
    picked = {}

    def loss_fn(m, batch):
        q, idx, loss = m(batch)
        picked['idx'] = idx
        return loss + q.square().mean()

    trainers = {mode: TensorParallelTrainer(m, torch.optim.SGD(m.parameters(), lr=1e-3), loss_fn, mesh,
                                            **({} if mode == 'compiled' else dict(compiled=False)))
                for mode, m in models.items()}
    check(trainers['compiled'].compiled, 'tp_vq_train: compiled=None compiles the step on the card')
    cb = models['eager'].vq._codebook
    c_local = cb.embed.shape[-2]
    row0 = mesh.index('code') * c_local
    init, used = cb.init_embed_, {}

    def init_and_record(flatten, mask=None):
        init(flatten, mask)
        used['embed'] = cb.embed[0].detach().clone()
    cb.init_embed_ = init_and_record
    result = dict(rows_per_rank=c_local, coords=mesh.coords, steps=[])
    for s in range(steps):
        full = dp_batch(s, device, (b, n, d))
        local = global_batch(mesh, ('data',), full, device)
        copy_state_(models['compiled'], models['eager'])
        used['embed'] = cb.embed[0].detach().clone()
        x_in = (local * models['eager'].gain).detach().reshape(-1, d)
        before = gathered_state_dict(models['compiled'], mesh) if s else None
        st, idx, loss = dict(step=s), {}, {}
        for mode in ('eager', 'compiled'):
            nearest_code.launches = code_sums.launches = fused_train_quantize.launches = 0
            dist.barrier()
            sync(device)
            t0 = time.perf_counter()
            loss[mode] = trainers[mode].step(local)
            sync(device)
            st[f'{mode}_s'] = time.perf_counter() - t0
            st[f'{mode}_launches'] = dict(nearest_code=nearest_code.launches, code_sums=code_sums.launches,
                                          train_fused=fused_train_quantize.launches)
            idx[mode] = picked['idx'].reshape(-1)
        st['step_graphs'] = len(_debug_get_cache_entry_list(TensorParallelTrainer._step_body.__code__))
        with mesh:
            embed = collectives.all_gather_exact(used['embed'].contiguous(), 'code')
            both = {mode: dp_gather(i, 'data').reshape(-1) for mode, i in idx.items()}
            state = {k: dp_gather(v, 'data') for k, v in dict(tp_leaves(models['compiled']),
                                                             gain=models['compiled'].gain.detach()).items()}
        st['ties'] = selection_disagreements(x_in, embed, selection_bias(embed, 'euclidean'), idx['compiled'],
                                             idx['eager'])
        del embed
        # this rank's codes that a flipped token of either data rank picked
        # in either step: the EMA statistics sum over 'data'
        flipped = both['compiled'] != both['eager']
        touched = torch.cat([both['compiled'][flipped], both['eager'][flipped]]).long().unique() - row0
        keep = torch.ones(c_local, dtype=torch.bool, device=device)
        keep[touched[(touched >= 0) & (touched < c_local)]] = False
        st['flips'] = int((idx['compiled'] != idx['eager']).sum())
        st['errors'] = dict(loss=rel_err(loss['compiled'], loss['eager']),
                            gain=rel_err(models['compiled'].gain, models['eager'].gain),
                            **{k: rel_err(v[:, keep], getattr(cb, k)[:, keep])
                               for k, v in tp_leaves(models['compiled']).items()})
        st['loss'] = float(loss['compiled'])
        st['data_replicas_identical'] = {k: bool(torch.equal(v[0], v[1])) for k, v in state.items()}
        del state
        if s:
            after = gathered_state_dict(models['compiled'], mesh)
            if rank == 0:
                st.update(tp_vq_reference(before, after, full, both['compiled'], device, kw))
            del after
        del before, full
        result['steps'].append(st)
    save_checkpoint(f'{out}/vq.pt', models['compiled'].vq, mesh=mesh)
    result['fxgraph_cache'] = {k: v for k, v in counters['inductor'].items() if 'fxgraph' in k}
    local = global_batch(mesh, ('data',), dp_batch(0, device, (b, n, d)), device)
    fns = {mode: (lambda t=t: t.step(local)) for mode, t in trainers.items()}
    agree = ranks_agree(mesh)
    result.update(mode_times(fns, TP_TIMED_REPS))
    result['trace'] = compiled_trace(fns['compiled'], agree=agree)
    result['idle'] = {mode: warm_idle_share(fn, agree=agree) for mode, fn in fns.items()}
    return result


def phase_tp_vq_train():
    """tp_vq_train: the README's VectorQuantize(dim=256, codebook_size=65536,
    sync_axis='data', code_axis='code', kmeans_init=True,
    threshold_ema_dead_code=2) behind a scalar gain, under
    TensorParallelTrainer on a (2, 2) ('data', 'code') mesh of four gloo
    ranks on the card, global batch (128, 1024, 256), each rank holding
    32,768 rows and 2^16 tokens; the step compiled whole by inductor
    (compiled=None), the collectives in its graph, held to its eager twin
    for TP_STEPS steps (kmeans init inside the first): K1 and code_sums
    once a rank a step in both (kmeans' assignments besides at step 0), no
    K4; every flipped index a near-tie in float64; the loss, gain and
    codebook within COMPILED_REL of eager over the unflipped codes; the two
    data ranks of a code shard bit-identical every step; at most two
    graphs (kmeans init, then the steps after it); from step 1 the
    gathered state held to one process over the whole batch; K1's and
    code_sums' symbols once in each rank's trace of a compiled step."""
    ranks = dp_run_world(tp_vq_body, 'tp_vq_train', world=4, axes=TP_MESH[0], mesh_shape=TP_MESH[1])
    kmeans_iters = 10
    for r, res in enumerate(ranks):
        check(res['rows_per_rank'] == TP_TRAIN[3] // TP_MESH[1][1], f"a rank holds its rows ({res['rows_per_rank']})")
        for st in res['steps']:
            at = f"tp_vq_train rank {r} step {st['step']}"
            extra = kmeans_iters if st['step'] == 0 else 0
            want = dict(nearest_code=1 + extra, code_sums=1 + extra, train_fused=0)
            check(st['compiled_launches'] == want and st['eager_launches'] == want,
                  f"{at}: K1 and code_sums once a rank a step (compiled {st['compiled_launches']}, eager "
                  f"{st['eager_launches']})")
            check(st['step_graphs'] == min(st['step'] + 1, 2), f"{at}: {st['step_graphs']} compiled versions of "
                                                               'the step')
            check(st['ties']['non_tie'] == 0, f"{at}: every flipped index a near-tie in float64 {st['ties']}")
            check(max(st['errors'].values()) <= COMPILED_REL, f"{at}: within {COMPILED_REL} of eager {st['errors']}")
            check(np.isfinite(st['loss']), f'{at}: finite loss')
            check(all(st['data_replicas_identical'].values()),
                  f"{at}: the data replicas of a shard are bit-identical {st['data_replicas_identical']}")
        check_trace(f'tp_vq_train rank {r}', res['trace'], dict(select=1, sorted_stats=1),
                    dict(nearest_code=1, code_sums=1))
    for st in ranks[0]['steps'][1:]:
        check(st['indices_equal_one_process'], f"tp_vq_train step {st['step']}: the indices of one process")
        check(st['cluster_size_share_of_f32_bound'] <= 1.0 and st['embed_avg_share_of_f32_bound'] <= 1.0,
              f"tp_vq_train step {st['step']}: the EMA state within the f32 bound of a float64 step")
    steps0 = ranks[0]['steps']
    b, n, d, c = TP_TRAIN
    per_step = {k: [[r['steps'][i][k] for r in ranks] for i in range(len(steps0))]
                for k in ('compiled_launches', 'eager_s', 'compiled_s', 'flips', 'ties', 'errors')}
    emit('tp_vq_train', config='VectorQuantize(dim=256, ' + ', '.join(f'{k}={v!r}' for k, v in TP_VQ_KW.items())
         + ') behind a scalar gain',
         trainer='TensorParallelTrainer(compiled=None: inductor, fullgraph), SGD(lr=1e-3); eager twin compiled=False',
         mesh=dict(zip(*TP_MESH)), backend='gloo (four ranks on cuda:0)', global_input=[b, n, d],
         per_rank_input=[b // 2, n, d], rows_per_rank=c // 2, steps=len(steps0),
         launches_per_rank_step=per_step['compiled_launches'],
         step_s_per_rank=dict(eager=per_step['eager_s'], compiled=per_step['compiled_s']),
         compile_s_per_graph=per_step['compiled_s'], flips_per_rank_step=per_step['flips'],
         ties_per_rank_step=per_step['ties'], errors_per_rank_step=per_step['errors'],
         ms=[r['ms'] for r in ranks], ms_runs=[r['ms_runs'] for r in ranks], idle=[r['idle'] for r in ranks],
         fxgraph_cache=[r['fxgraph_cache'] for r in ranks], trace_per_rank=[r['trace'] for r in ranks],
         step_ms_note='CUDA events over TP_TIMED_REPS steps a round, four ranks time-sharing one card over gloo: '
                      'a correctness run, not a rate',
         losses=[st['loss'] for st in steps0],
         one_process=[{k: st[k] for k in ('indices_equal_one_process', 'cluster_size_share_of_f32_bound',
                                          'embed_avg_share_of_f32_bound', 'expired')} for st in steps0[1:]])
    return ranks


def tp_eval_decode(m, x):
    """The eval forward and the decode of its indices, for tp_apply (one
    module-level function: its compiled body is cached)."""
    with torch.no_grad():
        q, idx, _ = m(x)
        return q, idx, m.get_output_from_indices(idx)


def tp_eval_body(rank, world, mesh, out, device, ckpt, tokens=TP_EVAL, shape=TP_TRAIN):
    """Rank body of tp_vq_eval: the trained module restored at rest from
    its gathered checkpoint; tp_apply of its eval forward and decode on two
    ('code',) ranks, eagerly and compiled (compiled=None on the card),
    against each other and its own unsharded eval, on a second batch
    without a new graph, the module after each call as before it; the
    CUDA-event ms and idle share of each mode; the bf16 tier's eager call
    against its unsharded eval; one sharded_vq EMA step against its plain
    version."""
    from torch._dynamo.eval_frame import _debug_get_cache_entry_list
    from torch._dynamo.utils import counters
    from vqtpu_torch import VectorQuantize
    from vqtpu_torch.kernels.distance import nearest_code
    from vqtpu_torch.kernels.train_fused import code_statistics_plain
    from vqtpu_torch.parallel import init_sharded_codebook, sharded_ema_update, sharded_quantize, tp_apply
    from vqtpu_torch.parallel import tp as ttp
    from vqtpu_torch.utils import restore_checkpoint
    b, n = tokens
    d, c = shape[2], shape[3]
    torch._dynamo.reset()
    counters.clear()
    ttp._TP_APPLY_CACHE.clear()
    torch.manual_seed(0)
    vq = VectorQuantize(**dict(TP_VQ_KW, dim=d, codebook_size=c), device=device).eval()
    restore_checkpoint(ckpt, vq)
    x = dp_batch(50, device, (b, n, d))

    def state():
        return {k: v.clone() for k, v in vq.state_dict().items()}

    def unchanged(before):
        return all(torch.equal(v, before[k]) for k, v in vq.state_dict().items())

    def frames():
        """Dynamo's graphs of the cached bodies (each its own code object)."""
        return sum(len(_debug_get_cache_entry_list(body.__wrapped__.__code__))
                   for body in ttp._TP_APPLY_CACHE.values())

    nearest_code.launches = 0
    q, idx, dec = tp_apply(vq, mesh, tp_eval_decode, x, compiled=False)
    sync(device)
    launches = nearest_code.launches
    with torch.no_grad():
        q1, idx1, _ = vq(x)
    out = dict(launches=launches, rows_restored=vq._codebook.embed.shape[-2],
               indices_bit_equal=bool(torch.equal(idx, idx1)), rows_bit_equal=bool(torch.equal(q, q1)),
               decode_bit_equal=bool(torch.equal(dec, q)))
    # compiled: the first call compiles (inductor), the second, on another
    # batch, finds its body in the cache and its graph in Dynamo's
    before = state()
    nearest_code.launches = 0
    sync(device)
    t0 = time.perf_counter()
    qc, ic, dc = tp_apply(vq, mesh, tp_eval_decode, x)
    sync(device)
    out.update(compile_s=time.perf_counter() - t0, compiled_launches=nearest_code.launches,
               compiled_bit_equal=bool(torch.equal(qc, q) and torch.equal(ic, idx) and torch.equal(dc, dec)),
               compiled_unchanged=unchanged(before), cached_bodies=len(ttp._TP_APPLY_CACHE), frames=frames())
    del qc, ic, dc, q1, idx1
    x2 = dp_batch(51, device, (b, n, d))
    eager2 = tp_apply(vq, mesh, tp_eval_decode, x2, compiled=False)
    nearest_code.launches = 0
    compiled2 = tp_apply(vq, mesh, tp_eval_decode, x2)
    sync(device)
    out.update(second_launches=nearest_code.launches, second_unchanged=unchanged(before),
               second_bit_equal=all(bool(torch.equal(a, e)) for a, e in zip(compiled2, eager2)),
               second_cached_bodies=len(ttp._TP_APPLY_CACHE), second_frames=frames())
    del eager2, compiled2, x2, before
    fns = dict(eager=lambda: tp_apply(vq, mesh, tp_eval_decode, x, compiled=False),
               compiled=lambda: tp_apply(vq, mesh, tp_eval_decode, x))
    agree = ranks_agree(mesh)
    out.update(mode_times(fns, TP_EVAL_REPS))
    out['idle'] = {mode: warm_idle_share(fn, calls=3, agree=agree) for mode, fn in fns.items()}
    out['fxgraph_cache'] = {k: v for k, v in counters['inductor'].items() if 'fxgraph' in k}
    # the bf16 tier eagerly: its selection (kernels.distance.bf16_select)
    # is a plain loop over 64 chunks of tokens here, which Dynamo would
    # unroll into one graph of 64 products
    vq.quantize_tier = vq._codebook.quantize_tier = 'bf16'
    qb, ib, _ = tp_apply(vq, mesh, tp_eval_decode, x, compiled=False)
    with torch.no_grad():
        qb1, ib1, _ = vq(x)
    out.update(bf16_indices_bit_equal=bool(torch.equal(ib, ib1)), bf16_rows_bit_equal=bool(torch.equal(qb, qb1)))
    del qb, ib, qb1, ib1
    # one step of the sharded_vq engine on this rank's rows against the plain step on all of them
    xs = x.reshape(-1, d)
    e_full = vq._codebook.embed[0]
    c_local = c // world
    state = init_sharded_codebook(e_full[rank * c_local:(rank + 1) * c_local].clone())
    nearest_code.launches = 0
    with mesh:
        sidx, sq = sharded_quantize(xs, state.embed, 'code')
        new = sharded_ema_update(state, xs, sidx, code_axis='code', decay=0.99)
    pidx = nearest_code(xs, e_full)
    bins, esum = code_statistics_plain(xs[None], pidx[None], c)
    cs = 1.0 + (bins[0] - 1.0) * (1.0 - 0.99)
    ea = e_full + (esum[0] - e_full) * (1.0 - 0.99)
    total = cs.sum()
    embed = ea / ((cs + 1e-5) / (total + c * 1e-5) * total)[:, None]
    window = slice(rank * c_local, (rank + 1) * c_local)
    out.update(engine_indices_bit_equal=bool(torch.equal(sidx, pidx)),
               engine_rows_bit_equal=bool(torch.equal(sq, e_full[pidx.long()])),
               engine_cluster_size_bit_equal=bool(torch.equal(new.cluster_size, cs[window])),
               engine_embed_avg_max_abs_err=float((new.embed_avg - ea[window]).abs().max()),
               engine_embed_max_rel_err=float((new.embed - embed[window]).abs().max()
                                              / embed[window].abs().max()),
               engine_launches=nearest_code.launches)
    return out


def phase_tp_vq_eval():
    """tp_vq_eval: tp_apply of the trained module's eval forward and decode
    on two ('code',) ranks at 2^17 tokens, eager and compiled (inductor,
    compiled=None): K1 once a rank a call; indices, rows and the decode
    bit-equal to the gathered module's unsharded eval and between the
    modes; a second compiled call on a new batch finds its body cached and
    captures no graph; the module after each call bit-equal to before it;
    each mode's CUDA-event ms and idle share; the bf16 tier (eager) sharded
    bit-equal to unsharded; one sharded_vq EMA step against its
    plain version (indices, rows and cluster sizes bit-equal; embed_avg
    within 1e-5 absolute and embed within 1e-5 of its largest entry: the
    sums and the laplace total are added in another order)."""
    from pathlib import Path
    ckpt = str((Path(DP_DIR) / 'tp_vq_train' / 'vq.pt').resolve())
    ranks = dp_run_world(tp_eval_body, 'tp_vq_eval', world=2, axes=('code',), ckpt=ckpt)
    for r in ranks:
        check(r['launches'] == 1 and r['compiled_launches'] == 1 and r['second_launches'] == 1,
              f"tp_vq_eval: K1 once a rank a call, eager and compiled ({r['launches']}, {r['compiled_launches']}, "
              f"{r['second_launches']})")
        check(r['rows_restored'] == TP_TRAIN[3], 'tp_vq_eval: the checkpoint holds the full codebook')
        check(r['cached_bodies'] == r['second_cached_bodies'] == 1 and r['frames'] == r['second_frames'] == 1,
              f"tp_vq_eval: compiled=None compiled one body and one graph, and the second call captured none {r}")
        for key in ('indices_bit_equal', 'rows_bit_equal', 'decode_bit_equal', 'compiled_bit_equal',
                    'compiled_unchanged', 'second_bit_equal', 'second_unchanged', 'bf16_indices_bit_equal',
                    'bf16_rows_bit_equal', 'engine_indices_bit_equal',
                    'engine_rows_bit_equal', 'engine_cluster_size_bit_equal'):
            check(r[key], f'tp_vq_eval: {key}')
        check(r['engine_embed_avg_max_abs_err'] <= 1e-5 and r['engine_embed_max_rel_err'] <= 1e-5,
              f"tp_vq_eval: the sharded_vq step within 1e-5 of its plain version {r}")
    emit('tp_vq_eval', world=2, tokens=TP_EVAL[0] * TP_EVAL[1], launches_per_rank=[r['launches'] for r in ranks],
         compiled_launches_per_rank=[r['compiled_launches'] for r in ranks],
         compile_s_per_rank=[r['compile_s'] for r in ranks],
         ms=[r['ms'] for r in ranks], idle=[r['idle'] for r in ranks],
         ms_note='CUDA events over TP_EVAL_REPS calls of tp_apply (eval forward and decode) a round, two ranks '
                 'time-sharing one card over gloo: a correctness run, not a rate', ranks=ranks)
    return ranks


def grouped_flips(x, embeds, idx_a, idx_b):
    """Tokens to which two calls of a GroupedResidualVQ (groups over the
    last dim of x) gave different codes, each judged at the first layer
    where they differ as a near-tie in float64 (flips_explained on one
    codebook) on that layer's input along call a's path; `embeds`: each
    group's layers' (c, d) codebooks as the calls found them. Returns
    (flips, flips not so explained, the (groups, tokens) mask of the tokens
    whose codes in a group differ at any layer)."""
    from vqtpu_torch.kernels.distance import selection_bias
    flips = bad = 0
    flipped = (idx_a != idx_b).reshape(len(embeds), -1, idx_a.shape[-1]).any(-1)
    for g, chunk in enumerate(x.chunk(len(embeds), dim=-1)):
        residual = chunk.reshape(-1, chunk.shape[-1])
        a, b = idx_a[g].reshape(residual.shape[0], -1), idx_b[g].reshape(residual.shape[0], -1)
        settled = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
        for layer, embed in enumerate(embeds[g]):
            differ = (a[:, layer] != b[:, layer]) & ~settled
            if bool(differ.any()):
                bias = selection_bias(embed, 'euclidean')
                f, unexplained, _ = flips_explained(residual[differ], (embed, bias, a[differ, layer]),
                                                    (embed, bias, b[differ, layer]))
                flips, bad, settled = flips + f, bad + unexplained, settled | differ
            residual = residual - embed[a[:, layer].long()]
    return flips, bad, flipped


def grouped_untouched(state_a: dict, state_b: dict, idx_a, idx_b, flipped) -> tuple[dict, dict]:
    """Two GroupedResidualVQ state_dicts (float entries) cut to what no
    flipped token moved: each layer's codebook entries without the codes a
    flipped token of its group picked at that layer in either call (a
    near-tie that flips moves two codes by a whole token; the statistics'
    total, and so the other codes' smoothing, stays)."""
    out_a, out_b = {}, {}
    for k, b in state_b.items():
        if not b.is_floating_point():
            continue
        a, parts = state_a[k], k.split('.')
        if parts[0] == 'rvqs' and parts[2] == 'layers' and '_codebook' in parts and b.ndim >= 2:
            g, layer = int(parts[1]), int(parts[3])
            picked = [i[g][..., layer].reshape(-1)[flipped[g]] for i in (idx_a, idx_b)]
            keep = torch.ones(b.shape[1], dtype=torch.bool, device=b.device)
            keep[torch.cat(picked).long()] = False
            a, b = a[:, keep], b[:, keep]
        out_a[k], out_b[k] = a, b
    return out_a, out_b


def gp_body(rank, world, mesh, out, device, vq_kw=GP_VQ_KW, vq_x=GP_VQ_X, fsq_x=GP_FSQ_X):
    """Rank body of gp_grouped: group_parallel_forward of
    GroupedResidualVQ (eval, then a training call with update_state=False,
    then one 'on' training step) and of GroupedResidualFSQ (eval), eagerly
    (compiled=False) and compiled (compiled=None: inductor on the card),
    against twins run serially on the same rank, and their decodes; this
    rank's launches of K1, K4 and K9 in each parallel call, the seconds of
    each compiled call that captured a graph, the graphs Dynamo holds, each
    mode's CUDA-event ms of the VQ eval and 'on' calls and the eval's idle
    share."""
    from torch._dynamo.eval_frame import _debug_get_cache_entry_list
    from torch._dynamo.utils import counters
    from vqtpu_torch import GroupedResidualFSQ, GroupedResidualVQ
    from vqtpu_torch.kernels.distance import nearest_code
    from vqtpu_torch.kernels.residual_fsq_fused import fused_residual_fsq_eval
    from vqtpu_torch.kernels.train_fused import fused_train_quantize
    from vqtpu_torch.parallel import group as tgroup
    from vqtpu_torch.parallel import group_parallel_forward, group_parallel_output_from_indices
    torch._dynamo.reset()
    counters.clear()
    tgroup._GP_CACHE.clear()

    def triplet(cls, **kw):
        """The eager, compiled and serial twins, from one seed."""
        mods = []
        for _ in range(3):
            torch.manual_seed(0)
            mods.append(cls(**kw, device=device))
        return mods

    def counts():
        sync(device)
        return dict(nearest_code=nearest_code.launches, train_fused=fused_train_quantize.launches,
                    residual_fsq=fused_residual_fsq_eval.launches)

    def run(fn, *args, **kwargs):
        """fn's result, this rank's launches in it and its seconds."""
        nearest_code.launches = fused_train_quantize.launches = fused_residual_fsq_eval.launches = 0
        sync(device)
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        launches = counts()
        return result, launches, time.perf_counter() - t0

    def state(m):
        return {k: v.clone() for k, v in m.state_dict().items()}

    def frames():
        """Dynamo's graphs of each cached body (each its own code object):
        the forward with a loss (VQ's), without one (FSQ's), the decode."""
        names = {}
        for key, body in tgroup._GP_CACHE.items():
            name = 'decode' if key[0] == 'decode' else 'fwd' if key[5] else 'fsq_fwd'
            names[name] = len(_debug_get_cache_entry_list(body.__wrapped__.__code__))
        return names

    def equal(a, b):
        return all(bool(torch.equal(u, v)) for u, v in zip(a, b))

    out, compile_s = {}, {}
    par, parc, ser = triplet(GroupedResidualVQ, **vq_kw, train_fused='on')
    x = dp_batch(60, device, vq_x)
    for m in (par, parc, ser):
        m.eval()
    with torch.no_grad():
        (q, idx, loss), out['vq_eval_launches'], _ = run(group_parallel_forward, par, x, mesh, compiled=False)
        (qc, ic, lc), out['vq_eval_compiled_launches'], compile_s['vq_eval'] = run(group_parallel_forward, parc, x,
                                                                                    mesh)
        dec = group_parallel_output_from_indices(par, idx, mesh, compiled=False)
        decc, _, compile_s['vq_decode'] = run(group_parallel_output_from_indices, parc, idx, mesh)
        qs, is_, ls = ser(x)
        out['vq_eval_bit_equal'] = equal((q, idx, loss), (qs, is_, ls))
        out['vq_eval_compiled_bit_equal'] = equal((qc, ic), (q, idx))
        out['vq_eval_compiled_loss_rel_err'] = rel_err(lc, ls)
        out['vq_decode_bit_equal'] = bool(torch.equal(dec, ser.get_output_from_indices(is_)))
        out['vq_decode_compiled_bit_equal'] = bool(torch.equal(decc, dec))
        del q, qc, qs, dec, decc
        out['vq_eval_frames'] = frames()
        fns = dict(eager=lambda: group_parallel_forward(par, x, mesh, compiled=False),
                   compiled=lambda: group_parallel_forward(parc, x, mesh))
        agree = ranks_agree(mesh)
        out['vq_eval_ms'] = mode_times(fns, GP_REPS)
        out['vq_eval_idle'] = {mode: warm_idle_share(fn, calls=3, agree=agree) for mode, fn in fns.items()}
    for m in (par, parc, ser):
        m.train()
    # F4: a training call without update_state leaves every rank's module as
    # it was (eager and compiled); its outputs are the step's from that state
    embeds = [[layer._codebook.embed[0].detach().clone() for layer in member.layers] for member in parc.rvqs]
    before = state(parc)
    kept, out['vq_kept_launches'], compile_s['vq_train'] = run(group_parallel_forward, parc, x, mesh,
                                                              update_state=False)
    out['vq_kept_compiled_unchanged'] = all(torch.equal(v, before[k]) for k, v in parc.state_dict().items())
    group_parallel_forward(par, x, mesh, update_state=False, compiled=False)
    out['vq_kept_eager_unchanged'] = all(torch.equal(v, before[k]) for k, v in par.state_dict().items())
    (q, idx, loss), out['vq_train_launches'], _ = run(group_parallel_forward, par, x, mesh, compiled=False)
    (qc, ic, lc), out['vq_train_compiled_launches'], _ = run(group_parallel_forward, parc, x, mesh)
    out['vq_train_frames'] = frames()
    qs, is_, ls = ser(x)
    out['vq_train_bit_equal'] = equal((q, idx, loss), (qs, is_, ls))
    sp, ss, sc = par.state_dict(), ser.state_dict(), parc.state_dict()
    out['vq_train_states_equal'] = all(torch.equal(sp[k], ss[k]) for k in ss)
    out['vq_kept_equals_step'] = equal(kept, (qc, ic, lc))
    # where an index flipped (a near-tie in float64), the rows of the other
    # tokens and the state of the codes no flipped token picked
    flips, unexplained, flipped = grouped_flips(x, embeds, ic, idx)
    kept_rows = ~flipped.any(0)
    sc_kept, sp_kept = grouped_untouched(sc, sp, ic, idx, flipped)
    out.update(vq_train_compiled_flips=flips, vq_train_compiled_unexplained=unexplained,
               vq_train_compiled_rows_compared=int(kept_rows.sum()),
               vq_train_compiled_rows_rel_err=rel_err(qc.reshape(-1, qc.shape[-1])[kept_rows],
                                                      q.reshape(-1, q.shape[-1])[kept_rows]),
               vq_train_compiled_loss_rel_err=rel_err(lc, loss),
               vq_train_compiled_state_rel_err=max(rel_err(sc_kept[k], v) for k, v in sp_kept.items()),
               vq_train_compiled_ints_equal=all(torch.equal(sc[k], sp[k]) for k in sp
                                                if not sp[k].is_floating_point()))
    del sc_kept, sp_kept
    del q, qc, qs, kept, before, embeds
    fns = dict(eager=lambda: group_parallel_forward(par, x, mesh, compiled=False),
               compiled=lambda: group_parallel_forward(parc, x, mesh))
    out['vq_train_ms'] = mode_times(fns, GP_REPS)
    del par, parc, ser, x, fns
    par, parc, ser = triplet(GroupedResidualFSQ, dim=fsq_x[-1], groups=2, levels=list(RFSQ_MAIN[0]),
                             num_quantizers=RFSQ_MAIN[1])
    for m in (par, parc, ser):
        m.eval()
    x = dp_batch(61, device, fsq_x)
    with torch.no_grad():
        (q, idx), out['fsq_eval_launches'], _ = run(group_parallel_forward, par, x, mesh, compiled=False)
        (qc, ic), out['fsq_eval_compiled_launches'], compile_s['fsq_eval'] = run(group_parallel_forward, parc, x, mesh)
        qs, is_ = ser(x)
        out['fsq_eval_bit_equal'] = equal((q, idx), (qs, is_))
        out['fsq_eval_compiled_bit_equal'] = equal((qc, ic), (q, idx))
        dec = group_parallel_output_from_indices(par, idx, mesh, compiled=False)
        decc, _, compile_s['fsq_decode'] = run(group_parallel_output_from_indices, parc, idx, mesh)
        out['fsq_decode_bit_equal'] = bool(torch.equal(dec, ser.get_output_from_indices(is_)))
        out['fsq_decode_compiled_bit_equal'] = bool(torch.equal(decc, dec))
        out['fsq_decode_compiled_rel_err'] = rel_err(decc, dec)
    out.update(frames=frames(), cached_bodies=len(tgroup._GP_CACHE), compile_s=compile_s,
               fxgraph_cache={k: v for k, v in counters['inductor'].items() if 'fxgraph' in k})
    return out


def phase_gp_grouped():
    """gp_grouped: group_parallel_forward on two ('group',) gloo ranks of the
    card, eagerly and compiled (inductor, compiled=None), against the
    serial forward. GroupedResidualVQ(dim=256, groups=2, num_quantizers=4,
    codebook_size=1024) on (32, 2048, 256): eval with K1 once a layer a
    rank, indices and rows bit-identical to serial in both modes; a
    training call with update_state=False that leaves every rank's state
    bit-equal (F4); one 'on' training step with K4 once a layer a rank, the
    eager states equal to serial after the broadcast, the compiled indices
    eager's but for near-ties in float64, its loss within 1e-6, its rows
    within 1e-6 and its state within 1e-5 (COMPILED_REL) of eager's (but a
    flipped token's rows and the codes a flipped token picked); GroupedResidualFSQ(dim=8,
    groups=2) on (2048, 2048, 8): K9 once a rank, bit-identical to serial
    in both modes; group_parallel_output_from_indices round trips in both
    modes (the compiled FSQ decode within 1e-6 of eager's). Each compiled
    call captures its graph once: three cached bodies (the VQ forward, the
    FSQ forward, the decode, whose key both share), each its own code
    object: the VQ forward's with two graphs (eval and training), the FSQ
    forward's with one, the decode's with two.
    The phase's line is printed before its checks."""
    ranks = dp_run_world(gp_body, 'gp_grouped', world=2, axes=('group',))
    emit('gp_grouped', world=2, vq=dict(GP_VQ_KW, x=list(GP_VQ_X)),
         fsq=dict(dim=GP_FSQ_X[-1], groups=2, levels=list(RFSQ_MAIN[0]), num_quantizers=RFSQ_MAIN[1],
                  x=list(GP_FSQ_X)),
         compile_s_per_rank=[r['compile_s'] for r in ranks],
         vq_eval_ms=[r['vq_eval_ms']['ms'] for r in ranks], vq_train_ms=[r['vq_train_ms']['ms'] for r in ranks],
         vq_eval_idle=[r['vq_eval_idle'] for r in ranks],
         ms_note='CUDA events over GP_REPS calls a round, two ranks time-sharing one card over gloo: a '
                 'correctness run, not a rate', ranks=ranks)
    layers = GP_VQ_KW['num_quantizers']
    for r in ranks:
        for mode in ('', 'compiled_'):
            check(r[f'vq_eval_{mode}launches'] == dict(nearest_code=layers, train_fused=0, residual_fsq=0),
                  f"gp_grouped: K1 once a layer a rank in eval ({mode}{r[f'vq_eval_{mode}launches']})")
            check(r[f'vq_train_{mode}launches'] == dict(nearest_code=0, train_fused=layers, residual_fsq=0),
                  f"gp_grouped: K4 once a layer a rank in training ({mode}{r[f'vq_train_{mode}launches']})")
            check(r[f'fsq_eval_{mode}launches'] == dict(nearest_code=0, train_fused=0, residual_fsq=1),
                  f"gp_grouped: K9 once a rank ({mode}{r[f'fsq_eval_{mode}launches']})")
        check(r['vq_kept_launches'] == r['vq_train_launches'], f"gp_grouped: the kept call's launches {r}")
        for key in ('vq_eval_bit_equal', 'vq_eval_compiled_bit_equal', 'vq_decode_bit_equal',
                    'vq_decode_compiled_bit_equal', 'vq_kept_compiled_unchanged', 'vq_kept_eager_unchanged',
                    'vq_kept_equals_step', 'vq_train_bit_equal', 'vq_train_states_equal',
                    'vq_train_compiled_ints_equal', 'fsq_eval_bit_equal', 'fsq_eval_compiled_bit_equal',
                    'fsq_decode_bit_equal'):
            check(r[key], f'gp_grouped: {key}')
        # FSQ's decode is arithmetic on the level indices (scale, shift, the
        # layers' sum), which inductor's kernel may contract into FMAs
        check(r['fsq_decode_compiled_rel_err'] <= 1e-6,
              f"gp_grouped: the compiled FSQ decode within 1e-6 of eager's ({r['fsq_decode_compiled_rel_err']})")
        check(r['vq_train_compiled_unexplained'] == 0,
              f"gp_grouped: every compiled index that differs from eager's a near-tie in float64 "
              f"({r['vq_train_compiled_flips']} flips, {r['vq_train_compiled_unexplained']} not)")
        check(r['vq_train_compiled_rows_rel_err'] <= 1e-6,
              f"gp_grouped: the compiled step's rows within 1e-6 of eager's, but a flipped token's "
              f"({r['vq_train_compiled_rows_rel_err']}, {r['vq_train_compiled_flips']} flips)")
        check(r['vq_eval_compiled_loss_rel_err'] <= 1e-6 and r['vq_train_compiled_loss_rel_err'] <= 1e-6,
              f"gp_grouped: the compiled losses within 1e-6 ({r['vq_eval_compiled_loss_rel_err']}, "
              f"{r['vq_train_compiled_loss_rel_err']})")
        check(r['vq_train_compiled_state_rel_err'] <= COMPILED_REL,
              f"gp_grouped: the compiled step's state within {COMPILED_REL}, but the codes a flipped token "
              f"picked ({r['vq_train_compiled_state_rel_err']})")
        check(r['vq_eval_frames'] == dict(fwd=1, decode=1) and r['vq_train_frames'] == dict(fwd=2, decode=1)
              and r['frames'] == dict(fwd=2, fsq_fwd=1, decode=2) and r['cached_bodies'] == 3,
              f"gp_grouped: one graph a (body, module, mode), none after ({r['frames']}, {r['cached_bodies']})")
    return ranks


NATIVE_IMAGES = 8192
NATIVE_BATCH = 256
NATIVE_TIMED_BATCHES = 200
# (n, c, d): 8192 of the main tokens against the main shape's codebook
ORACLE_MAIN = (8192, 512, 256)
EXAMPLE_STEPS = dict(autoencoder=50, autoencoder_lfq=50, autoencoder_fsq=50, autoencoder_sim_vq=50,
                     autoencoder_rvq=50, autoencoder_hq=50, autoencoder_fvq=50, autoencoder_fsp=50)
# the kernels one training step of each example launches once its codebooks
# are initialized (PERF.md section 6; LFQ's follow its entropy route), and
# one eval forward
EXAMPLE_STEP_LAUNCHES = dict(autoencoder=dict(train_fused=1), autoencoder_lfq={}, autoencoder_fsq={},
                             autoencoder_sim_vq=dict(nearest_code=1, code_sums=1), autoencoder_rvq={},
                             autoencoder_hq=dict(train_fused=4), autoencoder_fvq=dict(nearest_code=3, code_sums=2),
                             autoencoder_fsp={})
EXAMPLE_EVAL_LAUNCHES = dict(autoencoder=dict(nearest_code=1), autoencoder_lfq={}, autoencoder_fsq={},
                             autoencoder_sim_vq=dict(nearest_code=1), autoencoder_rvq=dict(nearest_code=8),
                             autoencoder_hq=dict(nearest_code=4), autoencoder_fvq=dict(nearest_code=1),
                             autoencoder_fsp={})
EXAMPLE_KMEANS = ('autoencoder_rvq', 'autoencoder_hq')
EXAMPLE_TIMED_STEPS = 10
EXAMPLE_WAIT_STEPS = 20
EX_TP_MESH = (('data', 'code'), (2, 2))
EX_DIST_STEPS = 3


def idx_decode_lut() -> np.ndarray:
    """numpy's decode of the native gather: x * (2/255) - 1 in f32."""
    return np.arange(256, dtype=np.float32) * (2.0 / 255.0) - 1.0


def synthetic_u8(num, seed):
    """The port's synthetic images as uint8, the IDX file's pixels."""
    from vqtpu_torch.models.data import _synthetic_images
    return np.clip(np.rint((_synthetic_images(num=num, seed=seed) + 1.0) * 127.5), 0, 255).astype(np.uint8)


def host_ms(fn, reps):
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_native_data(smi):
    """native_data: native/vqdata.c built into build/vqtpu_torch/native/ (a
    failed build fails the phase: no numpy fallback), 8192 synthetic images
    written as uint8 by the port's write_idx, the native gather against the
    numpy decode bit for bit on the same tokens, PrefetchLoader's first 4
    batches against a serial gather with the same seed, and the host time
    per 256-image batch of the native gather, the numpy decode and the
    float gather of the synthetic path."""
    import tempfile
    from vqtpu_torch.models import native_build, native_data
    t0 = time.perf_counter()
    lib = native_build.load()
    build_s = time.perf_counter() - t0
    check(lib is not None, 'native_data: native/vqdata.c builds and loads')
    lib_dir = os.path.dirname(lib._name)
    check(lib_dir == native_build.OUT_DIR and lib_dir.endswith(os.path.join('build', 'vqtpu_torch', 'native')),
          f'native_data: the library lands under build/vqtpu_torch/native ({lib._name})')
    images = synthetic_u8(NATIVE_IMAGES, seed=70)
    floats = images.astype(np.float32) * (2.0 / 255.0) - 1.0
    lut = idx_decode_lut()
    rng = np.random.default_rng(72)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, 'train-images-idx3-ubyte')
        native_data.write_idx(path, images)
        ds = native_data.IdxDataset(path)
        check((ds.count, ds.rows, ds.cols) == images.shape, f'native_data: the IDX header {ds.count, ds.rows, ds.cols}')
        tokens = rng.permutation(NATIVE_IMAGES)
        got = ds.gather(tokens)
        check(np.array_equal(got, lut[images[tokens]]), 'native_data: the gather equals the numpy decode bit for bit')
        loader = native_data.PrefetchLoader(ds, NATIVE_BATCH, seed=71)
        serial = np.random.default_rng(71)
        ring_equal = []
        for _ in range(4):
            want = ds.gather(serial.integers(0, NATIVE_IMAGES, NATIVE_BATCH))[..., None]
            ring_equal.append(bool(np.array_equal(next(loader), want)))
        loader.close()
        check(all(ring_equal), f'native_data: the prefetch ring equals a serial gather {ring_equal}')
        batches = [rng.integers(0, NATIVE_IMAGES, NATIVE_BATCH) for _ in range(NATIVE_TIMED_BATCHES)]
        out = np.empty((NATIVE_BATCH, 28, 28), np.float32)
        it = iter(batches * 2)
        native_ms = host_ms(lambda: ds.gather(next(it), out), NATIVE_TIMED_BATCHES)
        it = iter(batches * 2)
        numpy_ms = host_ms(lambda: lut[images[next(it)]], NATIVE_TIMED_BATCHES)
        it = iter(batches * 2)
        float_ms = host_ms(lambda: floats[next(it)][..., None].astype(np.float32), NATIVE_TIMED_BATCHES)
        ds.close()
    emit('native_data', library=os.path.relpath(lib._name), build_s=build_s, images=list(images.shape),
         gather_bit_equal=True, prefetch_first_4_equal=ring_equal, batch=NATIVE_BATCH,
         host_ms_per_batch=dict(native_gather=native_ms, numpy_lut_decode=numpy_ms,
                                numpy_float_gather=float_ms),
         host_ms_note='one thread of the host; numpy_float_gather is the synthetic path of image_batches',
         nvidia_smi=smi)
    return dict(native_ms=native_ms, numpy_ms=numpy_ms, float_ms=float_ms)


def phase_native_oracle(device, smi):
    """native_oracle: native/vqcheck.c built, K1 (nearest_code) on 8192 of
    the main tokens against the main shape's codebook (c = 512, d = 256),
    euclidean and cosine (both sides l2-normalized), held to the float64 C
    oracle (nearest_code_ref): the picks equal but at near-ties (1e-5
    relative in float64, selection_disagreements); and a tie probe (codes
    repeated, tokens on codes and zero tokens), where the picks equal the
    oracle's exactly."""
    from vqtpu_torch.core.utils import l2norm
    from vqtpu_torch.kernels import native_check
    from vqtpu_torch.kernels.distance import nearest_code, selection_bias, selection_disagreements
    t0 = time.perf_counter()
    check(native_check.available(), 'native_oracle: native/vqcheck.c builds and loads')
    build_s = time.perf_counter() - t0
    n, c, d = ORACLE_MAIN
    # the first rows of the main input and the main codebook (phase kernel_vs_plain)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((n, d), dtype=np.float32)).to(device)
    e = torch.from_numpy(np.random.default_rng(1).standard_normal((c, d), dtype=np.float32)).to(device)
    cases = {}
    for metric, (xs, es) in (('euclidean', (x, e)), ('cosine', (l2norm(x), l2norm(e)))):
        idx = nearest_code(xs, es, metric)
        sync(device)
        t0 = time.perf_counter()
        ref = torch.from_numpy(native_check.nearest_code_ref(xs, es, metric)).to(device)
        oracle_s = time.perf_counter() - t0
        r = selection_disagreements(xs, es, selection_bias(es, metric), idx, ref)
        check(r['non_tie'] == 0, f'native_oracle {metric}: K1 against the float64 oracle {r}')
        cases[metric] = dict(r, oracle_s=oracle_s)
    base = e[:128]
    ties_e = torch.cat([base, base, base, base]).contiguous()
    ties_x = torch.cat([base[::3], torch.zeros(64, d, device=device)]).contiguous()
    for metric in ('euclidean', 'cosine'):
        idx = nearest_code(ties_x, ties_e, metric).cpu().numpy()
        ref = native_check.nearest_code_ref(ties_x, ties_e, metric)
        check(np.array_equal(idx, ref) and (idx < 128).all(),
              f'native_oracle {metric}: tie probe, the first copy as the oracle picks it')
        cases[f'ties_{metric}'] = dict(tokens=int(ties_x.shape[0]), equal=True)
    emit('native_oracle', library_build_s=build_s, shape=dict(n=n, c=c, d=d), cases=cases,
         rule='picks equal but where both picks score within 1e-5 relative in float64', nvidia_smi=smi)
    return cases


def example_launches(examples: dict, key: str, kernel: str) -> dict:
    """{example: its launches of `kernel`} for the examples that launch it."""
    return {name: r[key][kernel] for name, r in examples.items() if r[key].get(kernel)}


def launches_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def parse_logged_losses(text: str) -> list[tuple[float, float]]:
    return [(float(m.group(1)), float(m.group(2)))
            for m in re.finditer(r'rec loss: (\S+) \| aux loss: (\S+) \|', text)]


def example_eval_l1(model, x):
    model.eval()
    with torch.no_grad():
        out = model(x)[0]
    model.train()
    return float((out.clamp(-1, 1) - x).abs().mean())


def example_data_wait(step, data, device, steps):
    """The training loop's host time in next(data), and in the batch's copy
    to the card (which waits for the stream: the copy from pageable memory
    synchronizes), each as a share of the loop's time over `steps` steps."""
    xb = torch.from_numpy(next(data)).to(device)      # the first batch builds the source
    step(xb)
    sync(device)
    wait = copy = 0.0
    t0 = time.perf_counter()
    for _ in range(steps):
        t1 = time.perf_counter()
        batch = next(data)
        t2 = time.perf_counter()
        xb = torch.from_numpy(batch).to(device)
        copy += time.perf_counter() - t2
        wait += t2 - t1
        step(xb)
    sync(device)
    total = time.perf_counter() - t0
    return dict(share=wait / total, wait_ms_per_step=wait * 1e3 / steps, copy_share=copy / total,
                copy_ms_per_step=copy * 1e3 / steps, loop_ms_per_step=total * 1e3 / steps)


def ex_tp_body(rank, world, mesh, out, device, steps):
    """Rank body: vqtpu_torch.examples.tp_large_codebook.run at its own
    widths (65,536 codes, dim 64, batch 256) for `steps` steps, and this
    rank's launches."""
    from vqtpu_torch.examples import tp_large_codebook
    from vqtpu_torch.parallel import TensorParallelTrainer
    reset_all_launches()
    # the example compiles its step on the card (the trainer's default); here
    # it runs eagerly: its four ranks compiling its two graphs took 269 s
    # alone on an H100 machine and, beside the other rank phases, more than
    # their 600 s (PERF.md section 6), past the script's limit
    init = TensorParallelTrainer.__init__
    TensorParallelTrainer.__init__ = lambda self, *args, **kwargs: init(self, *args, **dict(kwargs, compiled=False))
    try:
        result = tp_large_codebook.run(mesh, train_iter=steps, device=device)
    finally:
        TensorParallelTrainer.__init__ = init
    sync(device)
    return dict(result, launches=all_launches())


def ex_gp_body(rank, world, mesh, out, device, steps):
    """Rank body: vqtpu_torch.examples.group_parallel_grvq.run at its own
    widths (4 groups, dim 64, 4 layers of 128 codes, 2048 tokens), eagerly;
    its seconds."""
    from vqtpu_torch.examples import group_parallel_grvq
    reset_all_launches()
    t0 = time.perf_counter()
    # the example compiles its group-parallel calls on the card (their
    # default); here they run eagerly: compiled, its two ranks took 192.8 s
    # in the whole script on an H100 machine (its three graphs), which put
    # the script past its 1000 s aim (PERF.md section 6)
    result = group_parallel_grvq.run(mesh, steps=steps, device=device, compiled=False)
    sync(device)
    return dict(result, launches=all_launches(), seconds=time.perf_counter() - t0)


def examples_distributed() -> dict:
    """tp_large_codebook on a (2, 2) mesh and group_parallel_grvq on two
    ranks, 3 steps each, eagerly, as gloo ranks sharing the card (reported in the
    examples_path line): {'tp': ranks, 'gp': ranks, 'seconds': ...}."""
    seconds = {}
    t0 = time.perf_counter()
    tp = dp_run_world(ex_tp_body, 'ex_tp_large_codebook', world=4, axes=EX_TP_MESH[0], mesh_shape=EX_TP_MESH[1],
                      steps=EX_DIST_STEPS)
    for r in tp:
        check(all(r['data_replicas_identical'].values()), f"tp_large_codebook: data replicas bit-identical {r['coords']}")
        check(r['rows_per_rank'] == 65536 // EX_TP_MESH[1][1] and np.isfinite(r['losses']).all(),
              f"tp_large_codebook: rows and losses on {r['coords']}")
        check(r['losses'] == tp[0]['losses'], 'tp_large_codebook: every rank reports the same mean loss')
        check(not r['compiled'], 'tp_large_codebook: the trainer ran its step eagerly')
    seconds['tp_large_codebook'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gp = dp_run_world(ex_gp_body, 'ex_group_parallel_grvq', world=2, axes=('group',), steps=EX_DIST_STEPS)
    seconds['group_parallel_grvq'] = time.perf_counter() - t0
    for r in gp:
        check(all(r['step0'].values()) and r['output_rel_err'] == r['loss_rel_err'] == 0,
              f"group_parallel_grvq: step 0 bit-equal to the serial loop {r['step0']} ({r['output_rel_err']}, "
              f"{r['loss_rel_err']})")
        check(r['decode_max_err'] < 1e-5, f"group_parallel_grvq: decode round trip {r['decode_max_err']}")
        check(not r['compiled'], 'group_parallel_grvq: the group-parallel calls ran eagerly')
    return dict(tp=tp, gp=gp, seconds=seconds)


def phase_examples_path(device, smi, dist):
    """examples_path: each of the eight autoencoders of vqtpu_torch.examples,
    main(train_iter=0) and main(train_iter=N) from the same seed on the
    card, on the port's image_batches (the synthetic images: no dataset on
    the machine; generated once, the same array for every example): every
    logged loss finite, the trained model's L1 reconstruction of a held-out
    synthetic batch in eval below the untrained one's, the launches of one
    training step after the run as PERF.md's table says (LFQ's as its
    entropy route says), the run's launches N steps of them (plus kmeans'
    at step 0 where the example has kmeans init), an eval forward's
    launches; the step time (CUDA events after warm-up), the idle share of
    5 profiled steps and the share of the loop spent in next(data), for
    the VQ example also on the native IDX loader's prefetch ring. `dist`
    is examples_distributed()'s (run beside the earlier phases)."""
    import contextlib
    import functools
    import importlib
    import io
    import tempfile
    import vqtpu_torch.models.data as tdata
    from vqtpu_torch.examples import AUTOENCODERS
    from vqtpu_torch.examples.common import adamw, train_step
    from vqtpu_torch.models import native_data
    from vqtpu_torch.quantizers.lfq import entropy_route

    t_phase = time.perf_counter()
    synthetic = tdata._synthetic_images
    tdata._synthetic_images = functools.lru_cache(maxsize=2)(synthetic)
    held_out = torch.from_numpy(synthetic(num=256, seed=4321)[..., None]).to(device)
    results = {}
    try:
        for name in AUTOENCODERS:
            mod = importlib.import_module(f'vqtpu_torch.examples.{name}')
            steps = EXAMPLE_STEPS[name]
            untrained = mod.main(train_iter=0, device=device)
            # the run compiled_path made for the examples that draw, else a new one
            run = example_run(name, device)
            model, run_launches, run_s = run['model'], run['run_launches'], run['run_s']
            losses = parse_logged_losses(run['log'])
            check(len(losses) == (steps - 1) // 50 + 1 + (1 if (steps - 1) % 50 else 0),
                  f'{name}: one log line every 50 steps and at the last ({len(losses)})')
            check(all(np.isfinite(v) for pair in losses for v in pair), f'{name}: every logged loss is finite')
            l1_untrained, l1_trained = example_eval_l1(untrained, held_out), example_eval_l1(model, held_out)
            check(l1_trained < l1_untrained,
                  f'{name}: the trained model reconstructs a held-out batch better ({l1_trained} vs {l1_untrained})')
            expected = dict(EXAMPLE_STEP_LAUNCHES[name])
            route = None
            if name == 'autoencoder_lfq':
                q = model.quantizer
                chunk = q.entropy_chunk_size
                if chunk is None and q.codebook_size > (1 << 16):
                    chunk = 1 << 14
                route = entropy_route(q.entropy_fused, 'cuda', q.codebook_dim, chunk)
                if route == 'fused':
                    expected = {f'lfq_sweep_{k}': 1 for k in 'abcd'}
            data = tdata.image_batches(batch_size=256, seed=1234)
            xb = torch.from_numpy(next(data)).to(device)
            step = train_step(model, adamw(model.parameters(), 3e-4), mod.loss_from_outputs, 10.0)
            step(xb)
            sync(device)
            before = all_launches()
            step(xb)
            sync(device)
            step_launches = launches_delta(before, all_launches())
            check(step_launches == expected, f'{name}: a training step launched {step_launches}, expected {expected}')
            # the run's steps are compiled: FVQ's launch K1 once less (DRAWING_COMPILED_LAUNCHES)
            per_step = COMPILED_RUN_LAUNCHES.get(name, expected)
            extra = {k: run_launches.get(k, 0) - steps * per_step.get(k, 0) for k in set(run_launches) | set(per_step)}
            if name in EXAMPLE_KMEANS:
                check(all(v >= 0 for v in extra.values()), f'{name}: the run launched N steps of kernels {extra}')
            else:
                check(all(v == 0 for v in extra.values()), f'{name}: the run launched N steps of kernels {extra}')
            model.eval()
            before = all_launches()
            with torch.no_grad():
                model(held_out)
            sync(device)
            eval_launches = launches_delta(before, all_launches())
            model.train()
            check(eval_launches == EXAMPLE_EVAL_LAUNCHES[name],
                  f'{name}: an eval forward launched {eval_launches}, expected {EXAMPLE_EVAL_LAUNCHES[name]}')
            step_ms = cuda_ms(lambda: step(xb), EXAMPLE_TIMED_STEPS, warmup=2)
            prof = profile_device(lambda: step(xb), 5)
            wait = example_data_wait(step, data, device, EXAMPLE_WAIT_STEPS)
            entry = dict(steps=steps, run_s=run_s, logged=losses, l1_untrained=l1_untrained, l1_trained=l1_trained,
                         launches_run=run_launches, launches_step=step_launches, launches_beyond_n_steps=extra,
                         launches_eval=eval_launches, step_ms=step_ms,
                         device_idle_share_5_steps=prof['device_idle_share'], data_wait=wait)
            if route is not None:
                entry['entropy_route'] = route
            if name == 'autoencoder':
                with tempfile.TemporaryDirectory() as td:
                    path = os.path.join(td, 'train-images-idx3-ubyte')
                    native_data.write_idx(path, synthetic_u8(NATIVE_IMAGES, seed=1234))
                    candidates, tdata._IDX_CANDIDATES = tdata._IDX_CANDIDATES, (path,)
                    try:
                        native = tdata.image_batches(batch_size=256, seed=1234)
                        entry['data_wait_native_prefetch'] = example_data_wait(step, native, device,
                                                                               EXAMPLE_WAIT_STEPS)
                        native.close()
                    finally:
                        tdata._IDX_CANDIDATES = candidates
            results[name] = entry
            emit('example', name=name, **entry)
            del untrained, model, step, run
            _EXAMPLE_RUNS.pop(name)
    finally:
        tdata._synthetic_images = synthetic
    torch.cuda.empty_cache()
    seconds = dict(autoencoders=time.perf_counter() - t_phase, **dist['seconds'])
    tp, gp = dist['tp'], dist['gp']
    emit('examples_path', steps=EXAMPLE_STEPS, batch=256, data='synthetic blob images (no dataset on the machine)',
         step_ms={k: v['step_ms'] for k, v in results.items()},
         device_idle_share={k: v['device_idle_share_5_steps'] for k, v in results.items()},
         data_wait_share={k: v['data_wait']['share'] for k, v in results.items()},
         data_wait_share_native_prefetch=results['autoencoder']['data_wait_native_prefetch']['share'],
         launches_step={k: v['launches_step'] for k, v in results.items()},
         launches_eval={k: v['launches_eval'] for k, v in results.items()},
         tp_large_codebook=dict(mesh=dict(zip(*EX_TP_MESH)), steps=EX_DIST_STEPS,
                                ranks=[{k: r[k] for k in ('coords', 'losses', 'rows_per_rank', 'ema_perplexity',
                                                          'launches')} for r in tp]),
         group_parallel_grvq=dict(world=2, steps=EX_DIST_STEPS,
                                  ranks=[{k: r[k] for k in ('step0', 'output_rel_err', 'loss_rel_err', 'losses', 'decode_max_err',
                                                            'launches', 'compiled', 'seconds')} for r in gp]),
         seconds=seconds, nvidia_smi=smi)
    return results, tp, gp


# -- the port's entry points: vqtpu_torch.entry ---------------------------------

ENTRY_REPS = 20
ENTRY_GLOO_WORLD = 4
# a card dryrun against the CPU one: each float tensor within this share of
# the CPU's largest entry, each loss within it relative (full f32 on both;
# a wrong selection or statistic moves a codebook row by O(its norm))
DRYRUN_REL_TOL = 1e-4


def expected_dryrun_launches(world: int) -> dict:
    """{section: {kernel wrapper: launches}} of one dryrun rank on the card,
    from the sections' code (vqtpu_torch/entry.py)."""
    def k(nearest_code=0, train_fused=0, code_sums=0):
        return dict(nearest_code=nearest_code, train_fused=train_fused, code_sums=code_sums)
    even = world % 2 == 0
    out = {'dp_autoencoder': k(train_fused=1),                 # one training forward, fused
           'tp_argmin_bf16': k(nearest_code=2)}                # the sharded selection, the unsharded one
    if even:
        out['sharded_ema_2d'] = k(nearest_code=1, code_sums=1)  # sharded_quantize, its EMA statistics
        # kmeans' 10 Lloyd iterations and the 2 steps' forwards: a sharded selection and its statistics each
        out['tp_vq_65536'] = k(nearest_code=12, code_sums=12)
    # 2 groups x 2 EMA layers fused; SimVQ's selection and its backward into the transform
    out['config5'] = k(nearest_code=1, train_fused=4, code_sums=1)
    if even:
        out['rvq_tp'] = k(nearest_code=2, code_sums=2)          # 2 row-sharded layers
    # the serial loop (g groups x 2 layers), a group's 2 layers on each rank, and (even) the data x group run
    g = 2 if even else 1
    out['group_parallel'] = k(train_fused=2 * g + 2 + (2 if even else 0))
    return out


def dryrun_launches(result: dict, kernel: str) -> list[dict]:
    """{section: launches of `kernel`} for each rank of a dryrun."""
    return [{s: v[kernel] for s, v in r.items()} for r in result['launches']]


def hold_dryrun(card: dict, cpu: dict) -> dict:
    """The card dryrun against the CPU one on the same seeds: the losses,
    and, for every rank, what each section left (buffers and gradients,
    indices, rows): integer tensors equal, float ones within
    DRYRUN_REL_TOL of the CPU's largest entry. Returns the worst relative
    error of each section."""
    worst = {}
    for key in ('dp_loss', 'tp_loss', 'config5_loss', 'rvq_tp_loss'):
        a, b = card[key], cpu[key]
        check((a is None) == (b is None), f'dryrun {key}: ran on both')
        if a is not None:
            err = abs(a - b) / abs(b)
            worst[key] = err
            check(err <= DRYRUN_REL_TOL, f'dryrun {key} on the card {a} against the CPU {b}')
    for r, (got_r, want_r) in enumerate(zip(card['held'], cpu['held'])):
        check(list(got_r) == list(want_r), f'dryrun rank {r}: the same sections')
        for section, want in want_r.items():
            got = got_r[section]
            check(sorted(got) == sorted(want), f'dryrun rank {r} {section}: the same tensors')
            for name, w in want.items():
                g = got[name]
                check(g.shape == w.shape and g.dtype == w.dtype, f'dryrun rank {r} {section} {name}: shape, dtype')
                if not w.is_floating_point():
                    check(torch.equal(g, w), f'dryrun rank {r} {section} {name}: equal to the CPU')
                    continue
                scale = float(w.abs().max()) if w.numel() else 0.0
                err = float((g - w).abs().max()) / scale if scale > 0 else float((g - w).abs().max())
                worst[section] = max(worst.get(section, 0.0), err)
                check(err <= DRYRUN_REL_TOL,
                      f'dryrun rank {r} {section} {name}: {err} of the largest entry from the CPU')
    return worst


# the dryruns of entry_dryrun: over NCCL on every card (one rank a card;
# JAX's odd-n skips at one card), over gloo with four ranks sharing the
# card, and the same on four CPU ranks, which holds the gloo run
DRYRUNS = {'nccl': ('nccl', 'cuda'), 'gloo4': ('gloo', 'cuda'), 'gloo4_cpu': ('gloo', 'cpu')}


def dryrun_world(name: str) -> int:
    return torch.cuda.device_count() if name == 'nccl' else ENTRY_GLOO_WORLD


def timed_dryrun(name: str) -> dict:
    """One of DRYRUNS: dryrun_multichip's result and its seconds."""
    from vqtpu_torch.entry import dryrun_multichip
    t0 = time.perf_counter()
    result = dryrun_multichip(dryrun_world(name), backend=DRYRUNS[name][0], device=DRYRUNS[name][1])
    result['seconds'] = time.perf_counter() - t0
    return result


def entry_forward_on_card() -> dict:
    """vqtpu_torch.entry.entry() on the card, fn(state, x) called twice: the
    outputs bit-identical, the state unchanged, K4 once a call (and nothing
    else), held to entry(device='cpu') on the same state (reconstruction
    and commitment loss within 1e-4 of their largest entry, indices but at
    near-ties); its ms by CUDA events and the idle share of 5 profiled
    calls."""
    from vqtpu_torch.entry import build_flagship, entry
    from vqtpu_torch.kernels.distance import selection_bias, selection_disagreements

    fn, (state, x) = entry()
    check(x.is_cuda and all(v.is_cuda for v in state.values()), 'entry() puts its state and input on the card')
    before = {k: v.clone() for k, v in state.items()}
    outs, launches = [], []
    for _ in range(2):
        reset_all_launches()
        outs.append(fn(state, x))
        sync('cuda')
        launches.append(launches_delta({k: 0 for k in all_launches()}, all_launches()))
    check(launches == [dict(train_fused=1)] * 2, f'the entry forward launched K4 once a call {launches}')
    check(all(torch.equal(a, b) for a, b in zip(*outs)), 'two calls of the entry forward are bit-identical')
    check(all(torch.equal(before[k], v) for k, v in state.items()), 'the entry forward leaves its state unchanged')
    recon, idx, loss = outs[0]
    check(recon.shape == x.shape and idx.shape == (8, 49) and bool(torch.isfinite(recon).all()),
          'entry forward shapes and finite reconstruction')

    fn_cpu, (_, x_cpu) = entry(device='cpu')
    state_cpu = {k: v.cpu() for k, v in state.items()}
    recon_ref, idx_ref, loss_ref = fn_cpu(state_cpu, x_cpu)
    ref = build_flagship(device='cpu')
    ref.load_state_dict(state_cpu)
    with torch.no_grad():
        z = ref.encoder(x_cpu).reshape(-1, 32).to('cuda')
    embed = state['quantizer._codebook.embed'][0]
    ties = selection_disagreements(z, embed, selection_bias(embed, 'euclidean'), idx.reshape(-1),
                                   idx_ref.reshape(-1).to('cuda'))
    check(ties['non_tie'] == 0, f'entry indices disagree with the CPU beyond near-ties {ties}')
    same = (idx.cpu() == idx_ref).all(-1)
    recon_err = float((recon.detach().cpu()[same] - recon_ref.detach()[same]).abs().max()) if same.any() else 0.0
    recon_tol = 1e-4 * float(recon_ref.detach().abs().max())
    loss_err = abs(float(loss) - float(loss_ref))
    check(recon_err <= recon_tol and loss_err <= 1e-4 * abs(float(loss_ref)),
          f'the entry forward matches the CPU (recon {recon_err} > {recon_tol} or loss {loss_err})')
    with torch.no_grad():
        forward_ms = cuda_ms(lambda: fn(state, x), ENTRY_REPS)
        prof = profile_device(lambda: fn(state, x), 5)
    entry_out = dict(launches_per_call=launches, images_agreeing=int(same.sum()), recon_max_abs_err_vs_cpu=recon_err,
                     commit_loss_abs_err_vs_cpu=loss_err, forward_ms=forward_ms,
                     device_idle_share_5_calls=prof['device_idle_share'],
                     device_ms_per_call=prof['device_ms_per_call'], **ties)
    return entry_out


def phase_entry_dryrun(entry_out, runs, smi):
    """entry_dryrun: the entry forward on the card (entry_forward_on_card)
    and the dryruns (DRYRUNS, timed_dryrun): every section, each rank's
    launches of K1, K4 and code_sums per section exactly as predicted; the
    gloo run held to the same dryrun on four CPU ranks (hold_dryrun)."""
    for name in DRYRUNS:
        n = dryrun_world(name)
        check(runs[name]['n_devices'] == n and len(runs[name]['launches']) == n, f'dryrun {name}: {n} ranks')
    gloo = runs['gloo4']
    check(gloo['skipped'] == [] and gloo['tp_loss'] is not None and gloo['rvq_tp_loss'] is not None,
          'the 4-rank gloo dryrun ran every section')
    for name in ('nccl', 'gloo4'):
        want = expected_dryrun_launches(runs[name]['n_devices'])
        check(all(r == want for r in runs[name]['launches']),
              f"dryrun {name}: every rank's launches as predicted {runs[name]['launches']} vs {want}")
    worst = hold_dryrun(gloo, runs['gloo4_cpu'])
    emit('entry_dryrun', entry=entry_out,
         dryrun={k: {key: v[key] for key in ('n_devices', 'backend', 'devices', 'dp_loss', 'tp_loss', 'config5_loss',
                                              'rvq_tp_loss', 'skipped', 'summary', 'launches', 'seconds')}
                 for k, v in runs.items()},
         gloo4_vs_cpu_worst_rel_err=worst, gloo4_vs_cpu_tol=DRYRUN_REL_TOL, nvidia_smi=smi)
    return entry_out, {k: v for k, v in runs.items() if k != 'gloo4_cpu'}      # the card's runs


# -- dtypes: low-precision inputs and autocast -------------------------------------------

DTYPE_LOW = {'bf16': torch.bfloat16, 'fp16': torch.float16}
# a token whose index moves when the input moves this much (relative, plus
# the same absolute) sits at a bin edge (tests/test_torch_dtype.py)
DTYPE_EDGE_REL = 1e-6
DTYPE_MAX_DIFFER_SHARE = 1e-2
DTYPE_TOL = 1e-4


def dtype_cases():
    """Each module of the F1 repair (ROADMAP.md Queue 3) on a low-precision
    input: name -> (build(**route kwargs) on the CPU, the kernel route's
    kwargs, the plain route's kwargs, the plain route's device, the input
    shape, the index rule, {mode: kernels its forward must launch}, the
    output's dtype: 'f32', or the input's where no projection promotes it,
    as in the JAX package)."""
    import vqtpu_torch as vt
    lfq_sweeps = [f'lfq_sweep_{k}' for k in 'abcd']
    vq_routes = (dict(), dict(use_pallas=False), 'cuda')
    return {
        'lfq': (lambda **kw: vt.LFQ(dim=24, codebook_size=4096, **kw), dict(entropy_fused='on'),
                dict(entropy_fused='off'), 'cuda', (4, 1024, 24), 'scalar', dict(train=lfq_sweeps, eval=[]), 'f32'),
        'residual_lfq': (lambda **kw: vt.ResidualLFQ(dim=24, codebook_size=4096, num_quantizers=2, **kw),
                         dict(entropy_fused='on'), dict(entropy_fused='off'), 'cuda', (4, 1024, 24), 'scalar',
                         dict(train=lfq_sweeps, eval=[]), 'f32'),
        'fsq': (lambda **kw: vt.FSQ(levels=[8, 5, 5], dim=16, **kw), {}, {}, 'cpu', (4, 1024, 16), 'scalar',
                dict(train=[], eval=[]), 'f32'),
        # no projection: K9 in eval, held to the 'off' loop on the card
        'residual_fsq': (lambda **kw: vt.ResidualFSQ(dim=4, levels=[8, 5, 5, 5], num_quantizers=8, **kw),
                         dict(eval_fused='auto'), dict(eval_fused='off'), 'cuda', (4, 1024, 4), 'scalar',
                         dict(train=[], eval=['residual_fsq_fused']), 'input'),
        'grouped_residual_fsq': (lambda **kw: vt.GroupedResidualFSQ(dim=8, levels=[8, 5, 5, 5], num_quantizers=4,
                                                                    groups=2, **kw),
                                 dict(eval_fused='auto'), dict(eval_fused='off'), 'cuda', (4, 1024, 8), 'scalar',
                                 dict(train=[], eval=['residual_fsq_fused']), 'input'),
        'fsp': (lambda **kw: vt.FSP([8, 5, 5], dim=16, **kw), {}, {}, 'cpu', (4, 1024, 16), 'scalar',
                dict(train=[], eval=[]), 'f32'),
        'latent_quantize': (lambda **kw: vt.LatentQuantize(levels=[5, 5, 8], dim=16, **kw), {}, {}, 'cpu',
                            (4, 16, 1024), 'scalar', dict(train=[], eval=[]), 'f32'),
        'residual_vq': (lambda **kw: vt.ResidualVQ(dim=256, codebook_size=1024, num_quantizers=2, codebook_dim=128,
                                                   **kw), *vq_routes, (4, 1024, 256), 'codebook',
                        dict(train=['train_fused'], eval=['nearest_code']), 'f32'),
        'grouped_residual_vq': (lambda **kw: vt.GroupedResidualVQ(dim=256, codebook_size=1024, num_quantizers=2,
                                                                  groups=2, codebook_dim=64, **kw),
                                *vq_routes, (4, 1024, 256), 'codebook',
                                dict(train=['train_fused'], eval=['nearest_code']), 'f32'),
        'rpq': (lambda **kw: vt.RandomProjectionQuantizer(dim=256, codebook_size=1024, codebook_dim=64,
                                                          num_codebooks=4, **kw), *vq_routes, (4, 1024, 256),
                'codebook', dict(train=['nearest_code'], eval=['nearest_code']), None),
        # from its random codebook: kmeans init would overwrite the codebook
        # inside the call, after the codebook calls are recorded
        'hierarchical_vq': (lambda **kw: vt.HierarchicalVQ(dim=64, codebook_size=256, scales=(1, 2, 4, 8),
                                                           accept_image_fmap=True, kmeans_init=False, **kw),
                            *vq_routes, (8, 64, 8, 8), 'codebook',
                            dict(train=['train_fused'], eval=['nearest_code']), 'f32'),
        'binary_mapper': (lambda **kw: vt.BinaryMapper(bits=8, **kw), {}, {}, 'cpu', (4, 1024, 8), 'bits',
                          dict(train=[], eval=[]), 'f32'),
    }


def dtype_outputs(out) -> list:
    """The tensors of a module's output in a fixed order (dicts by key)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in dtype_outputs(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in dtype_outputs(o)]
    return []


def record_codebook_calls(model, store: list) -> list:
    """Hooks that append each Codebook call's (h, N, d) f32 input, its
    codebook and its (h, N) picks to `store`."""
    from vqtpu_torch.codebook.codebook import Codebook

    def pre(module, args, kwargs):
        x = args[0].detach().float()
        x = x[None] if x.ndim < 4 else x
        store.append([x.reshape(x.shape[0], -1, x.shape[-1]), module.embed.detach().clone(), None,
                      'cosine' if module.use_cosine_sim else 'euclidean'])

    def post(module, args, kwargs, out):
        store[-1][2] = out[1].reshape(store[-1][1].shape[0], -1)
    handles = []
    for m in model.modules():
        if isinstance(m, Codebook):
            handles += [m.register_forward_pre_hook(pre, with_kwargs=True),
                        m.register_forward_hook(post, with_kwargs=True)]
    return handles


def dtype_edge_entries(before, x32, idx) -> list:
    """Per index output, True where the kernel route's index moves when the
    f32 input moves by DTYPE_EDGE_REL of its magnitude (plus the same) either
    way, in eval."""
    import copy
    moved = [torch.zeros_like(i, dtype=torch.bool) for i in idx]
    step = DTYPE_EDGE_REL * (x32.abs() + 1.0)
    for sign in (1.0, -1.0):
        with torch.no_grad():
            out = dtype_outputs(copy.deepcopy(before).eval()(x32 + sign * step))
        moved = [mv | (a != b.to(a.device)) for mv, a, b in
                 zip(moved, idx, [o for o in out if not o.dtype.is_floating_point])]
    return moved


def dtype_case(name, case, dt, mode, device):
    """One module on a `dt` input in `mode` (a training step: forward and
    backward): the kernel route on the card against the plain route (on the
    card or a CPU copy) from the same state. Returns the case's findings."""
    import copy
    from vqtpu_torch.core.sampling import uniform_noise
    from vqtpu_torch.kernels.distance import selection_bias, selection_disagreements
    build, kernel_kw, plain_kw, plain_device, shape, rule, kernels, out_dtype = case
    # the same seed: the same parameters and the same random streams
    torch.manual_seed(61)
    kernel_model = build(device='cpu', **kernel_kw)
    torch.manual_seed(61)
    plain_model = build(device='cpu', **plain_kw)
    plain_model.load_state_dict(kernel_model.state_dict())
    kernel_model = kernel_model.to(device).train(mode == 'train')
    plain_model = plain_model.to(plain_device).train(mode == 'train')
    before = copy.deepcopy(kernel_model)
    x = torch.from_numpy(np.random.default_rng(62).standard_normal(shape, dtype=np.float32)).to(DTYPE_LOW[dt])
    call = (lambda m, t: m(t, return_indices=True)) if name == 'binary_mapper' else (lambda m, t: m(t))

    k_calls, p_calls = [], []
    handles = record_codebook_calls(kernel_model, k_calls) + record_codebook_calls(plain_model, p_calls)
    xk = x.to(device).requires_grad_(mode == 'train')
    reset_all_launches()
    got = dtype_outputs(call(kernel_model, xk))
    floats = [g for g in got if g.dtype.is_floating_point and g.requires_grad]
    if mode == 'train' and floats:
        # the backward: LFQ's sweeps C and D run there
        sum(g.float().mean() for g in floats).backward()
    sync(device)
    launches = {k: v for k, v in all_launches().items() if v}
    # K9 takes its input in f32, as the JAX package's kernel does, where the
    # loop soft-clamps in the input's dtype: in eval it is held to the loop
    # on the input's values in f32, its output cast back
    f32_plain = mode == 'eval' and 'residual_fsq_fused' in kernels['eval']
    with torch.set_grad_enabled(mode == 'train'):
        want = dtype_outputs(call(plain_model, x.to(plain_device).float() if f32_plain else x.to(plain_device)))
    if f32_plain:
        want = [w.to(x.dtype) if w.dtype.is_floating_point else w for w in want]
    for h in handles:
        h.remove()
    check(all(launches.get(k, 0) > 0 for k in kernels[mode]) and set(launches) <= set(kernels[mode]),
          f'dtype {name} {dt} {mode}: the kernel route launched {launches}, expected {kernels[mode]}')
    check(len(got) == len(want) and all(g.dtype == w.dtype and g.shape == w.shape for g, w in zip(got, want)),
          f'dtype {name} {dt} {mode}: the routes return the same dtypes and shapes')
    dtypes = [str(g.dtype).replace('torch.', '') for g in got]
    if out_dtype is not None:
        want_dtype = torch.float32 if out_dtype == 'f32' else x.dtype
        check(got[0].dtype == want_dtype and got[1].dtype == torch.int32,
              f'dtype {name} {dt} {mode}: the output in {want_dtype} and int32 indices ({dtypes})')

    idx_got = [g for g in got if not g.dtype.is_floating_point]
    idx_want = [w.to(device) for w in want if not w.dtype.is_floating_point]
    differ = [a != b for a, b in zip(idx_got, idx_want)]
    n_differ = sum(int(d.sum()) for d in differ)
    finding = dict(launches=launches, dtypes=dtypes, index_entries=sum(d.numel() for d in differ),
                   indices_differing=n_differ)
    if rule == 'codebook':
        check(len(k_calls) == len(p_calls) > 0, f'dtype {name}: the routes made the same codebook calls')
        non_tie = 0
        for (xin, embed, picks, metric), plain in zip(k_calls, p_calls):
            for h in range(embed.shape[0]):
                r = selection_disagreements(xin[h], embed[h], selection_bias(embed[h], metric), picks[h],
                                            plain[2][h].to(device))
                non_tie += r['non_tie']
        check(non_tie == 0, f'dtype {name} {dt} {mode}: {non_tie} picks differ beyond near-ties')
    else:
        x32 = x.float().to(device)
        if rule == 'scalar':
            edges = dtype_edge_entries(before, x32, idx_got)
        else:
            # a bit is an edge where its float64 probability lies within 2^-7
            # of its threshold: 0.5, or the uniform the draw compared it with
            # (the streams draw the same bits on the card and the CPU, so
            # both routes drew the same)
            p = torch.sigmoid(x32.double())
            if kernel_model.deterministic_on_eval and mode == 'eval':
                threshold = 0.5
            else:
                threshold = uniform_noise(before.generator, x.shape, dtype=x.dtype).double().to(device)
            edges = [((p - threshold).abs() <= 2 ** -7).any(-1)] * len(idx_got)
        for d, edge in zip(differ, edges):
            check(not bool((d & ~edge.expand_as(d)).any()),
                  f'dtype {name} {dt} {mode}: {int((d & ~edge.expand_as(d)).sum())} indices differ off an edge')
        finding['edge_entries'] = sum(int(e.sum()) for e in edges)
    check(n_differ <= max(1, DTYPE_MAX_DIFFER_SHARE * finding['index_entries']),
          f'dtype {name} {dt} {mode}: {n_differ} indices differ')
    # values: a differing index may move its token's (for HierarchicalVQ its
    # scale's upsampled patch's) features
    worst = 0.0
    for g, w in zip(got, want):
        if not g.dtype.is_floating_point:
            continue
        # a low-precision output (BinaryMapper's aux loss) may round an ulp apart
        tol = max(DTYPE_TOL, torch.finfo(g.dtype).eps)
        g, w = g.detach().float(), w.detach().float().to(device)
        err = (g - w).abs()
        bad = err > tol * (1.0 + w.abs())
        if g.ndim == len(shape):
            bad = bad.any(1) if len(shape) == 4 or name == 'latent_quantize' else bad.any(-1)
        spoiled = shape[-1] * shape[-2] if len(shape) == 4 else 1
        check(int(bad.sum()) <= n_differ * spoiled,
              f'dtype {name} {dt} {mode}: {int(bad.sum())} tokens beyond {tol} relative '
              f'({n_differ} indices differ)')
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    finding['max_abs_err'] = worst
    if mode == 'train':
        if floats:
            check(xk.grad is not None and xk.grad.dtype == x.dtype and bool(torch.isfinite(xk.grad).all()),
                  f'dtype {name} {dt}: the input gradient is finite and in the input dtype')
        if rule == 'codebook' and n_differ == 0:
            ks, ps = kernel_model.state_dict(), plain_model.state_dict()
            state_err = max(float((ks[k].float() - ps[k].float().to(device)).abs().max()
                                  / ps[k].float().abs().max().clamp_min(1e-30))
                            for k in ks if ks[k].dtype.is_floating_point and ks[k].numel())
            check(state_err <= 1e-5, f'dtype {name} {dt}: the state after the step within 1e-5 ({state_err})')
            finding['state_rel_err'] = state_err
    return finding


def autocast_twins(name, build, call, inputs, state_keys, kernels):
    """`call(model, x)` on two twins of one module (`build` seeds torch
    first, so their state and generators agree), plainly and under
    torch.autocast('cuda', dtype=torch.bfloat16): every output bit-equal,
    and the buffers `state_keys` after it; the same launches, `kernels` among
    them. Returns the launches of a call."""
    plain, cast = build(), build()
    reset_all_launches()
    want = call(plain, inputs())
    sync('cuda')
    plain_launches = all_launches()
    reset_all_launches()
    with torch.autocast('cuda', dtype=torch.bfloat16):
        got = call(cast, inputs())
    sync('cuda')
    cast_launches = all_launches()
    check(plain_launches == cast_launches and all(plain_launches[k] > 0 for k in kernels),
          f'autocast {name}: the same launches {plain_launches} {cast_launches}, {kernels} among them')
    want, got = dtype_outputs(want), dtype_outputs(got)
    check(len(want) == len(got) > 0 and all(w.dtype == g.dtype and torch.equal(w, g) for w, g in zip(want, got)),
          f'autocast {name}: every output bit-equal under autocast')
    ps, cs = plain.state_dict(), cast.state_dict()
    check(all(torch.equal(ps[k], cs[k]) for k in state_keys), f'autocast {name}: {state_keys} bit-equal')
    return {k: v for k, v in plain_launches.items() if v}


def dtype_launches(low: dict, casts: dict, kernel: str) -> dict:
    """A kernel's launches in each dtype_path call that launched it (for
    LFQ's four sweeps, sweep A's: each sweep runs once with it)."""
    out = {k: v['launches'][kernel] for k, v in low.items() if v['launches'].get(kernel)}
    out.update({f'autocast_{k}': v[kernel] for k, v in casts.items() if v.get(kernel)})
    return out


def phase_dtype_path(device, sizes):
    """dtype_path. Low-precision inputs: each module of the F1 repair on
    bf16 and fp16 inputs, in eval and in one training step (forward and
    backward), on its kernel route on the card against its plain route from
    the same state (dtype_case). Autocast at full width: the main path's
    VectorQuantize(dim=256, codebook_size=512) on (1024, 1024, 256) in eval
    and one step per train_fused route, ResidualVQ(dim=256,
    num_quantizers=8, codebook_size=1024) eval on (32, 2048, 256),
    SimVQ(dim=256, codebook_size=512) eval and one step of the distance path
    (stochastic_sample_codes=True) on the main shape, each under
    torch.autocast('cuda', dtype=torch.bfloat16) bit-equal to the same call
    without it: outputs, losses and the codebook's embed, embed_avg and
    cluster_size."""
    import vqtpu_torch as vt
    t0 = time.perf_counter()
    low = {}
    for name, case in dtype_cases().items():
        for dt in DTYPE_LOW:
            for mode in ('eval', 'train'):
                low[f'{name}_{dt}_{mode}'] = dtype_case(name, case, dt, mode, device)
    low_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    n, c, d = sizes['main']
    b = sizes['batch']
    rng = np.random.default_rng(63)
    x_main = torch.from_numpy(rng.standard_normal((b, n // b, d), dtype=np.float32)).to(device)
    g_main = torch.from_numpy(rng.standard_normal((b, n // b, d), dtype=np.float32) * 1e-3).to(device)
    state = ['_codebook.embed', '_codebook.embed_avg', '_codebook.cluster_size']

    def vq(**kw):
        torch.manual_seed(64)
        return vt.VectorQuantize(dim=d, codebook_size=c, device=device, **kw)

    def step(model, x):
        model.train()
        q, idx, loss = model(x)
        ((q * g_main).sum() + loss).backward()
        return q.detach(), idx, loss.detach(), x.grad

    def eval_call(model, x):
        with torch.no_grad():
            return model.eval()(x)

    def fresh():
        return x_main.clone().requires_grad_()
    casts = {
        'vq_eval': autocast_twins('vq_eval', vq, eval_call, lambda: x_main, state, ['nearest_code']),
        'vq_step_on': autocast_twins('vq_step_on', lambda: vq(train_fused='on'), step, fresh, state,
                                     ['train_fused']),
        'vq_step_off': autocast_twins('vq_step_off', lambda: vq(train_fused='off'), step, fresh, state,
                                      ['nearest_code']),
        'distance_path_step': autocast_twins('distance_path_step', lambda: vq(stochastic_sample_codes=True), step,
                                             fresh, state, []),
    }
    rb, rn, rd, rq, rc = RVQ_MAIN
    x_rvq = torch.from_numpy(rng.standard_normal((rb, rn, rd), dtype=np.float32)).to(device)

    def rvq():
        torch.manual_seed(65)
        return vt.ResidualVQ(dim=rd, num_quantizers=rq, codebook_size=rc, device=device)
    rvq_state = [f'layers.{i}.{k}' for i in range(rq) for k in state]
    casts['rvq_eval'] = autocast_twins('rvq_eval', rvq, eval_call, lambda: x_rvq, rvq_state, ['nearest_code'])
    del x_rvq
    sb, sn, sd, sc = sizes['simvq_main']

    def simvq():
        torch.manual_seed(66)
        return vt.SimVQ(dim=sd, codebook_size=sc, device=device)
    casts['simvq_eval'] = autocast_twins('simvq_eval', simvq, eval_call, lambda: x_main, [], ['nearest_code'])
    check(casts['vq_eval'] == dict(nearest_code=1) and casts['vq_step_on'] == dict(train_fused=1)
          and casts['vq_step_off'] == dict(nearest_code=1) and casts['rvq_eval'] == dict(nearest_code=rq)
          and casts['simvq_eval'] == dict(nearest_code=1) and casts['distance_path_step'] == {},
          f'autocast: each call launched its kernels as without autocast {casts}')
    cast_s = time.perf_counter() - t0
    del x_main, g_main
    torch.cuda.empty_cache()
    emit('dtype_path', low_precision=low, low_precision_s=low_s, autocast_launches=casts, autocast_s=cast_s,
         autocast_dtype='bfloat16', autocast_shapes=dict(vq=[b, n // b, d], rvq=list(RVQ_MAIN[:3]),
                                                         simvq=[sb, sn, sd]))
    return low, casts


# -- the compiled step: the kernels as torch.ops.vqtpu ops under torch.compile -------------

COMPILED_REPS = 10          # CUDA-event calls a mode and round; two rounds give the spread
COMPILED_STEPS = 3          # compiled training steps held to as many eager ones
COMPILED_REL = 1e-5         # inductor may reorder the glue's f32 reductions
COMPILED_MOMENTS_REL = 1e-4  # Adam's moments: the gradients, summed in another order by the compiled backward
FSP_EDGE_REL = 1e-5          # an FSP activation this close to a bin edge (in [0, 1]) sits on it in f32
# the examples whose steps draw (stochastic codes, kmeans init, FSP's perturbation)
DRAWING_EXAMPLES = ('autoencoder_rvq', 'autoencoder_hq', 'autoencoder_fvq', 'autoencoder_fsp')
# the kernels' symbols in csrc/*.cu: K1 and K4 share the tensor-core tile, K4
# (and code_sums) add the statistics by sorted code
KERNEL_SYMBOLS = dict(select='select_tf32_kernel', sorted_stats='sort_split_kernel', sweep_a='sweep_a_kernel',
                      sweep_b='sweep_b_kernel', sweep_c='sweep_c_kernel', sweep_d='sweep_d_kernel',
                      k9='residual_fsq_eval_kernel')
K1_SYMBOLS = dict(select=1)
K4_SYMBOLS = dict(select=1, sorted_stats=1)
LFQ_SYMBOLS = dict(sweep_a=1, sweep_b=1, sweep_c=1, sweep_d=1)
K9_SYMBOLS = dict(k9=1)


# a spin kernel of this many cycles (about 25 ms) pads each side of a
# profiled window
PAD_CYCLES = 50_000_000


class LostWindows(AssertionError):
    """Every profiler window of a measurement lost device events."""


def warm_profile(fn, calls: int = 1, windows: int = 4, agree=None):
    """torch.profiler events of `calls` calls of `fn`, and the launch
    counters' delta over them. A window may lose device events (seen on an
    H100 with torch 2.11: the first milliseconds of a cold window, and now
    and then all of them, more often in a process that has profiled much),
    so a spin kernel and one call warm the profiler up, spin kernels of
    about 25 ms pad the measured calls on either side, and a window that
    did not record both pads lost events and is taken again, up to
    `windows` in all. `agree(ok) -> ok`, where ranks call `fn` together,
    makes every rank take a window again while any lost events. Returns
    (events without the pads and the step annotation, launches, windows
    taken)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for window in range(1, windows + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            torch.cuda._sleep(PAD_CYCLES)
            fn()
            torch.cuda.synchronize()
            prof.step()
            torch.cuda._sleep(PAD_CYCLES)
            before = all_launches()
            for _ in range(calls):
                fn()
            launches = launches_delta(before, all_launches())
            torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
            prof.step()
        events = prof.events()
        ok = sum(e.device_type == DeviceType.CUDA and 'spin_kernel' in e.name for e in events) == 2
        if agree is not None:
            ok = agree(ok)
        if ok:
            break
    else:
        raise LostWindows(f'check failed: {windows} profiler windows each lost device events')
    # the pads, and the step annotation that spans the whole window on the device's timeline
    kept = [e for e in events if 'spin_kernel' not in e.name and not e.name.startswith('ProfilerStep')]
    return kept, launches, window


def compiled_trace(fn, windows: int = 4, agree=None) -> dict:
    """One call of `fn` under a warmed profiler (`warm_profile`): the
    hand-written kernels by symbol, every device kernel or host op whose
    name holds 'argmax' (a product and an argmax standing in for the
    selection), and the launch counters' delta."""
    from torch.autograd import DeviceType

    events, launches, windows = warm_profile(fn, windows=windows, agree=agree)
    device = [e.name for e in events if e.device_type == DeviceType.CUDA]
    symbols = {k: sum(sym in name for name in device) for k, sym in KERNEL_SYMBOLS.items()}
    return dict(symbols={k: v for k, v in symbols.items() if v}, device_kernels=len(device), windows=windows,
                kernel_names=sorted({name[:60] for name in device}),
                argmax=sorted({e.name[:80] for e in events if 'argmax' in e.name.lower()}),
                launches=launches)


def warm_idle_share(fn, calls: int = 5, windows: int = 4, agree=None) -> dict:
    """The device's idle share over `calls` back-to-back calls of `fn`
    under a warmed profiler: 1 - the time some kernel ran (the union of the
    kernels' intervals, each interval once) / the span from the first
    kernel's start to the last one's end."""
    from torch.autograd import DeviceType

    events, _, windows = warm_profile(fn, calls, windows, agree)
    spans = sorted({(e.time_range.start, e.time_range.end) for e in events if e.device_type == DeviceType.CUDA})
    if not spans:
        return dict(idle_share=None, device_events=0, windows=windows)
    busy, (lo, hi) = 0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    return dict(idle_share=1 - busy / (max(e for _, e in spans) - spans[0][0]), device_events=len(spans),
                windows=windows)


def check_trace(name, trace, symbols, launches):
    check(trace['symbols'] == symbols, f'{name}: the compiled call ran {trace["symbols"]}, expected {symbols} '
                                       f'({trace["launches"]}; {trace["kernel_names"]})')
    check(trace['launches'] == launches, f'{name}: the compiled call launched {trace["launches"]}, expected {launches}')
    check(not trace['argmax'], f'{name}: nothing stands in for the selection {trace["argmax"]}')


def first_calls_s(fn, calls: int = 1) -> float:
    """Seconds of the first `calls` calls (compile, warm-up and capture)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def mode_times(fns: dict, reps: int = COMPILED_REPS) -> dict:
    """CUDA-event ms a call of each mode, `reps` calls a round, two rounds
    in turns (forward, then backward order)."""
    order = list(fns)
    runs = {k: [] for k in order}
    for rnd in (order, order[::-1]):
        for k in rnd:
            runs[k].append(cuda_ms(fns[k], reps, warmup=2))
    return dict(ms={k: sum(v) / len(v) for k, v in runs.items()}, ms_runs=runs)


def profile_path(name: str, fns: dict, idle_modes=()) -> dict:
    """The trace of one call of fns['compiled'] (compiled_trace) and the
    idle share of 5 calls of each mode in `idle_modes`, taken in this
    process; a process that has lost its profiler windows keeps losing
    them, so then the path is built again in a fresh process
    (`python3 chip_smoke.py --profile NAME MODE...`) and profiled there."""
    try:
        return dict(trace=compiled_trace(fns['compiled']),
                    idle={k: warm_idle_share(fns[k]) for k in idle_modes}, profiled_in='this process')
    except LostWindows:
        cmd = [sys.executable, os.path.abspath(__file__), '--profile', name, *idle_modes]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        check(r.returncode == 0, f'{name}: the fresh process failed ({r.returncode}):\n{r.stdout[-3000:]}\n'
                                 f'{r.stderr[-3000:]}')
        return dict(json.loads(r.stdout.strip().splitlines()[-1]), profiled_in='a fresh process')


def _no_grad(fn):
    def call():
        with torch.no_grad():
            return fn()
    return call


# -- the compiled paths, each built the same way in this process and in a fresh one
# (`--profile NAME`): a dict of what the phase holds, 'fns' the calls by mode


def subject_vq_eval(device):
    import vqtpu_torch as vt
    from vqtpu_torch.core.compile import compile_step
    n, c, d = MAIN
    x = torch.from_numpy(np.random.default_rng(71).standard_normal((1024, n // 1024, d), dtype=np.float32)).to(device)
    torch.manual_seed(72)
    vq = vt.VectorQuantize(dim=d, codebook_size=c, device=device).eval()
    compiled = compile_step(vq)
    return dict(vq=vq, compiled=compiled, x=x,
                fns=dict(eager=_no_grad(lambda: vq(x)), compiled=_no_grad(lambda: compiled(x))))


def _vq_train_call(m):
    def step(xs, gs):
        q, idx, loss = m(xs)
        gx, = torch.autograd.grad((q * gs).sum() + loss, [xs])
        return q.detach(), idx, loss.detach(), gx
    return step


def subject_vq_on_step(device):
    import vqtpu_torch as vt
    from vqtpu_torch.core.compile import compile_step
    n, c, d = MAIN
    rng = np.random.default_rng(71)
    x = torch.from_numpy(rng.standard_normal((1024, n // 1024, d), dtype=np.float32)).to(device)
    g = torch.from_numpy(rng.standard_normal(x.shape, dtype=np.float32)).to(device)
    xg = x.detach().requires_grad_()
    torch.manual_seed(73)
    vqs = [vt.VectorQuantize(dim=d, codebook_size=c, train_fused='on', device=device).train() for _ in range(2)]
    vqs[1].load_state_dict(vqs[0].state_dict())
    eager, compiled = _vq_train_call(vqs[0]), compile_step(_vq_train_call(vqs[1]))
    return dict(vqs=vqs, eager=eager, compiled=compiled, x=x, xg=xg, g=g,
                fns=dict(eager=lambda: eager(xg, g), compiled=lambda: compiled(xg, g)))


def _lfq_call(m):
    def step(xs):
        (q, idx, aux), _ = m(xs, inv_temperature=LFQ_INV_TEMP, return_loss_breakdown=True)
        gx, = torch.autograd.grad(aux + q.square().mean(), [xs])
        return q.detach(), idx, aux.detach(), gx
    return step


def subject_lfq_on_step(device):
    import vqtpu_torch as vt
    from vqtpu_torch.core.compile import compile_step
    ld = LFQ_MAIN[1]
    xg = torch.from_numpy(np.random.default_rng(74).standard_normal((8, 1024, ld), dtype=np.float32)).to(device)
    xg.requires_grad_()
    torch.manual_seed(74)
    lfqs = [vt.LFQ(dim=ld, codebook_size=2 ** ld, spherical=True, entropy_loss_weight=0.1, entropy_fused='on',
                   device=device).train() for _ in range(2)]
    lfqs[1].load_state_dict(lfqs[0].state_dict())
    eager, compiled = _lfq_call(lfqs[0]), compile_step(_lfq_call(lfqs[1]))
    return dict(compiled=compiled, xg=xg, fns=dict(eager=lambda: eager(xg), compiled=lambda: compiled(xg)))


def subject_rfsq_eval(device):
    import vqtpu_torch as vt
    from vqtpu_torch.core.compile import compile_step
    levels, q, lead = RFSQ_MAIN
    xr = rfsq_input(levels, lead, device, seed=75)
    rfsq = vt.ResidualFSQ(dim=len(levels), levels=list(levels), num_quantizers=q, device=device).eval()
    compiled = compile_step(rfsq)
    return dict(fns=dict(eager=_no_grad(lambda: rfsq(xr)), compiled=_no_grad(lambda: compiled(xr))))


def subject_entry_forward(device):
    from vqtpu_torch.core.compile import compile_step
    from vqtpu_torch.entry import entry
    fn, (state, x) = entry(device=device)
    x = x + 0.5                       # zeros would pick code 0 for every token
    compiled, graph = compile_step(fn), compile_step(fn, mode='reduce-overhead')
    return dict(state=state, x=x, modes=dict(compiled=compiled, graph=graph),
                fns=dict(eager=lambda: fn(state, x), compiled=lambda: compiled(state, x),
                         graph=lambda: graph(state, x)))


def subject_vq_example_step(device):
    import contextlib
    import io
    from vqtpu_torch.examples import autoencoder
    from vqtpu_torch.examples.common import adamw, train_step
    from vqtpu_torch.models import data as tdata

    with contextlib.redirect_stdout(io.StringIO()):
        models = {k: autoencoder.main(train_iter=0, device=device) for k in ('eager', 'compiled', 'graph')}
    opts = {k: adamw(m.parameters(), 3e-4) for k, m in models.items()}
    modes = dict(eager={}, compiled=dict(compiled=True), graph=dict(compiled=True, mode='reduce-overhead'))
    steps = {k: train_step(m, opts[k], autoencoder.loss_from_outputs, 10.0, **modes[k]) for k, m in models.items()}
    data = tdata.image_batches(batch_size=256, seed=1234)
    batches = [torch.from_numpy(next(data)).to(device) for _ in range(COMPILED_STEPS)]
    return dict(models=models, opts=opts, steps=steps, batches=batches,
                fns={k: (lambda f=f: f(batches[0])) for k, f in steps.items()})


def subject_drawing_example(name):
    """The eager and compiled steps of an example that draws, each on a
    model of its own from main(train_iter=0), on one batch of 256."""
    def subject(device):
        import contextlib
        import io
        from vqtpu_torch.examples.common import adamw, train_step
        from vqtpu_torch.models import data as tdata

        mod = importlib.import_module(f'vqtpu_torch.examples.{name}')
        with contextlib.redirect_stdout(io.StringIO()):
            models = {k: mod.main(train_iter=0, device=device) for k in ('eager', 'compiled')}
        steps = {k: train_step(m, adamw(m.parameters(), 3e-4), mod.loss_from_outputs, 10.0, compiled=k == 'compiled')
                 for k, m in models.items()}
        xb = torch.from_numpy(next(tdata.image_batches(batch_size=256, seed=4321))).to(device)
        return dict(fns={k: (lambda f=f: f(xb)) for k, f in steps.items()})
    return subject


PROFILE_SUBJECTS = dict(vq_eval=subject_vq_eval, vq_on_step=subject_vq_on_step, lfq_on_step=subject_lfq_on_step,
                        rfsq_eval=subject_rfsq_eval, entry_forward=subject_entry_forward,
                        vq_example_step=subject_vq_example_step,
                        **{f'{name}_step': subject_drawing_example(name) for name in DRAWING_EXAMPLES})


def profile_main(args) -> int:
    """`--profile NAME MODE...`: build the compiled path NAME of
    PROFILE_SUBJECTS, call each of its modes 3 times (compile, warm-up and
    capture), and print one JSON line: the trace of one compiled call and
    the idle share of 5 calls of each MODE."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    use_build_caches()
    name, modes = args[0], args[1:]
    fns = PROFILE_SUBJECTS[name](torch.device('cuda'))['fns']
    for f in fns.values():
        for _ in range(3):
            f()
    torch.cuda.synchronize()
    print(json.dumps(dict(trace=compiled_trace(fns['compiled'], windows=4),
                          idle={k: warm_idle_share(fns[k], windows=4) for k in modes})), flush=True)
    return 0


def check_no_cudagraph_skip(name):
    from torch._dynamo.utils import counters
    skips = dict(counters['inductor']).get('cudagraph_skips', 0)
    check(skips == 0, f'{name}: inductor skipped the CUDA graph ({skips} skips)')


def compiled_entry(device, smi):
    """The entry forward: eager, inductor and CUDA graphs from the same state."""
    from vqtpu_torch.entry import build_flagship
    from vqtpu_torch.kernels.distance import selection_bias, selection_disagreements

    s = subject_entry_forward(device)
    fns, state, x = s['fns'], s['state'], s['x']
    eager_out = fns['eager']()
    compile_s = first_calls_s(fns['compiled'])
    graph_s = first_calls_s(fns['graph'], 3)
    check_no_cudagraph_skip('entry forward')
    model = build_flagship(device=device)
    model.load_state_dict(state)
    with torch.no_grad():
        z = model.encoder(x).reshape(-1, 32)
    embed = state['quantizer._codebook.embed'][0]
    bias = selection_bias(embed, 'euclidean')
    errs = {}
    for mode in ('compiled', 'graph'):
        recon, idx, loss = (t.detach().clone() for t in fns[mode]())
        ties = selection_disagreements(z, embed, bias, idx.reshape(-1), eager_out[1].reshape(-1))
        check(ties['non_tie'] == 0, f'entry {mode}: indices beyond near-ties {ties}')
        same = (idx == eager_out[1]).all(-1)
        errs[mode] = dict(recon=rel_err(recon[same], eager_out[0].detach()[same]) if same.any() else 0.0,
                          commit_loss=rel_err(loss, eager_out[2].detach()), images_agreeing=int(same.sum()), **ties)
        check(errs[mode]['recon'] <= COMPILED_REL and errs[mode]['commit_loss'] <= COMPILED_REL,
              f'entry {mode} against eager {errs[mode]}')
    prof = profile_path('entry_forward', fns, tuple(fns))
    check_trace('entry forward', prof['trace'], K4_SYMBOLS, dict(train_fused=1))
    return dict(compile_s=compile_s, graph_first_3_calls_s=graph_s, vs_eager=errs, **prof, **mode_times(fns),
                nvidia_smi=smi)


def codebook_vs_eager(got: dict, want: dict, idx_got, idx_want) -> tuple[dict, int]:
    """Each float buffer of a codebook's state after one step against
    eager's after the same step from the same state, as its largest
    relative error over the codes that no token picked differently (a
    near-tie that flips moves two codes by a whole token), and the number
    of tokens that flipped."""
    flipped = (idx_got != idx_want).reshape(-1)
    touched = torch.cat([idx_got.reshape(-1)[flipped], idx_want.reshape(-1)[flipped]]).long().unique()
    out = {}
    for name, w in want.items():
        if not w.is_floating_point():
            continue
        g = got[name]
        if w.ndim >= 2 and touched.numel():
            keep = torch.ones(w.shape[1], dtype=torch.bool, device=w.device)
            keep[touched] = False
            g, w = g[:, keep], w[:, keep]
        out[name] = rel_err(g, w)
    return out, int(flipped.sum())


def sync_to(model, opt, ref_model, ref_opt) -> None:
    """`model` and `opt` take `ref_model`'s and `ref_opt`'s state in place
    (the tensors a compiled step or a CUDA graph holds stay the same)."""
    model.load_state_dict(ref_model.state_dict())
    for p, q in zip(model.parameters(), ref_model.parameters()):
        for name, t in opt.state[p].items():
            t.copy_(ref_opt.state[q][name])


def compiled_vq_example(device, smi):
    """The VQ example's step (examples/common.py::train_step): forward, its
    gradients and the AdamW update in one graph; eager, inductor and CUDA
    graphs, each step from eager's state on the same batch, 3 steps."""
    from vqtpu_torch.kernels.distance import selection_bias, selection_disagreements

    s_ = subject_vq_example_step(device)
    models, opts, steps = s_['models'], s_['opts'], s_['steps']
    first_s, errs = {}, {k: [] for k in ('compiled', 'graph')}
    for s, xb in enumerate(s_['batches']):
        ref = models['eager']
        for k in ('compiled', 'graph'):
            sync_to(models[k], opts[k], ref, opts['eager'])
        with torch.no_grad():
            z = ref.encoder(xb).reshape(-1, 32)
        embed = ref.quantizer._codebook.embed[0].clone()
        params = [p.detach().clone() for p in ref.parameters()]
        want = [t.clone() for t in steps['eager'](xb)]
        for k in ('compiled', 'graph'):
            t0 = time.perf_counter()
            got = [t.clone() for t in steps[k](xb)]
            sync(device)
            if s == 0:
                first_s[k] = time.perf_counter() - t0
            ties = selection_disagreements(z, embed, selection_bias(embed, 'euclidean'), got[2].reshape(-1),
                                           want[2].reshape(-1))
            check(ties['non_tie'] == 0, f'VQ example step {s} {k}: indices beyond near-ties {ties}')
            cb, flips = codebook_vs_eager(models[k].quantizer._codebook.state_dict(),
                                          ref.quantizer._codebook.state_dict(), got[2], want[2])
            # a parameter moves by at most about lr a step; one whose
            # gradient is 0 up to rounding may move the other way
            moved = max(float((p - q).detach().abs().max()) for p, q in zip(models[k].parameters(), ref.parameters()))
            e = dict(rec=rel_err(got[0], want[0]), aux=rel_err(got[1], want[1]), codebook=cb, flips=flips,
                     params_max_abs_err=moved,
                     params_max_move=max(float((p - q).detach().abs().max()) for p, q in zip(ref.parameters(), params)))
            check(e['rec'] <= COMPILED_REL and e['aux'] <= COMPILED_REL and max(cb.values()) <= COMPILED_REL
                  and moved <= 2 * 3e-4, f'VQ example step {s} {k} {e}')
            errs[k].append(e)
    check_no_cudagraph_skip('VQ example step')
    fns = s_['fns']
    prof = profile_path('vq_example_step', fns, tuple(fns))
    check_trace('VQ example step', prof['trace'], K4_SYMBOLS, dict(train_fused=1))
    return dict(first_call_s=first_s, steps_vs_eager=errs, **prof, **mode_times(fns), nvidia_smi=smi)


# -- the examples that draw (RQ-VAE, HQ, FVQ, FSP): their steps compiled whole --------

# the kernels one compiled step of each launches once its codebooks are
# initialized, and their symbols in its trace: eager's (EXAMPLE_STEP_LAUNCHES)
# but for FVQ, whose inner step's forward selects from the same codebook for
# the same tokens as the outer forward: the compiled graph calls the pure op
# once for both (K1 2, where the eager step launches it 3 times)
COMPILED_RUN_LAUNCHES = dict(autoencoder_fvq=dict(nearest_code=2, code_sums=2))
DRAWING_COMPILED_LAUNCHES = dict(EXAMPLE_STEP_LAUNCHES, **COMPILED_RUN_LAUNCHES)
DRAWING_SYMBOLS = dict(autoencoder_rvq={}, autoencoder_hq=dict(select=4, sorted_stats=4),
                       autoencoder_fvq=dict(select=2, sorted_stats=2), autoencoder_fsp={})
_EXAMPLE_RUNS = {}


# the eight examples' steps, which main() compiles on the card, compiled
# first in four fresh processes (two each, the costlier first; HQ and the
# RQ-VAE compile twice, before and after kmeans init, so each takes one of
# the cheapest) while this one runs the kernel phases: inductor's caches
# under build/ then hand this process the compiled graphs (Dynamo still
# traces each)
PRECOMPILE_GROUPS = (('autoencoder_hq', 'autoencoder_sim_vq'), ('autoencoder_rvq', 'autoencoder_fsq'),
                     ('autoencoder_fvq', 'autoencoder_lfq'), ('autoencoder', 'autoencoder_fsp'))


def set_backends() -> None:
    """TF32 off and cuDNN deterministic, in every process of the script."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the flagships' convolutions: one algorithm in every run, no benchmark search
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def precompile_main(names) -> int:
    """`--precompile NAME...`: compile each example's step as its `main()`
    compiles it on the card (the model at batch 256, AdamW,
    `train_step(compiled=True)`, two calls on the first batch of
    `image_batches(256, seed=1234)`: a kmeans codebook's step compiles
    again once init has run) and print one JSON line of seconds."""
    import contextlib
    import io
    from vqtpu_torch.examples.common import adamw, train_step
    from vqtpu_torch.models import data as tdata

    set_backends()
    use_build_caches()
    out = {}
    x = torch.from_numpy(next(tdata.image_batches(batch_size=256, seed=1234))).cuda()
    for name in names:
        mod = importlib.import_module(f'vqtpu_torch.examples.{name}')
        with contextlib.redirect_stdout(io.StringIO()):
            model = mod.main(train_iter=0, device='cuda')
        step = train_step(model, adamw(model.parameters(), 3e-4), mod.loss_from_outputs, 10.0, compiled=True)
        t0 = time.perf_counter()
        step(x)
        step(x)
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
    print(json.dumps(dict(precompile_s=out)), flush=True)
    return 0


def start_precompile() -> list:
    """One process a group of PRECOMPILE_GROUPS, stopped by join_precompile
    or, should the script end first, at its exit."""
    import atexit
    here = os.path.dirname(os.path.abspath(__file__))
    # two compile workers each (not part of inductor's cache key), at a
    # lower priority: the phases of this process run meanwhile
    env = dict(os.environ, TORCHINDUCTOR_COMPILE_THREADS='2')
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), '--precompile', *names], cwd=here,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                              preexec_fn=lambda: os.nice(10))
             for names in PRECOMPILE_GROUPS]
    atexit.register(stop_processes, procs)
    return procs


def stop_processes(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def join_precompile(procs) -> dict:
    """Wait for the precompile processes (900 s at most, then kill them);
    their seconds, and the seconds this process waited."""
    t0 = time.perf_counter()
    out = {}
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=max(1.0, 900 - (time.perf_counter() - t0)))
            check(p.returncode == 0, f'a precompile process failed ({p.returncode}):\n{stdout[-2000:]}\n'
                                     f'{stderr[-3000:]}')
            out.update(json.loads(stdout.strip().splitlines()[-1])['precompile_s'])
    finally:
        stop_processes(procs)
    emit('precompile', seconds=out, waited_s=time.perf_counter() - t0)
    return out


def example_run(name, device) -> dict:
    """`main(train_iter=EXAMPLE_STEPS[name])` of an example on the card, once
    a process (so its step, which `train_loop` compiles on the card, compiles
    once: compiled_path and examples_path share the run). Returns the
    trained model, its printed log, the run's seconds and launches, and the
    step `train_loop` made (`examples/common.py::train_step`, captured) with
    its model and optimizer and the seconds of its first call (the
    compile)."""
    if name in _EXAMPLE_RUNS:
        return _EXAMPLE_RUNS[name]
    import contextlib
    import io
    from vqtpu_torch.examples import common

    mod = importlib.import_module(f'vqtpu_torch.examples.{name}')
    made = {}
    real = common.train_step

    def recording(model, opt, loss_from_outputs, alpha, **kw):
        step = real(model, opt, loss_from_outputs, alpha, **kw)

        def first_timed(x):
            if 'first_call_s' in made:
                return step(x)
            sync(device)
            t0 = time.perf_counter()
            out = step(x)
            sync(device)
            made['first_call_s'] = time.perf_counter() - t0
            return out
        made.update(model=model, opt=opt, step=step, compiled=kw.get('compiled', False))
        return first_timed
    log = io.StringIO()
    reset_all_launches()
    t0 = time.perf_counter()
    common.train_step = recording
    try:
        with contextlib.redirect_stdout(log):
            model = mod.main(train_iter=EXAMPLE_STEPS[name], device=device)
    finally:
        common.train_step = real
    sync(device)
    check(made.get('model') is model and made['compiled'], f'{name}: main() trained through a compiled step')
    _EXAMPLE_RUNS[name] = dict(made, mod=mod, log=log.getvalue(), run_s=time.perf_counter() - t0,
                               run_launches=launches_delta({k: 0 for k in all_launches()}, all_launches()))
    return _EXAMPLE_RUNS[name]


def codebook_modules(model) -> dict:
    from vqtpu_torch.codebook.codebook import Codebook
    return {n: m for n, m in model.named_modules() if isinstance(m, Codebook)}


def stochastic_disagreements(records, idx_a, idx_b, rel=1e-5) -> dict:
    """The RQ-VAE's gumbel-perturbed picks of two runs (idx_a, idx_b: (...,
    q) over q layers) judged in float64 against the records of run a's q
    calls of the codebook's distance path (its tokens, codebook,
    temperature and gumbel noise, `record_distance_path`). A token is
    judged at its first layer that differs (the later layers take another
    residual): both picks' scores -|x - e| / t + g again in float64, a
    near-tie when they differ by at most `rel` times the f32 rounding's
    scale, (|x|^2 + |e|^2) / (2 |x - e| t) + |score| for each pick (the
    distance from an f32 squared distance). Counts as selection_disagreements."""
    q = len(records)
    a, b = idx_a.reshape(-1, q).long(), idx_b.reshape(-1, q).long()
    differ = a != b
    tokens = differ.any(1)
    first = differ.int().argmax(1)
    out = {'tokens': int(a.shape[0]), 'disagree': int(tokens.sum()), 'non_tie': 0, 'max_score_gap': 0.0}
    for layer, r in enumerate(records):
        at = (tokens & (first == layer)).nonzero().reshape(-1)
        if at.numel() == 0:
            continue
        x = r['tokens'].reshape(-1, r['tokens'].shape[-1])[at].double()
        embed = r['embed'].reshape(-1, x.shape[-1]).double()
        noise = r['noise'].reshape(-1, embed.shape[0])[at].double()
        scores = []
        for pick in (a[at, layer], b[at, layer]):
            e = embed[pick]
            dist = (x - e).norm(dim=-1)
            score = -dist / r['temperature'] + noise.gather(1, pick[:, None])[:, 0]
            scale = ((x * x).sum(-1) + (e * e).sum(-1)) / (2 * dist.clamp_min(1e-6) * r['temperature']) + score.abs()
            scores.append((score, scale))
        gap = (scores[0][0] - scores[1][0]).abs()
        out['non_tie'] += int((gap > rel * (scores[0][1] + scores[1][1])).sum())
        out['max_score_gap'] = max(out['max_score_gap'], float(gap.max()))
    return out


def record_distance_path(codebook, records: list) -> None:
    """Record each call of `codebook`'s distance path: its tokens, codebook
    and temperature, and the gumbel noise it draws (drawn again from a copy
    of its stream's state, as `core.sampling.gumbel_sample` draws it)."""
    from vqtpu_torch.core.sampling import RandomStream, gumbel_noise
    real = codebook._distance_select

    def recording(tokens, embed, temperature, topk, codebook_transform_fn):
        stream = RandomStream(codebook.generator.get_state().clone())
        records.append(dict(tokens=tokens.detach().clone(), embed=embed.detach().clone(), temperature=temperature,
                            noise=gumbel_noise(stream, (*tokens.shape[:-1], embed.shape[-2]), device=tokens.device)))
        return real(tokens, embed, temperature, topk, codebook_transform_fn)
    codebook._distance_select = recording


def bin_edge_disagreements(act, levels, idx_a, idx_b, rel=FSP_EDGE_REL) -> dict:
    """FSP's indices of two runs judged against run a's activations (N,
    len(levels)) in [0, 1]: a token that differs is a near-tie when every
    dimension whose level differs has its activation within `rel` of a bin
    edge k / level. Counts as selection_disagreements."""
    lv = torch.tensor(levels, dtype=torch.float64, device=act.device)
    basis = torch.cumprod(torch.cat([lv.new_ones(1), lv[:-1]]), 0).long()
    a, b = idx_a.reshape(-1).long(), idx_b.reshape(-1).long()
    at = (a != b).nonzero().reshape(-1)
    out = {'tokens': int(a.numel()), 'disagree': int(at.numel()), 'non_tie': 0, 'max_score_gap': 0.0}
    if at.numel() == 0:
        return out
    level_a = (a[at, None] // basis) % lv.long()
    level_b = (b[at, None] // basis) % lv.long()
    u = act.reshape(-1, len(levels))[at].double() * lv
    edge = (u - u.round()).abs() / lv
    worst = torch.where(level_a != level_b, edge, 0.0).amax(-1)
    out['non_tie'] = int((worst > rel).sum())
    out['max_score_gap'] = float(worst.max())
    return out


# -- replaying an eager step with a compiled step's picks (the drawing examples) -------


def _forced_selection(x, embed, bias, own, forced, judged):
    """`forced` in place of the selection `own` of (h?, n, d) tokens
    against (h?, c, d) codes: the picks, and the verdict on the picks that
    differ, scored again in float64 on these operands (a near-tie or not),
    appended to `judged`."""
    from vqtpu_torch.kernels.distance import selection_disagreements
    forced = forced.reshape(own.shape).to(own.dtype)
    x3, e3 = (t if t.ndim == 3 else t[None] for t in (x, embed))
    b3 = bias if bias.ndim == 2 else bias[None]
    own3, forced3 = own.reshape(x3.shape[:2]), forced.reshape(x3.shape[:2])
    for i in range(x3.shape[0]):
        judged.append(selection_disagreements(x3[i], e3[i], b3[i], own3[i], forced3[i]))
    return forced


def _picked_rows_and_scores(x, embed, bias, idx, like):
    """What a selection returns beside its indices, for the picks `idx`:
    for each tensor of `like` (its own extra outputs), the codebook rows
    (exact) where it has the rows' shape, else the score x.e + bias in
    f32."""
    from vqtpu_torch.kernels.distance import gather_codes_per_head
    x3, e3 = (t if t.ndim == 3 else t[None] for t in (x, embed))
    b3 = bias if bias.ndim == 2 else bias[None]
    i3 = idx.reshape(x3.shape[:2])
    rows = gather_codes_per_head(e3, i3)
    out = []
    for t in like:
        if t.ndim == idx.ndim + 1:
            out.append(rows.reshape(t.shape))
        else:
            out.append(((x3 * rows).sum(-1) + b3.gather(1, i3.long())).reshape(t.shape))
    return out


@contextmanager
def selection_tape(device_type, record=None, force=None):
    """Within: each launch of the selection kernels (K1 and K4 on the card;
    on the CPU their plain versions, which the ops run there) appends its
    indices to `record`; or, with `force` (index tensors, one a launch, in
    launch order), returns the next of them in place of its own picks,
    with the rows, scores and statistics of those picks (K4's statistics by
    its statistics passes alone, `code_sums`; on the CPU
    `code_statistics_plain`). The manager's value is a list that gets the
    float64 verdict (`selection_disagreements` on the launch's own
    operands) on every forced launch's changed picks."""
    from vqtpu_torch.kernels import distance, train_fused
    verdicts, queue, depth = [], None if force is None else list(force), [0]

    def take(x, embed, bias, own):
        if queue is None:
            record.append(own.detach().clone())
            return own
        if not queue:
            raise AssertionError('a selection launched beyond the picks given to force')
        return _forced_selection(x, embed, bias, own, queue.pop(0), verdicts)

    def k1(real):
        def run(x, embed, bias, *args, **kwargs):
            if depth[0]:                       # the plain version's call for each head
                return real(x, embed, bias, *args, **kwargs)
            depth[0] += 1
            try:
                out = real(x, embed, bias, *args, **kwargs)
            finally:
                depth[0] -= 1
            parts = out if isinstance(out, tuple) else (out,)
            idx = take(x, embed, bias, parts[0])
            if queue is not None:
                parts = (idx, *_picked_rows_and_scores(x, embed, bias, idx, parts[1:]))
            return parts if isinstance(out, tuple) else parts[0]
        return run

    def k4(real):
        def run(x, embed, bias, weights, *args, **kwargs):
            idx, q, bins, esum = real(x, embed, bias, weights, *args, **kwargs)
            idx = take(x, embed, bias, idx)
            if queue is None:
                return idx, q, bins, esum
            q, = _picked_rows_and_scores(x, embed, bias, idx, (q,))
            x3 = x if x.ndim == 3 else x[None]
            w3 = weights if weights is None or weights.ndim == 2 else weights[None]
            stats = train_fused._code_sums_cuda if x.is_cuda else train_fused.code_statistics_plain
            new_bins, new_esum = stats(x3.contiguous(), idx.reshape(x3.shape[:2]).contiguous(), embed.shape[-2], w3)
            return idx, q, new_bins.reshape(bins.shape), new_esum.reshape(esum.shape)
        return run

    if device_type == 'cuda':
        wraps = [(distance, '_nearest_code_cuda', k1), (train_fused, '_fused_train_cuda', k4)]
    else:
        wraps = [(distance, 'nearest_code_plain', k1), (train_fused, 'fused_train_quantize_plain', k4)]
    reals = [(module, name, getattr(module, name)) for module, name, _ in wraps]
    for module, name, wrap in wraps:
        setattr(module, name, wrap(getattr(module, name)))
    try:
        yield verdicts
    finally:
        for module, name, real in reals:
            setattr(module, name, real)
    if queue:
        raise AssertionError(f'{len(queue)} forced picks were left unused')


# the compiled step's selection whose picks each of the eager step's K1 and
# K4 launches takes in a replay (by default the launch of the same rank):
# FVQ's inner step selects from the same codebook for the same tokens as its
# outer forward, one call of the pure op in the compiled graph
EAGER_PICKS_FROM = dict(autoencoder_fvq=(0, 0, 1))


def twin_state(model, opt):
    """A copy of `model`'s state and of its optimizer's (the eager twin's,
    before a step, for its replay)."""
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            [{k: v.clone() for k, v in opt.state[p].items()} for p in model.parameters()])


def restore_twin(model, opt, saved) -> None:
    """`model` and `opt` as `twin_state` saw them (load_state_dict: the
    eager twin reads its restored `initted` again)."""
    model.load_state_dict(saved[0])
    for p, state in zip(model.parameters(), saved[1]):
        for k, v in state.items():
            opt.state[p][k].copy_(v)


@contextmanager
def compiled_picks(name, twin, indices, launched, device):
    """Within: the eager twin of drawing example `name` picks what the
    compiled step picked, so that a step replayed from the same state
    follows the compiled step's discrete choices and differs from it by
    rounding only. HQ and FVQ: each K4 and K1 launch takes the picks of
    the compiled step's launch EAGER_PICKS_FROM names (`launched`, recorded
    by `selection_tape`), and every pick it changes is judged again in
    float64 on the replay's own operands (the manager's value gets the
    verdicts). The RQ-VAE: the distance path's sampler (each codebook's
    `gumbel_sample_fn`, layer by layer) returns layer l's column of the
    compiled step's `indices`, its straight-through one-hot rebuilt on it.
    FSP has no selection: its index is the bin of each activation
    (`quantize_act_value`'s floor), and a flip is an activation within
    FSP_EDGE_REL of a bin edge k / level that the two steps' activations,
    an ulp apart, put on either side (bin_edge_disagreements judges it);
    the replay takes the compiled step's bins."""
    from vqtpu_torch.core.sampling import one_hot_float
    if name in ('autoencoder_hq', 'autoencoder_fvq'):
        order = EAGER_PICKS_FROM.get(name, range(len(launched)))
        with selection_tape(device.type, force=[launched[k] for k in order]) as verdicts:
            yield verdicts
        return
    if name == 'autoencoder_rvq':
        columns = list(indices.reshape(-1, indices.shape[-1]).unbind(-1))
        samplers = {cb: cb.gumbel_sample_fn for cb in codebook_modules(twin).values()}

        def forced_sampler(real):
            def sample(generator, logits, *args, **kwargs):
                ind, onehot = real(generator, logits, *args, **kwargs)
                pick = columns.pop(0).reshape(ind.shape).to(ind.dtype)
                return pick, one_hot_float(pick, logits.shape[-1], onehot.dtype) + (onehot - onehot.detach())
            return sample
        for cb, real in samplers.items():
            cb.gumbel_sample_fn = forced_sampler(real)
        try:
            yield []
        finally:
            for cb, real in samplers.items():
                cb.gumbel_sample_fn = real
        check(not columns, f'{name}: the replay sampled every layer')
        return
    quantizer = twin.quantizer
    real = quantizer.quantize_act_value

    def forced_bins(act_z, eps):
        levels = quantizer._levels_arr(act_z)
        level_indices = quantizer.indices_to_level_indices(indices.reshape(act_z.shape[:-1])).to(act_z.dtype)
        return act_z + ((level_indices + 0.5) / levels - act_z).detach(), level_indices
    quantizer.quantize_act_value = forced_bins
    try:
        yield []
    finally:
        quantizer.quantize_act_value = real


def compiled_drawing_example(name, device, smi):
    """One of the examples whose step draws: `main()` trains it through its
    compiled step (example_run); then 3 steps of that compiled step, each
    from the state of an eager twin (`train_step` without compile) on the
    same batch, the kmeans codebooks reset to un-initted before step 0 so
    that kmeans init runs inside both steps (the compiled one given the
    eager one's means): the same launches, indices equal but at near-ties
    (every flip judged against what the eager step selected from: none
    beyond a near-tie), the losses within COMPILED_REL plus the flipped
    tokens' share, every codebook's buffers within COMPILED_REL, Adam's
    moments within COMPILED_MOMENTS_REL of their largest, parameters
    within 2 lr, the
    random streams' states equal; then eager and compiled ms, the compiled
    call's kernels by symbol in a profiler trace at eager's launches, and
    the idle shares."""
    from vqtpu_torch.examples.common import adamw, train_step
    from vqtpu_torch.kernels.distance import selection_bias, selection_disagreements
    from vqtpu_torch.models import data as tdata
    kmeans_module = importlib.import_module('vqtpu_torch.codebook.kmeans')

    run = example_run(name, device)
    mod, model, opt, step = run['mod'], run['model'], run['opt'], run['step']
    twin = mod.main(train_iter=0, device=device)
    twin_opt = adamw(twin.parameters(), 3e-4)
    eager = train_step(twin, twin_opt, mod.loss_from_outputs, 10.0)
    # what the eager twin selected from judges a flip a near-tie: HQ's and
    # FVQ's tokens and codebook of the selection whose indices the step
    # returns (HQ: the last scale's; FVQ: the one after the inner step, its
    # codebook through the bridge), the RQ-VAE's every layer's gumbel-
    # perturbed scores, FSP's activations against its bin edges
    seen, hooks = [], []
    if name == 'autoencoder_rvq':
        for cb in codebook_modules(twin).values():
            record_distance_path(cb, seen)
    elif name == 'autoencoder_fsp':
        real_act = twin.quantizer.quantize_act_value
        twin.quantizer.quantize_act_value = lambda act_z, eps: (seen.append(act_z.detach().clone()),
                                                                real_act(act_z, eps))[1]
    elif name == 'autoencoder_hq':
        hooks.append(twin.hq.vq.register_forward_pre_hook(lambda module, args: seen.append(
            [args[0].detach().movedim(1, -1).reshape(-1, args[0].shape[1]),
             module._codebook.embed.detach()[0].clone()])))
    elif name == 'autoencoder_fvq':
        cb = twin.quantizer._codebook
        hooks.append(cb.register_forward_pre_hook(lambda module, args: seen.append(
            [args[0].detach().reshape(-1, args[0].shape[-1]), None])))
        hooks.append(cb.vq_bridge.register_forward_hook(
            lambda module, args, out: seen[-1].__setitem__(1, out.detach()[0])))
    data = tdata.image_batches(batch_size=256, seed=4321)
    batches = [torch.from_numpy(next(data)).to(device) for _ in range(COMPILED_STEPS)]
    errs, replays = [], 0
    real_kmeans = kmeans_module.kmeans
    for s, xb in enumerate(batches):
        replayed = {}
        if s == 0 and name in EXAMPLE_KMEANS:
            for cb in codebook_modules(model).values():
                if cb.kmeans_init:
                    cb.initted.fill_(False)
                    cb.initted_on_host = False

            # kmeans init in both steps, the compiled one given the eager
            # one's means: the synthetic images' identical background tokens
            # make f32 kmeans near-ties, which inputs an ulp apart break
            # differently (as tests/test_torch_examples.py notes)
            def same_kmeans(*args, **kwargs):
                if 'out' not in replayed:
                    replayed['out'] = real_kmeans(*args, **kwargs)
                replayed['calls'] = replayed.get('calls', 0) + 1
                return tuple(t.clone() for t in replayed['out'])
            kmeans_module.kmeans = same_kmeans
        sync_to(twin, twin_opt, model, opt)
        saved = twin_state(twin, twin_opt)
        params = [p.detach().clone() for p in twin.parameters()]
        launched = []
        try:
            reset_all_launches()
            want = [t.clone() for t in eager(xb)]
            sync(device)
            eager_launches = {k: v for k, v in all_launches().items() if v}
            reset_all_launches()
            with selection_tape(device.type, record=launched):
                got = [t.clone() for t in step(xb)]
            sync(device)
            launches = {k: v for k, v in all_launches().items() if v}
            kmeans_calls = replayed.get('calls', 0)
            flips = int((got[2] != want[2]).sum())
            if name == 'autoencoder_rvq':
                ties = stochastic_disagreements(seen, want[2], got[2])
            elif name == 'autoencoder_fsp':
                ties = bin_edge_disagreements(seen[-1], twin.quantizer.levels, want[2], got[2])
            else:
                tokens, embed = seen[-1]
                ties = selection_disagreements(tokens, embed, selection_bias(embed, 'euclidean'),
                                               want[2].reshape(-1), got[2].reshape(-1))
            check(ties['non_tie'] == 0, f'{name} step {s}: {flips} indices differ from eager beyond near-ties '
                                        f'({ties})')
            replay = None
            if flips:
                # a near-tie flip moves its token's whole share of every
                # gradient and statistic: the compiled step is held to the
                # eager step from the same state given its picks
                restore_twin(twin, twin_opt, saved)
                with compiled_picks(name, twin, got[2], launched, device) as verdicts:
                    want = [t.clone() for t in eager(xb)]
                sync(device)
                replay = dict(forced_non_tie=sum(v['non_tie'] for v in verdicts),
                              forced_changed=sum(v['disagree'] for v in verdicts))
                check(replay['forced_non_tie'] == 0, f'{name} step {s}: the replay changed picks beyond near-ties '
                                                     f'{verdicts}')
                check(torch.equal(want[2], got[2]), f'{name} step {s}: the replay took the compiled picks')
                replays += 1
        finally:
            kmeans_module.kmeans = real_kmeans
            seen.clear()
        expected_kmeans = 2 if s == 0 and name in EXAMPLE_KMEANS else 0
        check(kmeans_calls == expected_kmeans, f'{name} step {s}: kmeans ran {expected_kmeans // 2} time in '
                                               f'each step ({kmeans_calls} calls)')
        check(eager_launches == EXAMPLE_STEP_LAUNCHES[name] and launches == DRAWING_COMPILED_LAUNCHES[name],
              f'{name} step {s}: the compiled step launched {launches}, expected '
              f'{DRAWING_COMPILED_LAUNCHES[name]}; eager {eager_launches}, expected {EXAMPLE_STEP_LAUNCHES[name]}')
        cbs, twin_cbs = codebook_modules(model), codebook_modules(twin)
        cb_err = {}
        for key, cb in cbs.items():
            # a learnable codebook's rows are parameters, held as the others
            learnable = {n for n, _ in cb.named_parameters()}
            state = {k: v for k, v in cb.state_dict().items() if k not in learnable}
            want_state = {k: v for k, v in twin_cbs[key].state_dict().items() if k not in learnable}
            cb_err.update({f'{key}.{k}': v for k, v in codebook_vs_eager(state, want_state, got[2], want[2])[0].items()})
            check(torch.equal(state['rng_state'], want_state['rng_state']), f'{name} step {s}: {key} drew alike')
        # Adam's moments hold the gradients: each kind against the largest
        # entry of that kind over the model (a gradient 0 but for rounding,
        # such as MiniEncoder's attention key bias's, has no scale of its own)
        moments = max(
            max(float((opt.state[p][k] - twin_opt.state[q][k]).abs().max())
                for p, q in zip(model.parameters(), twin.parameters()))
            / max(float(twin_opt.state[q][k].abs().max()) for q in twin.parameters())
            for k in ('exp_avg', 'exp_avg_sq'))
        moved = max(float((p - q).detach().abs().max()) for p, q in zip(model.parameters(), twin.parameters()))
        e = dict(rec=rel_err(got[0], want[0]), aux=rel_err(got[1], want[1]), flips=flips, ties=ties,
                 replay=replay, codebook=max(cb_err.values(), default=0.0), adam_moments=moments,
                 params_max_abs_err=moved,
                 params_max_move=max(float((p - q).detach().abs().max()) for p, q in zip(twin.parameters(), params)),
                 launches=launches)
        # against eager, or against its replay with the compiled picks (the
        # same picks: the losses, codebooks and moments differ by rounding)
        check(e['rec'] <= COMPILED_REL and e['aux'] <= COMPILED_REL and e['codebook'] <= COMPILED_REL
              and moments <= COMPILED_MOMENTS_REL and moved <= 2 * 3e-4, f'{name} step {s} against eager {e}')
        errs.append(e)
    # the timed calls record nothing
    for h in hooks:
        h.remove()
    for m in twin.modules():
        m.__dict__.pop('_distance_select', None)
        m.__dict__.pop('quantize_act_value', None)
    xb = batches[0]
    fns = dict(eager=lambda: eager(xb), compiled=lambda: step(xb))
    times = mode_times(fns)
    prof = profile_path(f'{name}_step', fns, tuple(fns))
    check(prof['trace']['symbols'] == DRAWING_SYMBOLS[name] and prof['trace']['launches'] ==
          DRAWING_COMPILED_LAUNCHES[name],
          f'{name}: the compiled step ran {prof["trace"]["symbols"]} ({prof["trace"]["launches"]}), expected '
          f'{DRAWING_SYMBOLS[name]} ({DRAWING_COMPILED_LAUNCHES[name]})')
    del twin, twin_opt, eager
    return dict(compile_s=run['first_call_s'], run_steps=EXAMPLE_STEPS[name], run_s=run['run_s'],
                steps_vs_eager=errs, replayed_steps=replays, **prof, **times, nvidia_smi=smi)


def compiled_served(device, smi):
    """The served paths at their PERF.md shapes, eager against inductor:
    VectorQuantize eval (K1) and its train_fused='on' step (K4), the LFQ
    entropy_fused='on' step (K5-K8), ResidualFSQ eval (K9)."""
    from vqtpu_torch.kernels.distance import selection_bias, selection_disagreements

    out = {}
    d = MAIN[2]

    # VectorQuantize eval: one K1 with its rows
    t_part = time.perf_counter()
    s = subject_vq_eval(device)
    fns, vq, x = s['fns'], s['vq'], s['x']
    want = fns['eager']()
    first = first_calls_s(fns['compiled'])
    got = fns['compiled']()
    embed = vq._codebook.embed[0]
    ties = selection_disagreements(x.reshape(-1, d), embed, selection_bias(embed, 'euclidean'),
                                   got[1].reshape(-1), want[1].reshape(-1))
    same = got[1] == want[1]
    err = rel_err(got[0][same], want[0][same])
    check(ties['non_tie'] == 0 and err <= COMPILED_REL, f'VQ eval compiled against eager {ties} {err}')
    prof = profile_path('vq_eval', fns)
    check_trace('VQ eval', prof['trace'], K1_SYMBOLS, dict(nearest_code=1))
    out['vq_eval'] = dict(seconds=time.perf_counter() - t_part, compile_s=first, quantize_rel_err=err, **ties,
                          **prof, **mode_times(fns))
    del s, fns, vq, x, want, got

    # the train_fused='on' step, 3 times, each from eager's state
    t_part = time.perf_counter()
    s = subject_vq_on_step(device)
    vqs, x, xg, g = s['vqs'], s['x'], s['xg'], s['g']
    errs = []
    for step in range(COMPILED_STEPS):
        vqs[1].load_state_dict(vqs[0].state_dict())
        embed = vqs[0]._codebook.embed[0].clone()
        want = s['eager'](xg, g)
        t0 = time.perf_counter()
        got = s['compiled'](xg, g)
        sync(device)
        if step == 0:
            first = time.perf_counter() - t0
        ties = selection_disagreements(x.reshape(-1, d), embed, selection_bias(embed, 'euclidean'),
                                       got[1].reshape(-1), want[1].reshape(-1))
        same = (got[1] == want[1]).reshape(-1)
        cb, flips = codebook_vs_eager(vqs[1]._codebook.state_dict(), vqs[0]._codebook.state_dict(), got[1], want[1])
        e = dict(quantize=rel_err(got[0].reshape(-1, d)[same], want[0].reshape(-1, d)[same]),
                 loss=rel_err(got[2], want[2]), x_grad=rel_err(got[3].reshape(-1, d)[same], want[3].reshape(-1, d)[same]),
                 codebook=cb, flips=flips)
        check(ties['non_tie'] == 0 and max(e['quantize'], e['loss'], e['x_grad'], *cb.values()) <= COMPILED_REL,
              f'VQ on step {step} compiled against eager {e} {ties}')
        errs.append(e)
    prof = profile_path('vq_on_step', s['fns'])
    check_trace("VQ 'on' step", prof['trace'], K4_SYMBOLS, dict(train_fused=1))
    out['vq_on_step'] = dict(seconds=time.perf_counter() - t_part, compile_s=first, steps_vs_eager=errs, **prof,
                             **mode_times(s['fns']))
    del s, vqs, x, xg, g, want, got
    torch.cuda.empty_cache()

    # the LFQ entropy_fused='on' step: K5-K8 once each; x.grad to 1e-3 of
    # its largest entry, as between the entropy routes (lfq_train_path): a
    # code whose batch probability lies within rounding of the entropy's
    # eps takes the other side of its kink when inductor sums the glue in
    # another order
    t_part = time.perf_counter()
    s = subject_lfq_on_step(device)
    fns = s['fns']
    want = fns['eager']()
    first = first_calls_s(fns['compiled'])
    got = fns['compiled']()
    e = dict(quantize=rel_err(got[0], want[0]), aux=rel_err(got[2], want[2]), x_grad=rel_err(got[3], want[3]),
             indices_equal=bool(torch.equal(got[1], want[1])))
    check(e['indices_equal'] and max(e['quantize'], e['aux']) <= COMPILED_REL and e['x_grad'] <= 1e-3,
          f'LFQ on step compiled against eager {e}')
    prof = profile_path('lfq_on_step', fns)
    check_trace("LFQ 'on' step", prof['trace'], LFQ_SYMBOLS, {f'lfq_sweep_{k}': 1 for k in 'abcd'})
    out['lfq_on_step'] = dict(seconds=time.perf_counter() - t_part, compile_s=first, vs_eager=e, **prof,
                              **mode_times(fns))
    del s, fns, want, got

    # ResidualFSQ eval, eval_fused='auto': one K9
    t_part = time.perf_counter()
    fns = subject_rfsq_eval(device)['fns']
    want = fns['eager']()
    first = first_calls_s(fns['compiled'])
    got = fns['compiled']()
    e = dict(quantize_bit_equal=bool(torch.equal(got[0], want[0])), indices_equal=bool(torch.equal(got[1], want[1])),
             quantize_rel_err=rel_err(got[0], want[0]))
    check(e['indices_equal'] and e['quantize_rel_err'] <= COMPILED_REL, f'ResidualFSQ eval compiled {e}')
    prof = profile_path('rfsq_eval', fns)
    check_trace('ResidualFSQ eval', prof['trace'], K9_SYMBOLS, dict(residual_fsq_fused=1))
    out['rfsq_eval'] = dict(seconds=time.perf_counter() - t_part, compile_s=first, vs_eager=e, **prof,
                            **mode_times(fns))
    del fns, want, got
    torch.cuda.empty_cache()
    return out


def compiled_launches(compiled: dict, kernel: str) -> dict:
    """{compiled path: the kernel's launches in one compiled call}."""
    return {path: r['trace']['launches'].get(kernel, 0) for path, r in compiled.items()}


def phase_compiled_path(device, smi):
    """compiled_path: each compiled path fullgraph under inductor, held to
    its eager call from the same state, its kernels in a profiler trace by
    symbol at eager's launches, and its compile s, ms and idle share beside
    eager's; the entry forward and the VQ example step also as CUDA graphs
    (mode='reduce-overhead')."""
    t0 = time.perf_counter()
    torch._dynamo.reset()
    from torch._dynamo.utils import counters
    counters.clear()
    out = compiled_served(device, smi)
    t1 = time.perf_counter()
    out['entry_forward'] = compiled_entry(device, smi)
    out['entry_forward']['seconds'] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out['vq_example_step'] = compiled_vq_example(device, smi)
    out['vq_example_step']['seconds'] = time.perf_counter() - t1
    for name in DRAWING_EXAMPLES:
        t1 = time.perf_counter()
        out[f'{name}_step'] = compiled_drawing_example(name, device, smi)
        out[f'{name}_step']['seconds'] = time.perf_counter() - t1
        emit('compiled_example', name=name, **out[f'{name}_step'])
    seconds = time.perf_counter() - t0
    emit('compiled_path', seconds=seconds, torch=torch.__version__, nvidia_smi=smi, **out)
    torch._dynamo.reset()
    torch.cuda.empty_cache()
    return out


def use_build_caches() -> None:
    """inductor's and Triton's compile caches under the checkout's build/
    directory (git-ignored), unless the caller set them."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build')
    os.environ.setdefault('TORCHINDUCTOR_CACHE_DIR', os.path.join(build, 'torchinductor'))
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(build, 'triton'))


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script needs one', file=sys.stderr)
        return 1
    import vqtpu_torch  # noqa: F401  -- fails before any output outside a checkout
    set_backends()
    device = torch.device('cuda')
    use_build_caches()
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
        'qinco_tokens': (1024, 64, 64),
        'simvq_main': SIMVQ_MAIN,
        'rsimvq_main': RSIMVQ_MAIN,
        'rpq_main': RPQ_MAIN,
    }

    # the examples' compiles first trace and generate code, which needs no
    # kernel library: they start beside the build (a step that runs before
    # the build is done builds what it needs, into the same atomic files)
    precompiling = start_precompile()
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
    simvq_launches, simvq_ms = phase_simvq_path(device, sizes)
    rsimvq_launches, rsimvq_ms = phase_rsimvq_path(device, sizes)
    rpq_launches, rpq_ms = phase_rpq_path(device, sizes)
    hq_launches, hq_ms = phase_hq_path(device, sizes)
    zoo = phase_zoo_path(device, sizes)
    # the in-process phases that time or trace on the card, alone on it
    tp_sel = phase_tp_select(device)
    phase_native_data(smi)
    phase_native_oracle(device, smi)
    entry_out = entry_forward_on_card()
    # the phases that only wait on rank processes of their own (DP, TP,
    # group parallel, the dryruns, the two distributed examples), BESIDE at
    # a time in threads (the longest first), beside dtype_path (bf16 and
    # fp16 inputs on each kernel route, and the cores under autocast; no
    # timing) and the precompile processes; all end before the phases that
    # time again
    torch.cuda.empty_cache()
    with concurrent.futures.ThreadPoolExecutor(BESIDE) as pool:
        # the longest first, by their seconds in the whole script (the TP
        # pair, group parallelism with its five graphs, dp_compiled, the
        # distributed examples, dp_nccl1, which compiles two graphs, then
        # the dryruns and DP phases); tp_vq_eval restores the checkpoint
        # tp_vq_train saves: one task
        beside = {name: pool.submit(fn) for name, fn in (
            ('tp', lambda: (phase_tp_vq_train(), phase_tp_vq_eval())), ('gp', phase_gp_grouped),
            ('dp_compiled', phase_dp_compiled), ('examples_distributed', examples_distributed),
            ('dp_nccl1', phase_dp_nccl1), ('dryrun_gloo4', functools.partial(timed_dryrun, 'gloo4')),
            ('dp_vq', phase_dp_vq_train), ('dryrun_nccl', functools.partial(timed_dryrun, 'nccl')),
            ('dp_lfq', phase_dp_lfq_train), ('dryrun_gloo4_cpu', functools.partial(timed_dryrun, 'gloo4_cpu')))}
        dtype_low, dtype_casts = phase_dtype_path(device, sizes)
        done = {name: f.result() for name, f in beside.items()}
    (tp_train, tp_eval), dp_vq, dp_lfq, gp = (done[k] for k in ('tp', 'dp_vq', 'dp_lfq', 'gp'))
    phase_utils(dp_vq, times['vq_forward_ms'])
    entry_out, dryruns = phase_entry_dryrun(entry_out, {k: done[f'dryrun_{k}'] for k in DRYRUNS}, smi)
    # the compiled step (every kernel a torch.ops.vqtpu op inside one
    # graph), once the precompile processes have filled the caches; a path
    # whose profiler windows keep losing events is profiled in a fresh
    # process (`--profile`)
    join_precompile(precompiling)
    phase_stream(device)
    compiled = phase_compiled_path(device, smi)
    # the example trainers (those compiled_path ran are not run again)
    examples, ex_tp, ex_gp = phase_examples_path(device, smi, done['examples_distributed'])
    tp_train_launches = [[r['steps'][i]['compiled_launches'] for r in tp_train]
                         for i in range(len(tp_train[0]['steps']))]
    dp_vq_launches = {f"{st['route']}_step_{st['step']}": [r['steps'][i]['launches'] for r in dp_vq]
                      for i, st in enumerate(dp_vq[0]['steps'])}
    dp_compiled_launches = {f"{st['route']}_step_{st['step']}": [r['steps'][i]['compiled_launches']
                                                                 for r in done['dp_compiled']]
                            for i, st in enumerate(done['dp_compiled'][0]['steps'])}
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
        'launches_simvq_eval': simvq_launches['eval']['nearest_code'],
        'launches_simvq_step': simvq_launches['step']['nearest_code'],
        'launches_simvq_autoencoder_step': simvq_launches['ae_step']['nearest_code'],
        'launches_rsimvq_eval': rsimvq_launches['eval']['nearest_code'],
        'launches_rsimvq_step': rsimvq_launches['step']['nearest_code'],
        'launches_rpq_forward': rpq_launches['nearest_code'],
        'launches_hq_eval': hq_launches['eval']['nearest_code'],
        'launches_sequential_simvq_step': zoo['sequential_step0']['launches']['nearest_code'],
        'launches_dp_vq_off_step_per_rank': [[x['nearest_code'] for x in v] for k, v in dp_vq_launches.items()
                                             if k.startswith('off')][0],
        'launches_dp_compiled_off_step_per_rank': [[x['nearest_code'] for x in v]
                                                   for k, v in dp_compiled_launches.items() if k.startswith('off')][0],
        'launches_tp_select_blocks': tp_sel['launches'],
        'launches_tp_vq_train_per_step_per_rank': [[x['nearest_code'] for x in st] for st in tp_train_launches],
        'launches_tp_vq_eval_per_rank': [r['launches'] for r in tp_eval],
        'launches_tp_vq_eval_compiled_per_rank': [r['compiled_launches'] for r in tp_eval],
        'launches_gp_grouped_rvq_eval_per_rank': [r['vq_eval_launches']['nearest_code'] for r in gp],
        'launches_gp_grouped_rvq_eval_compiled_per_rank': [r['vq_eval_compiled_launches']['nearest_code'] for r in gp],
        'launches_example_step': example_launches(examples, 'launches_step', 'nearest_code'),
        'launches_example_eval': example_launches(examples, 'launches_eval', 'nearest_code'),
        'launches_example_tp_large_codebook_per_rank': [r['launches']['nearest_code'] for r in ex_tp],
        'launches_example_group_parallel_grvq_per_rank': [r['launches']['nearest_code'] for r in ex_gp],
        'launches_dryrun_per_rank': {k: dryrun_launches(v, 'nearest_code') for k, v in dryruns.items()},
        'launches_dtype_path': dtype_launches(dtype_low, dtype_casts, 'nearest_code'),
        'launches_compiled_path': compiled_launches(compiled, 'nearest_code'),
        'tp_select_ms': dict(k1=tp_sel['k1_ms'], k1_return_best=tp_sel['k1_return_best_ms'],
                             sharded_world1=tp_sel['sharded_world1_ms'],
                             of=f'n, c, d = {list(TP_SELECT)}; sharded_world1 on a one-rank gloo group'),
        'rpq_k1_ms': rpq_ms['k1_ms'],
        'rpq_k1_bound_ms': rpq_ms['k1_bound_ms'],
        'rpq_k1_of': '16 heads of 8192 tokens, d = 4096, c = 1024, cosine',
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
        'launches_hq_step': hq_launches['step']['train_fused'],
        'launches_dp_vq_step_per_rank': {k: [r['train_fused'] for r in v] for k, v in dp_vq_launches.items()
                                         if k.startswith('on')},
        'launches_dp_compiled_step_per_rank': {k: [r['train_fused'] for r in v]
                                               for k, v in dp_compiled_launches.items() if k.startswith('on')},
        'launches_gp_grouped_rvq_on_step_per_rank': [r['vq_train_launches']['train_fused'] for r in gp],
        'launches_gp_grouped_rvq_on_step_compiled_per_rank': [r['vq_train_compiled_launches']['train_fused']
                                                              for r in gp],
        'launches_gp_grouped_rvq_kept_step_compiled_per_rank': [r['vq_kept_launches']['train_fused'] for r in gp],
        'launches_example_step': example_launches(examples, 'launches_step', 'train_fused'),
        'launches_example_group_parallel_grvq_per_rank': [r['launches']['train_fused'] for r in ex_gp],
        'launches_entry_forward': entry_out['launches_per_call'][0]['train_fused'],
        'launches_dryrun_per_rank': {k: dryrun_launches(v, 'train_fused') for k, v in dryruns.items()},
        'launches_dtype_path': dtype_launches(dtype_low, dtype_casts, 'train_fused'),
        'launches_compiled_path': compiled_launches(compiled, 'train_fused'),
        'entry_forward_ms': entry_out['forward_ms'],
        'entry_forward_of': 'vqtpu_torch.entry.entry() forward on (8, 28, 28, 1), CUDA events, K4 once a call',
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
        'launches_dp_lfq_step_per_rank': [{k: r['launches'][f'lfq_sweep_{k}'] for k in 'abcd'} for r in dp_lfq],
        'launches_example_lfq_step': {k: examples['autoencoder_lfq']['launches_step'].get(f'lfq_sweep_{k}', 0)
                                      for k in 'abcd'},
        'example_lfq_entropy_route': examples['autoencoder_lfq']['entropy_route'],
        'launches_dtype_path': dtype_launches(dtype_low, dtype_casts, 'lfq_sweep_a'),
        'launches_compiled_path': compiled_launches(compiled, 'lfq_sweep_a'),
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
        'launches_gp_grouped_per_rank': [r['fsq_eval_launches']['residual_fsq'] for r in gp],
        'launches_gp_grouped_compiled_per_rank': [r['fsq_eval_compiled_launches']['residual_fsq'] for r in gp],
        'launches_dtype_path': dtype_launches(dtype_low, dtype_casts, 'residual_fsq_fused'),
        'launches_compiled_path': compiled_launches(compiled, 'residual_fsq_fused'),
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
        'launches_simvq_step': simvq_launches['step']['code_sums'],
        'launches_simvq_autoencoder_step': simvq_launches['ae_step']['code_sums'],
        'launches_rsimvq_step': rsimvq_launches['step']['code_sums'],
        'launches_sequential_simvq_step': zoo['sequential_step0']['launches']['code_sums'],
        'launches_tp_vq_train_per_step_per_rank': [[x['code_sums'] for x in st] for st in tp_train_launches],
        'launches_example_step': example_launches(examples, 'launches_step', 'code_sums'),
        'launches_example_tp_large_codebook_per_rank': [r['launches']['code_sums'] for r in ex_tp],
        'launches_dryrun_per_rank': {k: dryrun_launches(v, 'code_sums') for k, v in dryruns.items()},
        'launches_compiled_path': compiled_launches(compiled, 'code_sums'),
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
                        diveq_rvq=diveq_ms, simvq=simvq_ms, rsimvq=rsimvq_ms, rpq_forward=rpq_ms['forward_ms'],
                        hq=hq_ms, fsp_autoencoder=zoo['fsp_step_ms'],
                        examples={k: v['step_ms'] for k, v in examples.items()}),
        'check': 'bins exact, sums within the f32 summation bound of float64, two calls bit-identical; the '
                 'learnable codebook gradient bit-identical across two calls and two steps',
        'power_limit': smi,
    }]}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind, 'count': count}}),
          flush=True)
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--profile']:
        sys.exit(profile_main(sys.argv[2:]))
    if sys.argv[1:2] == ['--precompile']:
        sys.exit(precompile_main(sys.argv[2:]))
    sys.exit(main())
