// The LFQ entropy statistics on Hopper (sm_90a), f32: four sweeps over the
// implicit codebook of K = 2^d codes, each code a vector of +v / -v (dim j
// of code k is +v when bit d-1-j of k is set: MSB first). For token n,
//
//   l_nk   = (x_n . c_k * -2) * -inv_temp          (the logits)
//   A:  m_n = max_k l_nk,  s_n = sum_k exp(l_nk - m_n)    -> logz = m + log s
//   B:  p_nk = exp(l_nk - logz_n)
//       ent_n = sum_k -p log max(p, eps),  avgp_k = sum_n w_n p_nk
//   C:  g_nk = entbar_n f'(p_nk) + w_n gbar_k,  f'(p) = -log max(p, eps) - [p > eps]
//       sigma_n = sum_k p g,  gdot_n = sum_k p gbar_k
//   D:  dx_n = 2 inv_temp sum_k p (g - sigma_n) c_k
//
// Replaces the Pallas TPU kernels of vqtpu/kernels/lfq_entropy.py:
// _kernel_a (A), _kernel_b (B), _kernel_c (C) and _kernel_d (D), which walk a
// (token block, code block) grid in order and carry each token's sums in
// VMEM scratch from one code block to the next.
//
// What bounds it: no tensor is read but x (n x d, d <= 24) and a few
// per-token columns, so bytes are nothing (well under 1 MB at n = 8192);
// the work is n * K (token, code) pairs, 2.1e9 at n = 8192, d = 18, each a
// d-term dot, an exp (A, D) or an exp and a log (B, C), and a few products.
// The codebook is generated, never read. (B and C need no log either, by
// the algebra sweep D uses; they keep theirs until their own redesign.)
//
// What the design does about it:
//
// 1. One thread per token, 128 tokens a block, the token's d floats in
//    registers. Every thread of a block walks the same codes at the same
//    time, so the code bits are uniform across the warp and cost no
//    divergence.
// 2. Codes go in runs of V = 2^L (L = min(d, 4)) consecutive codes, which
//    share their top d - L bits. A dot is the FMA chain over the dims in
//    order, dot = fma(x_{d-1}, c_{d-1}, ... fma(x_0, c_0, 0)); the chain's
//    prefix over the shared dims is computed once per run, and the last L
//    dims branch as a binary tree, so the 2^L dots cost about 2^(L+1) FMAs
//    and are rounded exactly as the d-FMA chain would round each of them.
// 3. n = 8192 tokens make only 64 blocks of tokens, too few for 132 SMs, so
//    K is split over the grid's second dimension (at least 8 blocks per SM
//    when K allows). Each (token block, split) block writes its per-token
//    partials to scratch, and a merge pass combines the splits in split
//    order: (m, s) pairs as m = max(m1, m2), s = s1 exp(m1 - m) + s2 exp(m2 - m);
//    ent, sigma, gdot and dx partials by addition.
// 4. avgp sums over tokens: each warp reduces its 32 tokens' w p of a run
//    with a butterfly of shuffles (16 shuffles for 16 codes), the warps'
//    sums go through shared memory and are added in warp order, and each
//    block row writes one row of partials per token group. The caller sums
//    the rows (torch.sum over them, deterministic on the card).
//
// No float atomics anywhere: two calls on the same inputs give bit-identical
// outputs, and the split plan depends on (n, d) only. Ragged n is masked in
// the kernels; no padded copies are made. Sweeps A-C use accurate expf /
// logf (the build has no fast-math flag); their logits are two rounded
// multiplies and the subtractions before exp are not contracted, as the TPU
// kernels write them. Sweep D works in base 2 on MUFU ex2 without a log (its
// note below).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;                 // tokens per block, one thread each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 24;
constexpr int kTargetBlocks = 132 * 8;        // 8 blocks per SM on an H100 SXM
constexpr int kMaxSplits = 64;
constexpr int kFlushRuns = 8;                 // runs of avgp partials per shared-memory flush
constexpr long long kMaxAvgpFloats = 1LL << 27;  // 512 MB of avgp partial rows at most

struct Plan {
  long long n;
  int d;
  int k;            // 2^d
  int token_tiles;  // blocks of kThreads tokens
  int splits;       // K splits
  int split_len;    // codes per split, a multiple of the run length
  int rows;         // sweep B: rows of avgp partials
  int tiles_per_row;
};

Plan make_plan(long long n, int d) {
  Plan p;
  p.n = n;
  p.d = d;
  p.k = 1 << d;
  p.token_tiles = static_cast<int>((n + kThreads - 1) / kThreads);
  const int run = 1 << (d < 4 ? d : 4);
  const int runs = p.k / run;
  int splits = 1;
  while (splits < runs && splits < kMaxSplits &&
         static_cast<long long>(p.token_tiles) * splits < kTargetBlocks) {
    splits *= 2;
  }
  p.splits = splits;
  p.split_len = p.k / splits;
  long long max_rows = kMaxAvgpFloats / p.k;
  if (max_rows < 1) max_rows = 1;
  p.tiles_per_row = static_cast<int>((p.token_tiles + max_rows - 1) / max_rows);
  p.rows = (p.token_tiles + p.tiles_per_row - 1) / p.tiles_per_row;
  return p;
}

// one token's x: the d - L leading dims (zero past them) and the L last dims
template <int L>
struct Token {
  float hi[kMaxD - L];
  float lo[L];
};

template <int L>
__device__ __forceinline__ void load_token(const float* __restrict__ x, long long t, bool valid,
                                           int d, Token<L>& tk) {
  const int dh = d - L;
  const float* row = x + t * d;
#pragma unroll
  for (int j = 0; j < kMaxD - L; ++j) tk.hi[j] = (valid && j < dh) ? row[j] : 0.f;
#pragma unroll
  for (int i = 0; i < L; ++i) tk.lo[i] = valid ? row[dh + i] : 0.f;
}

// l[u] = the logit of code k0 + u, u < 2^L, k0 a multiple of 2^L: the FMA
// chain over the dims in order, the shared prefix once, the last L dims as a
// tree (leaf u: bit L-1-i of u picks the sign of lo[i]). Zero-padded leading
// dims add +0 and change nothing.
template <int L>
__device__ __forceinline__ void run_logits(const Token<L>& tk, int k0, int d, float v,
                                           float inv_temp, float (&l)[1 << L]) {
  const int dh = d - L;
  float h = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxD - L; ++j) {
    const float c = (j < dh && !((k0 >> (d - 1 - j)) & 1)) ? -v : v;
    h = fmaf(tk.hi[j], c, h);
  }
  l[0] = h;
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int q = (1 << i) - 1; q >= 0; --q) {
      const float base = l[q];
      l[2 * q + 1] = fmaf(tk.lo[i], v, base);
      l[2 * q] = fmaf(tk.lo[i], -v, base);
    }
  }
#pragma unroll
  for (int u = 0; u < (1 << L); ++u) l[u] = __fmul_rn(__fmul_rn(l[u], -2.f), -inv_temp);
}

// the sum over the warp's 32 lanes of val[u] for u = lane >> (5 - L): a
// butterfly that halves the values at each of L steps, then sums the lanes
// that hold the same code. Lanes l and l ^ mask add the same two numbers, so
// both hold the same sum.
template <int L>
__device__ __forceinline__ float warp_column_sum(float (&val)[1 << L], int lane) {
#pragma unroll
  for (int step = 0; step < L; ++step) {
    const int half = (1 << L) >> (step + 1);
    const int mask = 16 >> step;
    const bool upper = (lane & mask) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? val[i] : val[i + half];
      const float keep = upper ? val[i + half] : val[i];
      val[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, mask));
    }
  }
  float r = val[0];
#pragma unroll
  for (int mask = 16 >> L; mask >= 1; mask >>= 1) {
    r = __fadd_rn(r, __shfl_xor_sync(0xffffffffu, r, mask));
  }
  return r;
}

template <int V>
__device__ __forceinline__ void load_run(const float* __restrict__ src, float (&out)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(src) + i);
      out[4 * i] = q.x;
      out[4 * i + 1] = q.y;
      out[4 * i + 2] = q.z;
      out[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = __ldg(src + i);
  }
}

// f'(p) of the entropy term -p log max(p, eps)
__device__ __forceinline__ float entropy_slope(float p, float eps) {
  return __fsub_rn(-logf(fmaxf(p, eps)), p > eps ? 1.f : 0.f);
}

// ---- A: online logsumexp over the split's codes ---------------------------
template <int L>
__global__ void __launch_bounds__(kThreads)
sweep_a_kernel(const float* __restrict__ x, float* __restrict__ part_m, float* __restrict__ part_s,
               Plan p, float v, float inv_temp) {
  constexpr int V = 1 << L;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= p.n) return;
  Token<L> tk;
  load_token<L>(x, t, true, p.d, tk);
  const int k_begin = blockIdx.y * p.split_len;
  const int k_end = k_begin + p.split_len;
  float m = -CUDART_INF_F;
  float s = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += V) {
    float l[V];
    run_logits<L>(tk, k0, p.d, v, inv_temp, l);
    float run_max = l[0];
#pragma unroll
    for (int u = 1; u < V; ++u) run_max = fmaxf(run_max, l[u]);
    const float m_new = fmaxf(m, run_max);
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < V; ++u) sum = __fadd_rn(sum, expf(__fsub_rn(l[u], m_new)));
    s = __fadd_rn(__fmul_rn(s, expf(__fsub_rn(m, m_new))), sum);
    m = m_new;
  }
  const size_t at = static_cast<size_t>(blockIdx.y) * p.n + t;
  part_m[at] = m;
  part_s[at] = s;
}

// ---- B: entropy per token and w-weighted column sums ----------------------
template <int L>
__global__ void __launch_bounds__(kThreads)
sweep_b_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ logz, float* __restrict__ part_ent,
               float* __restrict__ part_avgp, Plan p, float v, float inv_temp, float eps) {
  constexpr int V = 1 << L;
  __shared__ float buf[kWarps][kFlushRuns][V];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k_begin = blockIdx.y * p.split_len;
  const int k_end = k_begin + p.split_len;
  float* avgp_row = part_avgp + static_cast<size_t>(blockIdx.x) * p.k;
  const int tile0 = blockIdx.x * p.tiles_per_row;
  const int tile_end = min(p.token_tiles, tile0 + p.tiles_per_row);

  for (int tile = tile0; tile < tile_end; ++tile) {
    // every thread of the block runs every run: the shuffles and barriers
    // below need the whole block; a token past n has w = 0
    const long long t = static_cast<long long>(tile) * kThreads + threadIdx.x;
    const bool valid = t < p.n;
    Token<L> tk;
    load_token<L>(x, t, valid, p.d, tk);
    const float wt = valid ? w[t] : 0.f;
    const float lz = valid ? logz[t] : 0.f;
    float ent = 0.f;
    int slot = 0;
    int flush_k0 = k_begin;
    for (int k0 = k_begin; k0 < k_end; k0 += V) {
      float l[V];
      run_logits<L>(tk, k0, p.d, v, inv_temp, l);
      float run_ent = 0.f;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float pu = expf(__fsub_rn(l[u], lz));
        run_ent = __fadd_rn(run_ent, __fmul_rn(-pu, logf(fmaxf(pu, eps))));
        l[u] = __fmul_rn(pu, wt);
      }
      ent = __fadd_rn(ent, run_ent);
      const float col = warp_column_sum<L>(l, lane);
      if ((lane & ((32 >> L) - 1)) == 0) buf[warp][slot][lane >> (5 - L)] = col;
      ++slot;
      if (slot == kFlushRuns || k0 + V == k_end) {
        __syncthreads();
        const int count = slot * V;
        for (int i = threadIdx.x; i < count; i += kThreads) {
          float sum = buf[0][i / V][i % V];
#pragma unroll
          for (int wi = 1; wi < kWarps; ++wi) sum = __fadd_rn(sum, buf[wi][i / V][i % V]);
          float* dst = avgp_row + flush_k0 + i;
          *dst = tile == tile0 ? sum : __fadd_rn(*dst, sum);
        }
        __syncthreads();
        slot = 0;
        flush_k0 = k0 + V;
      }
    }
    if (valid) part_ent[static_cast<size_t>(blockIdx.y) * p.n + t] = ent;
  }
}

// ---- C: the softmax-VJP statistics sigma and gdot -------------------------
template <int L>
__global__ void __launch_bounds__(kThreads)
sweep_c_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ logz, const float* __restrict__ entbar,
               const float* __restrict__ gbar, float* __restrict__ part_sigma,
               float* __restrict__ part_gdot, Plan p, float v, float inv_temp, float eps) {
  constexpr int V = 1 << L;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= p.n) return;
  Token<L> tk;
  load_token<L>(x, t, true, p.d, tk);
  const float wt = w[t];
  const float lz = logz[t];
  const float eb = entbar[t];
  const int k_begin = blockIdx.y * p.split_len;
  const int k_end = k_begin + p.split_len;
  float sigma = 0.f;
  float gdot = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += V) {
    float l[V];
    float gb[V];
    run_logits<L>(tk, k0, p.d, v, inv_temp, l);
    load_run<V>(gbar + k0, gb);
    float run_sigma = 0.f;
    float run_gdot = 0.f;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const float pu = expf(__fsub_rn(l[u], lz));
      const float g = __fadd_rn(__fmul_rn(eb, entropy_slope(pu, eps)), __fmul_rn(wt, gb[u]));
      run_sigma = __fadd_rn(run_sigma, __fmul_rn(pu, g));
      run_gdot = __fadd_rn(run_gdot, __fmul_rn(pu, gb[u]));
    }
    sigma = __fadd_rn(sigma, run_sigma);
    gdot = __fadd_rn(gdot, run_gdot);
  }
  const size_t at = static_cast<size_t>(blockIdx.y) * p.n + t;
  part_sigma[at] = sigma;
  part_gdot[at] = gdot;
}

// ---- D: dx = 2 inv_temp sum_k p (g - sigma) c_k, without a log ------------
//
// K8's redesign. The slope needs no log: where p > eps, log p = l - logz, so
// f'(p) = -(l - logz) - 1; where p <= eps it is the constant -log(eps)
// (computed once on the host, in f32). The logits are taken in base 2, with
// log2(e) folded into the logit scale: t = dot * (2 inv_temp log2 e) -
// logz log2 e in one FMA, p = ex2.approx.ftz(t) (one MUFU op; p below 2^-126
// flushes to 0, which only zeroes terms far below eps), and the slope
// -t ln 2 - 1. A pair then costs one MUFU op and a few FMAs: no accurate expf
// and no logf. The indicator still compares the computed p with eps.
//
// The token's arrays are sized by d at compile time (one instantiation per
// d <= 24), not for 24 dims with zero padding (the old kernel held 151
// registers, 3 blocks of 128 threads an SM). __launch_bounds__(128, 4) caps a
// thread at 128 registers, so that 4 blocks fit on an SM: at 5 (96
// registers) ptxas spilled 20 bytes at d = 18, 23 and 24. The split plan,
// the merge in split order and the rounding of the dots (the FMA chain over
// the dims in order, the shared prefix once per run of 2^L codes) are those
// of the other sweeps.

// floor(log2(v)) for v >= 1, at compile time
__host__ __device__ constexpr int log2_floor(int v) { return v <= 1 ? 0 : 1 + log2_floor(v / 2); }

__device__ __forceinline__ float ex2_approx(float t) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(t));
  return r;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 4)
sweep_d_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ logz, const float* __restrict__ entbar,
               const float* __restrict__ gbar, const float* __restrict__ sigma,
               float* __restrict__ part_dx, Plan p, float v, float inv_temp, float eps,
               float logit_scale2, float neg_log_eps) {
  constexpr int L = D < 4 ? D : 4;
  constexpr int V = 1 << L;
  constexpr int DH = D - L;        // the leading dims, shared within a run
  constexpr int NH = DH > 0 ? DH : 1;
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kLn2 = 0.6931471805599453f;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= p.n) return;
  const float* row = x + t * D;
  float hi[NH];
  float lo[L];
#pragma unroll
  for (int j = 0; j < DH; ++j) hi[j] = row[j];
#pragma unroll
  for (int i = 0; i < L; ++i) lo[i] = row[DH + i];
  const float wt = w[t];
  const float lz2 = __fmul_rn(logz[t], kLog2e);
  const float eb = entbar[t];
  const float sg = sigma[t];
  const int k_begin = blockIdx.y * p.split_len;
  const int k_end = k_begin + p.split_len;
  // sums of +-dl over the codes, the sign of dim j's entry; v comes in at the end
  float acc_hi[NH];
  float acc_lo[L];
#pragma unroll
  for (int j = 0; j < NH; ++j) acc_hi[j] = 0.f;
#pragma unroll
  for (int i = 0; i < L; ++i) acc_lo[i] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += V) {
    // the dots of the run's 2^L codes: the chain's shared prefix, then the
    // last L dims as a tree (leaf u: bit L-1-i of u picks the sign of lo[i])
    // The tree's levels are walked as one flat loop of constant trip count:
    // nested loops whose inner bound depends on the outer index were left
    // rolled by the compiler here, which put l[] in local memory.
    float l[V];
    float h = 0.f;
#pragma unroll
    for (int j = 0; j < DH; ++j) h = fmaf(hi[j], ((k0 >> (D - 1 - j)) & 1) ? v : -v, h);
    l[0] = h;
#pragma unroll
    for (int s = 0; s < V - 1; ++s) {
      const int i = log2_floor(s + 1);   // tree level, nodes 2^i - 1 .. 2^(i+1) - 2
      const int q = (2 << i) - 2 - s;    // a level's nodes from the last down
      const float base = l[q];
      l[2 * q + 1] = fmaf(lo[i], v, base);
      l[2 * q] = fmaf(lo[i], -v, base);
    }
    float gb[V];
    load_run<V>(gbar + k0, gb);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const float t2 = fmaf(l[u], logit_scale2, -lz2);  // log2 p
      const float pu = ex2_approx(t2);
      const float slope = pu > eps ? fmaf(-t2, kLn2, -1.f) : neg_log_eps;
      const float g = fmaf(eb, slope, __fmul_rn(wt, gb[u]));
      l[u] = __fmul_rn(pu, __fsub_rn(g, sg));
    }
    // the last L dims: leaves 2q and 2q + 1 differ in the sign of lo[i] at
    // tree level i; fold the tree from the leaves up, level L-1 first, q
    // ascending within a level (one flat loop, as above)
    float diff = 0.f;
#pragma unroll
    for (int s = 0; s < V - 1; ++s) {
      const int i = log2_floor(V - 1 - s);  // level i holds 2^i nodes from s = V - 2^(i+1)
      const int q = s - (V - (2 << i));
      diff = __fadd_rn(q == 0 ? 0.f : diff, __fsub_rn(l[2 * q + 1], l[2 * q]));
      l[q] = __fadd_rn(l[2 * q + 1], l[2 * q]);
      if (q == (1 << i) - 1) acc_lo[i] = __fadd_rn(acc_lo[i], diff);
    }
    const float run_sum = l[0];
#pragma unroll
    for (int j = 0; j < DH; ++j) {
      const bool plus = (k0 >> (D - 1 - j)) & 1;
      acc_hi[j] = __fadd_rn(acc_hi[j], plus ? run_sum : -run_sum);
    }
  }
  const float scale = 2.f * inv_temp;
  float* out = part_dx + (static_cast<size_t>(blockIdx.y) * p.n + t) * D;
#pragma unroll
  for (int j = 0; j < DH; ++j) out[j] = __fmul_rn(__fmul_rn(acc_hi[j], v), scale);
#pragma unroll
  for (int i = 0; i < L; ++i) out[DH + i] = __fmul_rn(__fmul_rn(acc_lo[i], v), scale);
}

// ---- merges: the splits in split order ------------------------------------
__global__ void merge_ms_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
                                float* __restrict__ m_out, float* __restrict__ s_out, long long n,
                                int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float m = part_m[i];
    float s = part_s[i];
    for (int sp = 1; sp < splits; ++sp) {
      const float m2 = part_m[sp * n + i];
      const float s2 = part_s[sp * n + i];
      const float mm = fmaxf(m, m2);
      s = __fadd_rn(__fmul_rn(s, expf(__fsub_rn(m, mm))), __fmul_rn(s2, expf(__fsub_rn(m2, mm))));
      m = mm;
    }
    m_out[i] = m;
    s_out[i] = s;
  }
}

__global__ void merge_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 long long count, int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int sp = 1; sp < splits; ++sp) s = __fadd_rn(s, part[sp * count + i]);
    out[i] = s;
  }
}

unsigned merge_blocks(long long count) {
  long long blocks = (count + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

int merge_sum(const float* part, float* out, long long count, int splits, cudaStream_t s) {
  merge_sum_kernel<<<merge_blocks(count), 256, 0, s>>>(part, out, count, splits);
  return static_cast<int>(cudaGetLastError());
}

dim3 sweep_grid(const Plan& p) {
  return dim3(static_cast<unsigned>(p.token_tiles), static_cast<unsigned>(p.splits));
}

template <int L>
int launch_a(const float* x, float* m, float* s, float* scratch, const Plan& p, float v,
             float inv_temp, cudaStream_t st) {
  float* part_m = scratch;
  float* part_s = scratch + static_cast<size_t>(p.splits) * p.n;
  sweep_a_kernel<L><<<sweep_grid(p), kThreads, 0, st>>>(x, part_m, part_s, p, v, inv_temp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_ms_kernel<<<merge_blocks(p.n), 256, 0, st>>>(part_m, part_s, m, s, p.n, p.splits);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch_b(const float* x, const float* w, const float* logz, float* ent, float* avgp_rows,
             float* scratch, const Plan& p, float v, float inv_temp, float eps, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(p.rows), static_cast<unsigned>(p.splits));
  sweep_b_kernel<L><<<grid, kThreads, 0, st>>>(x, w, logz, scratch, avgp_rows, p, v, inv_temp, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return merge_sum(scratch, ent, p.n, p.splits, st);
}

template <int L>
int launch_c(const float* x, const float* w, const float* logz, const float* entbar,
             const float* gbar, float* sigma, float* gdot, float* scratch, const Plan& p, float v,
             float inv_temp, float eps, cudaStream_t st) {
  float* part_sigma = scratch;
  float* part_gdot = scratch + static_cast<size_t>(p.splits) * p.n;
  sweep_c_kernel<L><<<sweep_grid(p), kThreads, 0, st>>>(x, w, logz, entbar, gbar, part_sigma,
                                                         part_gdot, p, v, inv_temp, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int e = merge_sum(part_sigma, sigma, p.n, p.splits, st);
  if (e != 0) return e;
  return merge_sum(part_gdot, gdot, p.n, p.splits, st);
}

template <int D>
int launch_d(const float* x, const float* w, const float* logz, const float* entbar,
             const float* gbar, const float* sigma, float* dx, float* scratch, const Plan& p,
             float v, float inv_temp, float eps, cudaStream_t st) {
  // the base-2 logit scale 2 inv_temp log2(e), and the slope where p <= eps
  const float logit_scale2 = static_cast<float>(2.0 * inv_temp * 1.4426950408889634);
  const float neg_log_eps = -logf(eps);
  sweep_d_kernel<D><<<sweep_grid(p), kThreads, 0, st>>>(x, w, logz, entbar, gbar, sigma, scratch, p,
                                                         v, inv_temp, eps, logit_scale2, neg_log_eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return merge_sum(scratch, dx, p.n * p.d, p.splits, st);
}

// runs `call` with the constant L = min(d, 4) in scope
#define VQTPU_DISPATCH_L(d, call)            \
  switch ((d) < 4 ? (d) : 4) {               \
    case 1: { constexpr int L = 1; call; }   \
    case 2: { constexpr int L = 2; call; }   \
    case 3: { constexpr int L = 3; call; }   \
    default: { constexpr int L = 4; call; }  \
  }

}  // namespace

extern "C" {

// Floats of scratch each sweep needs for n tokens of d dims (sweep 0..3 for
// A..D): the per-split partials.
long long vqtpu_lfq_scratch_floats(int sweep, long long n, int d) {
  const Plan p = make_plan(n, d);
  const long long per = static_cast<long long>(p.splits) * n;
  switch (sweep) {
    case 0: return 2 * per;
    case 1: return per;
    case 2: return 2 * per;
    default: return per * d;
  }
}

// Rows of avgp partials sweep B writes, each K = 2^d floats; avgp is their
// sum over rows.
long long vqtpu_lfq_avgp_rows(long long n, int d) { return make_plan(n, d).rows; }

// All pointers are contiguous f32 on the current device: x (n, d), the
// per-token columns (n,), gbar (2^d,), dx (n, d), avgp_rows
// (vqtpu_lfq_avgp_rows(n, d), 2^d), scratch of vqtpu_lfq_scratch_floats
// floats. Each enqueues its sweep and its merge on `stream` and returns the
// first nonzero cudaGetLastError(). Requires 1 <= d <= 24 and n >= 1, with
// n * 2^d * d within the kernels' ranges (checked by the Python wrapper).
int vqtpu_lfq_sweep_a(const float* x, float* m, float* s, float* scratch, long long n, int d,
                      float v, float inv_temp, void* stream) {
  const Plan p = make_plan(n, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  VQTPU_DISPATCH_L(d, return launch_a<L>(x, m, s, scratch, p, v, inv_temp, st))
}

int vqtpu_lfq_sweep_b(const float* x, const float* w, const float* logz, float* ent,
                      float* avgp_rows, float* scratch, long long n, int d, float v,
                      float inv_temp, float eps, void* stream) {
  const Plan p = make_plan(n, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  VQTPU_DISPATCH_L(d, return launch_b<L>(x, w, logz, ent, avgp_rows, scratch, p, v, inv_temp,
                                         eps, st))
}

int vqtpu_lfq_sweep_c(const float* x, const float* w, const float* logz, const float* entbar,
                      const float* gbar, float* sigma, float* gdot, float* scratch, long long n,
                      int d, float v, float inv_temp, float eps, void* stream) {
  const Plan p = make_plan(n, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  VQTPU_DISPATCH_L(d, return launch_c<L>(x, w, logz, entbar, gbar, sigma, gdot, scratch, p, v,
                                         inv_temp, eps, st))
}

int vqtpu_lfq_sweep_d(const float* x, const float* w, const float* logz, const float* entbar,
                      const float* gbar, const float* sigma, float* dx, float* scratch,
                      long long n, int d, float v, float inv_temp, float eps, void* stream) {
  const Plan p = make_plan(n, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
#define VQTPU_SWEEP_D_CASE(D) \
  case D:                     \
    return launch_d<D>(x, w, logz, entbar, gbar, sigma, dx, scratch, p, v, inv_temp, eps, st);
    VQTPU_SWEEP_D_CASE(1) VQTPU_SWEEP_D_CASE(2) VQTPU_SWEEP_D_CASE(3) VQTPU_SWEEP_D_CASE(4)
    VQTPU_SWEEP_D_CASE(5) VQTPU_SWEEP_D_CASE(6) VQTPU_SWEEP_D_CASE(7) VQTPU_SWEEP_D_CASE(8)
    VQTPU_SWEEP_D_CASE(9) VQTPU_SWEEP_D_CASE(10) VQTPU_SWEEP_D_CASE(11) VQTPU_SWEEP_D_CASE(12)
    VQTPU_SWEEP_D_CASE(13) VQTPU_SWEEP_D_CASE(14) VQTPU_SWEEP_D_CASE(15) VQTPU_SWEEP_D_CASE(16)
    VQTPU_SWEEP_D_CASE(17) VQTPU_SWEEP_D_CASE(18) VQTPU_SWEEP_D_CASE(19) VQTPU_SWEEP_D_CASE(20)
    VQTPU_SWEEP_D_CASE(21) VQTPU_SWEEP_D_CASE(22) VQTPU_SWEEP_D_CASE(23) VQTPU_SWEEP_D_CASE(24)
#undef VQTPU_SWEEP_D_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* vqtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
