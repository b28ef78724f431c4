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
// d-term dot, one exp and a few FMAs. No sweep needs a log, and A needs no
// running max (below), so a pair costs one MUFU op: that is the bound.
//
// What the design does about it:
//
// 1. No accurate expf and no logf anywhere. The logits are taken in base 2,
//    with log2(e) folded into the logit scale (logit_scale2 =
//    2 inv_temp log2 e): t = dot * logit_scale2 - shift in one FMA, and
//    2^t = ex2.approx.ftz(t), one MUFU op (a result below 2^-126 flushes to
//    0, far below every term that counts). Where p > eps, log p = l - logz,
//    so the entropy term and the slope f'(p) = -t ln 2 - 1 come from t with
//    FMAs; where p <= eps the slope is the constant -log(eps), computed once
//    on the host. The indicator compares the computed p with eps. A's shift
//    is the largest logit in closed form (its notes below).
// 2. Sweeps A, B and C: a block is one warp, and a lane carries T tokens
//    (four, or two above d = 18); sweep D: 128 threads a block, one token
//    each. A token's d floats sit in registers, in arrays sized by d at
//    compile time (one instantiation per d <= 24, no padding). Every lane
//    walks the same codes at the same time, so the code bits are uniform
//    across the warp and cost no divergence.
// 3. Codes go in runs of V = 2^L (L = min(d, 4)) consecutive codes, which
//    share their top d - L bits. A dot is the FMA chain over the dims in
//    order, dot = fma(x_{d-1}, c_{d-1}, ... fma(x_0, c_0, 0)); the chain's
//    prefix over the shared dims is computed once per run, and the last L
//    dims branch as a binary tree, so the 2^L dots cost about 2^(L+1) FMAs
//    and are rounded exactly as the d-FMA chain would round each of them.
// 4. n = 8192 tokens make only 64 tiles of 128 tokens, too few for 132 SMs,
//    so K is split over the grid's second dimension (at least 8 blocks per SM
//    when K allows). Each (token tile, split) block writes its per-token
//    partials to scratch, and a merge pass adds the splits in split order
//    (s, ent, sigma, gdot, dx).
// 5. avgp sums over tokens: in sweep B each lane first adds its tokens'
//    w p of a run, then a butterfly of shuffles (16 shuffles for 16 codes)
//    sums the warp's lanes, and each block row writes one row of partials
//    per token group. The caller sums the rows (torch.sum over them,
//    deterministic on the card).
//
// No float atomics anywhere: two calls on the same inputs give bit-identical
// outputs, and the split plan depends on (n, d) only. Ragged n is masked in
// the kernels; no padded copies are made. The build has no fast-math flag.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;                 // tokens per tile
constexpr int kTargetBlocks = 132 * 8;        // 8 blocks per SM on an H100 SXM
constexpr int kMaxSplits = 64;
constexpr long long kMaxAvgpFloats = 1LL << 27;  // 512 MB of avgp partial rows at most
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Plan {
  long long n;
  int d;
  int k;            // 2^d
  int token_tiles;  // tiles of kThreads tokens
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

// floor(log2(v)) for v >= 1, at compile time
__host__ __device__ constexpr int log2_floor(int v) { return v <= 1 ? 0 : 1 + log2_floor(v / 2); }

// tokens a lane carries in sweeps A, B and C: four, or two above d = 18,
// whose x would not leave room in 128 registers for four
__host__ __device__ constexpr int tokens_a_lane(int d) { return d <= 18 ? 4 : 2; }

// token t's x: its d - L leading dims in hi, its L last dims in lo (zeros
// where the token is past n)
template <int D, int NH, int L>
__device__ __forceinline__ void load_x(const float* __restrict__ x, long long t, bool valid,
                                       float (&hi)[NH], float (&lo)[L]) {
  const float* row = x + t * D;
#pragma unroll
  for (int i = 0; i < D - L; ++i) hi[i] = valid ? row[i] : 0.f;
#pragma unroll
  for (int i = 0; i < L; ++i) lo[i] = valid ? row[D - L + i] : 0.f;
}

// l[u] = the dot x . c_{k0 + u} of the run's 2^L codes (k0 a multiple of
// 2^L): the chain's shared prefix over hi, then the last L dims as a tree
// (leaf u: bit L-1-i of u picks the sign of lo[i]). The tree's levels are
// walked as one flat loop of constant trip count: nested loops whose inner
// bound depends on the outer index were left rolled by the compiler, which
// put l[] in local memory.
template <int D, int NH, int L>
__device__ __forceinline__ void run_dots(const float (&hi)[NH], const float (&lo)[L], int k0, float v,
                                         float (&l)[1 << L]) {
  float h = 0.f;
#pragma unroll
  for (int i = 0; i < D - L; ++i) h = fmaf(hi[i], ((k0 >> (D - 1 - i)) & 1) ? v : -v, h);
  l[0] = h;
#pragma unroll
  for (int s = 0; s < (1 << L) - 1; ++s) {
    const int i = log2_floor(s + 1);   // tree level, nodes 2^i - 1 .. 2^(i+1) - 2
    const int q = (2 << i) - 2 - s;    // a level's nodes from the last down
    const float base = l[q];
    l[2 * q + 1] = fmaf(lo[i], v, base);
    l[2 * q] = fmaf(lo[i], -v, base);
  }
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

__device__ __forceinline__ float ex2_approx(float t) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(t));
  return r;
}

constexpr int kBThreads = 32;  // sweeps A, B, C: one warp a block

// ---- A: logsumexp over the split's codes, its shift in closed form -------
//
// K5's redesign. Every code is +-v in each dim, so the largest logit of a
// token is known before any code is visited: max_k x . c_k = |v| ||x||_1,
// reached by the sign pattern of x, and in base 2 the largest logit is
// m2 = |2 inv_temp log2 e| |v| ||x||_1 for either sign of inv_temp and v.
// So s = sum_k ex2(t_k - m2), t_k = dot_k logit_scale2, needs no running
// max and no rescale: a pair costs one FMA, one MUFU op and one add, and the
// splits' partial s merge as a plain sum. Every term is at most 1, and the
// merged s at least 1, up to the rounding of the largest logit (||x||_1 and
// the FMA chain round apart, by a few ulps of m2); a term below 2^-126,
// e^-87 below the largest, flushes to 0. m = m2 ln 2 is written in
// natural-log units, so that logz = m + log s: it is this shift, not the
// largest computed logit.
//
// B's layout: one warp a block, T tokens a lane, the token's arrays sized by
// d. A run's 2^L terms are added as a pairwise tree (one flat loop, as the
// dots' tree), then to the token's s.
template <int D>
__global__ void __launch_bounds__(kBThreads, 16)
sweep_a_kernel(const float* __restrict__ x, float* __restrict__ m_out, float* __restrict__ part_s,
               Plan p, float v, float logit_scale2, float shift_scale2) {
  constexpr int L = D < 4 ? D : 4;
  constexpr int V = 1 << L;
  constexpr int DH = D - L;        // the leading dims, shared within a run
  constexpr int NH = DH > 0 ? DH : 1;
  constexpr int T = tokens_a_lane(D);
  constexpr int kParts = kThreads / (32 * T);    // parts of a tile, walked in turn
  const int lane = threadIdx.x;
  const int k_begin = blockIdx.y * p.split_len;
  const int k_end = k_begin + p.split_len;
  for (int part = 0; part < kParts; ++part) {
    const long long t0 = static_cast<long long>(blockIdx.x) * kThreads + part * 32 * T + lane;
    float hi[T][NH];
    float lo[T][L];
    float m2[T];
    float s[T];
#pragma unroll
    for (int j = 0; j < T; ++j) {
      load_x<D>(x, t0 + 32 * j, t0 + 32 * j < p.n, hi[j], lo[j]);
      float norm1 = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) norm1 = __fadd_rn(norm1, fabsf(hi[j][i]));
#pragma unroll
      for (int i = 0; i < L; ++i) norm1 = __fadd_rn(norm1, fabsf(lo[j][i]));
      m2[j] = __fmul_rn(norm1, shift_scale2);
      s[j] = 0.f;
    }
    for (int k0 = k_begin; k0 < k_end; k0 += V) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        float l[V];
        run_dots<D>(hi[j], lo[j], k0, v, l);
#pragma unroll
        for (int u = 0; u < V; ++u) l[u] = ex2_approx(fmaf(l[u], logit_scale2, -m2[j]));
#pragma unroll
        for (int st = 0; st < V - 1; ++st) {
          const int h = 1 << log2_floor(V - 1 - st);  // V/2 sums, then V/4, ... 1
          const int u = st - (V - 2 * h);
          l[u] = __fadd_rn(l[u], l[u + h]);
        }
        s[j] = __fadd_rn(s[j], l[0]);
      }
    }
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const long long t = t0 + 32 * j;
      if (t < p.n) {
        part_s[static_cast<size_t>(blockIdx.y) * p.n + t] = s[j];
        if (blockIdx.y == 0) m_out[t] = __fmul_rn(m2[j], kLn2);
      }
    }
  }
}

// ---- B: entropy per token and w-weighted column sums, without a log -------
//
// K6's redesign. Where p > eps, -p log max(p, eps) = -p (l - logz) =
// -p t ln 2, with t = log2 p = dot * logit_scale2 - logz log2 e in one FMA
// and p = ex2.approx.ftz(t); where p <= eps the term is p * -log(eps).
//
// A block walks its 128-token tile in parts of 32 T tokens (lanes l,
// l + 32, ...). A token's weight and base-2 logZ wait in shared memory, read
// once a run, so that their registers go to x. A run's avgp column sums add a
// lane's T tokens in registers first, in token order, then one butterfly of
// shuffles over the 32 lanes gives the part's sums: 2^L shuffles a run serve
// 32 T tokens. There is no barrier: the lane that holds a code's sum adds it
// into the block's row of avgp partials itself, part after part and tile
// after tile in order (loading the partial it adds to at the start of the
// run, so that the load's latency hides behind the run).
//
// __launch_bounds__(32, 16) caps a thread at 128 registers, so that the 2048
// blocks of the main shape (64 token tiles x 32 splits) run in one wave on
// 132 SMs: 15 blocks an SM would leave a tail of 68 blocks. No instantiation
// spills.
template <int D>
__global__ void __launch_bounds__(kBThreads, 16)
sweep_b_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ logz, float* __restrict__ part_ent,
               float* __restrict__ part_avgp, Plan p, float v, float eps, float logit_scale2,
               float neg_log_eps) {
  constexpr int L = D < 4 ? D : 4;
  constexpr int V = 1 << L;
  constexpr int DH = D - L;        // the leading dims, shared within a run
  constexpr int NH = DH > 0 ? DH : 1;
  constexpr int T = tokens_a_lane(D);
  constexpr int kParts = kThreads / (32 * T);    // parts of a tile, walked in turn
  __shared__ float token_w[32 * T];
  __shared__ float token_lz2[32 * T];
  // volatile: read in every run, not held in registers across the runs
  volatile float* wts = token_w;
  volatile float* lz2s = token_lz2;
  const int lane = threadIdx.x;
  const int k_begin = blockIdx.y * p.split_len;
  const int k_end = k_begin + p.split_len;
  const bool holder = (lane & ((32 >> L) - 1)) == 0;  // holds a code's column sum
  float* avgp_row = part_avgp + static_cast<size_t>(blockIdx.x) * p.k + (lane >> (5 - L));
  const int tile0 = blockIdx.x * p.tiles_per_row;
  const int tile_end = min(p.token_tiles, tile0 + p.tiles_per_row);

  for (int tile = tile0; tile < tile_end; ++tile) {
    for (int part = 0; part < kParts; ++part) {
      // every lane runs every run: the shuffles need the whole warp; a token
      // past n has w = 0 and writes no ent
      const long long t0 = static_cast<long long>(tile) * kThreads + part * 32 * T + lane;
      const bool first = tile == tile0 && part == 0;
      float hi[T][NH];
      float lo[T][L];
      float ent[T];
      __syncwarp();  // the previous part's reads of the shared columns are done
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const long long t = t0 + 32 * j;
        const bool valid = t < p.n;
        load_x<D>(x, t, valid, hi[j], lo[j]);
        wts[32 * j + lane] = valid ? w[t] : 0.f;
        lz2s[32 * j + lane] = valid ? __fmul_rn(logz[t], kLog2e) : 0.f;
        ent[j] = 0.f;
      }
      __syncwarp();
      for (int k0 = k_begin; k0 < k_end; k0 += V) {
        const float prev = holder && !first ? avgp_row[k0] : 0.f;
        float col[V];
#pragma unroll
        for (int u = 0; u < V; ++u) col[u] = 0.f;
#pragma unroll
        for (int j = 0; j < T; ++j) {
          float l[V];
          run_dots<D>(hi[j], lo[j], k0, v, l);
          const float wt = wts[32 * j + lane];
          const float lz2 = lz2s[32 * j + lane];
          float run_ent = 0.f;
#pragma unroll
          for (int u = 0; u < V; ++u) {
            const float t2 = fmaf(l[u], logit_scale2, -lz2);  // log2 p
            const float pu = ex2_approx(t2);
            run_ent = fmaf(pu, pu > eps ? __fmul_rn(-t2, kLn2) : neg_log_eps, run_ent);
            col[u] = fmaf(pu, wt, col[u]);
          }
          ent[j] = __fadd_rn(ent[j], run_ent);
        }
        const float sum = warp_column_sum<L>(col, lane);
        if (holder) avgp_row[k0] = first ? sum : __fadd_rn(prev, sum);
      }
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const long long t = t0 + 32 * j;
        if (t < p.n) part_ent[static_cast<size_t>(blockIdx.y) * p.n + t] = ent[j];
      }
    }
  }
}

// ---- C: the softmax-VJP statistics sigma and gdot, without a log ----------
//
// K7's redesign, on sweep B's algebra and layout. g factors out of the pair
// loop: sigma_n = sum_k p (entbar_n f'(p) + w_n gbar_k) = entbar_n S_n +
// w_n gdot_n with S_n = sum_k p f'(p), so a pair adds one FMA to S and one to
// gdot, and sigma is formed once per token and split from the two sums. That
// is the same sum with its terms grouped otherwise, rounded otherwise. S is
// summed in base-2 units, f'(p) / ln 2 = -t - log2 e where p > eps, else
// -log2(eps) (one add and a select a pair), and multiplied by ln 2 once per
// token: -t ln 2 - 1 takes an FMA with two constants, one of which ptxas
// rematerialized in every pair, and spilled at d = 16-18.
//
// One warp a block, T tokens a lane, arrays sized by d; a token's base-2
// logZ waits in shared memory (each lane reads only its own slots), its
// weight and entbar are read once, at the end. A run's 2^L gbar values are
// loaded once and serve all of the lane's tokens. __launch_bounds__(32, 16)
// as sweep B's.
template <int D>
__global__ void __launch_bounds__(kBThreads, 16)
sweep_c_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ logz, const float* __restrict__ entbar,
               const float* __restrict__ gbar, float* __restrict__ part_sigma,
               float* __restrict__ part_gdot, Plan p, float v, float eps, float logit_scale2,
               float neg_log2_eps) {
  constexpr int L = D < 4 ? D : 4;
  constexpr int V = 1 << L;
  constexpr int DH = D - L;        // the leading dims, shared within a run
  constexpr int NH = DH > 0 ? DH : 1;
  constexpr int T = tokens_a_lane(D);
  constexpr int kParts = kThreads / (32 * T);    // parts of a tile, walked in turn
  __shared__ float token_lz2[32 * T];
  // volatile: read in every run, not held in registers across the runs
  volatile float* lz2s = token_lz2;
  const int lane = threadIdx.x;
  const int k_begin = blockIdx.y * p.split_len;
  const int k_end = k_begin + p.split_len;
  for (int part = 0; part < kParts; ++part) {
    const long long t0 = static_cast<long long>(blockIdx.x) * kThreads + part * 32 * T + lane;
    float hi[T][NH];
    float lo[T][L];
    float slope_sum[T];  // S / ln 2 = sum_k p f'(p) / ln 2
    float gdot[T];
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const long long t = t0 + 32 * j;
      const bool valid = t < p.n;
      load_x<D>(x, t, valid, hi[j], lo[j]);
      lz2s[32 * j + lane] = valid ? __fmul_rn(logz[t], kLog2e) : 0.f;
      slope_sum[j] = 0.f;
      gdot[j] = 0.f;
    }
    for (int k0 = k_begin; k0 < k_end; k0 += V) {
      float gb[V];
      load_run<V>(gbar + k0, gb);
#pragma unroll
      for (int j = 0; j < T; ++j) {
        float l[V];
        run_dots<D>(hi[j], lo[j], k0, v, l);
        const float lz2 = lz2s[32 * j + lane];
        float run_s = 0.f;
        float run_g = 0.f;
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float t2 = fmaf(l[u], logit_scale2, -lz2);  // log2 p
          const float pu = ex2_approx(t2);
          run_s = fmaf(pu, pu > eps ? __fsub_rn(-t2, kLog2e) : neg_log2_eps, run_s);
          run_g = fmaf(pu, gb[u], run_g);
        }
        slope_sum[j] = __fadd_rn(slope_sum[j], run_s);
        gdot[j] = __fadd_rn(gdot[j], run_g);
      }
    }
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const long long t = t0 + 32 * j;
      if (t < p.n) {
        const size_t at = static_cast<size_t>(blockIdx.y) * p.n + t;
        part_sigma[at] = fmaf(entbar[t], __fmul_rn(slope_sum[j], kLn2), __fmul_rn(w[t], gdot[j]));
        part_gdot[at] = gdot[j];
      }
    }
  }
}

// ---- D: dx = 2 inv_temp sum_k p (g - sigma) c_k, without a log ------------
//
// K8's redesign. A pair costs one MUFU op and a few FMAs (the algebra of
// note 1): g = entbar f'(p) + w gbar in full, then p (g - sigma), subtracted
// per pair. Folding C into D by expanding sum p (g - sigma) c into
// sum p g c - sigma sum p c would cancel both terms down to rounding noise
// where the softmax saturates (inv_temp 100).
//
// One thread per token, 128 tokens a block. __launch_bounds__(128, 4) caps a
// thread at 128 registers, so that 4 blocks fit on an SM: at 5 (96
// registers) ptxas spilled 20 bytes at d = 18, 23 and 24. The old kernel,
// padded to 24 dims, held 151 registers.
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
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= p.n) return;
  float hi[NH];
  float lo[L];
  load_x<D>(x, t, true, hi, lo);
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
    float l[V];
    run_dots<D>(hi, lo, k0, v, l);
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
    // ascending within a level (one flat loop, as run_dots')
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

// ---- merge: the splits' partials added in split order ---------------------
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

// the base-2 logit scale 2 inv_temp log2(e)
float logit_scale2(float inv_temp) { return static_cast<float>(2.0 * inv_temp * 1.4426950408889634); }

// the slope f'(p) where p <= eps
float neg_log_eps(float eps) { return -logf(eps); }

template <int D>
int launch_a(const float* x, float* m, float* s, float* scratch, const Plan& p, float v,
             float inv_temp, cudaStream_t st) {
  // the base-2 shift per unit of ||x||_1: |2 inv_temp log2(e) v|
  const float shift_scale2 = static_cast<float>(fabs(2.0 * inv_temp * 1.4426950408889634 * v));
  sweep_a_kernel<D><<<sweep_grid(p), kBThreads, 0, st>>>(x, m, scratch, p, v, logit_scale2(inv_temp),
                                                          shift_scale2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return merge_sum(scratch, s, p.n, p.splits, st);
}

template <int D>
int launch_b(const float* x, const float* w, const float* logz, float* ent, float* avgp_rows,
             float* scratch, const Plan& p, float v, float inv_temp, float eps, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(p.rows), static_cast<unsigned>(p.splits));
  sweep_b_kernel<D><<<grid, kBThreads, 0, st>>>(x, w, logz, scratch, avgp_rows, p, v, eps,
                                                 logit_scale2(inv_temp), neg_log_eps(eps));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return merge_sum(scratch, ent, p.n, p.splits, st);
}

template <int D>
int launch_c(const float* x, const float* w, const float* logz, const float* entbar,
             const float* gbar, float* sigma, float* gdot, float* scratch, const Plan& p, float v,
             float inv_temp, float eps, cudaStream_t st) {
  float* part_sigma = scratch;
  float* part_gdot = scratch + static_cast<size_t>(p.splits) * p.n;
  sweep_c_kernel<D><<<sweep_grid(p), kBThreads, 0, st>>>(x, w, logz, entbar, gbar, part_sigma,
                                                          part_gdot, p, v, eps,
                                                          logit_scale2(inv_temp), -log2f(eps));
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
  sweep_d_kernel<D><<<sweep_grid(p), kThreads, 0, st>>>(x, w, logz, entbar, gbar, sigma, scratch, p,
                                                         v, inv_temp, eps, logit_scale2(inv_temp),
                                                         neg_log_eps(eps));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return merge_sum(scratch, dx, p.n * p.d, p.splits, st);
}

// runs `call` with the constant D = d in scope, 1 <= d <= 24
#define VQTPU_D_CASE(n, call) case n: { constexpr int D = n; call; }
#define VQTPU_DISPATCH_D(d, call)                                                        \
  switch (d) {                                                                           \
    VQTPU_D_CASE(1, call) VQTPU_D_CASE(2, call) VQTPU_D_CASE(3, call) VQTPU_D_CASE(4, call)     \
    VQTPU_D_CASE(5, call) VQTPU_D_CASE(6, call) VQTPU_D_CASE(7, call) VQTPU_D_CASE(8, call)     \
    VQTPU_D_CASE(9, call) VQTPU_D_CASE(10, call) VQTPU_D_CASE(11, call) VQTPU_D_CASE(12, call)  \
    VQTPU_D_CASE(13, call) VQTPU_D_CASE(14, call) VQTPU_D_CASE(15, call) VQTPU_D_CASE(16, call) \
    VQTPU_D_CASE(17, call) VQTPU_D_CASE(18, call) VQTPU_D_CASE(19, call) VQTPU_D_CASE(20, call) \
    VQTPU_D_CASE(21, call) VQTPU_D_CASE(22, call) VQTPU_D_CASE(23, call) VQTPU_D_CASE(24, call) \
    default: return static_cast<int>(cudaErrorInvalidValue);                             \
  }

}  // namespace

extern "C" {

// Floats of scratch each sweep needs for n tokens of d dims (sweep 0..3 for
// A..D): the per-split partials.
long long vqtpu_lfq_scratch_floats(int sweep, long long n, int d) {
  const Plan p = make_plan(n, d);
  const long long per = static_cast<long long>(p.splits) * n;
  switch (sweep) {
    case 0: return per;
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
  VQTPU_DISPATCH_D(d, return launch_a<D>(x, m, s, scratch, p, v, inv_temp, st))
}

int vqtpu_lfq_sweep_b(const float* x, const float* w, const float* logz, float* ent,
                      float* avgp_rows, float* scratch, long long n, int d, float v,
                      float inv_temp, float eps, void* stream) {
  const Plan p = make_plan(n, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  VQTPU_DISPATCH_D(d, return launch_b<D>(x, w, logz, ent, avgp_rows, scratch, p, v, inv_temp,
                                         eps, st))
}

int vqtpu_lfq_sweep_c(const float* x, const float* w, const float* logz, const float* entbar,
                      const float* gbar, float* sigma, float* gdot, float* scratch, long long n,
                      int d, float v, float inv_temp, float eps, void* stream) {
  const Plan p = make_plan(n, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  VQTPU_DISPATCH_D(d, return launch_c<D>(x, w, logz, entbar, gbar, sigma, gdot, scratch, p, v,
                                         inv_temp, eps, st))
}

int vqtpu_lfq_sweep_d(const float* x, const float* w, const float* logz, const float* entbar,
                      const float* gbar, const float* sigma, float* dx, float* scratch,
                      long long n, int d, float v, float inv_temp, float eps, void* stream) {
  const Plan p = make_plan(n, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  VQTPU_DISPATCH_D(d, return launch_d<D>(x, w, logz, entbar, gbar, sigma, dx, scratch, p, v,
                                         inv_temp, eps, st))
}

const char* vqtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
