// The fused VQ training step on Hopper (sm_90a), f32: selection, the exact
// codebook-row lookup and the EMA batch statistics in one call.
//
//   idx[h, t]     = first argmax_j ( x[h, t] . e[h, j] + bias[h, j] )
//   q[h, t, :]    = e[h, idx[h, t], :]                (a bit copy)
//   bins[h, k]    = sum_t w[h, t] * [idx[h, t] == k]
//   esum[h, k, :] = sum_t w[h, t] * [idx[h, t] == k] * x[h, t, :]
//
// with w = 1 when no weight is given. Replaces the Pallas TPU kernel
// vqtpu/kernels/train_fused.py::_fused_train_kernel, which keeps each token
// block's scores, one-hot, lookup and statistics in VMEM and carries the
// (c, d) statistics in scratch from one sequential grid step to the next.
//
// What bounds it: the selection's 2*n*c*d f32 multiply-adds (4.1 ms at
// n = 2^20, c = 512, d = 256 on the H100 SXM's 67 TFLOP/s), against about
// 0.64 ms to read x once and write q once at 3.35 TB/s. It is
// compute-bound, and the statistics are a pass over x that costs bytes,
// not operations.
//
// What the design does about it, in three passes on one stream:
//
// 1. select_codes_kernel<true> (select_codes.cuh): the selection tile of
//    nearest_code.cu, with an epilogue that copies each token's winning
//    row into q. The
//    one-hot of the TPU kernel is never formed.
// 2. stats_partial_kernel: blocks run in parallel and in no order on
//    Hopper, so nothing carries a sum from one block to the next, and one
//    (c, d) f32 accumulator (512 KB at the main shape) does not fit in a
//    block's 227 KB of shared memory. The statistics are therefore split
//    over a grid of (code tile, d tile, token split): each block owns the
//    accumulator of its code tile x d tile in shared memory (at most 64 KB)
//    and scans the indices of its token split. In chunks of 256 tokens it
//    compacts, stably, the tokens whose code lies in its tile, and warp
//    k % 8 adds the tokens of code k, in token order, into row k. Every
//    (code, dim) entry is owned by one warp lane, so no atomics are used,
//    and the order of each sum is the token order, whatever the schedule.
//    The block writes its partial sums, zeros included, to scratch.
// 3. stats_merge_kernel sums the partials of the token splits in split
//    order into bins and esum.
//
// So bins and esum are deterministic: two calls on the same inputs give
// bit-identical outputs, and no float atomic is used. Their f32 summation
// order (token order within a split, then split order) may differ from
// the plain version's. The split count depends on (h, n, c, d) only, so
// the same shapes always sum in the same order. Ragged n, c and d are
// masked in the kernels; no padded copies are made.

#include "select_codes.cuh"

namespace {

constexpr int kStatThreads = 256;            // 8 warps
constexpr int kStatWarps = kStatThreads / 32;
constexpr int kMaxDTile = 256;               // dims per block: 8 per lane
constexpr int kAccFloats = 16384;            // 64 KB accumulator per block
constexpr int kBatch = 4;                    // tokens whose loads a warp issues together
constexpr long long kSplitTokens = 4096;     // tokens per split, at least
constexpr long long kMaxSplits = 128;
constexpr long long kScratchFloats = 1LL << 26;  // 256 MB of partial sums at most

struct StatTiles {
  int d_tile;     // dims per block
  int d_tiles;
  int c_tile;     // codes per block
  int c_tiles;
  int splits;     // token splits
  int split_len;  // tokens per split
};

StatTiles stat_tiles(long long h, long long n, long long c, long long d) {
  StatTiles t;
  t.d_tile = static_cast<int>(d < kMaxDTile ? d : kMaxDTile);
  t.d_tiles = static_cast<int>((d + t.d_tile - 1) / t.d_tile);
  long long ct = kAccFloats / t.d_tile;
  t.c_tile = static_cast<int>(ct < c ? ct : c);
  t.c_tiles = static_cast<int>((c + t.c_tile - 1) / t.c_tile);
  long long splits = (n + kSplitTokens - 1) / kSplitTokens;
  const long long by_memory = kScratchFloats / (h * c * (d + 1));
  if (splits > by_memory) splits = by_memory;
  if (splits > kMaxSplits) splits = kMaxSplits;
  if (splits < 1) splits = 1;
  t.splits = static_cast<int>(splits);
  t.split_len = static_cast<int>((n + splits - 1) / splits);
  return t;
}

size_t stat_smem_bytes(const StatTiles& t) {
  return (static_cast<size_t>(t.c_tile) * t.d_tile + t.c_tile) * sizeof(float) +
         2 * kStatThreads * sizeof(int);
}

__global__ void __launch_bounds__(kStatThreads)
stats_partial_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ part_esum,
                     float* __restrict__ part_bins, int n, int c, int d,
                     StatTiles t) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int warp_counts[kStatWarps];

  const int head = blockIdx.z;
  const int split = blockIdx.y;
  const int c_idx = blockIdx.x / t.d_tiles;
  const int d_idx = blockIdx.x - c_idx * t.d_tiles;
  const int c0 = c_idx * t.c_tile;
  const int cn = min(t.c_tile, c - c0);
  const int j0 = d_idx * t.d_tile;
  const int dn = min(t.d_tile, d - j0);

  float* acc = smem;                                    // [cn][dn]
  float* bacc = acc + static_cast<size_t>(t.c_tile) * t.d_tile;  // [cn]
  int* list_tok = reinterpret_cast<int*>(bacc + t.c_tile);       // [256]
  int* list_code = list_tok + kStatThreads;                      // [256]

  x += static_cast<size_t>(head) * n * d + j0;
  idx += static_cast<size_t>(head) * n;
  if (w != nullptr) w += static_cast<size_t>(head) * n;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < cn * dn; i += kStatThreads) acc[i] = 0.f;
  for (int i = tid; i < cn; i += kStatThreads) bacc[i] = 0.f;

  const int t_begin = split * t.split_len;
  const int t_end = min(n, t_begin + t.split_len);

  for (int base = t_begin; base < t_end; base += kStatThreads) {
    // stable compaction of this chunk's tokens whose code is in the tile
    const int tok = base + tid;
    const int code = tok < t_end ? idx[tok] - c0 : -1;
    const bool mine = code >= 0 && code < cn;
    const unsigned ballot = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();  // also: every thread has finished the previous chunk
    int offset = 0, total = 0;
#pragma unroll
    for (int i = 0; i < kStatWarps; ++i) {
      offset += i < warp ? warp_counts[i] : 0;
      total += warp_counts[i];
    }
    if (mine) {
      const int pos = offset + __popc(ballot & ((1u << lane) - 1u));
      list_tok[pos] = tok;
      list_code[pos] = code;
    }
    __syncthreads();

    // warp `warp` owns the codes k with k % 8 == warp and adds their tokens
    // in list (= token) order; lane l owns dims l, l + 32, ...
    for (int i0 = 0; i0 < total; i0 += 32) {
      const int entry = i0 + lane;
      const bool take = entry < total && (list_code[entry] % kStatWarps) == warp;
      unsigned todo = __ballot_sync(0xffffffffu, take);
      while (todo) {
        int toks[kBatch];
        int codes[kBatch];
        int count = 0;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          toks[u] = 0;
          codes[u] = 0;
          if (todo) {
            const int b = __ffs(todo) - 1;
            todo &= todo - 1;
            toks[u] = list_tok[i0 + b];
            codes[u] = list_code[i0 + b];
            count = u + 1;
          }
        }
        // all loads of the batch first, then the adds in token order
        float v[kBatch][kMaxDTile / 32];
        float wt[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          wt[u] = (u < count && w != nullptr) ? w[toks[u]] : 1.f;
          const float* xr = x + static_cast<size_t>(toks[u]) * d;
#pragma unroll
          for (int m = 0; m < kMaxDTile / 32; ++m) {
            const int j = lane + 32 * m;
            v[u][m] = (u < count && j < dn) ? xr[j] : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < count) {
            float* ar = acc + static_cast<size_t>(codes[u]) * dn;
#pragma unroll
            for (int m = 0; m < kMaxDTile / 32; ++m) {
              const int j = lane + 32 * m;
              if (j < dn) ar[j] = __fadd_rn(ar[j], __fmul_rn(wt[u], v[u][m]));
            }
            if (lane == 0) bacc[codes[u]] = __fadd_rn(bacc[codes[u]], wt[u]);
          }
        }
      }
    }
  }
  __syncthreads();

  const size_t slot = static_cast<size_t>(head) * t.splits + split;
  float* pe = part_esum + (slot * c + c0) * d + j0;
  for (int i = tid; i < cn * dn; i += kStatThreads) {
    const int k = i / dn;
    const int j = i - k * dn;
    pe[static_cast<size_t>(k) * d + j] = acc[i];
  }
  if (d_idx == 0) {
    float* pb = part_bins + slot * c + c0;
    for (int i = tid; i < cn; i += kStatThreads) pb[i] = bacc[i];
  }
}

// esum[h][k][j] = sum over splits s, in order, of part_esum[h][s][k][j];
// bins likewise
__global__ void stats_merge_kernel(const float* __restrict__ part_esum,
                                   const float* __restrict__ part_bins,
                                   float* __restrict__ esum, float* __restrict__ bins,
                                   long long h, long long c, long long d, int splits) {
  const long long cd = c * d;
  const long long n_esum = h * cd;
  const long long total = n_esum + h * c;
  for (long long el = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       el < total; el += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    if (el < n_esum) {
      const long long head = el / cd;
      const float* p = part_esum + head * splits * cd + (el - head * cd);
      for (int i = 0; i < splits; ++i) s = __fadd_rn(s, p[i * cd]);
      esum[el] = s;
    } else {
      const long long b = el - n_esum;
      const long long head = b / c;
      const float* p = part_bins + head * splits * c + (b - head * c);
      for (int i = 0; i < splits; ++i) s = __fadd_rn(s, p[i * c]);
      bins[b] = s;
    }
  }
}

}  // namespace

extern "C" {

// Floats of scratch the wrapper must give vqtpu_train_fused_f32 for these
// sizes: the per-split partial sums of esum and bins.
long long vqtpu_train_fused_scratch_floats(long long h, long long n, long long c,
                                           long long d) {
  const StatTiles t = stat_tiles(h, n, c, d);
  return static_cast<long long>(t.splits) * h * c * (d + 1);
}

// x (h, n, d), e (h, c, d), bias (h, c) f32, w (h, n) f32 or null, and the
// outputs idx (h, n) int32, q (h, n, d), bins (h, c), esum (h, c, d) f32,
// scratch of vqtpu_train_fused_scratch_floats(h, n, c, d) floats; all
// contiguous on the current device. Enqueues the three passes on `stream`
// and returns the first nonzero cudaGetLastError(). Requires
// 1 <= h <= 65535, 1 <= n, c, d < 2^31 and c * d < 2^31 (checked by the
// Python wrapper).
int vqtpu_train_fused_f32(const float* x, const float* e, const float* bias, const float* w,
                          int32_t* idx, float* q, float* bins, float* esum, float* scratch,
                          long long h, long long n, long long c, long long d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = vqtpu::launch_select_codes<true>(x, e, bias, idx, q, h, n, c, d, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const StatTiles t = stat_tiles(h, n, c, d);
  const size_t smem = stat_smem_bytes(t);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(stats_partial_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* part_esum = scratch;
  float* part_bins = scratch + static_cast<size_t>(t.splits) * h * c * d;
  const dim3 grid(static_cast<unsigned>(t.c_tiles) * t.d_tiles,
                  static_cast<unsigned>(t.splits), static_cast<unsigned>(h));
  stats_partial_kernel<<<grid, kStatThreads, smem, s>>>(
      x, idx, w, part_esum, part_bins, static_cast<int>(n), static_cast<int>(c),
      static_cast<int>(d), t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long total = h * c * (d + 1);
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  stats_merge_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      part_esum, part_bins, esum, bins, h, c, d, t.splits);
  return static_cast<int>(cudaGetLastError());
}

const char* vqtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
