// First-index nearest-code selection on Hopper (sm_90a), f32: the tile
// shared by nearest_code.cu and train_fused.cu.
//
//   idx[h, t] = first argmax_j ( x[h, t, :] . e[h, j, :] + bias[h, j] )
//
// What bounds it: 2*n*c*d multiply-adds. At n = 2^20, c = 512, d = 256 that
// is 2.75e11 FLOP, about 4.1 ms at the H100 SXM's 67 TFLOP/s f32 peak
// (no tensor cores), against ~0.32 ms to read x once at 3.35 TB/s. The
// selection is compute-bound.
//
// What the design does about it: a register-blocked f32 FMA tile. Each
// block owns 128 tokens and loops over the codebook in 128-code tiles and
// over d in 16-deep stages, double-buffered through shared memory (the
// 512x256 f32 codebook, 512 KB, does not fit in a block's 227 KB, so the
// c-loop is the only design). Each of the 256 threads keeps an 8x8 tile of
// scores in registers and reads its operands from shared memory as float4,
// so a thread makes 4 shared loads per 64 FMAs. The score matrix never
// leaves registers: at the end of each c-tile a thread folds its 8 code
// columns into a per-token (best, index) carry, and one warp-shuffle
// reduction over the 16 threads that share a token ends the block.
//
// Tie rule (K3's, vqtpu/kernels/distance.py:178-194): a thread meets its
// code columns in increasing index order, across c-tiles too, and only a
// strict `>` replaces its carry; the cross-thread reduction takes the
// smaller index on equal scores. Together that is exactly the global
// first-index argmax.
//
// With kCopyRows the block then copies the winning codebook row of each of
// its tokens into q (h, n, d): a bit copy, so q rows equal codebook rows.
//
// Ragged n, c and d are masked in the kernel (zero-filled loads, masked
// code columns, unwritten token rows); no padded copies are made. The
// kernel allocates nothing and does not synchronise. A head dimension h is
// the grid's y axis: x (h, n, d), e (h, c, d), bias (h, c), idx (h, n),
// all contiguous.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vqtpu {

constexpr int kBlockTokens = 128;  // tokens per block
constexpr int kBlockCodes = 128;   // codes per c-tile
constexpr int kDepth = 16;         // d per shared-memory stage
constexpr int kThreads = 256;      // 16 x 16 threads, 8 x 8 scores each
constexpr int kLd = kBlockTokens + 4;  // padded row of a stage: 16-byte aligned
constexpr int kLoadRows = kThreads / kDepth;  // rows one loader pass covers
constexpr int kLoadsPerThread = kBlockTokens / kLoadRows;
constexpr int kStageFloats = kDepth * kLd;
// x and e stages, double-buffered
constexpr size_t kSelectSmemBytes = 2 * 2 * kStageFloats * sizeof(float);

static_assert(kBlockTokens == kBlockCodes, "x and e stages share one layout");
static_assert(kThreads % kDepth == 0, "loader mapping");
static_assert(kBlockTokens * sizeof(int) <= kSelectSmemBytes, "row-copy index list");

template <bool kCopyRows>
__global__ void __launch_bounds__(kThreads, 2)
select_codes_kernel(const float* __restrict__ x, const float* __restrict__ e,
                    const float* __restrict__ bias, int32_t* __restrict__ idx,
                    float* __restrict__ q, int n, int c, int d) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                     // [2][kDepth][kLd], transposed x
  float* es = smem + 2 * kStageFloats;  // [2][kDepth][kLd], transposed e

  const int head = blockIdx.y;
  x += static_cast<size_t>(head) * n * d;
  e += static_cast<size_t>(head) * c * d;
  bias += static_cast<size_t>(head) * c;
  idx += static_cast<size_t>(head) * n;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // code columns tx*4+{0..3}, 64+tx*4+{0..3}
  const int ty = tid / 16;  // token rows   ty*4+{0..3}, 64+ty*4+{0..3}
  const int row0 = blockIdx.x * kBlockTokens;

  // loader: element (row, k) of a stage, k = tid % kDepth, rows
  // tid / kDepth + kLoadRows * i; a warp reads two 64-byte row segments
  const int lk = tid % kDepth;
  const int lr = tid / kDepth;

  const int k_stages = (d + kDepth - 1) / kDepth;
  const int c_tiles = (c + kBlockCodes - 1) / kBlockCodes;
  const int steps = k_stages * c_tiles;

  float xr[kLoadsPerThread];
  float er[kLoadsPerThread];

  auto load = [&](int step) {
    const int code0 = (step / k_stages) * kBlockCodes;
    const int k = (step % k_stages) * kDepth + lk;
    const bool k_in = k < d;
#pragma unroll
    for (int i = 0; i < kLoadsPerThread; ++i) {
      const int r = lr + kLoadRows * i;
      const int tok = row0 + r;
      const int code = code0 + r;
      xr[i] = (k_in && tok < n) ? x[static_cast<size_t>(tok) * d + k] : 0.f;
      er[i] = (k_in && code < c) ? e[static_cast<size_t>(code) * d + k] : 0.f;
    }
  };
  auto store = [&](int buf) {
    float* xb = xs + buf * kStageFloats + lk * kLd;
    float* eb = es + buf * kStageFloats + lk * kLd;
#pragma unroll
    for (int i = 0; i < kLoadsPerThread; ++i) {
      xb[lr + kLoadRows * i] = xr[i];
      eb[lr + kLoadRows * i] = er[i];
    }
  };

  float acc[8][8];
  float best[8];
  int best_idx[8];  // -1: no code seen yet
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = 0.f;
    best_idx[i] = -1;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  if (steps > 0) {
    load(0);
    store(0);
  }
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    const bool has_next = step + 1 < steps;
    if (has_next) load(step + 1);  // global loads in flight during the FMAs

    const float* xb = xs + buf * kStageFloats;
    const float* eb = es + buf * kStageFloats;
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(xb + kk * kLd + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(xb + kk * kLd + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(eb + kk * kLd + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(eb + kk * kLd + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }

    // the other buffer was last read before the previous barrier
    if (has_next) store(buf ^ 1);
    __syncthreads();

    if ((step + 1) % k_stages == 0) {
      // end of a c-tile: fold the 8 columns, in increasing code order, into
      // the carry; only a strict improvement replaces it
      const int code0 = (step / k_stages) * kBlockCodes;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int code = code0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
        if (code < c) {
          const float bj = bias[code];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float s = acc[i][j] + bj;
            if (best_idx[i] < 0 || s > best[i]) {
              best[i] = s;
              best_idx[i] = code;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
  }

  // after the last step's barrier no thread reads the stages again, so the
  // row copy may keep its index list in their place
  int* block_idx = reinterpret_cast<int*>(smem);

  // the 16 threads that share a token row are lanes of one warp
  // (lane = tid % 32, tx = lane % 16): reduce over them, first index wins
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = best[i];
    int id = best_idx[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, id, off);
      const bool take = oi >= 0 && (id < 0 || ov > v || (ov == v && oi < id));
      if (take) {
        v = ov;
        id = oi;
      }
    }
    const int r = i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
    const int tok = row0 + r;
    if (tx == 0 && tok < n) idx[tok] = id;
    if (kCopyRows && tx == 0) block_idx[r] = id;
  }

  if constexpr (kCopyRows) {
    __syncthreads();
    q += static_cast<size_t>(head) * n * d;
    const int rows = min(kBlockTokens, n - row0);
    if ((d & 3) == 0) {
      // 16-byte rows: each thread copies float4s, neighbours on neighbours
      const int d4 = d >> 2;
      for (int el = tid; el < rows * d4; el += kThreads) {
        const int r = el / d4;
        const int j = el - r * d4;
        reinterpret_cast<float4*>(q + static_cast<size_t>(row0 + r) * d)[j] =
            reinterpret_cast<const float4*>(e + static_cast<size_t>(block_idx[r]) * d)[j];
      }
    } else {
      for (int el = tid; el < rows * d; el += kThreads) {
        const int r = el / d;
        const int j = el - r * d;
        q[static_cast<size_t>(row0 + r) * d + j] =
            e[static_cast<size_t>(block_idx[r]) * d + j];
      }
    }
  }
}

// Sets the dynamic shared memory of the selection kernel when it needs more
// than the default 48 KB and launches it on `stream`; returns
// cudaGetLastError().
template <bool kCopyRows>
inline cudaError_t launch_select_codes(const float* x, const float* e, const float* bias,
                                       int32_t* idx, float* q, long long h, long long n,
                                       long long c, long long d, cudaStream_t stream) {
  if (kSelectSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_codes_kernel<kCopyRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSelectSmemBytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>((n + kBlockTokens - 1) / kBlockTokens),
                  static_cast<unsigned>(h));
  select_codes_kernel<kCopyRows><<<grid, kThreads, kSelectSmemBytes, stream>>>(
      x, e, bias, idx, q, static_cast<int>(n), static_cast<int>(c), static_cast<int>(d));
  return cudaGetLastError();
}

}  // namespace vqtpu
