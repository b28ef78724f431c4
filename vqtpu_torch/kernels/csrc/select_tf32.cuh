// First-index nearest-code selection on Hopper's tensor cores (sm_90a):
// split-TF32 wgmma, f32 accuracy.
//
//   idx[h, t] = first argmax_j ( x[h, t, :] . e[h, j, :] + bias[h, j] )
//   q[h, t, :] = e[h, idx[h, t], :]          (optional, a bit copy)
//   best[h, t] = the score at idx[h, t]        (optional)
//
// What bounds it: 2*n*c*d multiply-adds, 2.75e11 FLOP at n = 2^20, c = 512,
// d = 256. Outside the tensor cores that is 4.1 ms at the H100 SXM's
// 67 TFLOP/s f32; the register-blocked f32 tile of select_codes.cuh took
// 7.4 ms. One TF32 product (10-bit mantissas) moves the winner at about
// 1e-4 of ||x||*||e||, far outside the 1e-5 near-tie rule. Three TF32
// products keep f32's accuracy: with x = xb + xs and e = eb + es, each piece
// a TF32 value (big by round-to-nearest, small = the rounded remainder),
//
//   x.e ~= xs.eb + xb.es + xb.eb
//
// (xs.es is below f32's rounding). 3 x 2.75e11 / 495 TFLOP/s dense TF32 is
// 1.67 ms, against 0.32 ms to read x once at 3.35 TB/s: still bound by
// operations, 2.5x below the f32 pipes' floor.
//
// What the design does about it:
//
// 1. A block owns 128 tokens: two consumer warpgroups of 64 token rows each
//    and one producer warpgroup. The codebook streams past in c-tiles of 256
//    codes and d-chunks of 32 dims. Each consumer warpgroup issues
//    wgmma.mma_async.m64n256k8.f32.tf32.tf32 with A (its 64 x 8 slice of x)
//    in registers and B (256 codes x 8 dims) in shared memory; the 64 x 256
//    f32 scores stay in registers (128 a thread). setmaxnreg moves the
//    producer's registers to the consumers (40 and 232 a thread): at the 168
//    a launch of 384 threads gives every thread, the consumers spill and
//    ptxas serializes the wgmmas.
// 2. The codebook is split once per call by a small pre-pass
//    (pack_codebook_tf32_kernel) into eb and es, written in the exact
//    shared-memory image wgmma reads: per (c-tile, d-chunk) one contiguous
//    64 KB stage, eb then es, each 256 rows of 128 bytes in the 128-byte
//    swizzle (16-byte chunk c of row r stored at chunk c ^ (r % 8)), zero
//    past c and d. One producer thread copies a stage with two TMA bulk copies
//    (cp.async.bulk, completion on an mbarrier) into a ring of 3 stages;
//    consumers release a stage through a second mbarrier.
// 3. x is 1 GiB at the main shape and is split on the fly, never stored:
//    wgmma takes A from registers, so each consumer thread loads its
//    fragment straight from device memory (two rows, 8 consecutive floats
//    each per d-chunk, as two float4: a quad of lanes reads 128 contiguous
//    bytes of a row), one chunk ahead of the tensor cores, and splits it
//    with cvt.rna.tf32.f32 in registers. The fragment's k order is permuted
//    within a chunk so that those loads are contiguous: step j's column q
//    (q < 4) is dim 8q + 2j and column q + 4 is dim 8q + 2j + 1; the
//    pre-pass lays the codebook out in the same order. No TMA tensor map, so
//    no 16-byte stride rule: d = 30 or d = 3 take a scalar-load variant of
//    the same kernel (kVec = false), never a padded copy of x.
// 4. Per k8 step a warpgroup issues xs.eb, xb.es, then xb.eb into one
//    accumulator (the first of a c-tile with scale-d = 0), commits the
//    chunk's 12 products as one group and waits for it before it releases
//    the stage; the other warpgroup's products keep the tensor cores busy
//    meanwhile.
//
// Tie rule (K3's, vqtpu/kernels/distance.py:178-194): the accumulator of
// thread (warp w, lane l) holds rows 16w + l/4 (+8) and, per n8 block i,
// columns 8i + 2(l%4) and +1. A thread folds its columns in increasing code
// order, c-tiles in increasing order too, and only a strict `>` replaces its
// carry; the four lanes that share a row (a quad) then reduce with the
// smaller index winning on equal scores. Duplicated codebook rows get the
// same split and the same products in the same order, so they score
// bit-equal and the first copy wins.
//
// The winning score is the carry the quad reduction ends with: the f32 sum
// of the three TF32 products and the bias, as the argmax compared it. With
// a non-null `best` the kernel writes it beside idx (n floats more). A
// column's score does not depend on the column's position in its tile or
// on c: the pre-pass splits each code alone, and its products and their
// order are the same wherever the code sits. So the scores of a codebook's
// row blocks, each selected alone, are the unsharded scores, and a
// row-sharded selection reduces the shards' (best, index) pairs without
// scoring again (the JAX package's sharded_nearest_code, K1 per shard).
//
// With kCopyRows the block then copies each token's winning row of the
// original f32 codebook (not eb + es) into q: rows stay bit-equal to
// codebook rows, and the separate row lookup is gone.
//
// Ragged n, c and d are masked (zero x loads, zero codebook padding, code
// columns >= c never fold, rows >= n never written). The kernel allocates
// nothing and does not synchronise; the caller provides the packed
// codebook's scratch. A head dimension h is the grid's y axis: x (h, n, d),
// e (h, c, d), bias (h, c), idx (h, n), q (h, n, d), all contiguous.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vqtpu {

constexpr int kTcTokens = 128;     // tokens per block (two warpgroups of 64)
constexpr int kTcCodes = 256;      // codes per c-tile (the wgmma N)
constexpr int kTcDepth = 32;       // dims per d-chunk: one 128-byte swizzled row
constexpr int kTcStages = 3;       // codebook stages in flight
constexpr int kTcConsumers = 256;  // two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 128;  // and one producer warpgroup
// registers a thread after setmaxnreg: the producer gives its share to the
// consumers (128 x 40 + 256 x 232 <= 65,536, and per SM quarter one warp
// of each warpgroup: 32 x (40 + 2 x 232) <= 16,384)
constexpr int kTcProducerRegs = 40;
constexpr int kTcConsumerRegs = 232;
constexpr int kTcPartFloats = kTcCodes * kTcDepth;     // eb or es of one stage
constexpr int kTcStageFloats = 2 * kTcPartFloats;      // 64 KB
constexpr uint32_t kTcPartBytes = kTcPartFloats * sizeof(float);
constexpr size_t kTcSmemBytes = 1024 /* alignment slack */ +
                                kTcStages * kTcStageFloats * sizeof(float) +
                                2 * kTcStages * sizeof(uint64_t) + kTcTokens * sizeof(int);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// spins until the phase of `bar` with the given parity has completed; the
// loop lives inside the asm block, so the warp never diverges around it
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled operand:
// start address, stride 1024 bytes between groups of 8 rows, swizzle mode 1
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// d (64 x 256 f32, 128 a thread) = a (64 x 8 tf32, registers) x b (256 x 8
// tf32, shared memory) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_m64n256k8_tf32(float (&d)[128], const uint32_t (&a)[4],
                                                     uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate));
}

// Dim of position p (0..31) of a packed d-chunk row: k8 step j = p / 8,
// column q = p % 8; columns 0-3 take the even dims 8q + 2j, columns 4-7 the
// odd dims 8(q - 4) + 2j + 1 (the order a thread's fragment loads in).
__host__ __device__ __forceinline__ int packed_dim(int p) {
  const int j = p >> 3;
  const int q = p & 7;
  return q < 4 ? 8 * q + 2 * j : 8 * (q - 4) + 2 * j + 1;
}

// eb and es of e (h, c, d) in the shared-memory image of the selection
// kernel: [h][c-tile][d-chunk][eb | es][256 rows][32 floats, swizzled]
__global__ void pack_codebook_tf32_kernel(const float* __restrict__ e, float* __restrict__ packed,
                                          int c, int d, int c_tiles, int k_chunks, long long total) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int f = static_cast<int>(i % kTcDepth);
    long long rest = i / kTcDepth;
    const int row = static_cast<int>(rest % kTcCodes);
    rest /= kTcCodes;
    const int part = static_cast<int>(rest % 2);
    rest /= 2;
    const int kc = static_cast<int>(rest % k_chunks);
    rest /= k_chunks;
    const int ct = static_cast<int>(rest % c_tiles);
    const long long head = rest / c_tiles;
    const int logical = (((f >> 2) ^ (row & 7)) << 2) | (f & 3);
    const int dim = kc * kTcDepth + packed_dim(logical);
    const int code = ct * kTcCodes + row;
    const float v = (code < c && dim < d) ? e[(head * c + code) * d + dim] : 0.f;
    const uint32_t big = tf32_rna(v);
    const uint32_t small = tf32_rna(__fsub_rn(v, __uint_as_float(big)));
    packed[i] = __uint_as_float(part ? small : big);
  }
}

// one thread's x for a d-chunk: rows r and r + 8, dims k0 + 8q .. k0 + 8q + 7
template <bool kVec>
__device__ __forceinline__ void load_x_chunk(float (&xr)[16], const float* __restrict__ x, int row, int n,
                                             int d, int k0) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row + 8 * rr;
    const float* src = x + static_cast<size_t>(r) * d;
    if constexpr (kVec) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = k0 + 4 * hh;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < n && p < d) v = __ldg(reinterpret_cast<const float4*>(src + p));
        xr[8 * rr + 4 * hh] = v.x;
        xr[8 * rr + 4 * hh + 1] = v.y;
        xr[8 * rr + 4 * hh + 2] = v.z;
        xr[8 * rr + 4 * hh + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) xr[8 * rr + i] = (r < n && k0 + i < d) ? __ldg(src + k0 + i) : 0.f;
    }
  }
}

template <bool kVec, bool kCopyRows>
__global__ void __launch_bounds__(kTcThreads, 1)
select_tf32_kernel(const float* __restrict__ x, const float* __restrict__ packed,
                   const float* __restrict__ e, const float* __restrict__ bias,
                   int32_t* __restrict__ idx, float* __restrict__ q, float* __restrict__ best_out, int n,
                   int c, int d, int c_tiles, int k_chunks) {
  extern __shared__ uint8_t smem_raw[];
  float* stages = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kTcStages * kTcStageFloats);
  uint64_t* empty = full + kTcStages;
  int* block_idx = reinterpret_cast<int*>(empty + kTcStages);

  const int head = blockIdx.y;
  const int steps = c_tiles * k_chunks;
  const int row0 = blockIdx.x * kTcTokens;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {
    // producer warpgroup: one thread keeps the ring of codebook stages full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kTcProducerRegs));
    if (threadIdx.x == kTcConsumers) {
      const float* src = packed + static_cast<size_t>(head) * steps * kTcStageFloats;
      for (int it = 0; it < steps; ++it) {
        const int s = it % kTcStages;
        if (it >= kTcStages) mbar_wait(&empty[s], ((it / kTcStages) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kTcPartBytes);
        float* dst = stages + s * kTcStageFloats;
        const float* from = src + static_cast<size_t>(it) * kTcStageFloats;
        bulk_copy(dst, from, kTcPartBytes, &full[s]);
        bulk_copy(dst + kTcPartFloats, from + kTcPartFloats, kTcPartBytes, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns token rows 64 wg .. 64 wg + 63 of the block
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kTcConsumerRegs));
  x += static_cast<size_t>(head) * n * d;
  bias += static_cast<size_t>(head) * c;
  idx += static_cast<size_t>(head) * n;
  if (best_out != nullptr) best_out += static_cast<size_t>(head) * n;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int quad_row = lane >> 2;  // row within the warp's 16 (and +8)
  const int tq = lane & 3;         // position in the quad
  const int local = wg * 64 + warp * 16 + quad_row;
  const int row = row0 + local;

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float best[2] = {0.f, 0.f};
  int best_idx[2] = {-1, -1};  // -1: no code seen yet

  float xa[16];
  float xn[16];
  load_x_chunk<kVec>(xa, x, row, n, d, 8 * tq);

  for (int ct = 0; ct < c_tiles; ++ct) {
    for (int kc = 0; kc < k_chunks; ++kc) {
      const int it = ct * k_chunks + kc;
      const int s = it % kTcStages;
      // the next chunk's x is in flight while this one multiplies
      const bool reload = k_chunks > 1 && it + 1 < steps;
      if (reload) {
        const int next = kc + 1 == k_chunks ? 0 : kc + 1;
        load_x_chunk<kVec>(xn, x, row, n, d, next * kTcDepth + 8 * tq);
      }
      // split: step j's fragment is (row, col q) = dim 8q + 2j, (row + 8, q),
      // (row, q + 4) = dim 8q + 2j + 1, (row + 8, q + 4)
      uint32_t ab[4][4];
      uint32_t as[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v[4] = {xa[2 * j], xa[8 + 2 * j], xa[2 * j + 1], xa[8 + 2 * j + 1]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ab[j][r] = tf32_rna(v[r]);
          as[j][r] = tf32_rna(__fsub_rn(v[r], __uint_as_float(ab[j][r])));
        }
      }
      mbar_wait(&full[s], (it / kTcStages) & 1);
      const float* eb = stages + s * kTcStageFloats;
      const float* es = eb + kTcPartFloats;
#pragma unroll
      for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // step j reads bytes 32j .. 32j + 31 of each 128-byte row
        const uint64_t db = sw128_desc(eb + 8 * j);
        const uint64_t ds = sw128_desc(es + 8 * j);
        wgmma_m64n256k8_tf32(acc, as[j], db, kc > 0 || j > 0);
        wgmma_m64n256k8_tf32(acc, ab[j], ds, 1);
        wgmma_m64n256k8_tf32(acc, ab[j], db, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          fence_operand(ab[j][r]);
          fence_operand(as[j][r]);
        }
      mbar_arrive(&empty[s]);
      if (reload) {
#pragma unroll
        for (int i = 0; i < 16; ++i) xa[i] = xn[i];
      }
    }

    // end of a c-tile: fold the columns, in increasing code order, into the
    // carry; only a strict improvement replaces it
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int code = ct * kTcCodes + 8 * i + 2 * tq;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        if (code + cc < c) {
          const float bj = bias[code + cc];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float sc = acc[4 * i + 2 * rr + cc] + bj;
            if (best_idx[rr] < 0 || sc > best[rr]) {
              best[rr] = sc;
              best_idx[rr] = code + cc;
            }
          }
        }
      }
    }
  }

  // the four lanes of a quad share a row: reduce over them, first index wins
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float v = best[rr];
    int id = best_idx[rr];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, id, off);
      const bool take = oi >= 0 && (id < 0 || ov > v || (ov == v && oi < id));
      if (take) {
        v = ov;
        id = oi;
      }
    }
    const int r = row + 8 * rr;
    if (tq == 0 && r < n) {
      idx[r] = id;
      if (best_out != nullptr) best_out[r] = v;
    }
    if (kCopyRows && tq == 0) block_idx[local + 8 * rr] = id;
  }

  if constexpr (kCopyRows) {
    // the consumers only: the producer warpgroup has left
    asm volatile("bar.sync 1, %0;" ::"n"(kTcConsumers) : "memory");
    e += static_cast<size_t>(head) * c * d;
    q += static_cast<size_t>(head) * n * d;
    const int rows = min(kTcTokens, n - row0);
    const int tid = threadIdx.x;
    if constexpr (kVec) {
      // 16-byte rows: each thread copies float4s, neighbours on neighbours
      const int d4 = d >> 2;
      for (int el = tid; el < rows * d4; el += kTcConsumers) {
        const int r = el / d4;
        const int j = el - r * d4;
        reinterpret_cast<float4*>(q + static_cast<size_t>(row0 + r) * d)[j] =
            reinterpret_cast<const float4*>(e + static_cast<size_t>(block_idx[r]) * d)[j];
      }
    } else {
      for (int el = tid; el < rows * d; el += kTcConsumers) {
        const int r = el / d;
        const int j = el - r * d;
        q[static_cast<size_t>(row0 + r) * d + j] = e[static_cast<size_t>(block_idx[r]) * d + j];
      }
    }
  }
}

// Floats of packed-codebook scratch the selection needs for (h, c, d).
inline long long select_tf32_scratch_floats(long long h, long long c, long long d) {
  const long long c_tiles = (c + kTcCodes - 1) / kTcCodes;
  const long long k_chunks = (d + kTcDepth - 1) / kTcDepth;
  return h * c_tiles * k_chunks * kTcStageFloats;
}

template <bool kVec, bool kCopyRows>
inline cudaError_t launch_select_tf32_kernel(const float* x, const float* packed, const float* e,
                                             const float* bias, int32_t* idx, float* q, float* best,
                                             long long h, long long n, long long c, long long d,
                                             int c_tiles, int k_chunks, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(select_tf32_kernel<kVec, kCopyRows>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(kTcSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((n + kTcTokens - 1) / kTcTokens), static_cast<unsigned>(h));
  select_tf32_kernel<kVec, kCopyRows><<<grid, kTcThreads, kTcSmemBytes, stream>>>(
      x, packed, e, bias, idx, q, best, static_cast<int>(n), static_cast<int>(c), static_cast<int>(d),
      c_tiles, k_chunks);
  return cudaGetLastError();
}

// Splits the codebook into `packed` (select_tf32_scratch_floats floats,
// 16-byte aligned), then runs the selection (and the row copy when q is not
// null, the winning scores into `best` (h, n) when it is not null) on
// `stream`; returns the first nonzero cudaGetLastError().
inline cudaError_t launch_select_tf32(const float* x, const float* e, const float* bias, float* packed,
                                      int32_t* idx, float* q, float* best, long long h, long long n,
                                      long long c, long long d, cudaStream_t stream) {
  const int c_tiles = static_cast<int>((c + kTcCodes - 1) / kTcCodes);
  const int k_chunks = static_cast<int>((d + kTcDepth - 1) / kTcDepth);
  const long long total = select_tf32_scratch_floats(h, c, d);
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  pack_codebook_tf32_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      e, packed, static_cast<int>(c), static_cast<int>(d), c_tiles, k_chunks, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // float4 loads and copies need 16-byte rows and 16-byte aligned bases
  const bool vec = (d % 4) == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(e) % 16) == 0 &&
                   (q == nullptr || (reinterpret_cast<uintptr_t>(q) % 16) == 0);
  if (q != nullptr) {
    return vec ? launch_select_tf32_kernel<true, true>(x, packed, e, bias, idx, q, best, h, n, c, d, c_tiles,
                                                       k_chunks, stream)
               : launch_select_tf32_kernel<false, true>(x, packed, e, bias, idx, q, best, h, n, c, d,
                                                        c_tiles, k_chunks, stream);
  }
  return vec ? launch_select_tf32_kernel<true, false>(x, packed, e, bias, idx, q, best, h, n, c, d, c_tiles,
                                                      k_chunks, stream)
             : launch_select_tf32_kernel<false, false>(x, packed, e, bias, idx, q, best, h, n, c, d, c_tiles,
                                                       k_chunks, stream);
}

}  // namespace vqtpu
