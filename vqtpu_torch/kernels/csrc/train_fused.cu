// The fused VQ training step on Hopper (sm_90a), f32 accuracy: selection,
// the exact codebook-row lookup and the EMA batch statistics in one call.
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
// What bounds it: the selection's 2*n*c*d multiply-adds at f32 accuracy,
// three TF32 products on the tensor cores (1.67 ms at n = 2^20, c = 512,
// d = 256 on the H100 SXM's 495 TFLOP/s dense TF32; 4.1 ms for the same
// work on the 67 TFLOP/s f32 pipes), against about 0.64 ms to read x once
// and write q once at 3.35 TB/s. The statistics are a pass over x that
// costs bytes, not operations: one read of x, 0.32 ms.
//
// What the design does about it:
//
// 1. The selection is the nearest-code kernel's own: the split-TF32 wgmma
//    tile of select_tf32.cuh with its codebook pre-pass and its row-copy
//    epilogue, launched on the same operands as nearest_code.cu launches it.
//    So the indices equal nearest_code's bit for bit, and q rows are bit
//    copies of the f32 codebook. The one-hot of the TPU kernel is never
//    formed.
// 2. The statistics sort the tokens by code and sum fixed-length pieces of
//    each code's token list, so that no warp's work grows with the largest
//    cluster (the split statistics this replaced gave all of a code's
//    tokens of a split to one warp). Blocks run in parallel and in no order
//    on Hopper and nothing carries a sum from one to the next, so each pass
//    is a kernel of its own:
//    a. sort_split_kernel: the tokens go in splits of at least 2048; a block
//       sorts its split's indices 2048 at a time in shared memory (a
//       bitonic sort of code << 11 | position, so equal codes keep token
//       order), and writes the sorted token ids, each one's rank among its
//       code's tokens of the split, and the split's count of each code.
//    b. row_scan_kernel: one warp per code scans its counts over the splits:
//       where the code's tokens of each split start in its sorted list.
//    c. code_scan_kernel: one block per head scans the codes' totals: where
//       each code's list starts, and where its pieces of kSegTokens start.
//    d. scatter_kernel: every token id to its place in the sorted list, by
//       code and, within a code, by token order (a stable counting sort).
//    e. segment_sum_kernel: one warp per piece of at most 64 tokens of one
//       code sums w x over them in token order, reading whole rows (each
//       lane 8 dims of 256, as two float4, 8 rows in flight); it writes the
//       piece's partial row and weight. This pass reads x once: it is the
//       statistics' time.
//    f. segment_merge_kernel adds each code's pieces in order into esum and
//       bins.
//
// So bins and esum are deterministic: two calls on the same inputs give
// bit-identical outputs, and no float atomic is used. Every sum is in token
// order, rounded per piece of 64 tokens and then piece by piece: its order
// is fixed by the shapes and the indices, and may differ from the plain
// version's. Ragged n, c and d are masked in the kernels; no padded copy of
// x is made.
//
// vqtpu_train_fused_f32_simt is the step this one replaced: the
// register-blocked f32 FMA tile of select_codes.cuh with its row copy, then
// the split statistics (stats_partial_kernel, stats_merge_kernel). It stays
// as a same-run yardstick, and vqtpu_train_fused_stage runs one pass of
// either on its own for timing; no path of the port calls them.

#include <type_traits>

#include "select_codes.cuh"
#include "select_tf32.cuh"

namespace {

// ---- the replaced split statistics (the yardstick's) -----------------------
//
// Over a grid of (code tile, d tile, token split): each block owns the
// accumulator of its code tile x d tile in shared memory (at most 64 KB) and
// scans the indices of its token split. In chunks of 256 tokens it compacts,
// stably, the tokens whose code lies in its tile, and warp k % 8 adds the
// tokens of code k, in token order, into row k. The block writes its partial
// sums to scratch, and stats_merge_kernel sums them in split order.

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

// ---- the statistics by sorted code -----------------------------------------

constexpr int kSortTokens = 2048;   // tokens a block sorts at a time
constexpr int kSortShift = 11;      // log2(kSortTokens): the position bits of a key
constexpr int kSortThreads = kSortTokens / 2;  // one compare-exchange a thread a stage
constexpr int kSegTokens = 64;      // tokens of a piece, at most
constexpr int kSegWarps = 8;        // pieces a block
constexpr int kSegDims = 256;       // dims a warp sums: 8 a lane
constexpr long long kMaxCountInts = 1LL << 26;  // (code, split) counts: 256 MB at most

struct SortPlan {
  int splits;          // token splits
  int split_len;       // tokens a split
  long long max_segs;  // pieces a head, at most: ceil(n / kSegTokens) + c
};

SortPlan sort_plan(long long h, long long n, long long c) {
  SortPlan p;
  long long splits = (n + kSortTokens - 1) / kSortTokens;
  const long long by_memory = kMaxCountInts / (h * c);
  if (splits > by_memory) splits = by_memory;
  if (splits < 1) splits = 1;
  p.splits = static_cast<int>(splits);
  p.split_len = static_cast<int>((n + splits - 1) / splits);
  p.max_segs = (n + kSegTokens - 1) / kSegTokens + c;
  return p;
}

// offsets, in floats, of the statistics' arrays in the scratch (int arrays
// share the float buffer)
struct SortLayout {
  size_t cnt, off, tot, code_start, seg_start, sorted_local, rank_local, sorted, part, part_bins, floats;
};

SortLayout sort_layout(long long h, long long n, long long c, long long d, const SortPlan& p) {
  SortLayout l;
  size_t at = 0;
  const size_t counts = static_cast<size_t>(h) * c * p.splits;
  l.cnt = at;          at += counts;
  l.off = at;          at += counts;
  l.tot = at;          at += static_cast<size_t>(h) * c;
  l.code_start = at;   at += static_cast<size_t>(h) * (c + 1);
  l.seg_start = at;    at += static_cast<size_t>(h) * (c + 1);
  l.sorted_local = at; at += static_cast<size_t>(h) * n;
  l.rank_local = at;   at += static_cast<size_t>(h) * n;
  l.sorted = at;       at += static_cast<size_t>(h) * n;
  l.part = at;         at += static_cast<size_t>(h) * p.max_segs * d;
  l.part_bins = at;    at += static_cast<size_t>(h) * p.max_segs;
  l.floats = at;
  return l;
}

// a. per split: the tokens sorted by code (stable), each one's rank among
// its code's tokens of the split, and the split's count of each code;
// cnt[h][k][split] must be zero on entry
__global__ void __launch_bounds__(kSortThreads)
sort_split_kernel(const int32_t* __restrict__ idx, int* __restrict__ cnt, int* __restrict__ sorted_local,
                  int* __restrict__ rank_local, int n, int c, SortPlan p) {
  __shared__ unsigned long long keys[kSortTokens];
  const int head = blockIdx.y;
  const int split = blockIdx.x;
  idx += static_cast<size_t>(head) * n;
  cnt += static_cast<size_t>(head) * c * p.splits;
  sorted_local += static_cast<size_t>(head) * n;
  rank_local += static_cast<size_t>(head) * n;
  const int tid = threadIdx.x;
  const int begin = split * p.split_len;
  const int end = min(n, begin + p.split_len);
  for (int sub = begin; sub < end; sub += kSortTokens) {
    const int len = min(kSortTokens, end - sub);
    for (int i = tid; i < kSortTokens; i += kSortThreads) {
      keys[i] = i < len ? (static_cast<unsigned long long>(idx[sub + i]) << kSortShift) | i : ~0ull;
    }
    __syncthreads();
    // bitonic sort, ascending: the positions break every tie, so the order
    // is the stable one
    for (int k = 2; k <= kSortTokens; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        const int i = 2 * tid - (tid & (j - 1));
        const unsigned long long a = keys[i];
        const unsigned long long b = keys[i + j];
        if ((a > b) == ((i & k) == 0)) {
          keys[i] = b;
          keys[i + j] = a;
        }
        __syncthreads();
      }
    }
    int run_end[2] = {-1, -1};
    int code_of[2] = {0, 0};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * kSortThreads;
      if (i < len) {
        const unsigned long long key = keys[i];
        const int code = static_cast<int>(key >> kSortShift);
        // the code's first sorted position: the lower bound of code << 11
        const unsigned long long first = static_cast<unsigned long long>(code) << kSortShift;
        int lo = 0, hi = i;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (keys[mid] < first) lo = mid + 1; else hi = mid;
        }
        // the code's tokens in the split's earlier chunks come first
        const int before = cnt[static_cast<size_t>(code) * p.splits + split];
        sorted_local[sub + i] = sub + static_cast<int>(key & (kSortTokens - 1));
        rank_local[sub + i] = before + i - lo;
        code_of[e] = code;
        if (i + 1 == len || (keys[i + 1] >> kSortShift) != static_cast<unsigned long long>(code)) {
          run_end[e] = before + i - lo + 1;
        }
      }
    }
    __syncthreads();  // every count is read before the run ends write it
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (run_end[e] >= 0) cnt[static_cast<size_t>(code_of[e]) * p.splits + split] = run_end[e];
    }
    __syncthreads();  // the counts are visible, and the keys free, for the next chunk
  }
}

// b. one warp per code: off[h][k][s] = sum of cnt[h][k][s'] for s' < s, and
// tot[h][k] the code's total
__global__ void row_scan_kernel(const int* __restrict__ cnt, int* __restrict__ off, int* __restrict__ tot,
                                int c, int splits) {
  const int lane = threadIdx.x % 32;
  const int code = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (code >= c) return;
  const size_t row = (static_cast<size_t>(blockIdx.y) * c + code) * splits;
  int carry = 0;
  for (int s0 = 0; s0 < splits; s0 += 32) {
    const int s = s0 + lane;
    const int v = s < splits ? cnt[row + s] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (s < splits) off[row + s] = carry + incl - v;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) tot[static_cast<size_t>(blockIdx.y) * c + code] = carry;
}

// exclusive scan of one int a thread over a block of 1024; *total gets the sum
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int ws = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, ws, o);
      if (lane >= o) ws += u;
    }
    warp_sums[lane] = ws;
  }
  __syncthreads();
  const int out = (warp > 0 ? warp_sums[warp - 1] : 0) + incl - v;
  *total = warp_sums[31];
  __syncthreads();  // warp_sums is free again
  return out;
}

constexpr int kScanThreads = 1024;

// c. one block per head: code_start[h][k] (where code k's tokens start in the
// sorted list, n at k = c) and seg_start[h][k] (where its pieces start)
__global__ void __launch_bounds__(kScanThreads)
code_scan_kernel(const int* __restrict__ tot, int* __restrict__ code_start, int* __restrict__ seg_start,
                 int n, int c) {
  const size_t head = blockIdx.x;
  tot += head * c;
  code_start += head * (c + 1);
  seg_start += head * (c + 1);
  const int chunk = (c + kScanThreads - 1) / kScanThreads;
  const int k0 = min(c, static_cast<int>(threadIdx.x) * chunk);
  const int k1 = min(c, k0 + chunk);
  int tokens = 0, segs = 0;
  for (int k = k0; k < k1; ++k) {
    tokens += tot[k];
    segs += (tot[k] + kSegTokens - 1) / kSegTokens;
  }
  int tokens_total, segs_total;
  int t_at = block_exclusive_scan(tokens, &tokens_total);
  int s_at = block_exclusive_scan(segs, &segs_total);
  for (int k = k0; k < k1; ++k) {
    code_start[k] = t_at;
    seg_start[k] = s_at;
    t_at += tot[k];
    s_at += (tot[k] + kSegTokens - 1) / kSegTokens;
  }
  if (threadIdx.x == 0) {
    code_start[c] = n;
    seg_start[c] = segs_total;
  }
}

// d. every token id to its place: code k's list, then its split, then its rank
__global__ void scatter_kernel(const int32_t* __restrict__ idx, const int* __restrict__ off,
                               const int* __restrict__ code_start, const int* __restrict__ sorted_local,
                               const int* __restrict__ rank_local, int* __restrict__ sorted, int n, int c,
                               SortPlan p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t head = blockIdx.y;
  const int tok = sorted_local[head * n + i];
  const int code = idx[head * n + tok];
  const int at = code_start[head * (c + 1) + code] +
                 off[(head * c + code) * p.splits + i / p.split_len] + rank_local[head * n + i];
  sorted[head * n + at] = tok;
}

__device__ __forceinline__ float component(float v, int) { return v; }
__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// e. one warp per piece: the sum of w x over at most 64 tokens of one code,
// in token order, for 256 dims (8 a lane); grid (pieces / 8, d tiles, h).
// kVec (d a multiple of 4, 16-byte aligned x): each lane loads two float4
// of a row and a warp keeps 8 rows in flight; otherwise 8 floats and 4 rows.
// Either way each dim's sum is the same chain of FMAs in token order.
template <bool kVec>
__global__ void __launch_bounds__(kSegWarps * 32, 2)
segment_sum_kernel(const float* __restrict__ x, const float* __restrict__ w, const int* __restrict__ sorted,
                   const int* __restrict__ code_start, const int* __restrict__ seg_start,
                   float* __restrict__ part, float* __restrict__ part_bins, int n, int c, int d,
                   long long max_segs) {
  constexpr int kRows = kVec ? 8 : 4;        // rows a warp has in flight
  constexpr int kLoads = kVec ? 2 : 8;       // loads a lane a row
  constexpr int kWidth = kVec ? 4 : 1;       // floats a load
  using Load = typename std::conditional<kVec, float4, float>::type;
  const size_t head = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const long long seg = static_cast<long long>(blockIdx.x) * kSegWarps + threadIdx.x / 32;
  code_start += head * (c + 1);
  seg_start += head * (c + 1);
  if (seg >= seg_start[c]) return;
  // the piece's code: the last k with seg_start[k] <= seg (codes without
  // tokens have no pieces)
  int lo = 0, hi = c - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (seg_start[mid] <= seg) lo = mid; else hi = mid - 1;
  }
  const int a = code_start[lo] + static_cast<int>(seg - seg_start[lo]) * kSegTokens;
  const int len = min(kSegTokens, code_start[lo + 1] - a);
  const int j0 = blockIdx.y * kSegDims;
  const float* xs = x + head * n * d + j0;
  sorted += head * n;
  if (w != nullptr) w += head * n;
  // the piece's token ids and weights, two a lane
  int toks[2];
  float wts[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = lane + 32 * r;
    toks[r] = e < len ? sorted[a + e] : 0;
    wts[r] = e < len ? (w != nullptr ? w[toks[r]] : 1.f) : 0.f;
  }
  // dims j0 + kWidth * lane + 32 kWidth m .. + kWidth - 1 of load m
  float acc[kLoads * kWidth];
#pragma unroll
  for (int i = 0; i < kLoads * kWidth; ++i) acc[i] = 0.f;
  float wsum = 0.f;
  for (int t0 = 0; t0 < len; t0 += kRows) {
    // the rows' loads first, then their adds in token order
    Load v[kRows][kLoads];
    float wt[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int e = t0 + u;
      const int tok = __shfl_sync(0xffffffffu, e < 32 ? toks[0] : toks[1], e & 31);
      wt[u] = __shfl_sync(0xffffffffu, e < 32 ? wts[0] : wts[1], e & 31);
      const Load* row = reinterpret_cast<const Load*>(xs + static_cast<size_t>(tok) * d);
#pragma unroll
      for (int m = 0; m < kLoads; ++m) {
        const int j = kWidth * (lane + 32 * m);
        if (e < len && j0 + j < d) {
          v[u][m] = __ldg(row + lane + 32 * m);
        } else {
          v[u][m] = Load{};
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (t0 + u < len) {
#pragma unroll
        for (int m = 0; m < kLoads; ++m) {
#pragma unroll
          for (int i = 0; i < kWidth; ++i) {
            acc[kWidth * m + i] = fmaf(wt[u], component(v[u][m], i), acc[kWidth * m + i]);
          }
        }
        wsum = __fadd_rn(wsum, wt[u]);
      }
    }
  }
  float* out = part + (head * max_segs + seg) * d + j0;
#pragma unroll
  for (int m = 0; m < kLoads; ++m) {
    const int j = kWidth * (lane + 32 * m);
#pragma unroll
    for (int i = 0; i < kWidth; ++i) {
      if (j0 + j + i < d) out[j + i] = acc[kWidth * m + i];
    }
  }
  if (blockIdx.y == 0 && lane == 0) part_bins[head * max_segs + seg] = wsum;
}

// f. esum[h][k][j] = the sum over code k's pieces, in order, of their
// partial rows; bins likewise of their weights
__global__ void segment_merge_kernel(const float* __restrict__ part, const float* __restrict__ part_bins,
                                     const int* __restrict__ seg_start, float* __restrict__ esum,
                                     float* __restrict__ bins, long long h, long long c, long long d,
                                     long long max_segs) {
  const long long cd = c * d;
  const long long n_esum = h * cd;
  const long long total = n_esum + h * c;
  for (long long el = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; el < total;
       el += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    if (el < n_esum) {
      const long long head = el / cd;
      const long long k = (el - head * cd) / d;
      const long long j = el - head * cd - k * d;
      const int* ss = seg_start + head * (c + 1) + k;
      const float* p = part + head * max_segs * d + j;
      for (long long g = ss[0]; g < ss[1]; ++g) s = __fadd_rn(s, p[g * d]);
      esum[el] = s;
    } else {
      const long long b = el - n_esum;
      const long long head = b / c;
      const int* ss = seg_start + head * (c + 1) + (b - head * c);
      const float* p = part_bins + head * max_segs;
      for (long long g = ss[0]; g < ss[1]; ++g) s = __fadd_rn(s, p[g]);
      bins[b] = s;
    }
  }
}

unsigned grid_stride_blocks(long long count) {
  long long blocks = (count + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// the statistics by sorted code; `passes` picks a (bit 0, with the counts'
// zeroing) .. f (bit 5)
int launch_sorted_stats(const float* x, const int32_t* idx, const float* w, float* bins, float* esum,
                        float* scratch, long long h, long long n, long long c, long long d, cudaStream_t s,
                        int passes) {
  const SortPlan p = sort_plan(h, n, c);
  const SortLayout l = sort_layout(h, n, c, d, p);
  int* cnt = reinterpret_cast<int*>(scratch + l.cnt);
  int* off = reinterpret_cast<int*>(scratch + l.off);
  int* tot = reinterpret_cast<int*>(scratch + l.tot);
  int* code_start = reinterpret_cast<int*>(scratch + l.code_start);
  int* seg_start = reinterpret_cast<int*>(scratch + l.seg_start);
  int* sorted_local = reinterpret_cast<int*>(scratch + l.sorted_local);
  int* rank_local = reinterpret_cast<int*>(scratch + l.rank_local);
  int* sorted = reinterpret_cast<int*>(scratch + l.sorted);
  float* part = scratch + l.part;
  float* part_bins = scratch + l.part_bins;
  const unsigned hh = static_cast<unsigned>(h);
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
    err = cudaMemsetAsync(cnt, 0, static_cast<size_t>(h) * c * p.splits * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    sort_split_kernel<<<dim3(static_cast<unsigned>(p.splits), hh), kSortThreads, 0, s>>>(
        idx, cnt, sorted_local, rank_local, static_cast<int>(n), static_cast<int>(c), p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & 2) {
    row_scan_kernel<<<dim3(static_cast<unsigned>((c + 7) / 8), hh), 256, 0, s>>>(cnt, off, tot,
                                                                                static_cast<int>(c), p.splits);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & 4) {
    code_scan_kernel<<<hh, kScanThreads, 0, s>>>(tot, code_start, seg_start, static_cast<int>(n),
                                                 static_cast<int>(c));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & 8) {
    scatter_kernel<<<dim3(static_cast<unsigned>((n + 255) / 256), hh), 256, 0, s>>>(
        idx, off, code_start, sorted_local, rank_local, sorted, static_cast<int>(n), static_cast<int>(c), p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & 16) {
    const dim3 grid(static_cast<unsigned>((p.max_segs + kSegWarps - 1) / kSegWarps),
                    static_cast<unsigned>((d + kSegDims - 1) / kSegDims), hh);
    // 16-byte loads need 16-byte rows and a 16-byte aligned x
    if (d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
      segment_sum_kernel<true><<<grid, kSegWarps * 32, 0, s>>>(x, w, sorted, code_start, seg_start, part,
                                                               part_bins, static_cast<int>(n),
                                                               static_cast<int>(c), static_cast<int>(d),
                                                               p.max_segs);
    } else {
      segment_sum_kernel<false><<<grid, kSegWarps * 32, 0, s>>>(x, w, sorted, code_start, seg_start, part,
                                                                part_bins, static_cast<int>(n),
                                                                static_cast<int>(c), static_cast<int>(d),
                                                                p.max_segs);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & 32) {
    segment_merge_kernel<<<grid_stride_blocks(h * c * (d + 1)), 256, 0, s>>>(part, part_bins, seg_start, esum,
                                                                             bins, h, c, d, p.max_segs);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// the replaced split statistics: bit 0 the partial sums, bit 1 the merge
int launch_split_stats(const float* x, const int32_t* idx, const float* w, float* bins, float* esum,
                       float* scratch, long long h, long long n, long long c, long long d, cudaStream_t s,
                       int passes) {
  const StatTiles t = stat_tiles(h, n, c, d);
  float* part_esum = scratch;
  float* part_bins = scratch + static_cast<size_t>(t.splits) * h * c * d;
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
    const size_t smem = stat_smem_bytes(t);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(stats_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid(static_cast<unsigned>(t.c_tiles) * t.d_tiles, static_cast<unsigned>(t.splits),
                    static_cast<unsigned>(h));
    stats_partial_kernel<<<grid, kStatThreads, smem, s>>>(x, idx, w, part_esum, part_bins,
                                                          static_cast<int>(n), static_cast<int>(c),
                                                          static_cast<int>(d), t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & 2) {
    const long long total = h * c * (d + 1);
    long long blocks = (total + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    stats_merge_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(part_esum, part_bins, esum, bins,
                                                                      h, c, d, t.splits);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// the selection with its row copy: the split-TF32 tile (packing the
// codebook into `packed` first), or the replaced f32 FMA tile
int launch_selection(bool tensor_cores, const float* x, const float* e, const float* bias, float* packed,
                     int32_t* idx, float* q, long long h, long long n, long long c, long long d,
                     cudaStream_t s) {
  return static_cast<int>(tensor_cores
                              ? vqtpu::launch_select_tf32(x, e, bias, packed, idx, q, nullptr, h, n, c, d, s)
                              : vqtpu::launch_select_codes<true>(x, e, bias, idx, q, h, n, c, d, s));
}

// floats of the statistics' scratch: the larger of the two designs', which
// share it
long long stats_scratch_floats(long long h, long long n, long long c, long long d) {
  const StatTiles t = stat_tiles(h, n, c, d);
  const long long split = static_cast<long long>(t.splits) * h * c * (d + 1);
  const long long sorted = static_cast<long long>(sort_layout(h, n, c, d, sort_plan(h, n, c)).floats);
  return split > sorted ? split : sorted;
}

}  // namespace

extern "C" {

// Floats of scratch the wrapper must give vqtpu_train_fused_f32 for these
// sizes: the packed codebook of the selection, then the statistics' arrays.
long long vqtpu_train_fused_scratch_floats(long long h, long long n, long long c, long long d) {
  return vqtpu::select_tf32_scratch_floats(h, c, d) + stats_scratch_floats(h, n, c, d);
}

// x (h, n, d), e (h, c, d), bias (h, c) f32, w (h, n) f32 or null, and the
// outputs idx (h, n) int32, q (h, n, d), bins (h, c), esum (h, c, d) f32,
// scratch of vqtpu_train_fused_scratch_floats(h, n, c, d) floats, 16-byte
// aligned; all contiguous on the current device. Enqueues the passes on
// `stream` and returns the first nonzero CUDA error. Requires
// 1 <= h <= 65535, 1 <= n, c, d < 2^31 and c * d < 2^31 (checked by the
// Python wrapper).
int vqtpu_train_fused_f32(const float* x, const float* e, const float* bias, const float* w,
                          int32_t* idx, float* q, float* bins, float* esum, float* scratch,
                          long long h, long long n, long long c, long long d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* stats = scratch + vqtpu::select_tf32_scratch_floats(h, c, d);
  const int err = launch_selection(true, x, e, bias, scratch, idx, q, h, n, c, d, s);
  if (err != 0) return err;
  return launch_sorted_stats(x, idx, w, bins, esum, stats, h, n, c, d, s, 63);
}

// The statistics by sorted code alone, for indices chosen elsewhere: the
// backward of a looked-up row of a learnable codebook, whose gradient is
// the sum by code of the rows' gradients (x), in token order within a code,
// so two calls give the same bits. x (h, n, d), idx (h, n) int32 in [0, c),
// w (h, n) or null; bins (h, c), esum (h, c, d); scratch of
// vqtpu_code_sums_scratch_floats(h, n, c, d) floats. The same limits as
// vqtpu_train_fused_f32.
long long vqtpu_code_sums_scratch_floats(long long h, long long n, long long c, long long d) {
  return static_cast<long long>(sort_layout(h, n, c, d, sort_plan(h, n, c)).floats);
}

int vqtpu_code_sums_f32(const float* x, const int32_t* idx, const float* w, float* bins, float* esum,
                        float* scratch, long long h, long long n, long long c, long long d, void* stream) {
  return launch_sorted_stats(x, idx, w, bins, esum, scratch, h, n, c, d, static_cast<cudaStream_t>(stream), 63);
}

// The replaced step (f32 FMA tile, then the split statistics), same
// arguments.
int vqtpu_train_fused_f32_simt(const float* x, const float* e, const float* bias, const float* w,
                               int32_t* idx, float* q, float* bins, float* esum, float* scratch,
                               long long h, long long n, long long c, long long d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* stats = scratch + vqtpu::select_tf32_scratch_floats(h, c, d);
  const int err = launch_selection(false, x, e, bias, scratch, idx, q, h, n, c, d, s);
  if (err != 0) return err;
  return launch_split_stats(x, idx, w, bins, esum, stats, h, n, c, d, s, 3);
}

// One pass on its own, for timing, same arguments; each reads what the
// passes before it left in the scratch. Stage 0 the split-TF32 selection
// with its rows (with the codebook pre-pass), 1 the f32 tile's; 2 and 3 the
// split statistics' partial sums (reading idx) and merge; 4-9 the passes
// a-f of the statistics by sorted code.
int vqtpu_train_fused_stage(int stage, const float* x, const float* e, const float* bias,
                            const float* w, int32_t* idx, float* q, float* bins, float* esum,
                            float* scratch, long long h, long long n, long long c, long long d,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* stats = scratch + vqtpu::select_tf32_scratch_floats(h, c, d);
  if (stage <= 1) return launch_selection(stage == 0, x, e, bias, scratch, idx, q, h, n, c, d, s);
  if (stage <= 3) return launch_split_stats(x, idx, w, bins, esum, stats, h, n, c, d, s, stage == 2 ? 1 : 2);
  if (stage <= 9) return launch_sorted_stats(x, idx, w, bins, esum, stats, h, n, c, d, s, 1 << (stage - 4));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* vqtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
