// The fused eval forward of ResidualFSQ on Hopper (sm_90a), f32: the soft
// clamp and the q layers of the preserve-symmetry, hard-clamp FSQ chain in
// one pass over the tokens.
//
//   z = tanh(x / c) * c;  r = z;  qsum = 0
//   for each layer i with scale s = L^-i, per dim:
//     zi = r / s;  b = clip(zi, -1, 1);  br = floor((L - 1) * (b + 1) / 2 + 0.5)
//     code = (2 / (L - 1)) * br - 1;  qv = code * s;  r = r - qv;  qsum = qsum + qv
//   idx[i] = rint(sum_d ((code + 1) / (2 / (L - 1))) * basis_d)
//
// Replaces the Pallas TPU kernel vqtpu/kernels/residual_fsq_fused.py::_kernel,
// which views the (N, d) tokens as (N d / 128, 128) full-lane rows, turns the
// per-dim constants into per-lane patterns and sums each token's index over
// its lanes with a roll tree. None of that layout is carried over: here a
// thread owns two tokens (one in the general instantiation), the tokens of a
// block's threads side by side, and reads each token's d floats where they
// lie. Two tokens a thread were the fastest at the main shape: 0.1020 and
// 0.1013 ms against 0.1046 and 0.1047 for one and 0.1418 and 0.1421 for four
// (96 registers), in one run of tools/rfsq_variants.py on an H100 80GB HBM3
// at 700 W.
//
// What bounds it: bytes. At the main shape (N = 4,194,304 tokens, d = 4,
// q = 8) the kernel must read x (67.1 MB) and write the quantized values
// (67.1 MB) and the int32 indices (134.2 MB): 268.4 MB, 0.080 ms at
// 3.35 TB/s. The instruction count comes close: the exact route is 13
// instructions a (dim, layer) pair in its SASS, which with the clamp's tanh,
// the constants' uniform loads and the loops' overhead take some 0.08 ms to
// dispatch on 132 SMs. The two overlap but do not hide each other: 0.103 ms,
// 78% of the byte bound (chip_smoke.py on an H100 80GB HBM3 at 700 W).
//
// What the design does about it. Every byte is read or written once, with
// no padded copy and no intermediate in device memory; a token's dims, its
// residual, its running sum and (for q <= 16) its indices stay in
// registers, loaded and stored 16 bytes a thread where d allows it. An IEEE
// division costs a reciprocal, refinement FMAs, a range check and a branch;
// the chain had 2 d q + d of them a token. Here none is left on the route the
// wrapper proves (`exact_division`):
//   - r / s = fma(fma(-q0, s, r), y, q0) with q0 = RN(r y) and y = RN(1 / s)
//     from the wrapper (Markstein's correction step): the correctly rounded
//     quotient when s and y are normal and the remainder is exact, which it
//     is when r is 0 or |r| >= 2^-102. The wrapper proves that every nonzero
//     quantum code * s of the configuration is at least 2^-79 (its last bit
//     at least 2^-102), the kernel checks that every dim of z is 0 or at
//     least 2^-79, and every nonzero residual, made of those by rounded
//     subtractions, is then at least 2^-102.
//     x / c the same way, an infinite quotient passed on as it is.
//   - the bracket from one saturating FMA: sat(RN(zi / 2 + 1 / 2)) is
//     RN(clip(zi, -1, 1) + 1) / 2 exactly, so
//     floor(RN(RN((L - 1) * it) + 0.5)) is the chain's bracket bit for bit.
//     (fma.sat flushes NaN to 0; no NaN reaches this route, see below.)
//   - the index as the integer sum of bracket * basis (`integer_index`),
//     where the wrapper proves, per configuration, that the chain's rounded
//     float sum of RN(RN((code + 1) / step) * basis) is that integer; else
//     the digit by the same division sequence with RN(1 / step) and the float
//     sum as the chain makes it.
// The constants (L - 1, the step, the clamp, the basis, the scales and the
// reciprocals) are the kernel's parameters in the fixed instantiations
// (d <= 8, q <= 16), read from the constant bank by the instructions that
// use them: no load in the pair loop. One general instantiation takes any
// d <= 128 and any q, its arrays in local memory and its constants from
// device memory.
//
// The IEEE route: a token whose soft-clamped dims are not all 0 or at least
// 2^-79 (a tiny or NaN input), every token of a launch whose scales are not
// the plan's, and every token of a configuration whose proofs fail, take
// the chain with IEEE-rounded divisions (`ieee_token`), which propagates
// NaN as torch.clamp does. Those divisions need no slow-path call either
// (`ieee_quotient`), so the kernel has no call and no spill.
//
// Rounding: the chain is a sequence of bin decisions, so one differently
// rounded bit moves a deep layer's index. Every multiply, add and FMA is
// written with a round-to-nearest intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn, __fmaf_rn): nvcc would otherwise fuse a * b - c into one FMA,
// where PyTorch's separate elementwise kernels round twice. tanhf
// is the accurate one (no fast-math flag), and the index is rounded half to
// even (__float2int_rn), as torch.round.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 128;
// a token takes the exact-division route when every soft-clamped dim is 0 or
// at least this (MIN_FAST_Z in the wrapper): its last bit is then >= 2^-102
constexpr float kMinFastZ = 0x1p-79f;
constexpr float kInf = __builtin_huge_valf();

// The constant block: d values each of L - 1, the step 2 / (L - 1),
// RN(1 / step), the clamp, RN(1 / clamp) and the basis, then the (q, d)
// scales and the (q, d) RN(1 / scale).
enum : int { kLm1 = 0, kStep, kRstep, kClamp, kRclamp, kBasis, kPerDim };

// D, Q > 0: the block by value, in the kernel's parameter space.
template <int D, int Q>
struct Plan {
  float v[kPerDim * D + 2 * Q * D];
  __device__ __forceinline__ float dim(int k, int j) const { return v[k * D + j]; }
  __device__ __forceinline__ float scale(int e) const { return v[kPerDim * D + e]; }
  __device__ __forceinline__ float scale(int i, int j) const { return v[kPerDim * D + i * D + j]; }
  __device__ __forceinline__ float rscale(int i, int j) const { return v[kPerDim * D + Q * D + i * D + j]; }
};

// D == Q == 0: the block in device memory.
template <>
struct Plan<0, 0> {
  const float* v;
  int d, q;
  __device__ __forceinline__ float dim(int k, int j) const { return __ldg(v + k * d + j); }
  __device__ __forceinline__ float scale(int e) const { return __ldg(v + kPerDim * d + e); }
  __device__ __forceinline__ float scale(int i, int j) const { return __ldg(v + kPerDim * d + i * d + j); }
  __device__ __forceinline__ float rscale(int i, int j) const { return __ldg(v + kPerDim * d + q * d + i * d + j); }
};

struct Args {
  const float* x;          // (n, d)
  const float* plan_host;  // the constant block, in host memory
  const float* consts;     // the same block, on the device
  const float* scales;     // (q, d), as given
  float* qsum;             // (n, d)
  int32_t* idx;            // (n, q)
  long long n;
  int d;
  int q;
  int exact_division;
  int integer_index;
  cudaStream_t stream;
};

// v[0:D] = p[0:D], 16 or 8 bytes a load where D allows it; D == 0: d scalars
template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float* v, int d) {
  if constexpr (D > 0 && D % 4 == 0) {
#pragma unroll
    for (int k = 0; k < D / 4; ++k) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) + k);
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    }
  } else if constexpr (D > 0 && D % 2 == 0) {
#pragma unroll
    for (int k = 0; k < D / 2; ++k) {
      const float2 f = __ldg(reinterpret_cast<const float2*>(p) + k);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < (D > 0 ? D : d); ++j) v[j] = __ldg(p + j);
  }
}

template <int D, typename T, typename T4, typename T2>
__device__ __forceinline__ void store_row(T* __restrict__ p, const T* v, int d) {
  if constexpr (D > 0 && D % 4 == 0) {
#pragma unroll
    for (int k = 0; k < D / 4; ++k) {
      reinterpret_cast<T4*>(p)[k] = T4{v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]};
    }
  } else if constexpr (D > 0 && D % 2 == 0) {
#pragma unroll
    for (int k = 0; k < D / 2; ++k) reinterpret_cast<T2*>(p)[k] = T2{v[2 * k], v[2 * k + 1]};
  } else {
#pragma unroll
    for (int j = 0; j < (D > 0 ? D : d); ++j) p[j] = v[j];
  }
}

// a / b correctly rounded from y = RN(1 / b): exact when b and y are normal
// and a is 0 or |a| >= 2^-102 (Markstein's correction step)
__device__ __forceinline__ float exact_quotient(float a, float b, float y) {
  const float q0 = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-q0, b, a), y, q0);
}

// a / b as IEEE division rounds it (div.rn.f32), for every a and b, with no
// slow-path call (whose calling convention spills registers around it): the
// quotient in f64 from a Newton-refined approximate reciprocal, within 2^-44
// of a / b, rounded to f32, then moved to the f32 neighbour if the exact
// remainder a - b m (exact in f64: 24-bit a, 24-bit b, 25-bit m) puts a / b
// beyond the midpoint m between them, and to the even one at a tie. A zero,
// infinite or NaN operand takes a * (1 / b) with the approximate
// reciprocal, which gives IEEE's special results.
__device__ __forceinline__ float ieee_quotient(float a, float b) {
  if (!(fabsf(a) < kInf && fabsf(b) < kInf && b != 0.f)) {
    float rb;
    asm("rcp.approx.f32 %0, %1;" : "=f"(rb) : "f"(b));
    return __fmul_rn(a, rb);
  }
  const double ad = a;
  const double bd = b;
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(bd));
  y = __fma_rn(y, __fma_rn(-bd, y, 1.0), y);
  y = __fma_rn(y, __fma_rn(-bd, y, 1.0), y);
  const double q = __dmul_rn(ad, y);
  const float f = __double2float_rn(q);
  // an overflowed f stands for 2^128, the next power of two past FLT_MAX
  const double fd = fabsf(f) == kInf ? copysign(0x1p128, q) : static_cast<double>(f);
  if (q == fd) return f;
  const float g = nextafterf(f, q > fd ? kInf : -kInf);
  const double gd = fabsf(g) == kInf ? copysign(0x1p128, q) : static_cast<double>(g);
  const double m = 0.5 * (fd + gd);
  const double side = __fma_rn(-bd, m, ad) * bd;   // the sign of a / b - m
  if (side == 0.0) return (__float_as_uint(f) & 1u) ? g : f;
  return (side > 0.0) == (gd > m) ? g : f;
}

// clip(RN(z / 2 + 1 / 2), 0, 1) in one FFMA.SAT: RN(clip(z, -1, 1) + 1) / 2
__device__ __forceinline__ float half_bracket_arg(float z) {
  float h;
  asm("fma.rn.sat.f32 %0, %1, 0f3F000000, 0f3F000000;" : "=f"(h) : "f"(z));
  return h;
}

// The chain of one token with IEEE divisions (`ieee_quotient`), the scales
// as given: the route of tokens and launches the wrapper's proofs do not
// cover. It is rare, so it is kept small: none of its loops is unrolled, its
// arrays lie in local memory, and it stores each index as it is made.
template <int D, int Q>
__device__ __forceinline__ void ieee_token(const float* __restrict__ x, const float* __restrict__ consts,
                                        const float* __restrict__ scales, float* __restrict__ qsum,
                                        int32_t* __restrict__ idx, long long t, int d_arg, int q_arg) {
  constexpr bool kFixed = D > 0;
  constexpr int kDims = kFixed ? D : kMaxDim;
  const int d = kFixed ? D : d_arg;
  const int q = kFixed ? Q : q_arg;
  const float* __restrict__ levels_m1 = consts + kLm1 * d;
  const float* __restrict__ inv_step = consts + kStep * d;
  const float* __restrict__ clamp = consts + kClamp * d;
  const float* __restrict__ basis = consts + kBasis * d;

  float r[kDims];
  float acc[kDims];
  load_row<D>(x + t * d, r, d);
#pragma unroll 1
  for (int j = 0; j < d; ++j) {
    const float c = __ldg(clamp + j);
    r[j] = __fmul_rn(tanhf(ieee_quotient(r[j], c)), c);
    acc[j] = 0.f;
  }

#pragma unroll 1
  for (int i = 0; i < q; ++i) {
    float sum = 0.f;
#pragma unroll 1
    for (int j = 0; j < d; ++j) {
      const float s = __ldg(scales + i * d + j);
      const float lm1 = __ldg(levels_m1 + j);
      const float step = __ldg(inv_step + j);
      const float zi = ieee_quotient(r[j], s);
      const float b = zi < -1.f ? -1.f : (zi > 1.f ? 1.f : zi);
      const float br = floorf(__fadd_rn(__fmul_rn(__fmul_rn(lm1, __fadd_rn(b, 1.f)), 0.5f), 0.5f));
      const float code = __fsub_rn(__fmul_rn(step, br), 1.f);
      const float qv = __fmul_rn(code, s);
      r[j] = __fsub_rn(r[j], qv);
      acc[j] = __fadd_rn(acc[j], qv);
      sum = __fadd_rn(sum, __fmul_rn(ieee_quotient(__fadd_rn(code, 1.f), step), __ldg(basis + j)));
    }
    idx[t * q + i] = __float2int_rn(sum);
  }
  store_row<D, float, float4, float2>(qsum + t * d, acc, d);
}

// The q layers of T tokens on the exact-division route, interleaved token
// by token in each (dim, layer) pair. kIntIndex: the index is the integer
// sum of bracket * basis (exact in f32: the wrapper proves prod(L) <= 2^24).
template <int D, int Q, int T, bool kIntIndex, int kDims, int kInd>
__device__ __forceinline__ void exact_chain(const Plan<D, Q>& p, int d, int q, float (&r)[T][kDims],
                                            float (&acc)[T][kDims], int32_t (&ind)[T][kInd],
                                            int32_t* __restrict__ idx, const long long (&tok)[T], long long n) {
#pragma unroll
  for (int i = 0; i < (Q > 0 ? Q : q); ++i) {
    float sum[T];
#pragma unroll
    for (int k = 0; k < T; ++k) sum[k] = 0.f;
#pragma unroll
    for (int j = 0; j < (D > 0 ? D : d); ++j) {
      const float s = p.scale(i, j);
      const float ys = p.rscale(i, j);
      const float lm1 = p.dim(kLm1, j);
      const float step = p.dim(kStep, j);
      const float basis = p.dim(kBasis, j);
#pragma unroll
      for (int k = 0; k < T; ++k) {
        const float half = half_bracket_arg(exact_quotient(r[k][j], s, ys));
        const float br = floorf(__fadd_rn(__fmul_rn(lm1, half), 0.5f));
        const float code = __fsub_rn(__fmul_rn(step, br), 1.f);
        const float qv = __fmul_rn(code, s);
        r[k][j] = __fsub_rn(r[k][j], qv);
        acc[k][j] = __fadd_rn(acc[k][j], qv);
        if constexpr (kIntIndex) {
          sum[k] = __fmaf_rn(br, basis, sum[k]);
        } else {
          const float digit = exact_quotient(__fadd_rn(code, 1.f), step, p.dim(kRstep, j));
          sum[k] = __fadd_rn(sum[k], __fmul_rn(digit, basis));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < T; ++k) {
      if constexpr (Q > 0) {
        ind[k][i] = __float2int_rn(sum[k]);
      } else if (tok[k] < n) {
        idx[tok[k] * q + i] = __float2int_rn(sum[k]);
      }
    }
  }
}

// D, Q > 0: d = D, q = Q, everything in registers. D == Q == 0: d <= 128 and
// any q from the arguments, a token's arrays in local memory and each index
// stored as it is made. One block an SM at the least: with no minimum,
// ptxas caps the registers near the exact route's need and spills the IEEE
// route's values (31 of the 128 fixed instantiations, up to 176 bytes, in
// the same run; the main one then ran 0.0984 ms, 3% faster, and does not
// spill). With it the main instantiation takes 54 registers, four blocks an
// SM, and no instantiation spills.
template <int D, int Q, int T>
__global__ void __launch_bounds__(kThreads, 1)
residual_fsq_eval_kernel(const float* __restrict__ x, const __grid_constant__ Plan<D, Q> plan,
                         const float* __restrict__ consts, const float* __restrict__ scales,
                         float* __restrict__ qsum, int32_t* __restrict__ idx, long long n, int d_arg, int q_arg,
                         int exact_division, int integer_index) {
  constexpr bool kFixed = D > 0;
  constexpr int kDims = kFixed ? D : kMaxDim;
  constexpr int kInd = kFixed ? Q : 1;
  const int d = kFixed ? D : d_arg;
  const int q = kFixed ? Q : q_arg;

  // the proofs were made for the plan's scales: other scales take the IEEE route
  bool same = exact_division != 0;
  for (int e = threadIdx.x; e < q * d; e += kThreads) same = same && __ldg(scales + e) == plan.scale(e);
  bool exact = __syncthreads_and(same);

  const long long first = static_cast<long long>(blockIdx.x) * (kThreads * T) + threadIdx.x;
  if (first >= n) return;
  long long tok[T];
#pragma unroll
  for (int k = 0; k < T; ++k) tok[k] = first + k * kThreads;

  float r[T][kDims];
  float acc[T][kDims];
  if (exact) {
#pragma unroll
    for (int k = 0; k < T; ++k) {
      if (tok[k] < n) {
        load_row<D>(x + tok[k] * d, r[k], d);
      } else {
#pragma unroll
        for (int j = 0; j < d; ++j) r[k][j] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < T; ++k) {
#pragma unroll
      for (int j = 0; j < d; ++j) {
        const float c = plan.dim(kClamp, j);
        const float rc = plan.dim(kRclamp, j);
        const float q0 = __fmul_rn(r[k][j], rc);
        const float xc = fabsf(q0) == kInf ? q0 : __fmaf_rn(__fmaf_rn(-q0, c, r[k][j]), rc, q0);
        const float z = __fmul_rn(tanhf(xc), c);
        exact = exact && (z == 0.f || fabsf(z) >= kMinFastZ);
        r[k][j] = z;
        acc[k][j] = 0.f;
      }
    }
  }
  if (!exact) {
#pragma unroll 1
    for (int k = 0; k < T; ++k) {
      const long long t = first + k * kThreads;
      if (t < n) ieee_token<D, Q>(x, consts, scales, qsum, idx, t, d, q);
    }
    return;
  }

  int32_t ind[T][kInd];
  if (integer_index) {
    exact_chain<D, Q, T, true>(plan, d, q, r, acc, ind, idx, tok, n);
  } else {
    exact_chain<D, Q, T, false>(plan, d, q, r, acc, ind, idx, tok, n);
  }
#pragma unroll
  for (int k = 0; k < T; ++k) {
    if (tok[k] < n) {
      store_row<D, float, float4, float2>(qsum + tok[k] * d, acc[k], d);
      if constexpr (kFixed) store_row<Q, int32_t, int4, int2>(idx + tok[k] * Q, ind[k], Q);
    }
  }
}

template <int D, int Q>
cudaError_t launch(const Args& a) {
  constexpr int T = 2;
  Plan<D, Q> plan;
  for (int e = 0; e < kPerDim * D + 2 * Q * D; ++e) plan.v[e] = a.plan_host[e];
  const unsigned blocks = static_cast<unsigned>((a.n + kThreads * T - 1) / (kThreads * T));
  residual_fsq_eval_kernel<D, Q, T><<<blocks, kThreads, 0, a.stream>>>(
      a.x, plan, a.consts, a.scales, a.qsum, a.idx, a.n, a.d, a.q, a.exact_division, a.integer_index);
  return cudaGetLastError();
}

template <>
cudaError_t launch<0, 0>(const Args& a) {
  const Plan<0, 0> plan{a.consts, a.d, a.q};
  const unsigned blocks = static_cast<unsigned>((a.n + kThreads - 1) / kThreads);
  residual_fsq_eval_kernel<0, 0, 1><<<blocks, kThreads, 0, a.stream>>>(
      a.x, plan, a.consts, a.scales, a.qsum, a.idx, a.n, a.d, a.q, a.exact_division, a.integer_index);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dim(const Args& a) {
  switch (a.q) {
#define VQTPU_RFSQ_Q(Q) \
  case Q:               \
    return launch<D, Q>(a);
    VQTPU_RFSQ_Q(1) VQTPU_RFSQ_Q(2) VQTPU_RFSQ_Q(3) VQTPU_RFSQ_Q(4)
    VQTPU_RFSQ_Q(5) VQTPU_RFSQ_Q(6) VQTPU_RFSQ_Q(7) VQTPU_RFSQ_Q(8)
    VQTPU_RFSQ_Q(9) VQTPU_RFSQ_Q(10) VQTPU_RFSQ_Q(11) VQTPU_RFSQ_Q(12)
    VQTPU_RFSQ_Q(13) VQTPU_RFSQ_Q(14) VQTPU_RFSQ_Q(15) VQTPU_RFSQ_Q(16)
#undef VQTPU_RFSQ_Q
    default:
      return launch<0, 0>(a);
  }
}

}  // namespace

extern "C" {

// x (n, d) f32, 16-byte aligned; plan_host and consts: the constant block
// (kPerDim d + 2 q d f32, see Plan) in host memory and on the device; scales
// (q, d) f32 as given; outputs qsum (n, d) f32 and idx (n, q) int32; all
// device arrays contiguous on the current device. exact_division and
// integer_index: the routes the wrapper proved for the block's scales.
// Enqueues one launch on `stream` and returns cudaGetLastError(). Requires
// 1 <= d <= 128, q >= 1 and 1 <= n < 2^31 (checked by the Python wrapper).
int vqtpu_residual_fsq_eval_f32(const float* x, const float* plan_host, const float* consts, const float* scales,
                                float* qsum, int32_t* idx, long long n, int d, int q, int exact_division,
                                int integer_index, void* stream) {
  const Args a{x, plan_host, consts, scales, qsum, idx, n, d, q, exact_division, integer_index,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (d) {
    case 1: err = launch_dim<1>(a); break;
    case 2: err = launch_dim<2>(a); break;
    case 3: err = launch_dim<3>(a); break;
    case 4: err = launch_dim<4>(a); break;
    case 5: err = launch_dim<5>(a); break;
    case 6: err = launch_dim<6>(a); break;
    case 7: err = launch_dim<7>(a); break;
    case 8: err = launch_dim<8>(a); break;
    default: err = launch<0, 0>(a); break;
  }
  return static_cast<int>(err);
}

const char* vqtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
