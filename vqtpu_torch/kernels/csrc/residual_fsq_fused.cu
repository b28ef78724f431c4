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
// its lanes with a roll tree. None of that layout is carried over: here each
// thread owns one token and reads its d floats where they lie.
//
// What bounds it: bytes. At the main shape (N = 4,194,304 tokens, d = 4,
// q = 8) the kernel must read x (67.1 MB) and write the quantized values
// (67.1 MB) and the int32 indices (134.2 MB): 268.4 MB, 0.080 ms at
// 3.35 TB/s. Its operations (two IEEE divisions and about ten other
// flops per dim and layer, and a tanh per dim) take about 0.02 ms at the
// f32 peak.
//
// What the design does about it: every byte is read or written once, with
// no padded copy and no intermediate in device memory. A token's dims, its
// residual, its running sum and (for q <= 16) its indices stay in
// registers; a thread loads its d floats and stores its d outputs 16 bytes
// at a time when d is a multiple of 4 (8 bytes when even), and its q indices
// likewise, so the neighbouring threads of a warp touch neighbouring
// addresses. The ragged edge is masked, not padded. Instantiations for
// d <= 8 and q <= 16 unroll both loops; one general instantiation takes any
// d <= 128 and any q, its arrays in local memory.
//
// Rounding: the chain is a sequence of bin decisions, so one differently
// rounded bit moves a deep layer's index. Every multiply, add and divide is
// written with a round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn): nvcc would otherwise fuse a * b - c into one FMA, where
// PyTorch's separate elementwise kernels round twice. tanhf is the accurate
// one (no fast-math flag), the clip propagates NaN as torch.clamp does, and
// the index is rounded half to even (__float2int_rn), as torch.round. The
// per-dim constants (L - 1, 2 / (L - 1), c, basis) and the scales come from
// the wrapper, computed by the plain version's own expressions.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 128;

struct Args {
  const float* x;       // (n, d)
  const float* consts;  // L - 1, 2 / (L - 1), c, basis: (d,) each
  const float* scales;  // (q, d)
  float* qsum;          // (n, d)
  int32_t* idx;         // (n, q)
  long long n;
  int d;
  int q;
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

// D, Q > 0: d = D, q = Q, everything in registers. D == Q == 0: d <= 128 and
// any q from the arguments, the token's arrays in local memory and each
// index stored as it is made.
template <int D, int Q>
__global__ void __launch_bounds__(kThreads)
residual_fsq_eval_kernel(const float* __restrict__ x, const float* __restrict__ consts,
                         const float* __restrict__ scales, float* __restrict__ qsum,
                         int32_t* __restrict__ idx, long long n, int d_arg, int q_arg) {
  constexpr bool kFixed = D > 0;
  constexpr int kDims = kFixed ? D : kMaxDim;
  const int d = kFixed ? D : d_arg;
  const int q = kFixed ? Q : q_arg;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n) return;

  const float* __restrict__ levels_m1 = consts;
  const float* __restrict__ inv_step = consts + d;
  const float* __restrict__ clamp = consts + 2 * d;
  const float* __restrict__ basis = consts + 3 * d;

  float r[kDims];
  float acc[kDims];
  load_row<D>(x + t * d, r, d);
#pragma unroll
  for (int j = 0; j < d; ++j) {
    const float c = __ldg(clamp + j);
    r[j] = __fmul_rn(tanhf(__fdiv_rn(r[j], c)), c);
    acc[j] = 0.f;
  }

  int32_t ind[kFixed ? Q : 1];
#pragma unroll
  for (int i = 0; i < q; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < d; ++j) {
      const float s = __ldg(scales + i * d + j);
      const float lm1 = __ldg(levels_m1 + j);
      const float step = __ldg(inv_step + j);
      const float zi = __fdiv_rn(r[j], s);
      const float b = zi < -1.f ? -1.f : (zi > 1.f ? 1.f : zi);
      const float br = floorf(__fadd_rn(__fmul_rn(__fmul_rn(lm1, __fadd_rn(b, 1.f)), 0.5f), 0.5f));
      const float code = __fsub_rn(__fmul_rn(step, br), 1.f);
      const float qv = __fmul_rn(code, s);
      r[j] = __fsub_rn(r[j], qv);
      acc[j] = __fadd_rn(acc[j], qv);
      sum = __fadd_rn(sum, __fmul_rn(__fdiv_rn(__fadd_rn(code, 1.f), step), __ldg(basis + j)));
    }
    if constexpr (kFixed) {
      ind[i] = __float2int_rn(sum);
    } else {
      idx[t * q + i] = __float2int_rn(sum);
    }
  }

  store_row<D, float, float4, float2>(qsum + t * d, acc, d);
  if constexpr (kFixed) store_row<Q, int32_t, int4, int2>(idx + t * Q, ind, Q);
}

template <int D, int Q>
cudaError_t launch(const Args& a) {
  const unsigned blocks = static_cast<unsigned>((a.n + kThreads - 1) / kThreads);
  residual_fsq_eval_kernel<D, Q><<<blocks, kThreads, 0, a.stream>>>(a.x, a.consts, a.scales, a.qsum,
                                                                      a.idx, a.n, a.d, a.q);
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

// x (n, d) f32, 16-byte aligned; consts: L - 1, 2 / (L - 1), c and the basis
// ((d,) f32 each); scales (q, d) f32; outputs qsum (n, d) f32 and idx (n, q)
// int32; all contiguous on the current device. Enqueues one
// launch on `stream` and returns cudaGetLastError(). Requires 1 <= d <= 128,
// q >= 1 and 1 <= n < 2^31 (checked by the Python wrapper).
int vqtpu_residual_fsq_eval_f32(const float* x, const float* consts, const float* scales, float* qsum,
                                int32_t* idx, long long n, int d, int q, void* stream) {
  const Args a{x, consts, scales, qsum, idx, n, d, q, static_cast<cudaStream_t>(stream)};
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
