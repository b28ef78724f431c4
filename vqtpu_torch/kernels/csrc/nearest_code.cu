// First-index nearest-code selection on Hopper (sm_90a), f32 accuracy.
//
//   idx[h, t] = first argmax_j ( x[h, t, :] . e[h, j, :] + bias[h, j] )
//
// Replaces the three Pallas TPU kernels of vqtpu/kernels/distance.py that
// compute this one function: _pipelined_select_kernel and
// _grid_select_kernel (codebook resident in VMEM) and _tiled_select_kernel
// (codebook streamed in c-tiles with a running (best, index) carry). The
// bias (-||e||^2/2 for L2, 0 for cosine) is computed by the caller.
//
// The kernel is the split-TF32 tensor-core selection of select_tf32.cuh,
// with its row-copy epilogue when the caller asks for the rows; that file
// says what bounds it and what its design does about it.
//
// vqtpu_nearest_code_f32_simt is the register-blocked f32 FMA tile this
// kernel replaced (select_codes.cuh, which the fused train kernel still
// uses), kept as a same-run yardstick: no path of the port calls it.

#include "select_codes.cuh"
#include "select_tf32.cuh"

extern "C" {

// Floats of scratch vqtpu_nearest_code_f32 needs for the packed codebook.
long long vqtpu_nearest_code_scratch_floats(long long h, long long c, long long d) {
  return vqtpu::select_tf32_scratch_floats(h, c, d);
}

// x (h, n, d), e (h, c, d), bias (h, c) f32 and idx (h, n) int32, all
// contiguous on the current device; scratch of
// vqtpu_nearest_code_scratch_floats floats, 16-byte aligned; q (h, n, d) f32
// for the winning codebook rows, or null for indices only. Launches on
// `stream` and returns cudaGetLastError(). Requires 1 <= h <= 65535 and
// 1 <= n, c, d < 2^31 (checked by the Python wrapper).
int vqtpu_nearest_code_f32(const float* x, const float* e, const float* bias, float* scratch,
                           int32_t* idx, float* q, long long h, long long n, long long c,
                           long long d, void* stream) {
  return static_cast<int>(vqtpu::launch_select_tf32(x, e, bias, scratch, idx, q, h, n, c, d,
                                                     static_cast<cudaStream_t>(stream)));
}

// The replaced f32 FMA tile, indices only, same operands as above.
int vqtpu_nearest_code_f32_simt(const float* x, const float* e, const float* bias, int32_t* idx,
                                long long h, long long n, long long c, long long d, void* stream) {
  return static_cast<int>(vqtpu::launch_select_codes<false>(
      x, e, bias, idx, nullptr, h, n, c, d, static_cast<cudaStream_t>(stream)));
}

const char* vqtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
