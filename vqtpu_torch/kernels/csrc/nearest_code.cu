// First-index nearest-code selection on Hopper (sm_90a), f32.
//
//   idx[h, t] = first argmax_j ( x[h, t, :] . e[h, j, :] + bias[h, j] )
//
// Replaces the three Pallas TPU kernels of vqtpu/kernels/distance.py that
// compute this one function: _pipelined_select_kernel and
// _grid_select_kernel (codebook resident in VMEM) and _tiled_select_kernel
// (codebook streamed in c-tiles with a running (best, index) carry). The
// bias (-||e||^2/2 for L2, 0 for cosine) is computed by the caller.
//
// The kernel is the selection tile of select_codes.cuh without its
// row-copy epilogue; that file says what bounds it and how it is built.

#include "select_codes.cuh"

extern "C" {

// x (h, n, d), e (h, c, d), bias (h, c) f32 and idx (h, n) int32, all
// contiguous on the current device; launches on `stream` and returns
// cudaGetLastError(). Requires 1 <= h <= 65535 and 1 <= n, c, d < 2^31
// (checked by the Python wrapper).
int vqtpu_nearest_code_f32(const float* x, const float* e, const float* bias,
                           int32_t* idx, long long h, long long n, long long c,
                           long long d, void* stream) {
  return static_cast<int>(vqtpu::launch_select_codes<false>(
      x, e, bias, idx, nullptr, h, n, c, d, static_cast<cudaStream_t>(stream)));
}

const char* vqtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
