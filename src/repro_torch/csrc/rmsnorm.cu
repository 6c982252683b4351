// RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w per row.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_fwd (body
// _fwd_kernel), which tiled 256 rows at a time into VMEM.
//
// Bound on the H100: bytes.  A row of D values does 3 operations per value and
// moves 2 (bf16) or 4 (f32) bytes in and out, far below the ~295 operations per
// byte at which the card turns compute-bound.  So the design reads each row from
// device memory once: one block per row, so that a row's sum of squares is a
// block reduction (warp shuffles, then one shared-memory step across warps) and
// no block depends on another.  The second pass over the row re-reads it from
// L1/L2, where the first pass left it.  The statistics are computed in f32 and the
// output is rounded to x's dtype, as the reference does.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[32];
  __shared__ float total;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    v = lane < n_warps ? partial[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) total = v;
  }
  __syncthreads();
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       T* __restrict__ y, int D, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;

  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = block_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    yr[i] = from_f32<T>(to_f32(xr[i]) * r * w[i]);
  }
}

}  // namespace
}  // namespace repro_torch

// x, y: (rows, D) contiguous, dtype code `dtype`; w: (D,) f32.  Launches on
// `stream` and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, long long rows, int D,
                           int dtype, float eps, void* stream) {
  using namespace repro_torch;
  if (rows <= 0 || rows > 0x7fffffffLL || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    rmsnorm_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), D,
        eps);
  } else if (dtype == kBFloat16) {
    rmsnorm_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(y), D, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
