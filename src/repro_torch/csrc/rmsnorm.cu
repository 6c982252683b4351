// RMSNorm forward and backward for Hopper (sm_90a).
//
// Forward, y = x * rsqrt(mean(x^2) + eps) * w per row.  Replaces the TPU kernel
// src/repro/kernels/rmsnorm.py::rmsnorm_fwd (body _fwd_kernel), which tiled 256
// rows at a time into VMEM.
//
// Bound on the H100: bytes.  A row of D values does 3 operations per value and
// moves 2 (bf16) or 4 (f32) bytes in and out, far below the ~295 operations per
// byte at which the card turns compute-bound.  So the design reads each row from
// device memory once: one block per row, so that a row's sum of squares is a
// block reduction (warp shuffles, then one shared-memory step across warps) and
// no block depends on another.  The second pass over the row re-reads it from
// L1/L2, where the first pass left it.  The statistics are computed in f32 and the
// output is rounded to x's dtype, as the reference does.
//
// Backward (K3), with r = rsqrt(mean(x^2) + eps):
//   dx = r*dy*w - x*r^3*mean(dy*w*x)      (in x's dtype)
//   dw = sum over rows of dy*x*r          (f32)
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_bwd (body
// _bwd_kernel), which emitted dx and one partial dw per 256-row grid step, summed by
// its caller.  Bound on the H100: bytes, as the forward (x and dy read once, dx
// written once: about 100 MB at the internlm2 training shape (8, 1024, 2048) bf16,
// ~10 operations per value).  Blocks here run in parallel, so the TPU's sequential
// grid becomes a loop: a grid of as many blocks as fit on the card at once, each
// walking a share of the rows.  Per row a thread loads its columns of x and dy once
// into registers, the block reduces sum(x^2) and sum(dy*w*x) together (warp
// shuffles, one shared-memory step), and the thread writes dx from the registers.
// Each thread keeps the dw partials of its own columns in registers across all its
// rows, and the block writes one f32 row of partials at the end: no atomics, and the
// caller's sum over the (blocks, D) partials is deterministic.  The columns a thread
// owns are tid + k * blockDim (k < VPT), so a warp's loads are contiguous.

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

// the sums of a and b over the block, in one pass of shuffles and one shared step
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 partial[32];
  __shared__ float2 total;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    float2 v = lane < n_warps ? partial[lane] : make_float2(0.f, 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
    }
    if (lane == 0) total = v;
  }
  __syncthreads();
  return total;
}

constexpr int kBwdThreads = 256;

// VPT: columns per thread, a power of two with D <= VPT * kBwdThreads.
template <typename T, int VPT>
__global__ void __launch_bounds__(kBwdThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ dw_part, long long rows, int D, float eps) {
  const int tid = threadIdx.x;
  float wv[VPT], dwacc[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = tid + k * kBwdThreads;
    wv[k] = c < D ? w[c] : 0.f;
    dwacc[k] = 0.f;
  }
  const float inv_d = 1.f / static_cast<float>(D);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * D;
    const T* dyr = dy + row * D;
    float xv[VPT], dyv[VPT];
    float ss = 0.f, sdwx = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = tid + k * kBwdThreads;
      xv[k] = c < D ? to_f32(xr[c]) : 0.f;
      dyv[k] = c < D ? to_f32(dyr[c]) : 0.f;
      ss += xv[k] * xv[k];
      sdwx += dyv[k] * wv[k] * xv[k];
    }
    const float2 sums = block_sum2(ss, sdwx);
    const float r = rsqrtf(sums.x * inv_d + eps);
    const float proj = sums.y * inv_d;
    const float r3 = r * r * r;
    T* dxr = dx + row * D;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = tid + k * kBwdThreads;
      if (c < D) {
        const float dyw = dyv[k] * wv[k];
        dxr[c] = from_f32<T>(r * dyw - xv[k] * r3 * proj);
        dwacc[k] += dyv[k] * xv[k] * r;
      }
    }
  }
  float* part = dw_part + static_cast<long long>(blockIdx.x) * D;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = tid + k * kBwdThreads;
    if (c < D) part[c] = dwacc[k];
  }
}

template <typename T, int VPT>
int bwd_grid(long long rows) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rmsnorm_bwd_kernel<T, VPT>,
                                                        kBwdThreads, 0);
  if (err != cudaSuccess || sms <= 0 || per_sm <= 0) return -1;
  const long long blocks = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(rows < blocks ? rows : blocks);
}

template <typename T, int VPT>
int bwd_launch(const void* x, const void* w, const void* dy, void* dx, void* dw_part,
               long long rows, int D, int blocks, float eps, cudaStream_t s) {
  rmsnorm_bwd_kernel<T, VPT><<<blocks, kBwdThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(dw_part), rows, D, eps);
  return static_cast<int>(cudaGetLastError());
}

// Calls fn<T, VPT>(args...) for the dtype code and the smallest VPT that covers D;
// returns `bad` for a dtype or width the kernel has no instantiation for.
template <typename T, template <typename, int> class Fn, typename R, typename... Args>
R by_width(int D, R bad, Args... args) {
  if (D <= kBwdThreads) return Fn<T, 1>::run(args...);
  if (D <= 2 * kBwdThreads) return Fn<T, 2>::run(args...);
  if (D <= 4 * kBwdThreads) return Fn<T, 4>::run(args...);
  if (D <= 8 * kBwdThreads) return Fn<T, 8>::run(args...);
  if (D <= 16 * kBwdThreads) return Fn<T, 16>::run(args...);
  if (D <= 32 * kBwdThreads) return Fn<T, 32>::run(args...);
  return bad;
}

template <typename T, int VPT>
struct GridFn {
  static int run(long long rows) { return bwd_grid<T, VPT>(rows); }
};

template <typename T, int VPT>
struct LaunchFn {
  static int run(const void* x, const void* w, const void* dy, void* dx, void* dw_part,
                 long long rows, int D, int blocks, float eps, cudaStream_t s) {
    return bwd_launch<T, VPT>(x, w, dy, dx, dw_part, rows, D, blocks, eps, s);
  }
};

}  // namespace
}  // namespace repro_torch

// Widest row the backward kernel takes (32 columns per thread of 256).
extern "C" int rmsnorm_bwd_max_width() { return 32 * repro_torch::kBwdThreads; }

// Blocks the backward kernel is launched with for `rows` rows of width D: as many
// as fit on the current device at once, at most `rows`.  The caller allocates the
// (blocks, D) f32 partials of dw.  Returns -1 for an unsupported dtype or width, or
// when the device cannot be queried.
extern "C" int rmsnorm_bwd_blocks(long long rows, int D, int dtype) {
  using namespace repro_torch;
  if (rows <= 0 || D <= 0) return -1;
  if (dtype == kFloat32) return by_width<float, GridFn>(D, -1, rows);
  if (dtype == kBFloat16) return by_width<__nv_bfloat16, GridFn>(D, -1, rows);
  return -1;
}

// x, dy, dx: (rows, D) contiguous, dtype code `dtype`; w: (D,) f32; dw_part: (blocks, D)
// f32, with blocks from rmsnorm_bwd_blocks.  Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx,
                           void* dw_part, long long rows, int D, int blocks, int dtype,
                           float eps, void* stream) {
  using namespace repro_torch;
  if (rows <= 0 || D <= 0 || blocks <= 0 || blocks > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return by_width<float, LaunchFn>(D, bad, x, w, dy, dx, dw_part, rows, D, blocks, eps, s);
  if (dtype == kBFloat16)
    return by_width<__nv_bfloat16, LaunchFn>(D, bad, x, w, dy, dx, dw_part, rows, D, blocks,
                                             eps, s);
  return bad;
}

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
