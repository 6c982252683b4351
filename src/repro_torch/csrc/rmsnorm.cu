// RMSNorm forward and backward for Hopper (sm_90a).
//
// Forward (K2), y = x * rsqrt(mean(x^2) + eps) * w per row.  Replaces the TPU kernel
// src/repro/kernels/rmsnorm.py::rmsnorm_fwd (body _fwd_kernel), which tiled 256
// rows at a time into VMEM.
//
// Bound on the H100: bytes.  A row of D values does 3 operations per value and
// moves 2 (bf16) or 4 (f32) bytes in and out, far below the ~295 operations per
// byte at which the card turns compute-bound.  So the design moves each byte once,
// in wide transactions, and spends nothing on synchronisation: one warp per row,
// 4 rows to a block, so a row's sum of squares is a warp-shuffle reduction with no
// __syncthreads.  Each lane loads its columns in 16-byte vectors (8 bf16 or 4 f32),
// lane-interleaved so that a warp reads 512 contiguous bytes per step, and keeps
// them in registers from the sum of squares to the scaling: the row is read from
// device memory once.  w is read as float4.  A row whose width is not a multiple of
// the vector, or whose base is not 16-byte aligned, takes scalar loads in the same
// kernel.  Rows wider than the registers hold (4096 columns) go to a block-per-row
// kernel (rmsnorm_fwd_wide_kernel), which re-reads the row from L1/L2 in a second
// pass.  The
// statistics are computed in f32 and the output is rounded to x's dtype, as the
// reference does.
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

// K2 for rows wider than kWarpRowMax: one block per row, two passes over it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_fwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ w,
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

constexpr int kRowsPerBlock = 4;  // one warp per row

// 16 bytes of T, the vector a lane loads and stores, held raw in registers (4 words)
// between the two uses of the row, and its conversions to and from f32
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[4]) {
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[8]) {
    const float2 a = unpack_bf16x2(r.x), b = unpack_bf16x2(r.y), c = unpack_bf16x2(r.z),
                 d = unpack_bf16x2(r.w);
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y, v[4] = c.x, v[5] = c.y, v[6] = d.x,
    v[7] = d.y;
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[8]) {
    return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                      pack_bf16x2(v[6], v[7]));
  }
};

// NV: vectors per lane, a power of two with D <= 32 * NV * VEC.  Lane `lane` owns the
// vectors lane + 32 k (k < NV), columns [(lane + 32 k) * VEC, + VEC).  `vec` says that
// D is a multiple of VEC and x, w, y are 16-byte aligned, so every row is too;
// otherwise each value moves by a scalar load or store, masked at the row's end.
template <typename T, int NV>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       T* __restrict__ y, long long rows, int D, float eps, int vec) {
  using V = Vec16<T>;
  constexpr int VEC = V::N;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * D;
  T* yr = y + row * D;

  typename V::Raw raw[NV];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int col = (lane + 32 * k) * VEC;
    float v[VEC];
    if (vec && col < D) {
      raw[k] = *reinterpret_cast<const typename V::Raw*>(xr + col);
      V::unpack(raw[k], v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = col + e < D ? to_f32(xr[col + e]) : 0.f;
      raw[k] = V::pack(v);  // exact: the values came from T
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += v[e] * v[e];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);

#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int col = (lane + 32 * k) * VEC;
    if (col >= D) break;
    float v[VEC];
    V::unpack(raw[k], v);
    if (vec) {
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(w + col + e);
        v[e] = v[e] * r * wv.x, v[e + 1] = v[e + 1] * r * wv.y;
        v[e + 2] = v[e + 2] * r * wv.z, v[e + 3] = v[e + 3] * r * wv.w;
      }
      *reinterpret_cast<typename V::Raw*>(yr + col) = V::pack(v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (col + e < D) yr[col + e] = from_f32<T>(v[e] * r * w[col + e]);
    }
  }
}

template <typename T, int NV>
void fwd_launch(const T* x, const float* w, T* y, long long rows, int D, float eps, int vec,
                cudaStream_t s) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_fwd_kernel<T, NV><<<static_cast<unsigned>(blocks), 32 * kRowsPerBlock, 0, s>>>(
      x, w, y, rows, D, eps, vec);
}

// widest row the warp-per-row kernel holds in registers: 128 values a lane
constexpr int kWarpRowMax = 4096;

template <typename T>
int fwd_dispatch(const void* xp, const void* wp, void* yp, long long rows, int D, float eps,
                 cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const float* w = static_cast<const float*>(wp);
  T* y = static_cast<T*>(yp);
  constexpr int VEC = Vec16<T>::N;
  const int vec = D % VEC == 0 && ((reinterpret_cast<uintptr_t>(xp) |
                                    reinterpret_cast<uintptr_t>(wp) |
                                    reinterpret_cast<uintptr_t>(yp)) & 15) == 0;
  const int per_lane = (D + 32 * VEC - 1) / (32 * VEC);
  if (D > kWarpRowMax) {
    if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    rmsnorm_fwd_wide_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, s>>>(x, w, y, D, eps);
  } else if (per_lane <= 1) {
    fwd_launch<T, 1>(x, w, y, rows, D, eps, vec, s);
  } else if (per_lane <= 2) {
    fwd_launch<T, 2>(x, w, y, rows, D, eps, vec, s);
  } else if (per_lane <= 4) {
    fwd_launch<T, 4>(x, w, y, rows, D, eps, vec, s);
  } else if (per_lane <= 8) {
    fwd_launch<T, 8>(x, w, y, rows, D, eps, vec, s);
  } else if (per_lane <= 16) {
    fwd_launch<T, 16>(x, w, y, rows, D, eps, vec, s);
  } else if constexpr (VEC == 4) {
    fwd_launch<T, 32>(x, w, y, rows, D, eps, vec, s);  // f32 rows of 2049 to 4096
  }
  return static_cast<int>(cudaGetLastError());
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return fwd_dispatch<float>(x, w, y, rows, D, eps, s);
  if (dtype == kBFloat16) return fwd_dispatch<__nv_bfloat16>(x, w, y, rows, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
