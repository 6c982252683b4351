// RMSNorm forward and backward for Hopper (sm_90a).
//
// Forward (K2), y = x * rsqrt(mean(x^2) + eps) * w per row.  Replaces the TPU kernel
// src/repro/kernels/rmsnorm.py::rmsnorm_fwd (body _fwd_kernel), which tiled 256
// rows at a time into VMEM.
//
// Bound on the H100: bytes.  A row of D values does 3 operations per value and
// moves 2 (bf16) or 4 (f32) bytes in and out, far below the ~295 operations per
// byte at which the card turns compute-bound.  So every route moves each byte once,
// in 16-byte vectors (8 bf16 or 4 f32), lane-interleaved so that a warp reads 512
// contiguous bytes per step, and keeps them raw in registers from the sum of squares
// to the scaling: the row is read from device memory once.  w is read as float4.  A
// row whose width is not a multiple of the vector, or whose base is not 16-byte
// aligned, takes masked scalar loads and stores in the same kernel (the `vec` flag).
// The statistics are computed in f32 and the output is rounded to x's dtype, as the
// reference does.  Three routes, chosen by the row width alone (fwd_route; rmsnorm_fwd
// returns which):
//   - warp-per-row (rmsnorm_fwd_kernel), rows of up to 4096 values (kWarpRowMax): a warp
//     a row, 4 rows a block, the sum a warp shuffle with no __syncthreads.
//   - row-per-block, route 1 (rmsnorm_fwd_row_kernel), rows of 4097 to 8192 values
//     (kRowMax): 256 threads a row, 4 bf16 or 8 f32 vectors a thread, on a persistent
//     grid whose blocks walk the rows with the next row's loads in flight; w stays in
//     registers for all of a block's rows.
//   - row-per-block streamed (rmsnorm_fwd_stream_kernel), rows wider than 8192, any
//     width: route 1's block and grid, the row read twice in 16-byte vectors (the
//     second time from L2).
// Each threshold is the widest row a kernel holds in registers; no row count moves a
// row to another route.  At a decode step's few rows a call takes about one round trip
// to memory, and route 1, which issues its x and w loads together, is faster there
// than the warp-per-row kernel from 512 values on (measured on the H100, PERF.md); rows
// of up to 4096 stay on the warp-per-row kernel all the same (route 1 for them is open
// work, ROADMAP §B).  A row split over a thread block cluster, its blocks' partial sums
// exchanged through distributed shared memory, was slower than route 1 at every
// decode step's rows up to 8192 (a cluster launch costs the card ~0.8 us more than a
// plain one, more than one SM's transfer of a row of 8192), and no path gives wider
// rows, so it is kept only as csrc/variants/k2_cluster_split.patch.  The grid cannot
// overflow: rows are at most 2^31 - 1 (rmsnorm_fwd) and route 1's grids are persistent.
//
// Backward (K3), with r = rsqrt(mean(x^2) + eps):
//   dx = r*dy*w - x*r^3*mean(dy*w*x)      (in x's dtype)
//   dw = sum over rows of dy*x*r          (f32)
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_bwd (body
// _bwd_kernel), which emitted dx and one partial dw per 256-row grid step, summed by
// its caller.  Bound on the H100: bytes, as the forward (x and dy read once, dx
// written once: about 100 MB at the internlm2 training shape (8, 1024, 2048) bf16,
// ~10 operations per value).  So the design is the forward's: each byte moves once,
// in 16-byte lane-interleaved vectors, and nothing synchronises per row beyond the
// warps that share it.
//   - A warp per row, or a group of WPR warps for rows wider than 4 vectors a lane
//     cover (1024 bf16 or 512 f32 columns; kBwdVectors), each lane then holding 16
//     values (two bf16 or four f32 vectors; four bf16 ones spill there).  Each lane
//     holds its vectors
//     of x and dy raw in registers from the two sums to the write of dx; sum(x^2)
//     and sum(dy*w*x) are warp shuffles, and a group of several warps adds its warps'
//     sums through one double-buffered shared-memory slot and one named barrier of
//     its own warps per row.  w is read once per block into shared memory.
//   - A persistent grid: one block of 16 warps an SM (two where the registers allow),
//     each group walking rows with a stride of all the grid's groups, rows dealt to
//     the blocks first.  The registers hold two rows a group: the next row's loads
//     are issued before the current row's sums, so a group keeps a row in flight
//     while it reduces and writes the last.  That leaves no room for dw partials in
//     registers, so each group adds its rows' dy*x*r into its own f32 row in shared
//     memory (each column is one lane's); at the end the block adds its groups' rows
//     in group order and writes one f32 row of partials: at most one a block.
//   - dw is finished by rmsnorm_bwd_dw_kernel, a column pass over those partials in
//     a fixed order (blocks strided over 16 warps, then the warps in order): two calls
//     on the same inputs give bitwise-equal dw, and nothing is atomic.  It is
//     launched with programmatic dependent launch, so that its launch overlaps the
//     main kernel's tail (it waits for the whole main grid before reading); that
//     measured faster than plain stream order at every main-path shape.
// An unaligned base or a width that is no multiple of the vector takes scalar loads
// and stores in the same kernel (the `vec` flag), as the forward does.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

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
  // hides the value from the compiler, so that it unpacks the raw words again and
  // keeps no unpacked copy alive across a barrier (K3's register budget)
  static __device__ __forceinline__ void opaque(Raw& r) {
    asm volatile("" : "+f"(r.x), "+f"(r.y), "+f"(r.z), "+f"(r.w));
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
  static __device__ __forceinline__ void opaque(Raw& r) {
    asm volatile("" : "+r"(r.x), "+r"(r.y), "+r"(r.z), "+r"(r.w));
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

// ---- K2's routes for rows wider than kWarpRowMax ---------------------------------

// a few rows' vectors, raw, as one value (arrays cannot be assigned)
template <typename T, int NV>
struct Vecs {
  typename Vec16<T>::Raw v[NV];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Thread t of the N that share a row owns its vectors t + N k (k < NV): columns
// [(t + N k) * VEC, + VEC), lane-interleaved, so that a warp moves 512 contiguous bytes
// a step.  16-byte loads where `vec`, else masked scalar loads (zeros past D).
template <typename T, int NV, int N>
__device__ __forceinline__ void load_vectors(Vecs<T, NV>& a, const T* __restrict__ xr, int D,
                                             int t, int vec) {
  using V = Vec16<T>;
  constexpr int VEC = V::N;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int col = (t + N * k) * VEC;
    if (vec && col < D) {
      a.v[k] = *reinterpret_cast<const typename V::Raw*>(xr + col);
    } else {
      float f[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = col + e < D ? to_f32(xr[col + e]) : 0.f;
      a.v[k] = V::pack(f);  // exact: the values came from T
    }
  }
}

// w at the same columns, as float4 where `vec` (zeros past D)
template <int NV, int VEC, int N>
__device__ __forceinline__ void load_w(float (&wr)[NV][VEC], const float* __restrict__ w, int D,
                                       int t, int vec) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int col = (t + N * k) * VEC;
    if (vec && col < D) {
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(w + col + e);
        wr[k][e] = wv.x, wr[k][e + 1] = wv.y, wr[k][e + 2] = wv.z, wr[k][e + 3] = wv.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) wr[k][e] = col + e < D ? w[col + e] : 0.f;
    }
  }
}

template <typename T, int NV>
__device__ __forceinline__ float sum_squares(const Vecs<T, NV>& a) {
  constexpr int VEC = Vec16<T>::N;
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float f[VEC];
    Vec16<T>::unpack(a.v[k], f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += f[e] * f[e];
  }
  return ss;
}

// y = x * r * w at the thread's columns, stored as load_vectors loaded them
template <typename T, int NV, int N>
__device__ __forceinline__ void store_scaled(T* __restrict__ yr, const Vecs<T, NV>& a,
                                             const float (&wr)[NV][Vec16<T>::N], float r, int D,
                                             int t, int vec) {
  using V = Vec16<T>;
  constexpr int VEC = V::N;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int col = (t + N * k) * VEC;
    if (col >= D) break;
    float f[VEC];
    V::unpack(a.v[k], f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = f[e] * r * wr[k][e];
    if (vec) {
      *reinterpret_cast<typename V::Raw*>(yr + col) = V::pack(f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (col + e < D) yr[col + e] = from_f32<T>(f[e]);
    }
  }
}

// Route 1, row-per-block: kRowThreads threads a row, each holding NV vectors of it; a
// persistent grid whose blocks walk the rows with a stride of the grid, the next row's
// loads issued before the current row's sum.  w at the thread's columns stays in
// registers for all its rows.  The warps' sums meet in a double-buffered slot, one block
// barrier a row (a warp writes a slot again only after the next row's barrier, which
// every warp reaches after reading it), and each thread adds them in warp order.
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowMax = 8192;  // widest row route 1 holds: 4 bf16 or 8 f32 vectors a thread

template <typename T>
constexpr int row_vectors() { return kRowMax / (kRowThreads * Vec16<T>::N); }

template <typename T, int NV>
__global__ void __launch_bounds__(kRowThreads)
    rmsnorm_fwd_row_kernel(const T* __restrict__ x, const float* __restrict__ w,
                           T* __restrict__ y, long long rows, int D, float eps, int vec) {
  constexpr int VEC = Vec16<T>::N;
  __shared__ float sums[2][kRowWarps];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  long long row = blockIdx.x;
  Vecs<T, NV> cur;
  if (row < rows) load_vectors<T, NV, kRowThreads>(cur, x + row * D, D, t, vec);
  float wr[NV][VEC];
  load_w<NV, VEC, kRowThreads>(wr, w, D, t, vec);
  const float d = static_cast<float>(D);
  int parity = 0;
  for (; row < rows; row += gridDim.x) {
    const long long next = row + gridDim.x;
    Vecs<T, NV> nxt;
    if (next < rows) load_vectors<T, NV, kRowThreads>(nxt, x + next * D, D, t, vec);
    float ss = warp_sum(sum_squares(cur));
    if (lane == 0) sums[parity][warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int j = 0; j < kRowWarps; ++j) ss += sums[parity][j];
    parity ^= 1;
    store_scaled<T, NV, kRowThreads>(y + row * D, cur, wr, rsqrtf(ss / d + eps), D, t, vec);
    cur = nxt;
  }
}

// Route 1 for rows wider than kRowMax: the same block and grid, the row streamed twice
// in chunks of 4 vectors a thread (the second pass re-reads it, from L2 where it stays),
// w read as float4 with each chunk.  No width is too wide for it.
constexpr int kStreamVectors = 4;

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    rmsnorm_fwd_stream_kernel(const T* __restrict__ x, const float* __restrict__ w,
                              T* __restrict__ y, long long rows, int D, float eps, int vec) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int CHUNK = kRowThreads * kStreamVectors * VEC;  // columns
  __shared__ float sums[2][kRowWarps];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const float d = static_cast<float>(D);
  int parity = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * D;
    T* yr = y + row * D;
    float ss = 0.f;
    for (int c = 0; c < D; c += CHUNK) {
      Vecs<T, kStreamVectors> a;
      load_vectors<T, kStreamVectors, kRowThreads>(a, xr + c, D - c, t, vec);
      ss += sum_squares(a);
    }
    ss = warp_sum(ss);
    if (lane == 0) sums[parity][warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int j = 0; j < kRowWarps; ++j) ss += sums[parity][j];
    parity ^= 1;
    const float r = rsqrtf(ss / d + eps);
    for (int c = 0; c < D; c += CHUNK) {
      Vecs<T, kStreamVectors> a;
      float wr[kStreamVectors][VEC];
      load_vectors<T, kStreamVectors, kRowThreads>(a, xr + c, D - c, t, vec);
      load_w<kStreamVectors, VEC, kRowThreads>(wr, w + c, D - c, t, vec);
      store_scaled<T, kStreamVectors, kRowThreads>(yr + c, a, wr, r, D - c, t, vec);
    }
  }
}

// The routes, as rmsnorm_fwd returns them and the wrapper names them
// (kernels/rmsnorm.py: ROUTES).
constexpr int kRouteWarp = 0, kRouteRow = 1, kRouteStream = 2;

constexpr int kMaxDevices = 64;

int current_device() {
  int device = 0;
  return cudaGetDevice(&device) == cudaSuccess ? device : -1;
}

// SMs of the current device (read once a device)
int device_sms() {
  static int sms[kMaxDevices] = {};
  const int device = current_device();
  if (device < 0 || device >= kMaxDevices) return 0;
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    sms[device] = 0;
  return sms[device];
}

// Route 1's persistent grid for `rows` rows: as many blocks of its kernel (the streamed
// one for NV 0) as the current device holds at once (found once a device), at most one
// a row; -1 if the device cannot be queried.
template <typename T, int NV>
int row_grid(long long rows) {
  static int per_sm[kMaxDevices] = {};
  const int device = current_device();
  if (device < 0 || device >= kMaxDevices) return -1;
  if (per_sm[device] == 0) {
    cudaError_t err;
    if constexpr (NV == 0)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[device], rmsnorm_fwd_stream_kernel<T>, kRowThreads, 0);
    else
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[device], rmsnorm_fwd_row_kernel<T, NV>, kRowThreads, 0);
    if (err != cudaSuccess) per_sm[device] = 0;
  }
  const long long most = static_cast<long long>(device_sms()) * per_sm[device];
  if (most <= 0) return -1;
  return static_cast<int>(rows < most ? rows : most);
}

// Launches K2 for rows of width D on `route`; returns the route, or minus the CUDA error
// (cudaErrorInvalidValue for a width the route does not take).
template <typename T>
int fwd_on_route(const void* xp, const void* wp, void* yp, long long rows, int D, float eps,
                 int route, cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const float* w = static_cast<const float*>(wp);
  T* y = static_cast<T*>(yp);
  constexpr int VEC = Vec16<T>::N;
  const int vec = D % VEC == 0 && ((reinterpret_cast<uintptr_t>(xp) |
                                    reinterpret_cast<uintptr_t>(wp) |
                                    reinterpret_cast<uintptr_t>(yp)) & 15) == 0;
  const int bad = -static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWarp) {
    if (D > kWarpRowMax) return bad;
    const int per_lane = (D + 32 * VEC - 1) / (32 * VEC);
    if (per_lane <= 1) {
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
  } else if (route == kRouteRow) {
    constexpr int NV = row_vectors<T>();
    if (D > kRowMax) return bad;
    const int grid = row_grid<T, NV>(rows);
    if (grid <= 0) return bad;
    rmsnorm_fwd_row_kernel<T, NV><<<grid, kRowThreads, 0, s>>>(x, w, y, rows, D, eps, vec);
  } else if (route == kRouteStream) {
    const int grid = row_grid<T, 0>(rows);
    if (grid <= 0) return bad;
    rmsnorm_fwd_stream_kernel<T><<<grid, kRowThreads, 0, s>>>(x, w, y, rows, D, eps, vec);
  } else {
    return bad;
  }
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? route : -static_cast<int>(err);
}

// The route rmsnorm_fwd takes for rows of D values: the narrowest kernel that holds the
// row in registers, else the streamed one.
int fwd_route(int D) {
  if (D <= kWarpRowMax) return kRouteWarp;
  return D <= kRowMax ? kRouteRow : kRouteStream;
}

constexpr int kBwdWarps = 16;  // warps a block
constexpr int kBwdVectors = 4;  // 16-byte vectors a lane holds of x and of dy, at most
constexpr int kBwdMaxWidth = 8192;
constexpr int kBwdBlocksPerSM = 2;
constexpr int kDwWarps = 16;  // warps of the dw column pass, 32 columns a block

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// a row's vectors of x and dy, raw, in one lane's registers
template <typename T, int NV>
struct RowVecs {
  typename Vec16<T>::Raw x[NV], dy[NV];
};

// Loads lane `lane`'s vectors of one row (vector (k * WPR + wg) * 32 + lane, k < NV):
// 16-byte loads where `vec`, else masked scalar loads (zeros past D).
template <typename T, int NV, int WPR>
__device__ __forceinline__ void load_row(RowVecs<T, NV>& r, const T* __restrict__ xr,
                                         const T* __restrict__ dyr, int D, int wg, int lane,
                                         int vec) {
  using V = Vec16<T>;
  constexpr int VEC = V::N;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int col = ((k * WPR + wg) * 32 + lane) * VEC;
    if (vec && col < D) {
      r.x[k] = *reinterpret_cast<const typename V::Raw*>(xr + col);
      r.dy[k] = *reinterpret_cast<const typename V::Raw*>(dyr + col);
    } else {
      float xv[VEC], dv[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        xv[e] = col + e < D ? to_f32(xr[col + e]) : 0.f;
        dv[e] = col + e < D ? to_f32(dyr[col + e]) : 0.f;
      }
      r.x[k] = V::pack(xv);  // exact: the values came from T
      r.dy[k] = V::pack(dv);
    }
  }
}

// NV: vectors a lane holds (a power of two, at most kBwdVectors); WPR: warps a row
// (a power of two dividing kBwdWarps), with D <= R = WPR * 32 * NV * VEC.  Dynamic
// shared memory: (1 + G) * R floats, G = kBwdWarps / WPR: w zero-padded to R, then
// each group's dw partials, by column.
template <typename T, int NV, int WPR>
__global__ void __launch_bounds__(32 * kBwdWarps)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ dw_part, long long rows, int D, float eps,
                       int vec) {
  using V = Vec16<T>;
  constexpr int VEC = V::N;
  constexpr int G = kBwdWarps / WPR;  // rows a block holds at once
  constexpr int R = WPR * 32 * NV * VEC;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  __shared__ float2 sums[2][kBwdWarps];

  // the dw pass may be scheduled now: it waits for this whole grid before reading
  asm volatile("griddepcontrol.launch_dependents;");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp / WPR, wg = warp % WPR;
  float* acc_s = ws + (1 + g) * R;  // this group's dw partials
  const long long stride = static_cast<long long>(gridDim.x) * G;
  long long row = static_cast<long long>(g) * gridDim.x + blockIdx.x;

  RowVecs<T, NV> cur;
  if (row < rows) load_row<T, NV, WPR>(cur, x + row * D, dy + row * D, D, wg, lane, vec);
  // w (and zeros past D), and zeroed partials, while the first row is in flight
  for (int i = threadIdx.x; i < R; i += blockDim.x) ws[i] = i < D ? w[i] : 0.f;
  for (int i = threadIdx.x; i < G * R; i += blockDim.x) ws[R + i] = 0.f;
  __syncthreads();

  const float inv_d = 1.f / static_cast<float>(D);
  int parity = 0;
  for (; row < rows; row += stride) {
    // the group's next row is in flight while this one is reduced and written
    const long long next = row + stride;
    RowVecs<T, NV> nxt;
    if (next < rows)
      load_row<T, NV, WPR>(nxt, x + next * D, dy + next * D, D, wg, lane, vec);
    float ss = 0.f, sp = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int col = ((k * WPR + wg) * 32 + lane) * VEC;
      float xv[VEC], dv[VEC];
      V::unpack(cur.x[k], xv);
      V::unpack(cur.dy[k], dv);
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(ws + col + e);
        ss += xv[e] * xv[e] + xv[e + 1] * xv[e + 1] + xv[e + 2] * xv[e + 2] +
              xv[e + 3] * xv[e + 3];
        sp += dv[e] * wv.x * xv[e] + dv[e + 1] * wv.y * xv[e + 1] +
              dv[e + 2] * wv.z * xv[e + 2] + dv[e + 3] * wv.w * xv[e + 3];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sp += __shfl_xor_sync(0xffffffffu, sp, off);
    }
    if constexpr (WPR > 1) {  // the row's warps add their sums, in warp order
      if (lane == 0) sums[parity][warp] = make_float2(ss, sp);
      named_barrier(1 + g, 32 * WPR);
      ss = sp = 0.f;
#pragma unroll
      for (int j = 0; j < WPR; ++j) {
        const float2 v = sums[parity][g * WPR + j];
        ss += v.x;
        sp += v.y;
      }
      parity ^= 1;  // the next row's slot: a warp reaches it only after this barrier
    }
    const float r = rsqrtf(ss * inv_d + eps);
    const float proj = sp * inv_d;
    const float r3 = r * r * r;
    T* dxr = dx + row * D;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int col = ((k * WPR + wg) * 32 + lane) * VEC;
      if (col >= D) break;
      V::opaque(cur.x[k]);
      V::opaque(cur.dy[k]);
      float xv[VEC], dv[VEC], out[VEC];
      V::unpack(cur.x[k], xv);
      V::unpack(cur.dy[k], dv);
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(ws + col + e);
        out[e] = r * (dv[e] * wv.x) - xv[e] * r3 * proj;
        out[e + 1] = r * (dv[e + 1] * wv.y) - xv[e + 1] * r3 * proj;
        out[e + 2] = r * (dv[e + 2] * wv.z) - xv[e + 2] * r3 * proj;
        out[e + 3] = r * (dv[e + 3] * wv.w) - xv[e + 3] * r3 * proj;
        float4 a = *reinterpret_cast<float4*>(acc_s + col + e);  // this lane's columns
        a.x += dv[e] * xv[e] * r;
        a.y += dv[e + 1] * xv[e + 1] * r;
        a.z += dv[e + 2] * xv[e + 2] * r;
        a.w += dv[e + 3] * xv[e + 3] * r;
        *reinterpret_cast<float4*>(acc_s + col + e) = a;
      }
      if (vec) {
        *reinterpret_cast<typename V::Raw*>(dxr + col) = V::pack(out);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (col + e < D) dxr[col + e] = from_f32<T>(out[e]);
      }
    }
    cur = nxt;
  }

  // the block's dw partial row: the groups' partials added in group order
  __syncthreads();
  float* part = dw_part + static_cast<long long>(blockIdx.x) * D;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) t += ws[(1 + j) * R + c];
    part[c] = t;
  }
}

// dw[c] = the sum of the blocks' partials dw_part[:, c], in a fixed order: warp j of
// the block of column c adds the partial rows j, j + kDwWarps, ..., and the warps'
// sums are added in warp order.  Every block waits for the main grid first (a no-op
// unless launched as its programmatic dependent), so that no block ends before it.
__global__ void __launch_bounds__(32 * kDwWarps)
    rmsnorm_bwd_dw_kernel(const float* __restrict__ dw_part, float* __restrict__ dw,
                          int blocks, int D) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __shared__ float warp_sum[kDwWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < D) {
#pragma unroll 8
    for (int b = warp; b < blocks; b += kDwWarps)
      s += dw_part[static_cast<long long>(b) * D + c];
  }
  warp_sum[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < D) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < kDwWarps; ++j) t += warp_sum[j][lane];
    dw[c] = t;
  }
}

// 16-byte vectors a lane holds of a row split over warps: 16 values in either dtype
// (four bf16 vectors there need more than the 128 registers a thread may have, and spill)
template <typename T>
constexpr int bwd_split_vectors() { return Vec16<T>::N == 8 ? 2 : kBwdVectors; }

// (NV, WPR) of the backward kernel for rows of width D of T: one warp a row while four
// vectors a lane cover it, else the fewest warps (a power of two) that cover it with
// bwd_split_vectors<T>() each.
template <typename T>
void bwd_shape(int D, int& nv, int& wpr) {
  constexpr int VEC = Vec16<T>::N;
  const int per_lane = (D + 32 * VEC - 1) / (32 * VEC);
  nv = 1;
  wpr = 1;
  if (per_lane <= kBwdVectors) {
    while (nv < per_lane) nv *= 2;
    return;
  }
  nv = bwd_split_vectors<T>();
  while (wpr * nv < per_lane) wpr *= 2;
}

// the backward kernel's dynamic shared memory: w and G rows of dw partials, R floats each
template <typename T, int NV, int WPR>
constexpr size_t bwd_smem() {
  return static_cast<size_t>(1 + kBwdWarps / WPR) * WPR * 32 * NV * Vec16<T>::N * sizeof(float);
}

// the persistent grid's blocks on the current device, for as many rows as there may be:
// at most kBwdBlocksPerSM an SM.  Sets the kernel's dynamic shared-memory limit there
// first.
template <typename T, int NV, int WPR>
int bwd_grid() {
  const size_t smem = bwd_smem<T, NV, WPR>();
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rmsnorm_bwd_kernel<T, NV, WPR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rmsnorm_bwd_kernel<T, NV, WPR>, 32 * kBwdWarps, smem);
  if (err != cudaSuccess || sms <= 0 || per_sm <= 0) return -1;
  return sms * (per_sm < kBwdBlocksPerSM ? per_sm : kBwdBlocksPerSM);
}

// The main kernel, then the dw pass as its programmatic dependent: the pass's blocks
// may be scheduled while the main grid's last blocks run, and wait for it to finish
// (griddepcontrol.wait) before reading the partials.
template <typename T, int NV, int WPR>
int bwd_launch(const void* x, const void* w, const void* dy, void* dx, void* dw_part,
               void* dw, long long rows, int D, int blocks, float eps, cudaStream_t s) {
  const int vec = D % Vec16<T>::N == 0 &&
                  ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
  rmsnorm_bwd_kernel<T, NV, WPR><<<blocks, 32 * kBwdWarps, bwd_smem<T, NV, WPR>(), s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(dw_part), rows, D, eps, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((D + 31) / 32));
  cfg.blockDim = dim3(32 * kDwWarps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rmsnorm_bwd_dw_kernel, static_cast<const float*>(dw_part),
                           static_cast<float*>(dw), blocks, D);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Calls Fn<T, NV, WPR>::run(args...) for the (NV, WPR) that bwd_shape gives D;
// returns `bad` for a width the kernel has no instantiation for.
template <typename T, template <typename, int, int> class Fn, typename R, typename... Args>
R by_width(int D, R bad, Args... args) {
  if (D <= 0 || D > kBwdMaxWidth) return bad;
  int nv = 0, wpr = 0;
  bwd_shape<T>(D, nv, wpr);
  constexpr int SV = bwd_split_vectors<T>();
  if (wpr == 1 && nv == 1) return Fn<T, 1, 1>::run(args...);
  if (wpr == 1 && nv == 2) return Fn<T, 2, 1>::run(args...);
  if (wpr == 1) return Fn<T, kBwdVectors, 1>::run(args...);
  if constexpr (SV == kBwdVectors) {  // a bf16 row split takes at least four warps
    if (wpr == 2) return Fn<T, SV, 2>::run(args...);
  }
  if (wpr == 4) return Fn<T, SV, 4>::run(args...);
  if (wpr == 8) return Fn<T, SV, 8>::run(args...);
  if (wpr == 16) return Fn<T, SV, 16>::run(args...);  // rows over 4096 values
  return bad;
}

template <typename T, int NV, int WPR>
struct GridFn {
  static int run() { return bwd_grid<T, NV, WPR>(); }
};

template <typename T, int NV, int WPR>
struct LaunchFn {
  static int run(const void* x, const void* w, const void* dy, void* dx, void* dw_part,
                 void* dw, long long rows, int D, int blocks, float eps, cudaStream_t s) {
    return bwd_launch<T, NV, WPR>(x, w, dy, dx, dw_part, dw, rows, D, blocks, eps, s);
  }
};

}  // namespace
}  // namespace repro_torch

// Widest row the backward kernel takes.
extern "C" int rmsnorm_bwd_max_width() { return repro_torch::kBwdMaxWidth; }

// The persistent grid of the backward kernel for rows of width D on the current device:
// at most two blocks an SM.  A call launches min(rows, this) blocks and allocates the
// (blocks, D) f32 partials of dw.  Call it on the device before the first rmsnorm_bwd
// there at this width and dtype: it sets the kernel's shared-memory limit.  Returns -1
// for an unsupported dtype or width, or when the device cannot be queried.
extern "C" int rmsnorm_bwd_blocks(int D, int dtype) {
  using namespace repro_torch;
  if (dtype == kFloat32) return by_width<float, GridFn>(D, -1);
  if (dtype == kBFloat16) return by_width<__nv_bfloat16, GridFn>(D, -1);
  return -1;
}

// x, dy, dx: (rows, D) contiguous, dtype code `dtype`; w: (D,) f32; dw_part: (blocks, D)
// f32 scratch, blocks at most rmsnorm_bwd_blocks and at most rows; dw: (D,) f32.  Two
// grid launches on `stream`, the dw pass as the main kernel's programmatic dependent.
// Returns the first CUDA error of the launches (0 when both were accepted).
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx,
                           void* dw_part, void* dw, long long rows, int D, int blocks,
                           int dtype, float eps, void* stream) {
  using namespace repro_torch;
  if (rows <= 0 || D <= 0 || blocks <= 0 || blocks > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return by_width<float, LaunchFn>(D, bad, x, w, dy, dx, dw_part, dw, rows, D, blocks, eps,
                                     s);
  if (dtype == kBFloat16)
    return by_width<__nv_bfloat16, LaunchFn>(D, bad, x, w, dy, dx, dw_part, dw, rows, D, blocks,
                                             eps, s);
  return bad;
}

// x, y: (rows, D) contiguous, dtype code `dtype`; w: (D,) f32.  Launches K2 on `stream`
// on `route` (0 warp-per-row, 1 row-per-block, 2 row-per-block streamed), to time and
// test each route at any width it takes.  Returns the route once the launch was
// accepted, or minus the CUDA error (cudaErrorInvalidValue for a width the route does
// not take).
extern "C" int rmsnorm_fwd_on_route(const void* x, const void* w, void* y, long long rows,
                                    int D, int dtype, float eps, int route, void* stream) {
  using namespace repro_torch;
  const int bad = -static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || rows > 0x7fffffffLL || D <= 0) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return fwd_on_route<float>(x, w, y, rows, D, eps, route, s);
  if (dtype == kBFloat16) return fwd_on_route<__nv_bfloat16>(x, w, y, rows, D, eps, route, s);
  return bad;
}

// rmsnorm_fwd_on_route on the route fwd_route chooses for the width.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, long long rows, int D,
                           int dtype, float eps, void* stream) {
  return rmsnorm_fwd_on_route(x, w, y, rows, D, dtype, eps, repro_torch::fwd_route(D), stream);
}
