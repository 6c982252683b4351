// Mamba-2 SSD (state-space duality) chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_fwd (body
// _ssd_kernel).  On the TPU the chunks of the sequence were a sequential grid
// dimension, and the (N x P) f32 state lived in VMEM scratch from one grid step to the
// next.  Here blocks run in parallel and in no order, so one block owns one (batch,
// head) and walks the chunks in a loop, carrying the state in shared memory.  Per
// chunk of L = 64 rows, with a_t = A_h * dt_t and cum the inclusive cumsum of a over
// the chunk (head h reads group g = h / (H / G) of B and C):
//
//   intra:  y_i  = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j
//   inter:  y_i += exp(cum_i) * C_i . h
//   state:  h    = exp(cum_L) * h + sum_j exp(cum_L - cum_j) * dt_j * B_j (x) x_j
//
// Bound on the H100: bytes.  The function reads x, B, C and dt once and writes y and
// the final state once (about 40 MB at the mamba2-370m serving shape, 0.012 ms at
// 3.35 TB/s); the chunked form's products over the causal pairs are ~6 GFLOP there,
// under the bytes at the bf16 tensor-core rate.  This first version spends its
// operations as plain f32 FMAs (tensor cores are for a later change) and has only
// batch x heads blocks (128 at the serving shape, one wave on 132 SMs), so it runs
// far from that bound.  What
// it does about the bytes: every input value is read from device memory once, y is
// written once, the state never leaves shared memory between chunks and is written
// once at the end, and B and C of a group are read directly (never repeated per
// head).  The products read their operands as float4 from shared memory laid out so
// that 8 neighbouring threads read 128 neighbouring bytes or one broadcast address,
// and each thread keeps a 4 x 4 tile of its result in registers.
//
// Masking: exp(cum_i - cum_j) is large above the diagonal (cum falls along the chunk,
// since A < 0 and dt > 0).  The kernel never forms it there: it selects 0 for j > i
// and takes exp only where j <= i, so an overflow can never meet the mask as 0 * inf.
// Tiles wholly above the diagonal are skipped.
//
// Any S works: rows past the end of the last, ragged chunk are loaded as zeros with
// dt = 0, so they add nothing to y or the state and leave cum (hence the chunk's
// decay) where the last real row put it; their y rows are not written.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int L = 64;          // rows per chunk (the warp scan below takes 2 per lane)
constexpr int LT = L + 4;      // row stride of the transposed (N, L) tiles: float4-aligned,
                               // and 32 neighbouring rows fall in 8 banks, not 1
constexpr int kThreads = 256;  // 8 warps; each thread owns 4 x 4 tiles of the products

// Floats of dynamic shared memory one block uses for state size N and head dim P.
__host__ __device__ constexpr long long smem_floats(int N, int P) {
  return 2LL * N * LT            // Bt, Ct: B and C of the chunk, transposed (N, L)
         + 1LL * L * N           // Bw: B of the chunk scaled by w_j, (L, N)
         + 1LL * L * P           // Xs: x of the chunk, (L, P)
         + 1LL * L * LT          // St: the masked, decayed scores, transposed (L, L)
         + 1LL * N * P           // Hs: the carried state, (N, P)
         + 4LL * L;              // dt, cum, exp(cum), w
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[a][b] += u[a] * v[b]
__device__ __forceinline__ void outer_fma(float (&acc)[4][4], const float4 u, const float4 v) {
  const float us[4] = {u.x, u.y, u.z, u.w};
  const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(us[a], vs[b], acc[a][b]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const T* __restrict__ Bm,
                        const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ hT,
                        int S, int H, int G, int N, int P) {
  extern __shared__ float4 smem4[];
  float* Bt = reinterpret_cast<float*>(smem4);
  float* Ct = Bt + N * LT;
  float* Bw = Ct + N * LT;
  float* Xs = Bw + L * N;
  float* St = Xs + L * P;
  float* Hs = St + L * LT;
  float* dts = Hs + N * P;
  float* cum = dts + L;
  float* ecum = cum + L;
  float* wts = ecum + L;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const float a = A[h];
  const int PT = P / 4;  // 4-column tiles of y and of the state
  const int LB = L / 4;  // 4-row tiles of the chunk

  for (int i = tid; i < N * P; i += blockDim.x) Hs[i] = 0.f;

  const int nchunks = (S + L - 1) / L;
  for (int c = 0; c < nchunks; ++c) {
    const int s0 = c * L;
    const int rows = min(L, S - s0);

    // -- load the chunk, widened to f32; rows past S are zeros --------------------
    for (int idx = tid; idx < L * P; idx += blockDim.x) {
      const int l = idx / P;
      const int p = idx - l * P;
      Xs[idx] = l < rows ? to_f32<T>(x[((static_cast<size_t>(b) * S + s0 + l) * H + h) * P + p])
                         : 0.f;
    }
    for (int idx = tid; idx < L * N; idx += blockDim.x) {
      const int l = idx / N;
      const int n = idx - l * N;
      float vb = 0.f, vc = 0.f;
      if (l < rows) {
        const size_t off = ((static_cast<size_t>(b) * S + s0 + l) * G + g) * N + n;
        vb = to_f32<T>(Bm[off]);
        vc = to_f32<T>(Cm[off]);
      }
      Bw[idx] = vb;
      Bt[n * LT + l] = vb;
      Ct[n * LT + l] = vc;
    }
    if (tid < L)
      dts[tid] = tid < rows ? dt[(static_cast<size_t>(b) * S + s0 + tid) * H + h] : 0.f;
    __syncthreads();

    // -- cum: inclusive cumsum of a * dt, by warp 0 (two rows a lane) --------------
    if (tid < 32) {
      const float d0 = a * dts[2 * tid];
      const float d1 = a * dts[2 * tid + 1];
      float incl = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      const float prev = __shfl_up_sync(0xffffffffu, incl, 1);
      const float c0 = (tid == 0 ? 0.f : prev) + d0;
      const float c1 = c0 + d1;
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      cum[2 * tid] = c0;
      cum[2 * tid + 1] = c1;
      ecum[2 * tid] = expf(c0);
      ecum[2 * tid + 1] = expf(c1);
      wts[2 * tid] = expf(last - c0) * dts[2 * tid];  // last - c0 <= 0
      wts[2 * tid + 1] = expf(last - c1) * dts[2 * tid + 1];
    }
    __syncthreads();

    // -- intra-chunk scores, St[j][i] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j, j <= i
    for (int t = tid; t < LB * LB; t += blockDim.x) {
      const int ti = t / LB;
      const int tj = t - ti * LB;
      if (tj > ti) continue;  // wholly above the diagonal: never read
      const int i0 = 4 * ti, j0 = 4 * tj;
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) outer_fma(acc, ld4(Ct + n * LT + i0), ld4(Bt + n * LT + j0));
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = i0 + u, j = j0 + v;
          St[j * LT + i] = j <= i ? acc[u][v] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
    }
    // the state update's B, scaled by w_j = exp(cum_L - cum_j) * dt_j
    for (int idx = tid; idx < L * N; idx += blockDim.x) Bw[idx] *= wts[idx / N];
    __syncthreads();

    // -- y = scores @ x + exp(cum) * (C @ h), from the state entering the chunk --------
    for (int t = tid; t < LB * PT; t += blockDim.x) {
      const int ti = t / PT;
      const int tp = t - ti * PT;
      const int i0 = 4 * ti, p0 = 4 * tp;
      float intra[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < i0 + 4; ++j)
        outer_fma(intra, ld4(St + j * LT + i0), ld4(Xs + j * P + p0));
      for (int n = 0; n < N; ++n) outer_fma(inter, ld4(Ct + n * LT + i0), ld4(Hs + n * P + p0));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        if (i >= rows) continue;
        T* yr = y + ((static_cast<size_t>(b) * S + s0 + i) * H + h) * P + p0;
#pragma unroll
        for (int v = 0; v < 4; ++v) yr[v] = from_f32<T>(intra[u][v] + ecum[i] * inter[u][v]);
      }
    }
    __syncthreads();  // every thread has read the old state

    // -- state: h = exp(cum_L) * h + Bw^T @ x ---------------------------------------
    const float decay = ecum[L - 1];
    for (int t = tid; t < (N / 4) * PT; t += blockDim.x) {
      const int tn = t / PT;
      const int tp = t - tn * PT;
      const int n0 = 4 * tn, p0 = 4 * tp;
      float acc[4][4] = {};
      for (int j = 0; j < rows; ++j) outer_fma(acc, ld4(Bw + j * N + n0), ld4(Xs + j * P + p0));
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float* hp = Hs + (n0 + u) * P + p0 + v;
          *hp = decay * *hp + acc[u][v];
        }
    }
    __syncthreads();  // before the next chunk overwrites Xs and Bw
  }

  float* out = hT + (static_cast<size_t>(b) * H + h) * N * P;
  for (int i = tid; i < N * P; i += blockDim.x) out[i] = Hs[i];
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y,
           void* hT, int Bt, int S, int H, int G, int N, int P, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_floats(N, P)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_fwd_kernel<T><<<dim3(H, Bt), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(hT), S, H, G, N, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// Dynamic shared memory one block asks for at state size N and head dim P.  The
// wrapper checks it against the card's 227 KB.
extern "C" long long ssd_scan_fwd_smem(int N, int P) {
  return repro_torch::smem_floats(N, P) * static_cast<long long>(sizeof(float));
}

// x, y: (Bt, S, H, P) with dtype code `dtype`; dt: (Bt, S, H) f32; A: (H,) f32;
// B, C: (Bt, S, G, N) with dtype code `dtype`; hT: (Bt, H, N, P) f32; all contiguous.
// N and P multiples of 4, H a multiple of G.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, void* y, void* hT, int Bt, int S, int H, int G, int N,
                            int P, int dtype, void* stream) {
  using namespace repro_torch;
  if (Bt <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 || P <= 0 || N % 4 != 0 ||
      P % 4 != 0 || Bt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(x, dt, A, B, C, y, hT, Bt, S, H, G, N, P, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, dt, A, B, C, y, hT, Bt, S, H, G, N, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
