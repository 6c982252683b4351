// FlashAttention forward (GQA, causal and sliding-window masks) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention_fwd
// (body _fa_kernel).  On the TPU the KV axis was a sequential grid dimension whose
// online-softmax state lived in VMEM scratch between grid steps.  Here blocks run in
// parallel and in no order, so one block owns one (batch, head, 64-row query tile) and
// walks the KV tiles in a loop, keeping the state (running max m, running sum l, the
// 64 x D accumulator) in registers.
//
// Bound on the H100: operations.  Per query tile every KV tile costs 2 * 64 * 64 * D
// multiply-adds against (2 * 64 * D) loaded values, well above the card's ~295
// operations per byte.  This first version spends them as plain f32 FMAs, not tensor
// cores (mma.sync / wgmma are for a later change), so it runs far from the bf16
// tensor-core bound; what it does about the bound is to do no work it can skip:
//   * KV tiles that causality or the window masks for every row of the query tile
//     are never loaded (the loop bounds are the conditions of the TPU kernel's
//     pl.when: k_start <= q_start + BQ - 1, k_start + BK - 1 >= q_start - window + 1);
//   * KV head h / group is read directly (GQA), never materialised per query head;
//   * Q, K and V tiles sit in shared memory, each value read from device memory
//     once per tile, and every thread reuses 4 Q rows x 4 K rows per step.
// Shared memory is what limits the tile: at head_dim 256 the f32 tiles need 209 KB
// and the bf16 ones 113 KB, above the static 48 KB, so the tiles are dynamic shared
// memory sized from D and the dtype, after cudaFuncSetAttribute.
//
// With a non-null `lse` pointer the kernel also writes each row's logsumexp,
// lse = m + log(l) in the scaled-score units of the reference's chunked twin
// (src/repro/kernels/ref.py::flash_attention_fwd_lse_chunked): the residual the
// chunked backward needs, from the m and l the online softmax keeps anyway, so
// training needs no second attention pass.  Null (serving) writes nothing.
//
// Numerics follow the reference: scores, softmax and P·V in f32 (P is kept in f32,
// not rounded to bf16), the finite mask value -1e30, and the l == 0 guard.  Columns
// past the end of K are the only ones given -inf, so that they add nothing even to a
// row that has seen no visible column yet.  Rows and columns past Sq and Skv are
// masked, so any Sq and Skv work.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16 threads: each owns 4 query rows
constexpr int PS = BK + 1;    // row stride of the P tile (pad: no bank conflicts)
constexpr float kNegInf = -1e30f;

// Row padding of the Q and K tiles, chosen so that 16 consecutive rows fall in 16
// different shared-memory banks (the row stride in 32-bit words is odd).
template <typename T>
struct RowPad;
template <>
struct RowPad<float> {
  static constexpr int value = 1;
};
template <>
struct RowPad<__nv_bfloat16> {
  static constexpr int value = 2;
};

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (2 * BQ * (D + RowPad<T>::value) + BK * D) * sizeof(T) + BQ * PS * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, float* __restrict__ lse, int H, int KVH, int Sq, int Skv,
                  int causal, int window, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int QS = D + RowPad<T>::value;  // row stride of the Q and K tiles
  constexpr int DC = D / 16;                // accumulator columns per thread

  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BQ * QS;
  T* sV = sK + BK * QS;
  float* sP = reinterpret_cast<float*>(sV + BK * D);

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // owns key columns tx + 16 j and head-dim columns tx + 16 c
  const int ty = tid >> 4;  // owns query rows ty + 16 i
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q_start = blockIdx.x * BQ;

  const T* qb = q + (static_cast<size_t>(b) * H + h) * Sq * D;
  const T* kb = k + (static_cast<size_t>(b) * KVH + kvh) * Skv * D;
  const T* vb = v + (static_cast<size_t>(b) * KVH + kvh) * Skv * D;
  T* ob = o + (static_cast<size_t>(b) * H + h) * Sq * D;

  const T zero = from_f32<T>(0.f);
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = q_start + r;
    sQ[r * QS + c] = gr < Sq ? qb[static_cast<size_t>(gr) * D + c] : zero;
  }

  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // KV tiles with at least one visible column for some row of this query tile
  int kt_lo = 0;
  int kt_hi = (Skv + BK - 1) / BK;
  if (causal) kt_hi = min(kt_hi, (q_start + BQ - 1) / BK + 1);
  if (window > 0) {
    const int first_col = q_start - window + 1;  // oldest column the first row sees
    if (first_col > 0) kt_lo = first_col / BK;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int gr = k_start + r;
      const bool in = gr < Skv;
      sK[r * QS + c] = in ? kb[static_cast<size_t>(gr) * D + c] : zero;
      sV[r * D + c] = in ? vb[static_cast<size_t>(gr) * D + c] : zero;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 x 4 entries
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = to_f32(sQ[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = to_f32(sK[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax, P into shared memory, rescale the accumulator
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_start + ty + 16 * i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k_start + tx + 16 * j;
        float val = s[i][j] * scale;
        if (col >= Skv) {
          val = -INFINITY;
        } else if ((causal && col > row) || (window > 0 && col <= row - window)) {
          val = kNegInf;
        }
        s[i][j] = val;
        row_max = fmaxf(row_max, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        sP[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = alpha * l[i] + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float vv = to_f32(sV[c * D + tx + 16 * dc]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][dc] = fmaf(p[i], vv, acc[i][dc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_start + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int dc = 0; dc < DC; ++dc)
      ob[static_cast<size_t>(row) * D + tx + 16 * dc] = from_f32<T>(acc[i][dc] / denom);
    // the 16 threads of a row hold the same m and l (reduced over tx above)
    if (lse != nullptr && tx == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] = m[i] + logf(denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int KVH, int Sq, int Skv, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, KVH, Sq, Skv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_head_dim(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int H, int KVH, int Sq, int Skv, int D, int causal, int window, float scale,
                      cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
long long smem_for_head_dim(int D) {
  switch (D) {
    case 16:
      return smem_bytes<T, 16>();
    case 32:
      return smem_bytes<T, 32>();
    case 64:
      return smem_bytes<T, 64>();
    case 128:
      return smem_bytes<T, 128>();
    case 256:
      return smem_bytes<T, 256>();
    default:
      return -1;
  }
}

}  // namespace
}  // namespace repro_torch

// Dynamic shared memory one block of the kernel asks for, or -1 when the head_dim or
// dtype has no instantiation.  The wrapper checks it against the card's 227 KB.
extern "C" long long flash_attention_fwd_smem(int D, int dtype) {
  using namespace repro_torch;
  if (dtype == kFloat32) return smem_for_head_dim<float>(D);
  if (dtype == kBFloat16) return smem_for_head_dim<__nv_bfloat16>(D);
  return -1;
}

// q, o: (B, H, Sq, D); k, v: (B, KVH, Skv, D); all contiguous with dtype code `dtype`.
// lse: null, or (B, H, Sq) f32 contiguous, written with each row's logsumexp.
// window <= 0 means no window.  Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int H, int KVH, int Sq, int Skv, int D,
                                   int dtype, int causal, int window, float scale, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Skv <= 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == kFloat32)
    return dispatch_head_dim<float>(q, k, v, o, l, B, H, KVH, Sq, Skv, D, causal, window, scale,
                                    s);
  if (dtype == kBFloat16)
    return dispatch_head_dim<__nv_bfloat16>(q, k, v, o, l, B, H, KVH, Sq, Skv, D, causal, window,
                                            scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
