// FlashAttention forward (GQA, causal and sliding-window masks) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention_fwd
// (body _fa_kernel).  On the TPU the KV axis was a sequential grid dimension whose
// online-softmax state lived in VMEM scratch between grid steps.  Here blocks run in
// parallel and in no order, so one block owns one (batch, head, query tile) and walks
// the KV tiles in a loop, keeping the state (running max m, running sum l, the
// accumulator) in registers.
//
// Bound on the H100: operations.  Per query tile every KV tile costs 2 * BQ * 64 * D
// multiply-adds against (2 * 64 * D) loaded values, well above the card's ~295
// operations per byte.  Two kernels, chosen by dtype in flash_attention_fwd below:
//
// bf16 (every main path): fa_fwd_tc_kernel, on the tensor cores.
//   * A block of 384 threads: two consumer warpgroups of 64 query rows each (BQ 128)
//     and one producer warpgroup, whose first thread keeps K and V tiles of 64 keys in
//     flight with TMA (cp.async.bulk.tensor) into a ring of 2 stages, each stage a K
//     and a V buffer with a "full" mbarrier, and one "empty" mbarrier on which the
//     256 consumer threads arrive when the stage may be refilled.  Q comes once, by
//     TMA too.  setmaxnreg gives the producer 24 registers a thread and the consumers
//     240: at head_dim 256 the 64 x 256 f32 accumulator alone is 128 a thread.
//   * S = Q K^T is wgmma m64n64k16 with both operands in shared memory: Q and K in
//     their natural (row, D) layout, which is K-major for wgmma.  O += P V is wgmma
//     m64nDk16 with P from registers (the S accumulator fragment, rescaled and packed
//     to bf16 in place: no shared-memory round trip) and V from shared memory in its
//     (key, D) layout, MN-major for wgmma's B, so the descriptor's transpose bit is
//     set.  Tiles are stored as TMA writes them: column chunks of 128 bytes (64 bytes
//     at head_dim 32, 32 at 16) with the swizzle of the same width, which the
//     descriptors name.  A 3-D tensor map over (D, S, batch * heads) makes TMA
//     zero-fill the rows past each head's end.
//   * The online softmax runs on the accumulator fragment: each row lies in the 4
//     lanes of a quad, so its max is two shuffles; l stays a per-thread partial until
//     the end.  p = exp2(s * scale * log2(e) - m) is one FMA and one exp2, with m kept
//     in log2 units; lse is turned back into natural-log units at the end.  The scale
//     multiplies the f32 scores, never Q before the product: rounding q * scale to
//     bf16 would add an error the reference does not have.
//   * KV tiles that causality or the window masks for every row of the block are
//     never loaded; a warpgroup skips the tiles masked for all its 64 rows, and only
//     the tiles that cross the diagonal, the window's edge or Skv take per-element
//     masks.  Query tiles are issued longest first (the last causal tile first).
// f32: fa_fwd_simt_kernel, the plain f32 FMAs of the first port.  Tensor cores on f32
//   inputs would be TF32 (10-bit mantissas), a numerics change the reference does not
//   make, so f32 stays on the SIMT kernel: 64-row query tiles, K and V tiles loaded
//   synchronously into shared memory, 4 x 4 scores a thread.
//
// With a non-null `lse` pointer the kernels also write each row's logsumexp,
// lse = m + log(l) in the scaled-score units of the reference's chunked twin
// (src/repro/kernels/ref.py::flash_attention_fwd_lse_chunked): the residual the
// chunked backward needs, from the m and l the online softmax keeps anyway, so
// training needs no second attention pass.  Null (serving) writes nothing.
//
// Numerics.  f32: scores, softmax and P·V in f32, as the reference.  bf16: Q·K^T is
// exact products of the bf16 inputs summed in f32 (the reference's f32 dot of bf16
// values); P is rounded to bf16 for P·V, as FlashAttention-2 and -3 do, where the
// reference keeps P in f32 (l sums the unrounded f32 P, so lse does not see that
// rounding); the accumulator stays f32.  Both: the finite mask value -1e30 (in
// scaled-score units), the l == 0 guard, and -inf only for the columns past the end
// of K, so that they add nothing even to a row that has seen no visible column yet.
// Rows and columns past Sq and Skv are masked, so any Sq and Skv work.

#include <cuda.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

// ==================================================================================
// bf16: the tensor-core kernel
// ==================================================================================
namespace tc {

using namespace hopper;

constexpr int kBK = 64;                        // keys per KV tile
constexpr int kWgRows = 64;                    // query rows per consumer warpgroup
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kBQ = kConsumers * kWgRows;      // query rows per block
constexpr int kStages = 2;                     // K/V ring depth
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInfLog2 = -1e30f * kLog2e;  // the finite mask value, in log2 units

// Shared-memory geometry at head_dim D.  Each tile is stored as NC column chunks of
// COLS bf16 (SW bytes a row), the chunk the TMA box and the swizzle cover.
template <int D>
struct Geom {
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;
  static constexpr int COLS = SW / 2;
  static constexpr int NC = D / COLS;
  static constexpr CUtensorMapSwizzle TMA_SWIZZLE =
      SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : (SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
  static constexpr uint32_t DESC_SWIZZLE = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
  static constexpr int Q_CHUNK = kWgRows * SW;  // bytes of one column chunk of a Q tile
  static constexpr int KV_CHUNK = kBK * SW;
  static constexpr int Q_WG = NC * Q_CHUNK;  // one consumer warpgroup's Q rows
  static constexpr int KV_TILE = NC * KV_CHUNK;
  static constexpr int OFF_K = kConsumers * Q_WG;
  static constexpr int OFF_V = OFF_K + kStages * KV_TILE;
  static constexpr int OFF_BAR = OFF_V + kStages * KV_TILE;
  static constexpr int N_BAR = 1 + 3 * kStages;
  // + the barriers, + slack to align the base to the 1024 bytes of a swizzle pattern
  static constexpr int SMEM = OFF_BAR + 8 * N_BAR + 1024;
};

// The KV tiles [lo, hi) in which some row of [first, last] sees a column.
__device__ __forceinline__ void visible_tiles(int first, int last, int Skv, int causal,
                                              int window, int& lo, int& hi) {
  lo = 0;
  hi = (Skv + kBK - 1) / kBK;
  if (causal) hi = min(hi, last / kBK + 1);
  if (window > 0 && first - window + 1 > 0) lo = (first - window + 1) / kBK;
}

// One KV tile's online-softmax step on a warpgroup's S fragment (rows row0 and
// row0 + 8 of this thread): masks (kMask), row max and sum, the rescale of O, and P
// packed to bf16 as the A fragments of the four k16 steps of P·V.
template <int D, bool kMask>
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&o)[D / 2], uint32_t (&p)[4][4], int row0,
                                             int k_start, int Skv, int causal, int window,
                                             float scale_log2) {
  const int lane_col = 2 * (threadIdx.x & 3);
  if constexpr (kMask) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = k_start + 8 * j + lane_col + (e & 1);
        float t = s[4 * j + e] * scale_log2;
        if (col >= Skv) {
          t = -INFINITY;
        } else if ((causal && col > row) || (window > 0 && col <= row - window)) {
          t = kNegInfLog2;
        }
        s[4 * j + e] = t;
      }
  }
  // masked scores are already in log2 units; interior ones fold the scale in the FMA
  const float factor = kMask ? 1.f : scale_log2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * factor);
    const float alpha = exp2f(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pv = exp2f(fmaf(s[4 * j + 2 * r + e], factor, -m_new));
        s[4 * j + 2 * r + e] = pv;
        sum += pv;
      }
    l[r] = l[r] * alpha + sum;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * r] *= alpha;
      o[4 * j + 2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16x2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int BH, int H, int KVH, int Sq, int Skv,
                     int causal, int window, float scale_log2) {
  using G = Geom<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  // longest query tiles first: with causality the last tile has the most KV tiles
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int h = bh % H;
  const int bkv = (bh / H) * KVH + h / (H / KVH);
  const int q_start = qt * kBQ;
  int kt_lo, kt_hi;
  visible_tiles(q_start, min(q_start + kBQ, Sq) - 1, Skv, causal, window, kt_lo, kt_hi);
  const int n_tiles = max(kt_hi - kt_lo, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(empty + st, kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load --------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers * 128) {
      tma_prefetch_desc(&tm_q);
      tma_prefetch_desc(&tm_k);
      tma_prefetch_desc(&tm_v);
      mbar_arrive_expect_tx(q_full, kConsumers * G::Q_WG);
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < G::NC; ++c)
          tma_load_3d(smem + w * G::Q_WG + c * G::Q_CHUNK, &tm_q, q_full, c * G::COLS,
                      q_start + w * kWgRows, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        mbar_wait(empty + st, ((i / kStages) & 1) ^ 1);
        const int k_start = (kt_lo + i) * kBK;
        unsigned char* sk = smem + G::OFF_K + st * G::KV_TILE;
        unsigned char* sv = smem + G::OFF_V + st * G::KV_TILE;
        mbar_arrive_expect_tx(k_full + st, G::KV_TILE);
        for (int c = 0; c < G::NC; ++c)
          tma_load_3d(sk + c * G::KV_CHUNK, &tm_k, k_full + st, c * G::COLS, k_start, bkv);
        mbar_arrive_expect_tx(v_full + st, G::KV_TILE);
        for (int c = 0; c < G::NC; ++c)
          tma_load_3d(sv + c * G::KV_CHUNK, &tm_v, v_full + st, c * G::COLS, k_start, bkv);
      }
    }
  } else {
    // ---- consumers: one warpgroup per 64 query rows --------------------------------
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128;
    const int wg_first = q_start + wg * kWgRows;
    const int wg_last = min(wg_first + kWgRows, Sq) - 1;  // < wg_first: no row left
    const int row0 = wg_first + (t / 32) * 16 + (t & 31) / 4;
    const uint32_t sq = smem_addr(smem + wg * G::Q_WG);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInfLog2, kNegInfLog2};
    float l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int k_start = (kt_lo + i) * kBK;
      const int k_end = k_start + kBK - 1;
      const bool skip = wg_last < wg_first || (causal && k_start > wg_last) ||
                        (window > 0 && k_end <= wg_first - window);
      const bool need_mask = k_end >= Skv || (causal && k_end > wg_first) ||
                             (window > 0 && k_start <= wg_last - window);
      uint32_t p[4][4];

      mbar_wait(k_full + st, parity);
      if (!skip) {
        const uint32_t sk = smem_addr(smem + G::OFF_K + st * G::KV_TILE);
        float s[32];
#pragma unroll
        for (int i2 = 0; i2 < 32; ++i2) fence_operand(s[i2]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk * 16 / G::COLS;
          const uint32_t within = (kk * 16 % G::COLS) * 2;
          const uint64_t da =
              make_desc(sq + c * G::Q_CHUNK + within, 16, 8 * G::SW, G::DESC_SWIZZLE);
          const uint64_t db =
              make_desc(sk + c * G::KV_CHUNK + within, 16, 8 * G::SW, G::DESC_SWIZZLE);
          wgmma_ss_m64n64k16(s, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i2 = 0; i2 < 32; ++i2) fence_operand(s[i2]);
        if (need_mask)
          softmax_step<D, true>(s, m, l, acc, p, row0, k_start, Skv, causal, window, scale_log2);
        else
          softmax_step<D, false>(s, m, l, acc, p, row0, k_start, Skv, causal, window,
                                 scale_log2);
      }

      mbar_wait(v_full + st, parity);
      if (!skip) {
        const uint32_t sv = smem_addr(smem + G::OFF_V + st * G::KV_TILE);
#pragma unroll
        for (int i2 = 0; i2 < D / 2; ++i2) fence_operand(acc[i2]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_rs<D>(acc, p[kk],
                      make_desc(sv + kk * 16 * G::SW, G::KV_CHUNK, 8 * G::SW, G::DESC_SWIZZLE));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i2 = 0; i2 < D / 2; ++i2) fence_operand(acc[i2]);
      }
      mbar_arrive(empty + st);
    }

    // ---- epilogue: O = acc / l in bf16, lse in natural-log units --------------------
    const int lane_col = 2 * (t & 3);
    __nv_bfloat16* ob = o + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lsum = l[r];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      const int row = row0 + 8 * r;
      if (row > wg_last) continue;
      const float denom = lsum == 0.f ? 1.f : lsum;
      __nv_bfloat16* orow = ob + static_cast<size_t>(row) * D + lane_col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
      if (lse != nullptr && (t & 3) == 0)
        lse[static_cast<size_t>(bh) * Sq + row] = m[r] * kLn2 + logf(denom);
    }
  }
}

// A 3-D tensor map over a (BH, S, D) bf16 tensor, (D, S, BH) innermost first, whose
// box is one column chunk of `rows` rows of one head: TMA zero-fills rows past S.
template <int D>
bool encode_map(CUtensorMap* map, const void* base, int S, int BH, int rows) {
  using G = Geom<D>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(G::COLS), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                const_cast<void*>(base), dims, strides, box, elem_strides,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, G::TMA_SWIZZLE,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int KVH, int Sq, int Skv, int causal, int window, float scale, cudaStream_t stream) {
  using G = Geom<D>;
  // TMA reads from 16-byte aligned addresses only
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap tq, tk, tv;
  if (!encode_map<D>(&tq, q, Sq, B * H, kWgRows) || !encode_map<D>(&tk, k, Skv, B * KVH, kBK) ||
      !encode_map<D>(&tv, v, Skv, B * KVH, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((Sq + kBQ - 1) / kBQ) * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fa_fwd_tc_kernel<D><<<static_cast<unsigned>(blocks), kThreads, G::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, B * H, H, KVH, Sq, Skv, causal, window,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ==================================================================================
// f32: the SIMT kernel
// ==================================================================================
namespace simt {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16 threads: each owns 4 query rows
constexpr int PS = BK + 1;     // row stride of the P tile (pad: no bank conflicts)
constexpr float kNegInf = -1e30f;
// row padding of the f32 Q and K tiles: an odd row stride in 32-bit words puts 16
// consecutive rows in 16 different shared-memory banks
constexpr int kRowPad = 1;

template <int D>
constexpr size_t simt_smem_bytes() {
  return (2 * BQ * (D + kRowPad) + BK * D) * sizeof(float) + BQ * PS * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, float* __restrict__ lse, int H, int KVH, int Sq, int Skv,
                  int causal, int window, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int QS = D + kRowPad;  // row stride of the Q and K tiles
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
int launch_simt(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                int KVH, int Sq, int Skv, int causal, int window, float scale,
                cudaStream_t stream) {
  constexpr size_t smem = simt_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_simt_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd_simt_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, KVH, Sq, Skv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace simt

template <int D>
int launch_by_dtype(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                    int H, int KVH, int Sq, int Skv, int dtype, int causal, int window,
                    float scale, cudaStream_t s) {
  if (dtype == kBFloat16)
    return tc::launch<D>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal, window, scale, s);
  if (dtype == kFloat32)
    return simt::launch_simt<float, D>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal, window,
                                       scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
long long smem_by_dtype(int dtype) {
  if (dtype == kBFloat16) return tc::Geom<D>::SMEM;
  if (dtype == kFloat32) return simt::simt_smem_bytes<D>();
  return -1;
}

}  // namespace
}  // namespace repro_torch

// Dynamic shared memory one block of the kernel asks for, or -1 when the head_dim or
// dtype has no instantiation.  The wrapper checks it against the card's 227 KB.
extern "C" long long flash_attention_fwd_smem(int D, int dtype) {
  using namespace repro_torch;
  switch (D) {
    case 16: return smem_by_dtype<16>(dtype);
    case 32: return smem_by_dtype<32>(dtype);
    case 64: return smem_by_dtype<64>(dtype);
    case 128: return smem_by_dtype<128>(dtype);
    case 256: return smem_by_dtype<256>(dtype);
    default: return -1;
  }
}

// q, o: (B, H, Sq, D); k, v: (B, KVH, Skv, D); all contiguous with dtype code `dtype`
// (bf16 also 16-byte aligned).  lse: null, or (B, H, Sq) f32 contiguous, written with
// each row's logsumexp.  window <= 0 means no window.  bf16 runs the tensor-core
// kernel and f32 the SIMT one.  Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int H, int KVH, int Sq, int Skv, int D,
                                   int dtype, int causal, int window, float scale, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Skv <= 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 16: return launch_by_dtype<16>(q, k, v, o, l, B, H, KVH, Sq, Skv, dtype, causal, window, scale, s);
    case 32: return launch_by_dtype<32>(q, k, v, o, l, B, H, KVH, Sq, Skv, dtype, causal, window, scale, s);
    case 64: return launch_by_dtype<64>(q, k, v, o, l, B, H, KVH, Sq, Skv, dtype, causal, window, scale, s);
    case 128: return launch_by_dtype<128>(q, k, v, o, l, B, H, KVH, Sq, Skv, dtype, causal, window, scale, s);
    case 256: return launch_by_dtype<256>(q, k, v, o, l, B, H, KVH, Sq, Skv, dtype, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
