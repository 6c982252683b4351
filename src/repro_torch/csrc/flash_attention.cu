// FlashAttention forward (GQA, causal and sliding-window masks) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention_fwd
// (body _fa_kernel).  On the TPU the KV axis was a sequential grid dimension whose
// online-softmax state lived in VMEM scratch between grid steps.  Here blocks run in
// parallel and in no order, so one block owns one (batch, head, query tile) and walks
// the KV tiles in a loop, keeping the state (running max m, running sum l, the
// accumulator) in registers.
//
// Bound on the H100: operations.  Per query tile every KV tile of BK keys costs
// 2 * BQ * BK * D multiply-adds against 2 * BK * D loaded values, well above the card's
// ~295 bf16 (~20 f32) operations per byte.  Two kernels, chosen by dtype in flash_attention_fwd below:
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
// f32 (the examples, the f32 placed prefills): fa_fwd_simt_kernel, on the CUDA cores.
//   Tensor cores on f32 inputs would be TF32 (10-bit mantissas), a numerics change the
//   reference does not make, so every product is an FFMA; its bound is the card's
//   67 TFLOP/s of f32 FMA.  The design is an FFMA SGEMM's, twice a KV tile:
//   * A block owns 64 query rows (32 at head_dim 16) in row groups of 16 lanes (a
//     half-warp).  Each thread holds TM rows (ty + RY i: 4, or 8 at head_dim 32 and
//     128) by BK / 16 keys (tx + 16 j) of S, and the same rows by D / 16 columns of the
//     accumulator.  Q, K and V tiles keep their (row, D) layout with 16 bytes of
//     padding a row, so a thread reads 4 columns of D of a row in one 16-byte load:
//     per 4 columns of D, TM loads of Q (two rows a warp: a broadcast) and BK / 16 of
//     K (16 consecutive rows a half-warp, in distinct banks) feed 4 TM BK / 16 FMAs.
//     P goes through shared memory only within its half-warp, so a __syncwarp and no
//     block barrier publishes it; P·V then reads 4 keys of P a row and 16-byte pieces
//     of V rows along D.
//   * K and V tiles (64 keys at head_dim 32 and 64, 32 elsewhere) come by cp.async
//     16-byte copies into a ring of 2 stages, with Q in the first group: while tile t
//     is computed, tile t + 1 is in flight.  One block barrier a tile.
//   * Shared memory is 19, 67, 108, 114 and 212 KB a block at head_dim 16 to 256: two
//     blocks an SM at 64 and 128 (with the carveout set to all shared memory), one at
//     256.  __launch_bounds__ names those block counts, so no instantiation spills.
//   * As in the bf16 kernel: tiles no row of the block sees are skipped, only tiles
//     that cross the diagonal, the window's edge or Skv take per-element masks, query
//     tiles are issued longest first, and the softmax is exp2 with the scale and
//     log2(e) folded into one multiply of the f32 scores.
//   At train_e2e's shape a block alone takes about 4.4 us a 64 x 64 x 64 tile, half the
//   SM's FMA rate (launch/profile_flash.py's probes), so the longest causal blocks, 4
//   tiles, set the call's time.  Larger register tiles read from d-major Q and K tiles
//   (csrc/variants/k4_f32_dmajor.patch: 8 x 8 or 8 x 4 scores a thread, 4 or 2.67 FMAs
//   a shared-memory word against 2 here at head_dim 64) were slower at head_dim 64 and
//   128: fewer threads share a tile's FMAs, so the longest block's walk takes longer.
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

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInfLog2 = -1e30f * kLog2e;  // the finite mask value, in log2 units
constexpr int kMaxDevices = 64;

// Runs `set` (a kernel's shared-memory attributes) on the current device the first time
// a launch there asks: the attributes are per device, and setting them on every call
// costs host time.  `done` is the calling kernel's record.
template <typename Set>
cudaError_t once_per_device(bool (&done)[kMaxDevices], Set set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = set();
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

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
  static bool configured[kMaxDevices] = {};
  const cudaError_t err = once_per_device(configured, [] {
    return cudaFuncSetAttribute(fa_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                G::SMEM);
  });
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
// f32: the register-blocked SIMT kernel
// ==================================================================================
namespace simt {

constexpr int kRX = 16;             // lanes of a row group: a half-warp
constexpr int kPad = 4;             // floats of padding after each row of the Q, K and V tiles
constexpr int kSmemPerSM = 233472;  // 228 KB, of which each block also holds 1 KB

// Tile geometry at head_dim D, as measured best on the H100 (launch/profile_flash.py):
// 64 query rows a block (32 at head_dim 16, whose calls are short), 4 rows a thread
// (256 threads: the more warps hide more latency) where the registers allow it and 8
// (128 threads) at head_dim 32 and 128; KV tiles of 64 keys at head_dim 32 and 64 and
// of 32 elsewhere, so that two blocks fit an SM at head_dim 128 and one at 256.  The
// Q, K and V tiles keep their (row, D) layout with rows padded by 16 bytes: the 8 lanes
// of a quarter-warp that read one 16-byte piece of 8 consecutive rows then hit 8
// different bank groups at every D.  P's row stride is 16 words off a multiple of 32,
// so the two row groups of a warp write disjoint banks.
template <int D>
struct Tile {
  static constexpr int BQ = D == 16 ? 32 : 64;             // query rows per block
  static constexpr int TM = D == 32 || D == 128 ? 8 : 4;  // query rows a thread: ty + RY i
  static constexpr int BK = D == 32 || D == 64 ? 64 : 32;  // keys per KV tile
  static constexpr int RY = BQ / TM;                       // row groups
  static constexpr int THREADS = RY * kRX;
  static constexpr int TN = BK / kRX;         // keys per thread: tx + 16 j
  static constexpr int CW = D / kRX;          // output columns per thread
  static constexpr int VW = CW < 4 ? CW : 4;  // floats per vector load of V and store of O
  static constexpr int NV = CW / VW;          // vectors a row: columns VW tx + 16 VW c + e
  static constexpr int QS = D + kPad;         // row stride of the Q, K and V tiles
  static constexpr int PS = BK + kRX;         // row stride of the P tile
  static constexpr int KV_TILE = BK * QS;
  static constexpr int OFF_K = BQ * QS;        // in floats; then V, then P
  static constexpr int OFF_V = OFF_K + 2 * KV_TILE;
  static constexpr int OFF_P = OFF_V + 2 * KV_TILE;
  static constexpr int SMEM = (OFF_P + BQ * PS) * 4;  // bytes
  // blocks an SM holds by shared memory, at most 4 (19, 67, 108, 114 and 212 KB a
  // block at head_dim 16 to 256: 4, 3, 2, 2 and 1)
  static constexpr int MIN_BLOCKS =
      kSmemPerSM / (SMEM + 1024) < 4 ? kSmemPerSM / (SMEM + 1024) : 4;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ROWS rows of a (S, D) head from row `first` into a padded shared tile, 16 bytes a
// copy; rows at or past `limit` are zero-filled (V's must be: 0 * garbage may be NaN)
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int first, int limit) {
  constexpr int CHUNKS = D / 4, THREADS = Tile<D>::THREADS;
  static_assert(ROWS * CHUNKS % THREADS == 0, "a tile must split evenly over the block");
#pragma unroll
  for (int n = 0; n < ROWS * CHUNKS / THREADS; ++n) {
    const int idx = threadIdx.x + n * THREADS;
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const int gr = first + r;
    const bool in = gr < limit;
    cp_async16(dst + r * Tile<D>::QS + 4 * c, src + static_cast<size_t>(in ? gr : 0) * D + 4 * c,
               in);
  }
}

// One KV tile's online-softmax step on this thread's TM x TN scores (rows row0 + RY i,
// columns col0 + 16 j): the scale into log2 units, the masks (kMask), each row's max
// over its 16 lanes, the rescale of l and of the accumulator, and P in place of S.
template <int TM, int RY, int TN, int CW, bool kMask>
__device__ __forceinline__ void softmax_step(float (&s)[TM][TN], float (&m)[TM],
                                             float (&l)[TM], float (&acc)[TM][CW], int row0,
                                             int col0, int Skv, int causal, int window,
                                             float scale_log2) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + RY * i;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float t = s[i][j] * scale_log2;
      if constexpr (kMask) {
        const int col = col0 + kRX * j;
        if (col >= Skv) {
          t = -INFINITY;
        } else if ((causal && col > row) || (window > 0 && col <= row - window)) {
          t = kNegInfLog2;
        }
      }
      s[i][j] = t;
      mx = fmaxf(mx, t);
    }
#pragma unroll
    for (int off = kRX / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[i], mx);
    const float alpha = exp2f(m[i] - m_new);
    m[i] = m_new;
    float sum = 0.f;  // this lane's part of the row sum; the 16 parts meet at the end
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      s[i][j] = exp2f(s[i][j] - m_new);
      sum += s[i][j];
    }
    l[i] = l[i] * alpha + sum;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] *= alpha;
  }
}

// VW consecutive floats between shared or global memory and registers, as one load or
// store of 4, 8 or 16 bytes
template <int VW>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x, dst[1] = t.y, dst[2] = t.z, dst[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x, dst[1] = t.y;
  } else {
    dst[0] = *src;
  }
}
template <int VW>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  else if constexpr (VW == 2)
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  else
    *dst = src[0];
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS, Tile<D>::MIN_BLOCKS)
    fa_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int BH, int H, int KVH, int Sq, int Skv,
                       int causal, int window, float scale_log2) {
  using G = Tile<D>;
  constexpr int TM = G::TM, RY = G::RY, BK = G::BK, TN = G::TN, CW = G::CW, VW = G::VW,
                NV = G::NV, QS = G::QS, PS = G::PS;
  static_assert(D % 16 == 0 && CW == NV * VW, "head_dim must be a multiple of 16");
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sP = smem + G::OFF_P;

  const int tx = threadIdx.x % kRX;
  const int ty = threadIdx.x / kRX;  // a warp holds row groups 2w and 2w + 1

  // longest query tiles first: with causality the last tile has the most KV tiles
  const int n_qt = (Sq + G::BQ - 1) / G::BQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int h = bh % H;
  const int bkv = (bh / H) * KVH + h / (H / KVH);
  const int q_start = qt * G::BQ;
  const int q_last = min(q_start + G::BQ, Sq) - 1;
  // the KV tiles in which some row of this block sees a column
  int kt_lo = 0, kt_hi = (Skv + BK - 1) / BK;
  if (causal) kt_hi = min(kt_hi, q_last / BK + 1);
  if (window > 0 && q_start - window + 1 > 0) kt_lo = (q_start - window + 1) / BK;
  const int n_tiles = max(kt_hi - kt_lo, 0);

  const float* qb = q + static_cast<size_t>(bh) * Sq * D;
  const float* kb = k + static_cast<size_t>(bkv) * Skv * D;
  const float* vb = v + static_cast<size_t>(bkv) * Skv * D;

  float acc[TM][CW];
  float m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInfLog2;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  if (n_tiles > 0) {
    load_rows<D, G::BQ>(sQ, qb, q_start, Sq);
    load_rows<D, BK>(smem + G::OFF_K, kb, kt_lo * BK, Skv);
    load_rows<D, BK>(smem + G::OFF_V, vb, kt_lo * BK, Skv);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    // tile t has landed for every thread, and every thread is done with tile t - 1,
    // whose stage the next copies refill while this tile is computed
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int next = (kt_lo + t + 1) * BK, st = (t + 1) & 1;
      load_rows<D, BK>(smem + G::OFF_K + st * G::KV_TILE, kb, next, Skv);
      load_rows<D, BK>(smem + G::OFF_V + st * G::KV_TILE, vb, next, Skv);
      cp_async_commit();
    }
    const float* sK = smem + G::OFF_K + (t & 1) * G::KV_TILE;
    const float* sV = smem + G::OFF_V + (t & 1) * G::KV_TILE;
    const int k_start = (kt_lo + t) * BK;
    const bool need_mask = k_start + BK > Skv || (causal && k_start + BK - 1 > q_start) ||
                           (window > 0 && k_start <= q_last - window);

    // S = Q K^T: per 4 columns of D, TN + TM 16-byte loads for 4 TM TN FMAs
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      float4 kf[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        kf[j] = *reinterpret_cast<const float4*>(sK + (tx + kRX * j) * QS + d);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 qf = *reinterpret_cast<const float4*>(sQ + (ty + RY * i) * QS + d);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
        }
      }
    }

    if (need_mask)
      softmax_step<TM, RY, TN, CW, true>(s, m, l, acc, q_start + ty, k_start + tx, Skv, causal,
                                         window, scale_log2);
    else
      softmax_step<TM, RY, TN, CW, false>(s, m, l, acc, q_start + ty, k_start + tx, Skv, causal,
                                          window, scale_log2);

    // P through shared memory to the lanes of the same half-warp, which alone read
    // these rows: a warp barrier, not a block one
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sP[(ty + RY * i) * PS + tx + kRX * j] = s[i][j];
    __syncwarp();

    // acc += P V: per 4 keys, TM + 4 NV vector loads for 4 TM CW FMAs
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pf[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        pf[i] = *reinterpret_cast<const float4*>(sP + (ty + RY * i) * PS + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vf[CW];
#pragma unroll
        for (int c = 0; c < NV; ++c)
          load_vec<VW>(vf + c * VW, sV + (kk + e) * QS + VW * tx + kRX * VW * c);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float p = e == 0 ? pf[i].x : (e == 1 ? pf[i].y : (e == 2 ? pf[i].z : pf[i].w));
#pragma unroll
          for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(p, vf[c], acc[i][c]);
        }
      }
    }
  }

  // ---- epilogue: O = acc / l, lse in natural-log units ------------------------------
  float* ob = o + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float lsum = l[i];
#pragma unroll
    for (int off = kRX / 2; off > 0; off >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    const int row = q_start + ty + RY * i;
    if (row > q_last) continue;
    const float denom = lsum == 0.f ? 1.f : lsum;
    float out[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) out[c] = acc[i][c] / denom;
#pragma unroll
    for (int c = 0; c < NV; ++c)
      store_vec<VW>(ob + static_cast<size_t>(row) * D + VW * tx + kRX * VW * c, out + c * VW);
    if (lse != nullptr && tx == 0)
      lse[static_cast<size_t>(bh) * Sq + row] = m[i] * kLn2 + logf(denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int KVH, int Sq, int Skv, int causal, int window, float scale, cudaStream_t stream) {
  using G = Tile<D>;
  // 16-byte copies and stores
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static bool configured[kMaxDevices] = {};
  const cudaError_t err = once_per_device(configured, [] {
    cudaError_t e = cudaFuncSetAttribute(
        fa_fwd_simt_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e == cudaSuccess)  // the whole 228 KB as shared memory: two blocks at head_dim 128
      e = cudaFuncSetAttribute(fa_fwd_simt_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((Sq + G::BQ - 1) / G::BQ) * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fa_fwd_simt_kernel<D><<<static_cast<unsigned>(blocks), G::THREADS, G::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, B * H, H, KVH, Sq, Skv, causal, window, scale * kLog2e);
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
    return simt::launch<D>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
long long smem_by_dtype(int dtype) {
  if (dtype == kBFloat16) return tc::Geom<D>::SMEM;
  if (dtype == kFloat32) return simt::Tile<D>::SMEM;
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

// q, o: (B, H, Sq, D); k, v: (B, KVH, Skv, D); all contiguous with dtype code `dtype`,
// 16-byte aligned.  lse: null, or (B, H, Sq) f32 contiguous, written with
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
