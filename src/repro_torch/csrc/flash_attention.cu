// FlashAttention forward (GQA, causal and sliding-window masks) for Hopper (sm_90a),
// and its backward in bf16 (see "Backward" below).
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
//
// Backward (bf16 at head_dim 64 and 128; flash_attention_bwd below).  It replaces no TPU
// kernel: the JAX package's backward is plain chunked math (src/repro/kernels/ops.py::
// _flash_bwd_vjp), which the port keeps for f32 and the other head_dims
// (kernels/ref.py::flash_attention_bwd_chunked).  It was added because that plain
// backward, in f32 on the CUDA cores and over every masked pair, took a third of a
// training step at 1k context and two thirds at 4k.  Bound: operations, 10 B H D FLOPs
// a visible (query, key) pair (S and dP recomputed, then dV, dK and dQ) against q, k,
// v, o, dO and the gradients moved once.  Three launches a call:
//   * fa_bwd_pre_kernel: delta = rowsum(dO * O) in f32 and lse in log2 units, a warp a
//     row, into rows padded to the 64-query tile; padding rows get delta 0 and lse
//     +inf, so their P is 0 and no query row needs a mask.
//   * fa_bwd_tc_kernel, the main kernel.  Grid: one block per (batch, kv head, tile of
//     128 keys), key tiles in order, so that under causality the longest (the first,
//     which every query sees) go first.  384 threads: two consumer warpgroups of 64
//     keys each and a producer warpgroup whose first thread TMA-loads the block's K and
//     V tiles once, then keeps Q and dO tiles of 64 rows in flight, with their lse and
//     delta slices (bulk copies), in a ring of 2 stages with "full" and "empty"
//     mbarriers, as the forward's ring does.  It walks every q head of the kv head's
//     GQA group and, for each, the query tiles in which some row sees a key of the
//     tile (from the diagonal under causality, to the window's edge under a window),
//     so dK and dV sum the group in registers: no repeat_interleave, no reshape-sum.
//     setmaxnreg gives the producer 24 registers and the consumers 240: at head_dim
//     128 dK and dV hold 128 a thread and S^T and dP^T 64 more.  Per query tile, each
//     consumer warpgroup:
//       - S^T = K Q^T and dP^T = V dO^T, wgmma m64n64k16 with both operands in shared
//         memory in their (row, D) layout, K-major;
//       - P^T = exp2(S^T scale log2(e) - lse log2(e)), per-element masks only on tiles
//         that cross the diagonal, the window's edge or Skv, as in the forward; then
//         dS^T = P^T (dP^T - delta);
//       - dV += P^T dO and dK += dS^T Q, wgmma m64nDk16 with A from the register
//         fragment packed to bf16 in place (as the forward packs P) and B, dO or Q in
//         their (row, D) layout, MN-major (the transpose bit);
//       - dS^T to shared memory in bf16, rows of keys under the 128-byte swizzle, in
//         one of two buffers; after a named barrier of both warpgroups, dQ for the
//         tile is dS K, wgmma m64n64k16 with both operands MN-major: at head_dim 128
//         each warpgroup takes one 64-column chunk of K over the block's 128 keys, at
//         64 all columns over its own keys.  The f32 partial goes to a staging buffer
//         in the accumulator's fragment order (conflict-free stores), and one thread
//         adds its 16 KB into an f32 workspace with cp.reduce.async.bulk .add.f32, an
//         atomic add of each element.  Ordered (fa_bwd_tc_kernel<D, true>, which the
//         wrapper launches under PyTorch's deterministic algorithms): the adds into each
//         (q head, query tile) take turns in key-tile order, counted in an int32 a tile;
//         the producer loads a tile once the lower key tiles' adds there have completed,
//         and each add passes the turn on once it has (at head_dim 64 warpgroup 0's
//         before warpgroup 1's).  A key tile waits only on lower ones, issued first.
//     At the end dK (times the scale) and dV are written once, in bf16.
//   * fa_bwd_dq_kernel: dQ = scale * the workspace, in bf16, reading the fragment order.
// Numerics: S^T and dP^T are exact products of the bf16 inputs summed in f32; P^T and
// dS^T are rounded to bf16 only as operands of the dV, dK and dQ products (what the
// forward does for P V, and FlashAttention-2 and -3 do), dS from the f32 P; every sum
// is f32 and the gradients are bf16, as the chunked backward returns them; their
// relative norm errors against it are ~2.6e-3 (the card tests hold them to 1e-2 and each
// element to the bf16 tolerance, 2e-2).  dK and dV are summed in a fixed order (bitwise
// equal call to call).  dQ's f32 sum over the key tiles arrives in an order that changes
// from call to call, so two calls differ by f32 rounding, then bf16 rounding of dQ, and
// two bf16 training runs drift apart (AdamW amplifies it: 1.6e-4 of the loss by the
// third step at 8 x 1024); ordered, they are bitwise equal, at several times the
// kernel's time (PERF.md §6).
// A row that sees no key at all (a window wholly behind a row past Skv; no path has
// one) contributes nothing: its dQ row is zero and it adds nothing to dK and dV, as in
// the chunked backward, which zeroes P on every masked pair.

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

// ----------------------------------------------------------------------------------
// The backward (bf16, head_dim 64 and 128): fa_bwd_pre_kernel, fa_bwd_tc_kernel,
// fa_bwd_dq_kernel; see "Backward" in the header.
// ----------------------------------------------------------------------------------

constexpr int kBwdKeys = 128;                    // keys per block
constexpr int kBwdWgKeys = kBwdKeys / kConsumers;  // keys per consumer warpgroup
constexpr int kBwdQ = 64;                        // query rows per tile
constexpr int kBwdStages = 2;                    // Q/dO ring depth
constexpr int kDqChunk = kBwdQ * 64;             // f32 values of one dQ partial (64 x 64)

// Shared memory of the backward at head_dim D (64 or 128): the block's K and V tiles,
// the ring of Q and dO tiles with their lse and delta slices, two dS^T buffers, and
// one dQ staging buffer a consumer warpgroup.  Every tile is stored as TMA writes it:
// column chunks of 64 bf16 (128 bytes a row) under the 128-byte swizzle.
template <int D>
struct BwdGeom {
  static_assert(D == 64 || D == 128, "the backward is instantiated at head_dim 64 and 128");
  static constexpr int NC = D / 64;               // column chunks of a tile
  static constexpr int KV_CHUNK = kBwdKeys * 128;  // bytes of a column chunk of K or V
  static constexpr int KV_TILE = NC * KV_CHUNK;
  static constexpr int Q_CHUNK = kBwdQ * 128;
  static constexpr int Q_TILE = NC * Q_CHUNK;
  static constexpr int DS_TILE = kBwdKeys * kBwdQ * 2;  // rows of keys, 64 queries a row
  static constexpr int DQ_STAGE = kDqChunk * 4;
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = OFF_K + KV_TILE;
  static constexpr int OFF_Q = OFF_V + KV_TILE;
  static constexpr int OFF_DO = OFF_Q + kBwdStages * Q_TILE;
  static constexpr int OFF_DS = OFF_DO + kBwdStages * Q_TILE;
  static constexpr int OFF_DQ = OFF_DS + 2 * DS_TILE;
  static constexpr int OFF_LSE = OFF_DQ + kConsumers * DQ_STAGE;
  static constexpr int OFF_DELTA = OFF_LSE + kBwdStages * kBwdQ * 4;
  static constexpr int OFF_BAR = OFF_DELTA + kBwdStages * kBwdQ * 4;
  static constexpr int N_BAR = 1 + 2 * kBwdStages;
  static constexpr int STAGE_TX = 2 * Q_TILE + 2 * kBwdQ * 4;  // bytes a ring stage brings
  static constexpr int SMEM = OFF_BAR + 8 * N_BAR + 1024;
  static_assert(SMEM <= 232448, "the backward's tiles overrun a block's 227 KB of shared memory");
};

// delta = rowsum(dO * O) in f32, and lse in log2 units, into (BH, Sq_pad) rows padded
// to the query tile: padding rows get delta 0 and lse +inf, so that their P is 0.  A
// warp a row.
__global__ void __launch_bounds__(256)
    fa_bwd_pre_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ delta, int BH, int Sq, int Sq_pad, int D) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(BH) * Sq_pad) return;
  const int bh = static_cast<int>(row / Sq_pad), i = static_cast<int>(row % Sq_pad);
  if (i >= Sq) {
    if (lane == 0) {
      delta[row] = 0.f;
      lse2[row] = INFINITY;
    }
    return;
  }
  const size_t base = (static_cast<size_t>(bh) * Sq + i) * D;
  float sum = 0.f;
  for (int d = 2 * lane; d < D; d += 64) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + base + d));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + base + d));
    sum = fmaf(a.x, b.x, fmaf(a.y, b.y, sum));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    delta[row] = sum;
    lse2[row] = lse[static_cast<size_t>(bh) * Sq + i] * kLog2e;
  }
}

// The A fragments of four k16 steps from a 64 x 64 accumulator fragment, rounded to
// bf16 in place (the layout of hopper.cuh's register fragment)
__device__ __forceinline__ void pack_fragments(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16x2(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// S^T and dP^T to P^T and dS^T in place, for a warpgroup's 64 keys (rows key0 and
// key0 + 8 of this thread) by a tile's 64 queries (columns q0 + 8j + 2(t%4) + {0,1}):
// P = exp2(S * scale * log2(e) - lse * log2(e)), 0 where the mask hides the pair
// (kMask), then dS = P (dP - delta).  Two passes, with a compiler barrier between
// them, so that the lse and delta slices are not held in registers at once.
template <bool kMask>
__device__ __forceinline__ void bwd_scores(float (&s)[32], float (&dp)[32],
                                           const float* __restrict__ lse2,
                                           const float* __restrict__ delta, int key0, int q0,
                                           int Skv, int causal, int window, float scale_log2) {
  const int lane_col = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + lane_col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(fmaf(s[4 * j + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
      if constexpr (kMask) {
        const int key = key0 + (e >> 1) * 8;
        const int q = q0 + 8 * j + lane_col + (e & 1);
        if (key >= Skv || (causal && key > q) || (window > 0 && key <= q - window)) p = 0.f;
      }
      s[4 * j + e] = p;
    }
  }
  asm volatile("" ::: "memory");
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + lane_col);
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
  }
}

// A warpgroup's dS^T fragments (64 keys x 64 queries, bf16 pairs) into its rows of a
// dS^T buffer: row r (a key) holds 64 queries in 128 bytes, 16-byte chunk c stored at
// chunk c ^ (r % 8), as the 128-byte swizzle (and TMA) lays a tile out.  This thread's
// rows r0 and r0 + 8 share r % 8, so every address is one base XOR the chunk's offset.
__device__ __forceinline__ void store_ds(unsigned char* buf, const uint32_t (&ds)[4][4]) {
  const int t = threadIdx.x % 128;
  const int r0 = (threadIdx.x / 128) * kBwdWgKeys + (t / 32) * 16 + (t & 31) / 4;
  const uint32_t base = smem_addr(buf) + r0 * 128 + ((r0 & 7) << 4) + 4 * (t & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"((base + h * 8 * 128) ^ (j << 4)),
                   "r"(ds[j / 2][(j & 1) * 2 + h])
                   : "memory");
}

// keeps the A fragments of dV's and dK's products in their registers until the
// asynchronous wgmma that reads them has been waited on
__device__ __forceinline__ void fence_fragments(uint32_t (&pa)[4][4], uint32_t (&dsa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fence_operand(pa[kk][i]);
      fence_operand(dsa[kk][i]);
    }
}

// Ordered dQ (kOrdered): the adds into one (q head, query tile) of the workspace take
// turns in a fixed order, key tile by key tile (and, at head_dim 64, warpgroup 0's before
// warpgroup 1's), so that the f32 sums, and dQ, are the same on every call.  A tile's
// turn is the count of adds completed there: the producer waits for it (acquire) before
// loading the tile, and each add passes it on (release) once it has completed.  Key
// tiles only wait on lower ones, whose blocks were issued first, so every wait ends; one
// that outlasts 2^26 reads (seconds, where a block's whole work takes milliseconds) is a
// fault, and traps rather than hangs.
__device__ __forceinline__ void wait_turn(const int* sem, int turn) {
  int now;
  for (unsigned polls = 0;; ++polls) {
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(now) : "l"(sem) : "memory");
    if (now == turn) break;
    if (polls == (1u << 26)) __trap();
  }
}
__device__ __forceinline__ void pass_turn(int* sem) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(sem), "r"(1) : "memory");
}

template <int D, bool kOrdered>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse2,
                     const float* __restrict__ delta, float* __restrict__ dq_acc,
                     int* __restrict__ dq_turns, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int B, int H, int KVH, int Sq, int Skv,
                     int causal, int window, float scale, float scale_log2) {
  using G = BwdGeom<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kBwdStages;

  // longest key tiles first: with causality the first tile is seen by every query
  const int BKV = B * KVH;
  const int bkv = blockIdx.x % BKV;
  const int kt = static_cast<int>(blockIdx.x / BKV);
  const int group = H / KVH;
  const int bh0 = (bkv / KVH) * H + (bkv % KVH) * group;  // the group's first q head
  const int k0 = kt * kBwdKeys;
  const int k_last = min(k0 + kBwdKeys, Skv) - 1;
  const int n_qt = (Sq + kBwdQ - 1) / kBwdQ;
  const int Sq_pad = n_qt * kBwdQ;
  // the query tiles in which some row sees a key of this tile
  const int qt_lo = causal ? min(k0 / kBwdQ, n_qt) : 0;
  const int qt_hi = window > 0 ? min(n_qt, (k_last + window - 1) / kBwdQ + 1) : n_qt;
  const int n_q = max(qt_hi - qt_lo, 0);
  const int n_iter = group * n_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every load -----------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers * 128) {
      tma_prefetch_desc(&tm_q);
      tma_prefetch_desc(&tm_k);
      tma_prefetch_desc(&tm_v);
      tma_prefetch_desc(&tm_do);
      mbar_arrive_expect_tx(kv_full, 2 * G::KV_TILE);
      for (int c = 0; c < G::NC; ++c) {
        tma_load_3d(smem + G::OFF_K + c * G::KV_CHUNK, &tm_k, kv_full, c * 64, k0, bkv);
        tma_load_3d(smem + G::OFF_V + c * G::KV_CHUNK, &tm_v, kv_full, c * 64, k0, bkv);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % kBwdStages;
        mbar_wait(empty + st, ((it / kBwdStages) & 1) ^ 1);
        const int bh = bh0 + it / n_q;
        const int q0 = (qt_lo + it % n_q) * kBwdQ;
        if constexpr (kOrdered) {
          // every key tile before this one that sees the query tile (all from the
          // window's first on) has added its NC chunks there
          const int need = q0 - window + 1;  // the lowest key a query of the tile sees
          const int first = window > 0 && need > 0 ? need / kBwdKeys : 0;
          wait_turn(dq_turns + bh * n_qt + q0 / kBwdQ, G::NC * (kt - first));
        }
        mbar_arrive_expect_tx(full + st, G::STAGE_TX);
        for (int c = 0; c < G::NC; ++c) {
          tma_load_3d(smem + G::OFF_Q + st * G::Q_TILE + c * G::Q_CHUNK, &tm_q, full + st,
                      c * 64, q0, bh);
          tma_load_3d(smem + G::OFF_DO + st * G::Q_TILE + c * G::Q_CHUNK, &tm_do, full + st,
                      c * 64, q0, bh);
        }
        const size_t row = static_cast<size_t>(bh) * Sq_pad + q0;
        bulk_load(smem + G::OFF_LSE + st * kBwdQ * 4, lse2 + row, kBwdQ * 4, full + st);
        bulk_load(smem + G::OFF_DELTA + st * kBwdQ * 4, delta + row, kBwdQ * 4, full + st);
      }
    }
  } else {
    // ---- consumers: one warpgroup per 64 keys ------------------------------------
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128;
    const int kw0 = k0 + wg * kBwdWgKeys;               // this warpgroup's first key
    const int key0 = kw0 + (t / 32) * 16 + (t & 31) / 4;  // this thread's rows: key0, key0 + 8
    const int lane_col = 2 * (t & 3);
    // this warpgroup's rows of K and V as the K-major A of S^T and dP^T, and the K tile
    // as dQ's MN-major B (its column chunk and first key for this warpgroup, below)
    const uint32_t sk = smem_addr(smem + G::OFF_K);
    const uint64_t k_rows = make_desc(sk + wg * kBwdWgKeys * 128, 16, 1024, 1);
    const uint64_t v_rows = make_desc(smem_addr(smem + G::OFF_V) + wg * kBwdWgKeys * 128, 16,
                                      1024, 1);
    // dQ = dS K takes, at head_dim 128, column chunk wg of K over all 128 keys of the
    // block (both warpgroups' dS^T); at 64, all of K's columns over this warpgroup's keys
    constexpr int kDqKeys = D == 128 ? kBwdKeys : kBwdWgKeys;
    const int dq_key0 = D == 128 ? 0 : wg * kBwdWgKeys;
    const int dq_chunk = D == 128 ? wg : 0;
    const uint64_t k_cols =
        make_desc(sk + dq_chunk * G::KV_CHUNK + dq_key0 * 128, G::KV_CHUNK, 1024, 1);
    float* stage = reinterpret_cast<float*>(smem + G::OFF_DQ + wg * G::DQ_STAGE);

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int st = it % kBwdStages;
      const int bh = bh0 + it / n_q;
      const int qt = qt_lo + it % n_q;
      const int q0 = qt * kBwdQ;
      const uint32_t sq = smem_addr(smem + G::OFF_Q + st * G::Q_TILE);
      const uint32_t sdo = smem_addr(smem + G::OFF_DO + st * G::Q_TILE);
      unsigned char* ds_buf = smem + G::OFF_DS + (it & 1) * G::DS_TILE;
      // a warpgroup whose keys no query of the tile sees (or that lie past Skv)
      auto skipped = [&](int first) {
        return first >= Skv || (causal && first > q0 + kBwdQ - 1) ||
               (window > 0 && q0 >= first + kBwdWgKeys - 1 + window);
      };
      const bool skip = skipped(kw0);
      const bool need_mask = kw0 + kBwdWgKeys > Skv || (causal && kw0 + kBwdWgKeys - 1 > q0) ||
                             (window > 0 && q0 + kBwdQ - 1 >= kw0 + window);
      const bool dq_skip = D == 128 ? skipped(k0) && skipped(k0 + kBwdWgKeys) : skip;
      uint32_t pa[4][4], dsa[4][4];

      mbar_wait(full + st, (it / kBwdStages) & 1);
      if (!skip) {
        // S^T = K Q^T and dP^T = V dO^T: 64 keys by 64 queries, both operands K-major
        float s[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          fence_operand(s[i]);
          fence_operand(dp[i]);
        }
        wgmma_fence();
        const uint64_t q_kmajor = make_desc(sq, 16, 1024, 1);
        const uint64_t do_kmajor = make_desc(sdo, 16, 1024, 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // column chunk kk / 4, 32 bytes a k16 step
          wgmma_ss_m64n64k16(s, desc_add(k_rows, kk / 4 * G::KV_CHUNK + kk % 4 * 32),
                             desc_add(q_kmajor, kk / 4 * G::Q_CHUNK + kk % 4 * 32), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_m64n64k16(dp, desc_add(v_rows, kk / 4 * G::KV_CHUNK + kk % 4 * 32),
                             desc_add(do_kmajor, kk / 4 * G::Q_CHUNK + kk % 4 * 32), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          fence_operand(s[i]);
          fence_operand(dp[i]);
        }
        const float* l2 = reinterpret_cast<const float*>(smem + G::OFF_LSE + st * kBwdQ * 4);
        const float* dl = reinterpret_cast<const float*>(smem + G::OFF_DELTA + st * kBwdQ * 4);
        if (need_mask)
          bwd_scores<true>(s, dp, l2, dl, key0, q0, Skv, causal, window, scale_log2);
        else
          bwd_scores<false>(s, dp, l2, dl, key0, q0, Skv, causal, window, scale_log2);
        pack_fragments(s, pa);
        pack_fragments(dp, dsa);
        // dS^T in bf16 to shared memory for dQ: rows of keys, the 128-byte swizzle
        store_ds(ds_buf, dsa);
        // dV += P^T dO and dK += dS^T Q, A from registers, B MN-major (transpose bit)
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          fence_operand(dk_acc[i]);
          fence_operand(dv_acc[i]);
        }
        wgmma_fence();
        const uint64_t do_mnmajor = make_desc(sdo, G::Q_CHUNK, 1024, 1);
        const uint64_t q_mnmajor = make_desc(sq, G::Q_CHUNK, 1024, 1);
#pragma unroll
        for (int kk = 0; kk < kBwdQ / 16; ++kk)  // 16 rows of 128 bytes a k16 step
          wgmma_rs<D>(dv_acc, pa[kk], desc_add(do_mnmajor, kk * 16 * 128));
#pragma unroll
        for (int kk = 0; kk < kBwdQ / 16; ++kk)
          wgmma_rs<D>(dk_acc, dsa[kk], desc_add(q_mnmajor, kk * 16 * 128));
        wgmma_commit();
      } else if (D == 128) {
        // the other warpgroup's dQ reads these rows: zeros
        uint32_t zeros[4][4] = {};
        store_ds(ds_buf, zeros);
      }
      fence_proxy_async();
      if (t == 0) bulk_wait_read();  // the last dQ partial has left this staging buffer
      named_barrier(1, kConsumers * 128);  // both warpgroups' dS^T are in shared memory

      if (!dq_skip) {
        // dQ (64 queries x 64 columns) = dS K: A is dS^T (MN-major), B is K (MN-major)
        float dq[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(dq[i]);
        wgmma_fence();
        const uint64_t ds_rows = make_desc(smem_addr(ds_buf) + dq_key0 * 128, G::DS_TILE, 1024, 1);
#pragma unroll
        for (int kk = 0; kk < kDqKeys / 16; ++kk)
          wgmma_ss_m64n64k16<1, 1>(dq, desc_add(ds_rows, kk * 16 * 128),
                                   desc_add(k_cols, kk * 16 * 128), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(dq[i]);
        fence_fragments(pa, dsa);
        mbar_arrive(empty + st);
        // the partial to the staging buffer in fragment order (float pair p of thread t
        // at 2 (128 p + t): conflict-free), then one bulk reduce-add into the workspace
#pragma unroll
        for (int p = 0; p < 16; ++p)
          reinterpret_cast<float2*>(stage)[p * 128 + t] = make_float2(dq[2 * p], dq[2 * p + 1]);
        fence_proxy_async();
        named_barrier(2 + wg, 128);
      } else {
        wgmma_wait<0>();
        fence_fragments(pa, dsa);
        mbar_arrive(empty + st);
      }
      // the workspace's chunk this warpgroup's partial adds into
      const size_t chunk = (static_cast<size_t>(bh) * n_qt + qt) * G::NC + dq_chunk;
      if constexpr (!kOrdered) {
        if (t == 0 && !dq_skip) {
          bulk_reduce_add_f32(dq_acc + chunk * kDqChunk, stage, G::DQ_STAGE);
          bulk_commit();
        }
      } else {
        // the producer loaded this tile once the key tiles before this one had added
        // there; this block's adds follow, warpgroup 0's before warpgroup 1's at head_dim
        // 64 (one chunk), and each passes the turn on once it has completed
        if (D == 64 && wg == 1) {
          __syncwarp();
          named_barrier(4, kConsumers * 128);  // warpgroup 0's add has completed
        }
        if (t == 0) {
          if (!dq_skip) {
            bulk_reduce_add_f32(dq_acc + chunk * kDqChunk, stage, G::DQ_STAGE);
            bulk_commit();
            bulk_wait();
          }
          if (D == 128 || wg == 1) pass_turn(dq_turns + bh * n_qt + qt);
        }
        if (D == 64 && wg == 0) {
          __syncwarp();
          named_barrier_arrive(4, kConsumers * 128);
        }
      }
    }
    if (t == 0) bulk_wait();

    // ---- epilogue: dK (x scale) and dV in bf16 -------------------------------------
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 8 * h;
      if (key >= Skv) continue;
      const size_t off = (static_cast<size_t>(bkv) * Skv + key) * D + lane_col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) = __floats2bfloat162_rn(
            dk_acc[4 * j + 2 * h] * scale, dk_acc[4 * j + 2 * h + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// dQ = scale * the f32 workspace, in bf16: one float pair a thread, read in the
// workspace's fragment order (coalesced) and written to its (row, column)
__global__ void __launch_bounds__(256)
    fa_bwd_dq_kernel(const float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq, int Sq,
                     int n_qt, int NC, float scale, long long pairs) {
  const long long f = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (f >= pairs) return;
  const float2 val = reinterpret_cast<const float2*>(dq_acc)[f];
  const int within = static_cast<int>(f % (kDqChunk / 2));
  const long long chunk = f / (kDqChunk / 2);
  const int c = static_cast<int>(chunk % NC);
  const long long tile = chunk / NC;
  const int qt = static_cast<int>(tile % n_qt);
  const long long bh = tile / n_qt;
  const int p = within / 128, t = within % 128;  // float pair p of consumer thread t
  const int row = qt * kBwdQ + (t / 32) * 16 + (t & 31) / 4 + 8 * (p & 1);
  const int col = c * 64 + 8 * (p / 2) + 2 * (t & 3);
  if (row >= Sq) return;
  *reinterpret_cast<__nv_bfloat162*>(dq + (bh * Sq + row) * (NC * 64) + col) =
      __floats2bfloat162_rn(val.x * scale, val.y * scale);
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dq, void* dk, void* dv, float* lse2, float* delta,
               float* dq_acc, int* dq_turns, int B, int H, int KVH, int Sq, int Skv,
               int causal, int window, int ordered, float scale, cudaStream_t stream) {
  using G = BwdGeom<D>;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
       reinterpret_cast<uintptr_t>(lse2) | reinterpret_cast<uintptr_t>(delta) |
       reinterpret_cast<uintptr_t>(dq_acc) | reinterpret_cast<uintptr_t>(dq_turns)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_map<D>(&tq, q, Sq, B * H, kBwdQ) || !encode_map<D>(&tdo, dout, Sq, B * H, kBwdQ) ||
      !encode_map<D>(&tk, k, Skv, B * KVH, kBwdKeys) ||
      !encode_map<D>(&tv, v, Skv, B * KVH, kBwdKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured[kMaxDevices] = {};
  cudaError_t err = once_per_device(configured, [] {
    cudaError_t e = cudaFuncSetAttribute(fa_bwd_tc_kernel<D, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(fa_bwd_tc_kernel<D, true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (Sq + kBwdQ - 1) / kBwdQ;
  const long long rows = static_cast<long long>(B) * H * n_qt * kBwdQ;
  const long long blocks = static_cast<long long>((Skv + kBwdKeys - 1) / kBwdKeys) * B * KVH;
  const long long pairs = rows * D / 2;
  if (blocks > 0x7fffffffLL || (rows + 7) / 8 > 0x7fffffffLL ||
      (pairs + 255) / 256 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  fa_bwd_pre_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse, lse2,
      delta, B * H, Sq, n_qt * kBwdQ, D);
  const auto main_kernel = ordered ? fa_bwd_tc_kernel<D, true> : fa_bwd_tc_kernel<D, false>;
  main_kernel<<<static_cast<unsigned>(blocks), kThreads, G::SMEM, stream>>>(
      tq, tk, tv, tdo, lse2, delta, dq_acc, dq_turns, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, H, KVH, Sq, Skv, causal, window, scale,
      scale * kLog2e);
  fa_bwd_dq_kernel<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, stream>>>(
      dq_acc, static_cast<__nv_bfloat16*>(dq), Sq, n_qt, G::NC, scale, pairs);
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

// The backward of the bf16 forward from its saved (q, k, v, o, lse) and dO: q, o, dout,
// dq (B, H, Sq, D) and k, v, dk, dv (B, KVH, Skv, D), bf16 and contiguous; lse (B, H,
// Sq) f32 as the forward wrote it; lse2 and delta (B, H, Sq_pad) f32 scratch and dq_acc
// (B, H, Sq_pad, D) f32 zeroed, Sq_pad being Sq rounded up to 64; all 16-byte aligned.
// window <= 0 means no window.  ordered != 0 orders dQ's adds (bitwise equal calls) and
// needs dq_turns, (B, H, Sq_pad / 64) int32 zeroed; else dq_turns may be null.
// Three launches on `stream` (fa_bwd_pre_kernel, fa_bwd_tc_kernel, fa_bwd_dq_kernel);
// returns cudaGetLastError().
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dq, void* dk,
                                   void* dv, void* lse2, void* delta, void* dq_acc,
                                   void* dq_turns, int B, int H, int KVH, int Sq, int Skv, int D,
                                   int causal, int window, int ordered, float scale,
                                   void* stream) {
  using namespace repro_torch;
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Skv <= 0 ||
      (ordered && dq_turns == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float *l2 = static_cast<float*>(lse2), *dl = static_cast<float*>(delta),
        *acc = static_cast<float*>(dq_acc);
  int* turns = static_cast<int*>(dq_turns);
  switch (D) {
    case 64: return tc::launch_bwd<64>(q, k, v, o, dout, l, dq, dk, dv, l2, dl, acc, turns, B, H, KVH, Sq, Skv, causal, window, ordered, scale, s);
    case 128: return tc::launch_bwd<128>(q, k, v, o, dout, l, dq, dk, dv, l2, dl, acc, turns, B, H, KVH, Sq, Skv, causal, window, ordered, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
