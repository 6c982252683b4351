// Mamba-2 SSD (state-space duality) chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_fwd (body
// _ssd_kernel).  On the TPU the chunks of the sequence were a sequential grid
// dimension and the (N x P) f32 state lived in VMEM scratch from one grid step to the
// next.  Here the chunks run in parallel, in the three passes of the Mamba-2 paper's
// SSD algorithm (arXiv:2405.21060 section 6).  Per chunk of L rows, with a_t = A_h *
// dt_t and cum the inclusive cumsum of a over the chunk (head h reads group
// g = h / (H / G) of B and C):
//
//   A, chunk state   (grid: chunk x tile of heads of one group x batch; f32: one head)
//       cum;  dH_c = sum_j exp(cum_L - cum_j) * dt_j * B_j (x) x_j          (N x P)
//   B, state passing (grid: tiles of N*P x head x batch)
//       h_in[c] = h;  h = exp(cum_L,c) * h + dH_c;  hT = h
//   C, chunk output  (grid: chunk x tile of heads of one group x batch)
//       y_i = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j
//             + exp(cum_i) * C_i . h_in[c]
//
// Pass A writes dH and cum to f32 scratch that the wrapper allocates; pass B runs the
// short recurrence over the chunks and writes h_in (in place over dH in f32, as a bf16
// hi and lo pair in bf16) and the final state; pass C computes C.B^T once per group
// and chunk and reuses it for every head of its tile (mamba2-370m has one group: 32
// heads share it).  Fusing A and B into one block per (batch, head) that walks the
// chunks with the state in shared memory saves dH's round trip but runs the chunks in
// series on 128 blocks at the serving shape: it measured slower (PERF.md).  The
// wrapper (kernels/ssd_scan.py) allocates the scratch and launches the passes from its
// plan(); everything the body computes runs here.
//
// bf16 (every main path): L = 128, and the four products run on the tensor cores as
// mma.sync m16n8k16 (bf16 in, f32 accumulators), operands fed by ldmatrix from shared
// memory whose rows are padded by 16 bytes (conflict-free), N and P zero-padded to
// 16.  x, B and C are bf16 already, so C.B^T is exact products summed in f32.  The
// other operand of each remaining product is an f32 value: the masked, decayed scores
// (scores . x), w_j * x_j (the state) and h_in (C . h_in).  Each is split into a bf16
// hi and lo pair and both halves are multiplied (two MMAs), which keeps about 16 bits
// of its mantissa.  Rounding the scores or h_in to one bf16 alone is not enough: at the
// mamba2-370m serving shape it takes y past the reference's bf16 tolerance of 2e-2
// where terms of ~1 cancel (ref.ssd_scan_fwd_tc_twin, the kernel's rounding points in
// plain PyTorch, is held against the reference in the CPU tests).  Loads of x, B, C,
// dt and h_in are cp.async copies (16 bytes a row piece, 8 where a row is not a
// multiple of 16 bytes), the next head's in flight while a block works on the current
// one; y is staged in shared memory and written with 16-byte stores.
//
// f32: the same passes with f32 FMAs from shared memory (TF32 would be a numerics
// change the reference does not make), at L = 64 to fit shared memory.
//
// Bound on the H100: bytes.  The function reads x, B, C and dt once and writes y and
// the final state once (about 40 MB at the mamba2-370m serving shape, 0.012 ms at
// 3.35 TB/s).  The passes move more: dH out and back and h_in out and back (33.5 MB
// each way at that shape) and x twice, so their own floor is near 0.05 ms.
//
// Masking: exp(cum_i - cum_j) is large above the diagonal (cum falls along the chunk,
// since A < 0 and dt > 0).  The kernels select 0 for j > i in place of the decayed
// score, never multiply by a mask, so an overflow there can never meet it as 0 * inf.
//
// Any S works: rows past the end of the last, ragged chunk are zeros with dt = 0, so
// they add nothing to y or the state and leave cum (hence the chunk's decay) where the
// last real row put it; their y rows are not written.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps in every pass
constexpr int kWarps = kThreads / 32;
constexpr int kChunkTC = 128;  // bf16 chunk: 16 rows per warp in pass C
constexpr int kChunkF32 = 64;  // f32 chunk
constexpr int LT = kChunkF32 + 4;  // row stride of the f32 kernels' transposed (N, L) tiles

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }
// row stride of a bf16 tile of v columns: padded to the MMA tile, plus 16 bytes so
// that 8 rows of an ldmatrix fall in 8 different bank groups
__host__ __device__ constexpr int tc_stride(int v) { return round16(v) + 8; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Dynamic shared memory of pass A (chunk state) and pass C (chunk output).
__host__ __device__ constexpr long long state_smem(int N, int P, bool tc) {
  return tc ? 1LL * kChunkTC * tc_stride(N) * 2        // B, (L, N)
                  + 2LL * (kChunkTC * tc_stride(P) * 2 + kChunkTC * 4)  // two heads' x, dt
                  + 1LL * kChunkTC * tc_stride(P) * 2  // lo of w_j * x_j
                  + (2LL * kChunkTC + kWarps) * 4      // cum, w; the scan's warp sums
            : 1LL * kChunkF32 * N * 4 + 1LL * kChunkF32 * P * 4 + (3LL * kChunkF32 + kWarps) * 4;
}
__host__ __device__ constexpr long long output_smem(int N, int P, bool tc) {
  return tc ? 1LL * kChunkTC * tc_stride(N) * 2                      // C, (L, N)
                  + 1LL * kChunkTC * imax(tc_stride(N), tc_stride(P)) * 2  // B, then y's staging
                  + 2LL * kChunkTC * tc_stride(P) * 2       // x, (L, P), two heads' buffers
                  + 4LL * round16(N) * tc_stride(P) * 2     // h_in hi and lo, (N, P), two heads
                  + 4LL * kChunkTC * 4                      // (cum, dt), two heads
            : 2LL * N * LT * 4                      // C and B, transposed (N, L)
                  + 1LL * kChunkF32 * LT * 4        // the scores, transposed (L, L)
                  + 1LL * kChunkF32 * P * 4         // x, (L, P)
                  + 1LL * N * P * 4                 // h_in, (N, P)
                  + 3LL * kChunkF32 * 4;            // cum, exp(cum), dt
}

// -- PTX building blocks ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy BYTES from global to shared memory; with `valid` false, write zeros instead
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(n)
                 : "memory");
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d(16 x 8, f32) += a(16 x 16, bf16, row) * b(16 x 8, bf16, col).  Fragments, for lane
// l with g = l / 4 and t = l % 4: a[0] row g, columns 2t, 2t+1; a[1] row g+8; a[2],
// a[3] the same rows at columns + 8; b[0] rows 2t, 2t+1 of column g, b[1] rows + 8;
// d[0], d[1] row g, columns 2t, 2t+1; d[2], d[3] row g+8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (a, b) as bf16 pairs hi = bf16(a, b) and lo = bf16((a, b) - hi): hi + lo keeps
// about 16 bits of each f32 mantissa
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(a, b);
  const float2 h = unpack_bf16x2(hi);
  lo = pack_bf16x2(a - h.x, b - h.y);
}

// Offsets (in elements) of this lane's ldmatrix row, for a tile at (r0, c0) of a
// matrix stored row-major with stride `ld`:
//  - an A fragment (16 x 16) stored as (m, k):      a_rows
//  - an A fragment stored as (k, m), transposed:    a_trans
//  - B fragments of two 8-column tiles stored as (n, k):          b_rows
//  - B fragments of two 8-column tiles stored as (k, n), transposed: b_trans
// Registers: a -> a[0..3]; b -> {b0, b1} of columns c0..c0+7 (n0) then of n0 + 8.
__device__ __forceinline__ int a_rows(int lane, int m0, int k0, int ld) {
  const int r = lane & 7, q = lane >> 3;
  return (m0 + r + ((q & 1) << 3)) * ld + k0 + ((q >> 1) << 3);
}
__device__ __forceinline__ int a_trans(int lane, int m0, int k0, int ld) {
  const int r = lane & 7, q = lane >> 3;
  return (k0 + r + ((q >> 1) << 3)) * ld + m0 + ((q & 1) << 3);
}
__device__ __forceinline__ int b_rows(int lane, int n0, int k0, int ld) {
  const int r = lane & 7, q = lane >> 3;
  return (n0 + r + ((q >> 1) << 3)) * ld + k0 + ((q & 1) << 3);
}
__device__ __forceinline__ int b_trans(int lane, int n0, int k0, int ld) {
  const int r = lane & 7, q = lane >> 3;
  return (k0 + r + ((q & 1) << 3)) * ld + n0 + ((q >> 1) << 3);
}

// -- shared pieces -------------------------------------------------------------------

// Rows l < L of `cols` values, row l at src + l * src_stride, into dst + l * ld; rows
// l >= rows are zeros.  16-byte copies where a row is a multiple of 16 bytes, else
// 8-byte ones (cols is a multiple of 4).  Columns past `cols` are left alone.
template <typename T>
__device__ __forceinline__ void load_rows_async(T* dst, int ld, const T* src, size_t src_stride,
                                                int cols, int rows, int L) {
  constexpr int V16 = 16 / sizeof(T), V8 = 8 / sizeof(T);
  if (cols % V16 == 0) {
    const int per_row = cols / V16;
    for (int i = threadIdx.x; i < L * per_row; i += blockDim.x) {
      const int l = i / per_row, v = i - l * per_row;
      const bool ok = l < rows;
      cp_async<16>(dst + l * ld + V16 * v, ok ? src + l * src_stride + V16 * v : src, ok);
    }
  } else {
    const int per_row = cols / V8;
    for (int i = threadIdx.x; i < L * per_row; i += blockDim.x) {
      const int l = i / per_row, v = i - l * per_row;
      const bool ok = l < rows;
      cp_async<8>(dst + l * ld + V8 * v, ok ? src + l * src_stride + V8 * v : src, ok);
    }
  }
}

// cum[r] = sum_{k <= r} a * dts[k] over the L rows of the chunk, every warp scanning
// L / 8 rows with shuffles; then the warps' totals are added in order.  Every thread
// of the block calls it; it ends with the block synchronised.
template <int L>
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a, float* cum, float* wsum) {
  constexpr int R = L / kWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp * R + (lane % R);
  float v = a * dts[r];
#pragma unroll
  for (int off = 1; off < R; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, v, off, R);
    if ((lane % R) >= off) v += t;
  }
  if (lane == R - 1) wsum[warp] = v;
  __syncthreads();
  float base = 0.f;
  for (int k = 0; k < warp; ++k) base += wsum[k];
  if (lane < R) cum[r] = base + v;
  __syncthreads();
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

// ===================================================================================
// Pass A: chunk state.  One block per (chunk, tile of HT heads of one group, batch): the
// group's B is loaded once for the tile, and each next head's x and dt are in flight
// while the block works on the current one.
// ===================================================================================

__global__ void __launch_bounds__(kThreads, 2)
    ssd_chunk_state_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const bf16* __restrict__ Bm,
                       float* __restrict__ dH, float* __restrict__ cum_out, int S, int H, int G,
                       int N, int P, int HT) {
  constexpr int L = kChunkTC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NS = tc_stride(N), PS = tc_stride(P), NP = round16(N), PP = round16(P);
  const int head_tile = L * PS + 2 * L;          // bf16 units: x (L, PS), then dt (L f32)
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);  // (L, NS): B of the chunk
  bf16* heads = Bs + L * NS;                     // two heads' x (then bf16(w_j * x_j)), dt
  bf16* xl = heads + 2 * head_tile;              // (L, PS): lo of w_j * x_j
  float* cum = reinterpret_cast<float*>(xl + L * PS);
  float* wts = cum + L;
  float* wsum = wts + L;

  const int c = blockIdx.x, b = blockIdx.z;
  const int nc = gridDim.x;
  const int h_first = blockIdx.y * HT;
  const int g = h_first / (H / G);
  const int s0 = c * L, rows = min(L, S - s0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;

  // head hh's x and dt into buffer hh % 2, as one cp.async group; rows past S are zeros
  auto fetch = [&](int hh) {
    const int h = h_first + hh;
    bf16* xs = heads + (hh & 1) * head_tile;
    float* dts = reinterpret_cast<float*>(xs + L * PS);
    load_rows_async(xs, PS, x + (static_cast<size_t>(b) * S + s0) * H * P + static_cast<size_t>(h) * P,
                    static_cast<size_t>(H) * P, P, rows, L);
    if (tid < L) {
      const bool ok = tid < rows;
      cp_async<4>(dts + tid, ok ? dt + (static_cast<size_t>(b) * S + s0 + tid) * H + h : dt, ok);
    }
    cp_async_commit();
  };

  load_rows_async(Bs, NS, Bm + (static_cast<size_t>(b) * S + s0) * G * N + static_cast<size_t>(g) * N,
                  static_cast<size_t>(G) * N, N, rows, L);
  fetch(0);  // one group with B
  for (int i = tid; i < L * (NP - N); i += kThreads) {  // B's padding columns
    const int l = i / (NP - N);
    Bs[l * NS + N + (i - l * (NP - N))] = __float2bfloat16_rn(0.f);
  }

  for (int hh = 0; hh < HT; ++hh) {
    const int h = h_first + hh;
    const size_t slot = (static_cast<size_t>(b) * nc + c) * H + h;
    __syncthreads();  // every warp is done with buffer (hh + 1) % 2
    if (hh + 1 < HT) {
      fetch(hh + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    bf16* xh = heads + (hh & 1) * head_tile;  // x, then bf16(w_j * x_j)
    const float* dts = reinterpret_cast<const float*>(xh + L * PS);
    chunk_cumsum<L>(dts, A[h], cum, wsum);
    if (tid < L) {
      wts[tid] = expf(cum[L - 1] - cum[tid]) * dts[tid];  // cum_L - cum_j <= 0
      cum_out[slot * L + tid] = cum[tid];
    }
    __syncthreads();

    // w_j * x_j in f32, split into bf16 hi (over x) + lo; padding columns are zeros
    const int pairs = PP / 2;
    for (int i = tid; i < L * pairs; i += kThreads) {
      const int l = i / pairs, p0 = 2 * (i - l * pairs);
      uint32_t hi = 0u, lo = 0u;
      if (p0 < P) {
        const float2 v = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(xh + l * PS + p0));
        const float w = wts[l];
        split_bf16x2(v.x * w, v.y * w, hi, lo);
      }
      *reinterpret_cast<uint32_t*>(xh + l * PS + p0) = hi;
      *reinterpret_cast<uint32_t*>(xl + l * PS + p0) = lo;
    }
    __syncthreads();

    // dH (N x P) = B^T (N x L) . (w * x) (L x P); each warp 16 rows of N at a time
    float* out = dH + slot * N * P;
    for (int m0 = 16 * warp; m0 < NP; m0 += 16 * kWarps) {
      for (int p0 = 0; p0 < PP; p0 += 64) {
        float acc[8][4] = {};
        for (int k0 = 0; k0 < L; k0 += 16) {
          uint32_t af[4];
          ldsm_x4_t(af, Bs + a_trans(lane, m0, k0, NS));
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (p0 + 16 * np < PP) {
              uint32_t bh[4], bl[4];
              ldsm_x4_t(bh, xh + b_trans(lane, p0 + 16 * np, k0, PS));
              ldsm_x4_t(bl, xl + b_trans(lane, p0 + 16 * np, k0, PS));
              mma_bf16(acc[2 * np], af, bh[0], bh[1]);
              mma_bf16(acc[2 * np + 1], af, bh[2], bh[3]);
              mma_bf16(acc[2 * np], af, bl[0], bl[1]);
              mma_bf16(acc[2 * np + 1], af, bl[2], bl[3]);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = p0 + 8 * nt + 2 * tq;  // even, and P is: col < P covers col + 1
          if (col >= P) continue;
          const int r0 = m0 + gq, r1 = r0 + 8;
          if (r0 < N)
            *reinterpret_cast<float2*>(out + static_cast<size_t>(r0) * P + col) =
                make_float2(acc[nt][0], acc[nt][1]);
          if (r1 < N)
            *reinterpret_cast<float2*>(out + static_cast<size_t>(r1) * P + col) =
                make_float2(acc[nt][2], acc[nt][3]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state_f32(const float* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const float* __restrict__ Bm,
                        float* __restrict__ dH, float* __restrict__ cum_out, int S, int H, int G,
                        int N, int P) {
  constexpr int L = kChunkF32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Bs = reinterpret_cast<float*>(smem_raw);  // (L, N)
  float* xs = Bs + L * N;                          // (L, P)
  float* dts = xs + L * P;
  float* cum = dts + L;
  float* wts = cum + L;
  float* wsum = wts + L;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (H / G);
  const int s0 = c * L, rows = min(L, S - s0);
  const int tid = threadIdx.x;
  const size_t slot = (static_cast<size_t>(b) * nc + c) * H + h;

  load_rows_async(Bs, N, Bm + (static_cast<size_t>(b) * S + s0) * G * N + static_cast<size_t>(g) * N,
                  static_cast<size_t>(G) * N, N, rows, L);
  load_rows_async(xs, P, x + (static_cast<size_t>(b) * S + s0) * H * P + static_cast<size_t>(h) * P,
                  static_cast<size_t>(H) * P, P, rows, L);
  if (tid < L) {
    const bool ok = tid < rows;
    cp_async<4>(dts + tid, ok ? dt + (static_cast<size_t>(b) * S + s0 + tid) * H + h : dt, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  chunk_cumsum<L>(dts, A[h], cum, wsum);
  if (tid < L) {
    wts[tid] = expf(cum[L - 1] - cum[tid]) * dts[tid];
    cum_out[slot * L + tid] = cum[tid];
  }
  __syncthreads();

  // dH = sum_j (B_j * w_j) (x) x_j, 4 x 4 tiles
  float* out = dH + slot * N * P;
  const int PT = P / 4;
  for (int t = tid; t < (N / 4) * PT; t += kThreads) {
    const int n0 = 4 * (t / PT), p0 = 4 * (t % PT);
    float acc[4][4] = {};
    for (int j = 0; j < rows; ++j) {
      float4 u = ld4(Bs + j * N + n0);
      const float w = wts[j];
      u.x *= w, u.y *= w, u.z *= w, u.w *= w;
      outer_fma(acc, u, ld4(xs + j * P + p0));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<float4*>(out + static_cast<size_t>(n0 + k) * P + p0) =
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
  }
}

// ===================================================================================
// Pass B: state passing.  One thread per 4 state elements of one (batch, head), over
// the chunks in order: h_in goes to `hin16` as a bf16 hi (N, P) and lo (N, P) pair per
// chunk or, if that is null, in place over dH (f32).
// ===================================================================================

__global__ void __launch_bounds__(kThreads)
    ssd_state_pass(float* dH, bf16* __restrict__ hin16, const float* __restrict__ cum,
                   float* __restrict__ hT, int nc, int H, int N, int P, int L) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int quads = N * P / 4;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= quads) return;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int kBatch = 4;  // chunks whose loads are in flight together
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float4 d[kBatch];
    float decay[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < nc) {
        const size_t slot = (static_cast<size_t>(b) * nc + c0 + k) * H + h;
        d[k] = reinterpret_cast<const float4*>(dH + slot * N * P)[q];
        decay[k] = expf(cum[slot * L + L - 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < nc) {
        const size_t slot = (static_cast<size_t>(b) * nc + c0 + k) * H + h;
        if (hin16 != nullptr) {
          uint2 hi, lo;
          split_bf16x2(run.x, run.y, hi.x, lo.x);
          split_bf16x2(run.z, run.w, hi.y, lo.y);
          reinterpret_cast<uint2*>(hin16 + 2 * slot * N * P)[q] = hi;
          reinterpret_cast<uint2*>(hin16 + (2 * slot + 1) * N * P)[q] = lo;
        } else {
          reinterpret_cast<float4*>(dH + slot * N * P)[q] = run;
        }
        run.x = fmaf(decay[k], run.x, d[k].x);
        run.y = fmaf(decay[k], run.y, d[k].y);
        run.z = fmaf(decay[k], run.z, d[k].z);
        run.w = fmaf(decay[k], run.w, d[k].w);
      }
    }
  }
  reinterpret_cast<float4*>(hT + (static_cast<size_t>(b) * H + h) * N * P)[q] = run;
}

// ===================================================================================
// Pass C: chunk output.  One block per (chunk, tile of HT heads of one group, batch).
// ===================================================================================

constexpr float kLog2e = 1.4426950408889634f;

// two neighbouring scores of row i, columns j and j + 1 (j even), decayed, as bf16 hi
// and lo pairs; cd holds (cum_j, dt_j) pairs.  Only a tile on the diagonal (`diag`)
// has columns past its rows: they are selected to 0, never multiplied by the mask.
__device__ __forceinline__ void score_pair(float cb0, float cb1, int i, float cum_i, int j,
                                           const float* cd, bool diag, uint32_t& hi,
                                           uint32_t& lo) {
  const float4 q = *reinterpret_cast<const float4*>(cd + 2 * j);  // cum_j, dt_j, cum_j+1, dt_j+1
  float s0 = cb0 * exp2f((cum_i - q.x) * kLog2e) * q.y;
  float s1 = cb1 * exp2f((cum_i - q.z) * kLog2e) * q.w;
  if (diag) {
    s0 = j <= i ? s0 : 0.f;
    s1 = j + 1 <= i ? s1 : 0.f;
  }
  split_bf16x2(s0, s1, hi, lo);
}

__global__ void __launch_bounds__(kThreads, 1)
    ssd_chunk_output_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                        const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                        const bf16* __restrict__ hin, const float* __restrict__ cum_in,
                        bf16* __restrict__ y, int S, int H, int G, int N, int P, int HT) {
  constexpr int L = kChunkTC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NS = tc_stride(N), PS = tc_stride(P), NP = round16(N), PP = round16(P);
  const int US = imax(NS, PS);
  // per head, two buffers (the next head's copies land while this one computes):
  // x (L, PS), h_in's hi and lo (NP, PS) each; (cum, dt) pairs (L) each
  const int head_tile = L * PS + 2 * NP * PS;
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // (L, NS)
  bf16* Bs = Cs + L * NS;                        // (L, NS); after C.B^T, y's staging (L, PS)
  bf16* ys = Bs;
  bf16* heads = Bs + L * US;
  float* vecs = reinterpret_cast<float*>(heads + 2 * head_tile);

  const int c = blockIdx.x, b = blockIdx.z;
  const int nc = gridDim.x;
  const int h_first = blockIdx.y * HT;
  const int g = h_first / (H / G);
  const int s0 = c * L, rows = min(L, S - s0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;

  // zeros in every padding row and column, once: the copies below write only the rest
  const int tile_vec = (L * NS + L * US + 2 * head_tile) * 2 / 16;
  for (int i = tid; i < tile_vec; i += kThreads)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // head hh's copies into buffer hh % 2, as one cp.async group: x, h_in, (cum, dt)
  auto fetch = [&](int hh) {
    const int h = h_first + hh;
    const size_t slot = (static_cast<size_t>(b) * nc + c) * H + h;
    bf16* xs = heads + (hh & 1) * head_tile;
    bf16* hs = xs + L * PS;
    load_rows_async(xs, PS, x + (static_cast<size_t>(b) * S + s0) * H * P + static_cast<size_t>(h) * P,
                    static_cast<size_t>(H) * P, P, rows, L);
    load_rows_async(hs, PS, hin + 2 * slot * N * P, P, P, N, N);
    load_rows_async(hs + NP * PS, PS, hin + (2 * slot + 1) * N * P, P, P, N, N);
    float* v = vecs + (hh & 1) * 2 * L;
    if (tid < L) {
      const bool ok = tid < rows;  // dt = 0 past S
      cp_async<4>(v + 2 * tid, cum_in + slot * L + tid, true);
      cp_async<4>(v + 2 * tid + 1, ok ? dt + (static_cast<size_t>(b) * S + s0 + tid) * H + h : dt,
                  ok);
    }
    cp_async_commit();
  };

  const size_t bc_off = (static_cast<size_t>(b) * S + s0) * G * N + static_cast<size_t>(g) * N;
  load_rows_async(Cs, NS, Cm + bc_off, static_cast<size_t>(G) * N, N, rows, L);
  load_rows_async(Bs, NS, Bm + bc_off, static_cast<size_t>(G) * N, N, rows, L);
  cp_async_commit();
  fetch(0);
  cp_async_wait<1>();  // C and B have landed; head 0 may still be in flight
  __syncthreads();

  // C.B^T for this warp's 16 rows i0 = 16 * mt, kept in registers for every head: the
  // 8-column tiles j < i0 + 16 (the rest is above the diagonal).  Row tile mt has mt + 1
  // tiles of causal work; warps w and w + 4 share a scheduler, so they take the tiles
  // {w, 7 - w}: 9 tiles on each scheduler.
  const int mt = warp < 4 ? warp : 11 - warp;
  const int i0 = 16 * mt;
  float cb[16][4] = {};
  for (int k0 = 0; k0 < NP; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, Cs + a_rows(lane, i0, k0, NS));
#pragma unroll
    for (int jp = 0; jp < 8; ++jp) {
      if (jp <= mt) {
        uint32_t bq[4];
        ldsm_x4(bq, Bs + b_rows(lane, 16 * jp, k0, NS));
        mma_bf16(cb[2 * jp], a, bq[0], bq[1]);
        mma_bf16(cb[2 * jp + 1], a, bq[2], bq[3]);
      }
    }
  }

  const int ia = i0 + gq, ib = ia + 8;
  for (int hh = 0; hh < HT; ++hh) {
    const int h = h_first + hh;
    __syncthreads();  // every warp is done with buffer (hh + 1) % 2 (and with B)
    if (hh + 1 < HT) {
      fetch(hh + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // head hh's tiles are visible to every warp
    const bf16* xs = heads + (hh & 1) * head_tile;
    const bf16* hs = xs + L * PS;
    const bf16* hl = hs + NP * PS;
    const float* cd = vecs + (hh & 1) * 2 * L;  // (cum, dt) pairs
    const float cum_a = cd[2 * ia], cum_b = cd[2 * ib];
    const float ea = expf(cum_a), eb = expf(cum_b);
    for (int p0 = 0; p0 < PP; p0 += 64) {
      float acc[8][4] = {};
      // inter: C . h_in, scaled by exp(cum_i)
      for (int k0 = 0; k0 < NP; k0 += 16) {
        uint32_t a[4];
        ldsm_x4(a, Cs + a_rows(lane, i0, k0, NS));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (p0 + 16 * np < PP) {
            uint32_t bh[4], bl[4];
            ldsm_x4_t(bh, hs + b_trans(lane, p0 + 16 * np, k0, PS));
            ldsm_x4_t(bl, hl + b_trans(lane, p0 + 16 * np, k0, PS));
            mma_bf16(acc[2 * np], a, bh[0], bh[1]);
            mma_bf16(acc[2 * np + 1], a, bh[2], bh[3]);
            mma_bf16(acc[2 * np], a, bl[0], bl[1]);
            mma_bf16(acc[2 * np + 1], a, bl[2], bl[3]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] *= ea, acc[nt][1] *= ea, acc[nt][2] *= eb, acc[nt][3] *= eb;
      }
      // intra: the masked, decayed scores (hi + lo, from the f32 C.B^T) . x
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk <= mt) {
          const int ja = 16 * kk + 2 * tq, jb = ja + 8;
          const bool diag = kk == mt;
          uint32_t ah[4], al[4];
          score_pair(cb[2 * kk][0], cb[2 * kk][1], ia, cum_a, ja, cd, diag, ah[0], al[0]);
          score_pair(cb[2 * kk][2], cb[2 * kk][3], ib, cum_b, ja, cd, diag, ah[1], al[1]);
          score_pair(cb[2 * kk + 1][0], cb[2 * kk + 1][1], ia, cum_a, jb, cd, diag, ah[2], al[2]);
          score_pair(cb[2 * kk + 1][2], cb[2 * kk + 1][3], ib, cum_b, jb, cd, diag, ah[3], al[3]);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (p0 + 16 * np < PP) {
              uint32_t bq[4];
              ldsm_x4_t(bq, xs + b_trans(lane, p0 + 16 * np, 16 * kk, PS));
              mma_bf16(acc[2 * np], ah, bq[0], bq[1]);
              mma_bf16(acc[2 * np + 1], ah, bq[2], bq[3]);
              mma_bf16(acc[2 * np], al, bq[0], bq[1]);
              mma_bf16(acc[2 * np + 1], al, bq[2], bq[3]);
            }
          }
        }
      }
      // this warp's rows of y, as bf16, into the staging tile
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = p0 + 8 * nt + 2 * tq;
        if (col < PP) {
          *reinterpret_cast<uint32_t*>(ys + ia * PS + col) = pack_bf16x2(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<uint32_t*>(ys + ib * PS + col) = pack_bf16x2(acc[nt][2], acc[nt][3]);
        }
      }
    }
    __syncwarp();
    // the warp writes its own 16 rows: 16-byte stores (8-byte where P % 8 != 0)
    bf16* yg = y + (static_cast<size_t>(b) * S + s0) * H * P + static_cast<size_t>(h) * P;
    if (P % 8 == 0) {
      const int per_row = P / 8;
      for (int k = lane; k < 16 * per_row; k += 32) {
        const int i = i0 + k / per_row, v = k % per_row;
        if (i < rows)
          *reinterpret_cast<uint4*>(yg + static_cast<size_t>(i) * H * P + 8 * v) =
              *reinterpret_cast<const uint4*>(ys + i * PS + 8 * v);
      }
    } else {
      const int per_row = P / 4;
      for (int k = lane; k < 16 * per_row; k += 32) {
        const int i = i0 + k / per_row, v = k % per_row;
        if (i < rows)
          *reinterpret_cast<uint2*>(yg + static_cast<size_t>(i) * H * P + 4 * v) =
              *reinterpret_cast<const uint2*>(ys + i * PS + 4 * v);
      }
    }
    __syncwarp();  // the staging rows are read before the next head writes them
  }
}

__global__ void __launch_bounds__(kThreads)
    ssd_chunk_output_f32(const float* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ Bm, const float* __restrict__ Cm,
                         const float* __restrict__ hin, const float* __restrict__ cum_in,
                         float* __restrict__ y, int S, int H, int G, int N, int P, int HT) {
  constexpr int L = kChunkF32;
  constexpr int LB = L / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ct = reinterpret_cast<float*>(smem_raw);  // (N, LT)
  float* Bt = Ct + N * LT;                         // (N, LT)
  float* St = Bt + N * LT;                         // (L, LT): scores, St[j][i]
  float* xs = St + L * LT;                         // (L, P)
  float* hs = xs + L * P;                          // (N, P)
  float* cum = hs + N * P;
  float* ecum = cum + L;
  float* dts = ecum + L;

  const int c = blockIdx.x, b = blockIdx.z;
  const int nc = gridDim.x;
  const int h_first = blockIdx.y * HT;
  const int g = h_first / (H / G);
  const int s0 = c * L, rows = min(L, S - s0);
  const int tid = threadIdx.x;
  const int PT = P / 4;

  for (int idx = tid; idx < L * N; idx += kThreads) {
    const int l = idx / N, n = idx - l * N;
    float vb = 0.f, vc = 0.f;
    if (l < rows) {
      const size_t off = ((static_cast<size_t>(b) * S + s0 + l) * G + g) * N + n;
      vb = Bm[off];
      vc = Cm[off];
    }
    Bt[n * LT + l] = vb;
    Ct[n * LT + l] = vc;
  }

  for (int hh = 0; hh < HT; ++hh) {
    const int h = h_first + hh;
    const size_t slot = (static_cast<size_t>(b) * nc + c) * H + h;
    const size_t row0 = (static_cast<size_t>(b) * S + s0) * H * P + static_cast<size_t>(h) * P;
    const float* xg = x + row0;
    float* yg = y + row0;
    for (int i = tid; i < L * PT; i += kThreads) {
      const int l = i / PT, p0 = 4 * (i - l * PT);
      *reinterpret_cast<float4*>(xs + l * P + p0) =
          l < rows ? ld4(xg + static_cast<size_t>(l) * H * P + p0) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int i = tid; i < N * PT; i += kThreads)
      reinterpret_cast<float4*>(hs)[i] = reinterpret_cast<const float4*>(hin + slot * N * P)[i];
    if (tid < L) {
      const float cv = cum_in[slot * L + tid];
      cum[tid] = cv;
      ecum[tid] = expf(cv);
      dts[tid] = tid < rows ? dt[(static_cast<size_t>(b) * S + s0 + tid) * H + h] : 0.f;
    }
    __syncthreads();

    // St[j][i] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j for j <= i, else 0
    for (int t = tid; t < LB * LB; t += kThreads) {
      const int ti = t / LB, tj = t - ti * LB;
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
    __syncthreads();

    // y = scores . x + exp(cum) * (C . h_in)
    for (int t = tid; t < LB * PT; t += kThreads) {
      const int ti = t / PT, tp = t - ti * PT;
      const int i0 = 4 * ti, p0 = 4 * tp;
      float intra[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < i0 + 4; ++j) outer_fma(intra, ld4(St + j * LT + i0), ld4(xs + j * P + p0));
      for (int n = 0; n < N; ++n) outer_fma(inter, ld4(Ct + n * LT + i0), ld4(hs + n * P + p0));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        if (i >= rows) continue;
        const float e = ecum[i];
        *reinterpret_cast<float4*>(yg + static_cast<size_t>(i) * H * P + p0) =
            make_float4(intra[u][0] + e * inter[u][0], intra[u][1] + e * inter[u][1],
                        intra[u][2] + e * inter[u][2], intra[u][3] + e * inter[u][3]);
      }
    }
    __syncthreads();  // before the next head overwrites x, h_in and the scores
  }
}

// -- host ------------------------------------------------------------------------------

int set_smem(const void* kernel, long long bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace
}  // namespace repro_torch

// Dynamic shared memory of pass 0 (chunk state) or 2 (chunk output) at state size N and
// head dim P, for dtype code `dtype` (pass 1, state passing, uses none).
// kernels/ssd_scan.py's plan() computes the same numbers; the card tests hold the two
// together.
extern "C" long long ssd_scan_fwd_smem(int N, int P, int dtype, int pass) {
  using namespace repro_torch;
  const bool tc = dtype == kBFloat16;
  return pass == 0 ? state_smem(N, P, tc) : pass == 2 ? output_smem(N, P, tc) : 0;
}

// Rows per chunk for dtype code `dtype`.
extern "C" int ssd_scan_fwd_chunk(int dtype) {
  using namespace repro_torch;
  return dtype == kBFloat16 ? kChunkTC : kChunkF32;
}

// x, y: (Bt, S, H, P) with dtype code `dtype`; dt: (Bt, S, H) f32; A: (H,) f32;
// B, C: (Bt, S, G, N) with dtype code `dtype`; hT: (Bt, H, N, P) f32; all contiguous
// and 16-byte aligned.  Scratch: dH (Bt, nc, H, N, P) f32; hin, the state entering each
// chunk, (Bt, nc, H, 2, N, P) bf16 (a hi and lo pair) for bf16 (unused for f32, where
// h_in goes over dH); cum (Bt, nc, H, L) f32; nc = ceil(S / L) with
// L = ssd_scan_fwd_chunk(dtype).  N and P multiples of 4, H a multiple of G; HA and HT
// (heads per block of passes A, bf16 only, and C) divisors of H / G.  Launches the three
// passes on `stream` and returns the first launch error (cudaGetLastError()).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, void* y, void* hT, void* dH, void* hin, void* cum,
                            int Bt, int S, int H, int G, int N, int P, int HA, int HT, int dtype,
                            void* stream) {
  using namespace repro_torch;
  if (Bt <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 || P <= 0 || N % 4 != 0 ||
      P % 4 != 0 || Bt > 65535 || H > 65535 || HT <= 0 || (H / G) % HT != 0 || HA <= 0 ||
      (H / G) % HA != 0 ||
      (dtype != kFloat32 && dtype != kBFloat16) || (dtype == kBFloat16 && hin == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = dtype == kBFloat16;
  const int L = tc ? kChunkTC : kChunkF32;
  const int nc = (S + L - 1) / L;
  const long long smem_a = state_smem(N, P, tc), smem_c = output_smem(N, P, tc);
  const dim3 grid_a(nc, tc ? H / HA : H, Bt),
      grid_b((N * P / 4 + kThreads - 1) / kThreads, H, Bt), grid_c(nc, H / HT, Bt);
  int err;
  if (tc) {
    using T = __nv_bfloat16;
    if ((err = set_smem(reinterpret_cast<const void*>(ssd_chunk_state_tc), smem_a))) return err;
    if ((err = set_smem(reinterpret_cast<const void*>(ssd_chunk_output_tc), smem_c))) return err;
    ssd_chunk_state_tc<<<grid_a, kThreads, smem_a, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
        static_cast<const T*>(B), static_cast<float*>(dH), static_cast<float*>(cum), S, H, G, N, P,
        HA);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    ssd_state_pass<<<grid_b, kThreads, 0, s>>>(static_cast<float*>(dH), static_cast<T*>(hin),
                                                static_cast<const float*>(cum),
                                                static_cast<float*>(hT), nc, H, N, P, L);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    ssd_chunk_output_tc<<<grid_c, kThreads, smem_c, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const T*>(B),
        static_cast<const T*>(C), static_cast<const T*>(hin), static_cast<const float*>(cum),
        static_cast<T*>(y), S, H, G, N, P, HT);
    return static_cast<int>(cudaGetLastError());
  }
  if ((err = set_smem(reinterpret_cast<const void*>(ssd_chunk_state_f32), smem_a))) return err;
  if ((err = set_smem(reinterpret_cast<const void*>(ssd_chunk_output_f32), smem_c))) return err;
  ssd_chunk_state_f32<<<grid_a, kThreads, smem_a, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<float*>(dH), static_cast<float*>(cum), S, H, G, N,
      P);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  ssd_state_pass<<<grid_b, kThreads, 0, s>>>(static_cast<float*>(dH), nullptr,
                                              static_cast<const float*>(cum),
                                              static_cast<float*>(hT), nc, H, N, P, L);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  ssd_chunk_output_f32<<<grid_c, kThreads, smem_c, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(dH), static_cast<const float*>(cum),
      static_cast<float*>(y), S, H, G, N, P, HT);
  return static_cast<int>(cudaGetLastError());
}
