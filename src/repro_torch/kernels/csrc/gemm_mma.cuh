// The tensor-core main loop of the port's W4A8 GEMMs: int8 activations
// [M, K] x NS packed int4 weight streams [K/2, N] (1, or 2 for the gated
// MLP's up and gate over one shared A tile), each with its per-group int8
// multipliers qmul [K/G, N], G in {32, 64, 128}.
//
// Bound on the H100: at decode rows (M <= 64) bytes — half a byte of weight
// per multiply-add, so the nibble stream must run near HBM's rate; at
// prefill rows operations at the int8 tensor-core rate.  What the SIMT loop
// of ``gemm_tile.cuh`` lost on both: ``__dp4a`` from shared memory, and
// loads through registers with no copy in flight while the block computes.
//
// Design:
// * products with ``mma.sync.m16n8k32.s32.s8.s8.s32`` (exact int32 sums, so
//   every output bit of the SIMT loop stays);
// * A ([BM, BK] int8) and each stream's raw nibble tile ([BK/2, BN] bytes)
//   and its qmul rows arrive by 16-byte ``cp.async.cg`` copies in a ring of
//   STAGES = 4 stages of BK = 128; the copy of step j + 3 is in flight while
//   step j is computed, one barrier per step; rows are padded by 16 bytes
//   (an odd stride in 16-byte chunks), so ``ldmatrix``'s eight rows never
//   share a bank;
// * the nibbles widen at the fragment load: ``ldmatrix.trans`` of the packed
//   tile as 16-bit elements gives lane (g, t) the bytes of packed rows 2t and
//   2t + 1 at columns 2g and 2g + 1 — four consecutive k of two columns, in
//   one register; two masks and two byte permutes make the B fragments of
//   two 8-column tiles, "even" (column 2g of each 16) and "odd" (2g + 1),
//   with each nibble in the high half of its byte (16 * w: no sign
//   extension; the fold divides by 16 exactly — faster on the card than
//   widening to w).  So lane (g, t) holds, per 16-column group, outputs
//   at columns 4t .. 4t + 3 of rows g and g + 8;
// * each scale group's sums build in ``part`` and fold into ``acc`` as
//   ``acc += (part / 16) * qmul[grp, n]`` at the group's end (the
//   reference's int32 group combine, exact in any order), qmul read from
//   the staged rows;
// * split K as in ``gemm_tile.cuh``: blocks of one output tile add int32
//   sums into a workspace [NS][M][N], the last to arrive (a per-tile counter)
//   takes the totals, resets workspace and counter, and runs the epilogue;
//   the wrapper keeps every block's K range on group boundaries;
// * two tile shapes (``int8_gemm.w4_tiling`` picks): decode, M <= 64, blocks
//   of 16 rows x 128 columns (4 warps of 16 x 32; rows past M are computed
//   only up to the next multiple of 16), K split until each SM has about 32
//   KB of weight in flight (one block over all 64 rows of a bucket-64 step
//   ran slower than four 16-row blocks, and slower than the SIMT loop);
//   prefill (M > 64), BM = 64, BN = 128, 8 warps of 32 x 32 and two blocks
//   an SM (<= 128 registers a thread; 8 warps of 64 x 32, one block an SM,
//   and 16 warps of 32 x 32 over 128 x 128 ran slower at M = 4096).
//   ``wgmma`` would need the widened B tile written back to shared memory
//   K-major first; this loop stays on ``mma.sync``.
// Ragged M and N are masked; with ``vec`` = 0 (N or K not a multiple of 16,
// or an unaligned operand) the stages fill by byte loads instead.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace mma_gemm {

constexpr int BK = 128;     // K per stage
constexpr int STAGES = 4;   // stages in the ring
constexpr int PAD = 16;     // bytes added to every shared row

// WARPS_M x WARPS_N warps, each MT 16-row tiles x NP 16-column groups;
// MIN_BLOCKS blocks per SM (the register cap ``__launch_bounds__`` sets)
template <int WARPS_M_, int WARPS_N_, int MT_, int NP_, int MIN_BLOCKS_ = 1>
struct Cfg {
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, MT = MT_, NP = NP_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int BM = 16 * MT * WARPS_M, BN = 16 * NP * WARPS_N;
  static constexpr int LDA = BK + PAD;           // A stage [BM][LDA]
  static constexpr int LDW = BN + PAD;           // W stage [BK/2][LDW], per stream
  static constexpr int A_BYTES = BM * LDA;
  static constexpr int W_BYTES = BK / 2 * LDW;
  static constexpr int Q_BYTES = BK / 32 * BN;   // qmul rows of a stage (G >= 32)
  template <int NS>
  __host__ __device__ static constexpr int stage_bytes() {
    return A_BYTES + NS * (W_BYTES + Q_BYTES);
  }
  template <int NS>
  __host__ __device__ static constexpr int smem_bytes() { return STAGES * stage_bytes<NS>(); }
  static_assert(NP % 2 == 0, "ldmatrix.x4 takes two 16-column groups");
};

using Decode = Cfg<1, 4, 1, 2>;     // BM = 16, BN = 128, 4 warps
using Prefill = Cfg<2, 4, 2, 2, 2>;  // BM = 64, BN = 128, 8 warps of 32 x 32, 2 blocks an SM

template <int NS>
struct Streams {
  const int8_t* w4[NS];    // packed int4 [K/2, N]
  const int8_t* qmul[NS];  // int8 group multipliers [K/G, N]
};

// acc[stream][m tile][column group][even, odd][fragment]
template <class C, int NS>
using Acc = int[NS][C::MT][C::NP][2][4];

// the output row and column of fragment element c of (m tile i, column
// group j, even/odd e) of this lane
template <class C>
__device__ __forceinline__ int out_row(int i, int c) {
  const int warp_m = (threadIdx.x >> 5) / C::WARPS_N;
  return blockIdx.y * C::BM + 16 * (warp_m * C::MT + i) + ((threadIdx.x & 31) >> 2) + 8 * (c >> 1);
}
template <class C>
__device__ __forceinline__ int out_col(int j, int e, int c) {
  const int warp_n = (threadIdx.x >> 5) % C::WARPS_N;
  return blockIdx.x * C::BN + 16 * (warp_n * C::NP + j) + 4 * (threadIdx.x & 3) + 2 * (c & 1) + e;
}

// 16 bytes at p (count bytes valid, the rest 0) into shared dst, synchronously
__device__ __forceinline__ void copy_bytes(uint8_t* dst, const int8_t* p, int count) {
#pragma unroll
  for (int b = 0; b < 16; ++b) dst[b] = b < count ? static_cast<uint8_t>(p[b]) : 0;
}

// rows r0 .. r0 + ROWS - 1, bytes c0 .. c0 + COLS - 1 of a row-major int8
// [n_rows, ld] matrix (rows at or past n_rows and columns at or past n_cols
// read as 0) into shared [ROWS][dst_ld]
template <class C, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(uint8_t* dst, int dst_ld, const int8_t* __restrict__ src,
                                          int ld, int r0, int n_rows, int c0, int n_cols,
                                          int vec) {
  constexpr int CH = COLS / 16;
  for (int i = threadIdx.x; i < ROWS * CH; i += C::THREADS) {
    const int r = i / CH, c = 16 * (i % CH);
    uint8_t* d = dst + r * dst_ld + c;
    const int row = r0 + r, col = c0 + c;
    const int count = row < n_rows ? max(0, min(16, n_cols - col)) : 0;
    if (vec)  // every 16-byte chunk is all in or all out
      wmma::cp_async_16(d, src + (count ? static_cast<size_t>(row) * ld + col : 0), count);
    else
      copy_bytes(d, src + static_cast<size_t>(row) * ld + col, count);
  }
}

// one stage: A [BM, BK] at k0, each stream's packed rows k0/2 .. + BK/2 and
// the qmul rows of the groups starting in [k0, k0 + BK)
template <class C, int NS>
__device__ __forceinline__ void load_stage(uint8_t* stage, const int8_t* __restrict__ x,
                                           const Streams<NS>& s, int M, int N, int K, int G,
                                           int k0, int kend, int vec) {
  load_tile<C, C::BM, BK>(stage, C::LDA, x, K, blockIdx.y * C::BM, M, k0, kend, vec);
  const int n0 = blockIdx.x * C::BN;
  const int kp_end = kend / 2, g0 = k0 / G, g_end = (kend + G - 1) / G;
#pragma unroll
  for (int st = 0; st < NS; ++st) {
    uint8_t* ws = stage + C::A_BYTES + st * C::W_BYTES;
    uint8_t* qs = stage + C::A_BYTES + NS * C::W_BYTES + st * C::Q_BYTES;
    load_tile<C, BK / 2, C::BN>(ws, C::LDW, s.w4[st], N, k0 / 2, kp_end, n0, N, vec);
    // BK / G rows (at most BK / 32): rows past the stage's groups read as 0
    for (int i = threadIdx.x; i < (BK / 32) * (C::BN / 16); i += C::THREADS) {
      const int j = i / (C::BN / 16), c = 16 * (i % (C::BN / 16));
      const int grp = g0 + j, col = n0 + c;
      const int count = (j < BK / G && grp < g_end) ? max(0, min(16, N - col)) : 0;
      uint8_t* d = qs + j * C::BN + c;
      if (vec)
        wmma::cp_async_16(d, s.qmul[st] + (count ? static_cast<size_t>(grp) * N + col : 0), count);
      else
        copy_bytes(d, s.qmul[st] + static_cast<size_t>(grp) * N + col, count);
    }
  }
}

// one ``ldmatrix.trans`` register of the packed tile (bytes: row 2t col 2g,
// row 2t col 2g+1, row 2t+1 col 2g, row 2t+1 col 2g+1) -> the B words of
// column 2g (even) and 2g + 1 (odd), k = 4t .. 4t + 3 in byte order, each
// byte 16 * w: the nibble in the byte's high half is its own sign extension
__device__ __forceinline__ void widen(uint32_t r, uint32_t& even, uint32_t& odd) {
  const uint32_t lo = (r << 4) & 0xF0F0F0F0u, hi = r & 0xF0F0F0F0u;
  even = __byte_perm(lo, hi, 0x6240);
  odd = __byte_perm(lo, hi, 0x7351);
}

// acc += (part / 16) * qmul for local group j of the stage (part sums
// x * 16w: a multiple of 16, |part| <= 16 * 128 * 128 * 8 = 2^21); part
// back to zero
template <class C, int NS>
__device__ __forceinline__ void fold(Acc<C, NS>& part, Acc<C, NS>& acc, const uint8_t* stage,
                                     int j) {
  const int wn0 = 16 * ((threadIdx.x >> 5) % C::WARPS_N) * C::NP;
#pragma unroll
  for (int st = 0; st < NS; ++st) {
    const uint8_t* qs = stage + C::A_BYTES + NS * C::W_BYTES + st * C::Q_BYTES + j * C::BN;
#pragma unroll
    for (int jj = 0; jj < C::NP; ++jj) {
      const uint32_t qw =
          *reinterpret_cast<const uint32_t*>(qs + wn0 + 16 * jj + 4 * (threadIdx.x & 3));
      // columns 4t, 4t + 1, 4t + 2, 4t + 3: even c0/c2, odd c0/c2, even c1/c3, odd c1/c3
      const int q[4] = {static_cast<int8_t>(qw), static_cast<int8_t>(qw >> 8),
                        static_cast<int8_t>(qw >> 16), static_cast<int8_t>(qw >> 24)};
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[st][i][jj][e][c] += (part[st][i][jj][e][c] >> 4) * q[2 * (c & 1) + e];
            part[st][i][jj][e][c] = 0;
          }
    }
  }
}

// the products of one stage (k0 .. k0 + BK, stopping at kend)
template <class C, int NS>
__device__ __forceinline__ void compute_stage(const uint8_t* stage, int G, int k0, int kend,
                                              Acc<C, NS>& part, Acc<C, NS>& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = 16 * (warp / C::WARPS_N) * C::MT, wn0 = 16 * (warp % C::WARPS_N) * C::NP;
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 16 * (lane >> 4);
#pragma unroll
  for (int ks = 0; ks < BK / 32; ++ks) {
    const int k = k0 + 32 * ks;
    if (k >= kend) break;
    uint32_t a[C::MT][4];
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
      wmma::ldmatrix_x4(a[i], stage + (wm0 + 16 * i + lrow) * C::LDA + 32 * ks + lcol);
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      const uint8_t* ws = stage + C::A_BYTES + st * C::W_BYTES;
#pragma unroll
      for (int jp = 0; jp < C::NP / 2; ++jp) {
        uint32_t r[4];  // groups 2jp (k 0..15, 16..31), 2jp + 1 (the same)
        wmma::ldmatrix_x4_trans(r, ws + (16 * ks + lrow) * C::LDW + wn0 + 32 * jp + lcol);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t e0, o0, e1, o1;
          widen(r[2 * h], e0, o0);
          widen(r[2 * h + 1], e1, o1);
#pragma unroll
          for (int i = 0; i < C::MT; ++i) {
            wmma::mma_s8_16832(part[st][i][2 * jp + h][0], a[i], e0, e1);
            wmma::mma_s8_16832(part[st][i][2 * jp + h][1], a[i], o0, o1);
          }
        }
      }
    }
    if ((k + 32) % G == 0) fold<C, NS>(part, acc, stage, (k - k0) / G);
  }
}

// Run this block's K range and the split-K combine.  Returns true in the
// block that holds the tile's totals in ``acc`` and must run the epilogue.
template <class C, int NS>
__device__ __forceinline__ bool mainloop(const int8_t* __restrict__ x, const Streams<NS>& s,
                                         int M, int N, int K, int G, int k_len, int vec,
                                         int32_t* __restrict__ partial,
                                         int* __restrict__ counters, Acc<C, NS>& acc) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int is_last;
  constexpr int SB = C::template stage_bytes<NS>();
  const int kbeg = blockIdx.z * k_len;
  const int kend = min(K, kbeg + k_len);
  const int nk = (kend - kbeg + BK - 1) / BK;
  Acc<C, NS> part;
#pragma unroll
  for (int st = 0; st < NS; ++st)
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NP; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[st][i][j][e][c] = part[st][i][j][e][c] = 0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage<C, NS>(smem + st * SB, x, s, M, N, K, G, kbeg + st * BK, kend, vec);
    wmma::cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    wmma::cp_async_wait<STAGES - 2>();  // step it has landed (this thread's copies)
    __syncthreads();                    // ... everyone's; step it - 1 is consumed
    const int nxt = it + STAGES - 1;    // refill the stage step it - 1 used
    if (nxt < nk)
      load_stage<C, NS>(smem + (nxt % STAGES) * SB, x, s, M, N, K, G, kbeg + nxt * BK, kend,
                        vec);
    wmma::cp_async_commit();
    compute_stage<C, NS>(smem + (it % STAGES) * SB, G, kbeg + it * BK, kend, part, acc);
  }
  wmma::cp_async_wait<0>();

  if (gridDim.z > 1) {  // split K: combine the int32 sums
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const size_t mn = static_cast<size_t>(M) * N;
#pragma unroll
    for (int st = 0; st < NS; ++st)
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NP; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int m = out_row<C>(i, c), n = out_col<C>(j, e, c);
              if (m < M && n < N)
                atomicAdd(&partial[st * mn + static_cast<size_t>(m) * N + n], acc[st][i][j][e][c]);
            }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      is_last = atomicAdd(&counters[tile], 1) == static_cast<int>(gridDim.z) - 1;
    __syncthreads();
    if (!is_last) return false;
    __threadfence();
#pragma unroll
    for (int st = 0; st < NS; ++st)
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NP; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int m = out_row<C>(i, c), n = out_col<C>(j, e, c);
              if (m < M && n < N)
                acc[st][i][j][e][c] =
                    atomicExch(&partial[st * mn + static_cast<size_t>(m) * N + n], 0);
            }
    if (threadIdx.x == 0) counters[tile] = 0;
  }
  return true;
}

}  // namespace mma_gemm
