// The tensor-core main loop of the port's GEMMs: activations [M, K] x NS
// weight streams [K, N] (1, or 2 for the gated MLP's up and gate over one
// shared A tile), templated on the kind of weight (the B operand):
//   W4    int8 activations x packed int4 weights [K/2, N], each with its
//         per-group int8 multipliers qmul [K/G, N], G in {32, 64, 128}
//         (int4_gemm, dual_int4_gemm_gated);
//   W8    int8 activations x int8 weights [K, N] (int8_gemm,
//         dual_gemm_gated's int8 form);
//   BF16  bf16 activations x bf16 weights [K, N], f32 sums
//         (dual_gemm_gated, bf16).
// The A operand comes from a source type (``mainloop``'s last template
// argument): ``RowMajorA``, the default, copies a row-major [M, K] tile
// (every GEMM: the same code as before the source existed);
// int8_conv2d's ``ConvA`` gathers an implicit GEMM's rows, the output
// pixels, from an NHWC image, one window chunk per ``cp.async`` (or byte
// loads for ragged channels).
//
// Bound on the H100: at decode rows (M <= 64) bytes — the weight streams
// must run near HBM's rate (half a byte, one byte or two bytes of weight per
// multiply-add and row); at prefill rows operations at the int8 or bf16
// tensor-core rate.  What the SIMT loop these GEMMs ran on before lost on
// both: ``__dp4a`` or f32 FMAs from shared memory, and loads through
// registers with no copy in flight while the block computes.
//
// Design:
// * products with ``mma.sync.m16n8k32.s32.s8.s8.s32`` (W4, W8: exact int32
//   sums, so every output bit of the SIMT loop stays) or
//   ``mma.sync.m16n8k16.f32.bf16.bf16.f32`` (BF16);
// * A ([BM, BK]) and each stream's raw weight tile and, for W4, its qmul
//   rows arrive by 16-byte ``cp.async.cg`` copies in a ring of STAGES = 4
//   stages; the copy of step j + 3 is in flight while step j is computed,
//   one barrier per step.  BK is 128 (W4) or 64 (W8, BF16): a stage holds
//   64 rows of each weight stream (8 KB at 128 int8 or packed columns, 16 KB
//   at 128 bf16 ones).
//   Rows are padded by 16 bytes (an odd stride in 16-byte chunks), so
//   ``ldmatrix``'s eight rows never share a bank;
// * W4: the nibbles widen at the fragment load: ``ldmatrix.trans`` of the
//   packed tile as 16-bit elements gives lane (g, t) the bytes of packed rows
//   2t and 2t + 1 at columns 2g and 2g + 1 — four consecutive k of two
//   columns, in one register; two masks and two byte permutes make the B
//   fragments of two 8-column tiles, "even" (column 2g of each 16) and "odd"
//   (2g + 1), with each nibble in the high half of its byte (16 * w: no sign
//   extension; the fold divides by 16 exactly — faster on the card than
//   widening to w).  So lane (g, t) holds, per 16-column group, outputs at
//   columns 4t .. 4t + 3 of rows g and g + 8;
// * W4: each scale group's sums build in ``part`` and fold into ``acc`` as
//   ``acc += (part / 16) * qmul[grp, n]`` at the group's end (the
//   reference's int32 group combine, exact in any order), qmul read from the
//   staged rows;
// * W8: the same "even"/"odd" fragments from the int8 tile in the
//   reference's [K, N] layout: ``ldmatrix.trans`` of 16-bit elements hands a
//   lane two rows of two columns, so the eight row addresses of a matrix
//   are k = {0, 1, 4, 5, 10, 11, 14, 15} (matrix 0) and {2, 3, 6, 7, 8, 9,
//   12, 13} (matrix 1), +16 for matrices 2 and 3 — each set distinct mod 8,
//   so conflict-free at any odd row stride — and two byte permutes per
//   register pair (their selector swapped for lanes t >= 2, whose matrix 0
//   rows are 4t + 2, 4t + 3) give k = 4t .. 4t + 3 of columns 2g and 2g + 1;
// * BF16: A by ``ldmatrix.x4``, B by ``ldmatrix.x4.trans`` straight from the
//   [K, N] tile (as flash_attention.cu loads V); lane (g, t) holds, per
//   16-column group, outputs at columns 2t, 2t + 1 (+8) of rows g and g + 8;
// * split K (the integer kinds): blocks of one output tile add int32 sums
//   into a workspace [NS][M][N], the last to arrive (a per-tile counter)
//   takes the totals, resets workspace and counter, and runs the epilogue;
//   the wrapper keeps every block's K range on group boundaries.  BF16
//   never splits K (float sums would depend on the arrival order): its
//   decode tile is narrower instead;
// * expert batching (a MoE layer's experts, the reference's ``jax.vmap``
//   over ``pallas_call``): one launch over E experts, grid z = expert x
//   split (``Slice``); each kernel moves its operands, scales, output and
//   split-K scratch to the block's expert before ``mainloop``, so an
//   expert's blocks compute what an unbatched launch (E = 1) on its rows
//   computes, bit for bit;
// * tile shapes (``int8_gemm.w4_tiling``, ``w8_tiling``, ``bf16_tiling``
//   pick): decode, blocks of 16 rows x 128 columns (4 warps of 16 x 32; rows
//   past M are computed only up to the next multiple of 16), K split until
//   each SM has about 32 KB of weight in flight — int4_gemm and int8_gemm
//   up to M = 64 (one block over all 64 rows of a bucket-64 step ran slower
//   than four 16-row blocks at N = 4096; int8_gemm takes 64-row blocks from
//   the first row for a weight past 64 MiB, the heads, which 16-row blocks
//   would read from device memory once per 16 rows), the dual GEMMs up to
//   M = 32 (at N = 13440 a 64-row block over 105 column tiles ran 1.1-2.4x
//   faster at M = 64 than four 16-row blocks, which read the weights four
//   times); dual_gemm_gated's bf16 decode
//   blocks are 16 x 64 (4 warps of 16 x 16: 210 blocks at N = 13440 without
//   a split); prefill, BM = 64, BN = 128, 8 warps of 32 x 32 and two blocks
//   an SM (<= 128 registers a thread; for int4_gemm 8 warps of 64 x 32, one
//   block an SM, and 16 warps of 32 x 32 over 128 x 128 ran slower at
//   M = 4096).  Two W4 streams hold part and acc for both, so
//   dual_int4_gemm_gated's prefill warps are 16 x 32 (``DualPrefill``, 64 ints
//   a thread, two blocks an SM: 4-14% faster than 32 x 32 warps at one block
//   an SM); dual_gemm_gated's bf16 form runs 64 x 128 blocks up to M = 128
//   (``MidPrefill``: BK = 64 fills 176 KB, one block an SM) and 128 x 128
//   blocks of 8 warps of 64 x 32
//   past it (``WidePrefill``, one block an SM: 23% faster at M = 4096 than
//   64 x 128 blocks at BK = 32); int8_gemm runs ``WidePrefill`` for deep K
//   (the down projections) at scoring rows (``int8_gemm.w8_tiling``).
// ``wgmma`` with TMA is the next step for these kernels: it would need the
// widened W4 tile written back to shared memory K-major first, and
// flash_attention's first ``wgmma`` form ran slower than its ``mma.sync``
// one, so this loop stays on ``mma.sync``.  The float linear, bf16_gemm,
// has a ``wgmma`` loop of its own (``bf16_gemm.cu``): the BF16 kind here
// serves dual_gemm_gated's bf16 form only.
// Ragged M and N are masked; with ``vec`` = 0 (a row of A or W not a
// multiple of 16 bytes, or an unaligned operand) the stages fill by byte
// loads instead.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace mma_gemm {

constexpr int STAGES = 4;   // stages in the ring
constexpr int PAD = 16;     // bytes added to every shared row

// the B operand's kinds: K per stage, bytes of an activation, shared rows of
// a weight stage, bytes of a weight column in a row
struct W4 {
  using T = int;
  static constexpr int BK = 128, A_ELEM = 1, W_ROWS = BK / 2, W_ELEM = 1;
  static constexpr bool GROUPED = true, FLOAT = false;
};
struct W8 {
  using T = int;
  static constexpr int BK = 64, A_ELEM = 1, W_ROWS = BK, W_ELEM = 1;
  static constexpr bool GROUPED = false, FLOAT = false;
};
struct BF16 {
  using T = float;
  static constexpr int BK = 64, A_ELEM = 2, W_ROWS = BK, W_ELEM = 2;
  static constexpr bool GROUPED = false, FLOAT = true;
};

// WARPS_M x WARPS_N warps, each MT 16-row tiles x NP 16-column groups;
// MIN_BLOCKS blocks per SM (the register cap ``__launch_bounds__`` sets)
template <int WARPS_M_, int WARPS_N_, int MT_, int NP_, int MIN_BLOCKS_ = 1>
struct Cfg {
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, MT = MT_, NP = NP_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int BM = 16 * MT * WARPS_M, BN = 16 * NP * WARPS_N;
};

using Decode = Cfg<1, 4, 1, 2>;          // BM = 16, BN = 128, 4 warps
using Prefill = Cfg<2, 4, 2, 2, 2>;      // BM = 64, BN = 128, 8 warps of 32 x 32, 2 blocks an SM
using DualPrefill = Cfg<2, 4, 1, 2, 2>;  // BM = 32, BN = 128, 8 warps of 16 x 32 (two W4 streams)
using NarrowDecode = Cfg<1, 4, 1, 1>;    // BM = 16, BN = 64, 4 warps (BF16)
using MidPrefill = Cfg<2, 4, 2, 2, 1>;   // BM = 64, BN = 128, one block an SM (BF16: 176 KB)
using WidePrefill = Cfg<2, 4, 4, 2, 1>;  // BM = 128, BN = 128, 8 warps of 64 x 32 (BF16)

// one stage of config C, kind B, NS streams: A [BM][LDA], NS weight tiles
// [W_ROWS][LDW], then (W4) NS qmul tiles [BK/32][BN] (rows past the stage's
// groups are zero); ``int8_gemm.mma_smem_bytes`` mirrors it
template <class C, class B, int NS>
struct Stage {
  static constexpr int LDA = B::BK * B::A_ELEM + PAD;
  static constexpr int LDW = C::BN * B::W_ELEM + PAD;
  static constexpr int A_BYTES = C::BM * LDA;
  static constexpr int W_BYTES = B::W_ROWS * LDW;
  static constexpr int Q_BYTES = B::GROUPED ? B::BK / 32 * C::BN : 0;
  static constexpr int BYTES = A_BYTES + NS * (W_BYTES + Q_BYTES);
  static constexpr int SMEM = STAGES * BYTES;
  static_assert(SMEM <= 232448, "a block's shared memory on the H100");
  static_assert(!B::GROUPED || C::NP % 2 == 0, "W4's ldmatrix.x4 takes two 16-column groups");
};

template <int NS>
struct Streams {
  const void* w[NS];       // W4: packed int4 [K/2, N]; W8: int8 [K, N]; BF16: bf16 [K, N]
  const int8_t* qmul[NS];  // W4 only: int8 group multipliers [K/G, N]
};

// acc[stream][m tile][column group][even/odd or 8-column half][fragment]
template <class C, class B, int NS>
using Acc = typename B::T[NS][C::MT][C::NP][2][4];

// the output row and column of fragment element c of (m tile i, column
// group j, e: even/odd (integer kinds) or 8-column half (BF16)) of this lane
template <class C>
__device__ __forceinline__ int out_row(int i, int c) {
  const int warp_m = (threadIdx.x >> 5) / C::WARPS_N;
  return blockIdx.y * C::BM + 16 * (warp_m * C::MT + i) + ((threadIdx.x & 31) >> 2) + 8 * (c >> 1);
}
template <class C, class B>
__device__ __forceinline__ int out_col(int j, int e, int c) {
  const int warp_n = (threadIdx.x >> 5) % C::WARPS_N;
  const int col0 = blockIdx.x * C::BN + 16 * (warp_n * C::NP + j), t = threadIdx.x & 3;
  return B::FLOAT ? col0 + 8 * e + 2 * t + (c & 1) : col0 + 4 * t + 2 * (c & 1) + e;
}

// 16 bytes at p (count bytes valid, the rest 0) into shared dst, synchronously
__device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* p, int count) {
#pragma unroll
  for (int b = 0; b < 16; ++b) dst[b] = b < count ? p[b] : 0;
}

// rows r0 .. r0 + ROWS - 1, bytes c0 .. c0 + COLS - 1 of a row-major
// [n_rows, ld] byte matrix (rows at or past n_rows and bytes at or past
// n_cols read as 0) into shared [ROWS][dst_ld].  Each thread copies one
// column chunk of every (THREADS / CH)-th row, its addresses stepped by a
// constant in a fully unrolled loop: the index arithmetic of a strided loop
// over all chunks cost 5-20% of the GEMMs' time on the card.
template <class C, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(uint8_t* dst, int dst_ld, const uint8_t* __restrict__ src,
                                          int ld, int r0, int n_rows, int c0, int n_cols,
                                          int vec) {
  constexpr int CH = COLS / 16, RS = C::THREADS / CH;
  static_assert(C::THREADS % CH == 0, "whole rows per pass");
  const int r_t = threadIdx.x / CH, c = 16 * (threadIdx.x % CH), col = c0 + c;
  uint8_t* d0 = dst + r_t * dst_ld + c;
  const uint8_t* s0 = src + static_cast<size_t>(r0 + r_t) * ld + col;
  const bool col_in = col < n_cols;
#pragma unroll
  for (int j = 0; j < (ROWS + RS - 1) / RS; ++j) {
    const int r = r_t + j * RS;
    if (ROWS % RS != 0 && r >= ROWS) break;
    uint8_t* d = d0 + j * RS * dst_ld;
    const uint8_t* sp = s0 + static_cast<size_t>(j * RS) * ld;
    if (vec) {  // every 16-byte chunk is all in or all out
      const bool in = r0 + r < n_rows && col_in;
      wmma::cp_async_16(d, in ? sp : src, in ? 16 : 0);
    } else {
      copy_bytes(d, sp, r0 + r < n_rows ? max(0, min(16, n_cols - col)) : 0);
    }
  }
}

// The A operand's sources.  ``load_stage`` asks its source for the
// block's A tile [BM, BK] at depth k0 (bytes at or past kend, and rows at or
// past M, zero) once a stage, k0 rising from the block's first depth by BK
// each call, so a source may keep per-thread state from one stage to the
// next.  ``RowMajorA``, the default: x is a row-major [M, K] matrix (the
// GEMMs).  int8_conv2d's gathered source (``ConvA``, in int8_conv2d.cu)
// maps output pixel m and window depth k to the NHWC image.
struct RowMajorA {
  template <class C, class B>
  __device__ __forceinline__ void load(uint8_t* dst, int lda, const uint8_t* __restrict__ x,
                                       int M, int K, int k0, int kend, int vec) {
    constexpr int AE = B::A_ELEM;
    load_tile<C, C::BM, B::BK * AE>(dst, lda, x, K * AE, blockIdx.y * C::BM, M, k0 * AE,
                                    kend * AE, vec);
  }
};

// one stage: A [BM, BK] at k0 from the A source, each stream's weight rows
// for k0 .. k0 + BK and (W4) the qmul rows of the groups starting in
// [k0, k0 + BK)
template <class C, class B, int NS, class A>
__device__ __forceinline__ void load_stage(uint8_t* stage, const uint8_t* __restrict__ x,
                                           const Streams<NS>& s, int M, int N, int K, int G,
                                           int k0, int kend, int vec, A& a) {
  using S = Stage<C, B, NS>;
  constexpr int WE = B::W_ELEM;
  a.template load<C, B>(stage, S::LDA, x, M, K, k0, kend, vec);
  const int n0 = blockIdx.x * C::BN;
  // weight rows: packed (two k a row) for W4, one k a row otherwise
  const int r0 = B::GROUPED ? k0 / 2 : k0, r_end = B::GROUPED ? kend / 2 : kend;
#pragma unroll
  for (int st = 0; st < NS; ++st) {
    uint8_t* ws = stage + S::A_BYTES + st * S::W_BYTES;
    load_tile<C, B::W_ROWS, C::BN * WE>(ws, S::LDW, static_cast<const uint8_t*>(s.w[st]),
                                        N * WE, r0, r_end, n0 * WE, N * WE, vec);
    if constexpr (B::GROUPED) {
      // BK / G rows (at most BK / 32): rows past the stage's groups read as 0
      const uint8_t* qm = reinterpret_cast<const uint8_t*>(s.qmul[st]);
      uint8_t* qs = stage + S::A_BYTES + NS * S::W_BYTES + st * S::Q_BYTES;
      const int g0 = k0 / G, g_end = (kend + G - 1) / G;
      for (int i = threadIdx.x; i < (B::BK / 32) * (C::BN / 16); i += C::THREADS) {
        const int j = i / (C::BN / 16), c = 16 * (i % (C::BN / 16));
        const int grp = g0 + j, col = n0 + c;
        const int count = (j < B::BK / G && grp < g_end) ? max(0, min(16, N - col)) : 0;
        uint8_t* d = qs + j * C::BN + c;
        if (vec)
          wmma::cp_async_16(d, qm + (count ? static_cast<size_t>(grp) * N + col : 0), count);
        else
          copy_bytes(d, qm + static_cast<size_t>(grp) * N + col, count);
      }
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
__device__ __forceinline__ void fold(Acc<C, W4, NS>& part, Acc<C, W4, NS>& acc,
                                     const uint8_t* stage, int j) {
  using S = Stage<C, W4, NS>;
  const int wn0 = 16 * ((threadIdx.x >> 5) % C::WARPS_N) * C::NP;
#pragma unroll
  for (int st = 0; st < NS; ++st) {
    const uint8_t* qs = stage + S::A_BYTES + NS * S::W_BYTES + st * S::Q_BYTES + j * C::BN;
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

// the products of one stage (k0 .. k0 + BK, stopping at kend): W4 into
// ``part`` (folded into ``acc`` at each group's end), W8 and BF16 into ``acc``
template <class C, class B, int NS>
__device__ __forceinline__ void compute_stage(const uint8_t* stage, int G, int k0, int kend,
                                              Acc<C, B, NS>& part, Acc<C, B, NS>& acc) {
  using S = Stage<C, B, NS>;
  constexpr int KS = B::FLOAT ? 16 : 32;  // k of one mma (32 bytes of A a row)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = 16 * (warp / C::WARPS_N) * C::MT, wn0 = 16 * (warp % C::WARPS_N) * C::NP;
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 16 * (lane >> 4);
  // W8: this lane's row address in a 32-k step, and the byte permutes of
  // the registers it receives (rows 4t, 4t + 1 of matrix 0 for t < 2, else
  // 4t + 2, 4t + 3)
  const int r8 = lane & 7, m8 = lane >> 3;
  const int krow8 = 4 * (r8 >> 1) + (r8 & 1) + 2 * (((r8 >> 2) ^ m8) & 1) + 16 * (m8 >> 1);
  const uint32_t sel_e = (lane & 3) < 2 ? 0x6420u : 0x2064u;
  const uint32_t sel_o = (lane & 3) < 2 ? 0x7531u : 0x3175u;
#pragma unroll
  for (int ks = 0; ks < B::BK / KS; ++ks) {
    const int k = k0 + KS * ks;
    if (k >= kend) break;
    uint32_t a[C::MT][4];
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
      wmma::ldmatrix_x4(a[i], stage + (wm0 + 16 * i + lrow) * S::LDA + 32 * ks + lcol);
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      const uint8_t* ws = stage + S::A_BYTES + st * S::W_BYTES;
      if constexpr (B::GROUPED) {
#pragma unroll
        for (int jp = 0; jp < C::NP / 2; ++jp) {
          uint32_t r[4];  // groups 2jp (k 0..15, 16..31), 2jp + 1 (the same)
          wmma::ldmatrix_x4_trans(r, ws + (16 * ks + lrow) * S::LDW + wn0 + 32 * jp + lcol);
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
      } else if constexpr (!B::FLOAT) {
#pragma unroll
        for (int jj = 0; jj < C::NP; ++jj) {
          uint32_t r[4];  // k {0,1,4,5,..} / {2,3,6,7,..} of group jj, then +16
          wmma::ldmatrix_x4_trans(r, ws + (32 * ks + krow8) * S::LDW + wn0 + 16 * jj);
          const uint32_t e0 = __byte_perm(r[0], r[1], sel_e), o0 = __byte_perm(r[0], r[1], sel_o);
          const uint32_t e1 = __byte_perm(r[2], r[3], sel_e), o1 = __byte_perm(r[2], r[3], sel_o);
#pragma unroll
          for (int i = 0; i < C::MT; ++i) {
            wmma::mma_s8_16832(acc[st][i][jj][0], a[i], e0, e1);
            wmma::mma_s8_16832(acc[st][i][jj][1], a[i], o0, o1);
          }
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < C::NP; ++jj) {
          uint32_t b[4];  // columns 0..7 (k 0..7, 8..15), 8..15 (the same) of group jj
          wmma::ldmatrix_x4_trans(b, ws + (16 * ks + lrow) * S::LDW + 2 * (wn0 + 16 * jj) + lcol);
#pragma unroll
          for (int i = 0; i < C::MT; ++i) {
            wmma::mma_bf16_16816(acc[st][i][jj][0], a[i], b[0], b[1]);
            wmma::mma_bf16_16816(acc[st][i][jj][1], a[i], b[2], b[3]);
          }
        }
      }
    }
    if constexpr (B::GROUPED) {
      if ((k + 32) % G == 0) fold<C, NS>(part, acc, stage, (k - k0) / G);
    }
  }
}

// This block's place in a launch over E experts (the expert-batched forms;
// an unbatched launch is E = 1), each expert's output tiles split ``split``
// ways along K: blockIdx.z = expert * split + kz.  The kernels move every
// operand, scale, output and split-K scratch pointer to the block's expert
// before ``mainloop``, so one expert's blocks compute exactly what an
// unbatched launch on that expert's rows computes.
struct Slice {
  int expert, kz, split;
  __device__ __forceinline__ explicit Slice(int split_)
      : expert(static_cast<int>(blockIdx.z) / split_),
        kz(static_cast<int>(blockIdx.z) - expert * split_),
        split(split_) {}
};

// Run this block's K range (``sl.kz`` of ``sl.split``) and (integer kinds)
// the split-K combine.  Returns true in the block that holds the tile's
// totals in ``acc`` and must run the epilogue.  G: the W4 scale group
// (unused otherwise).  ``a``: the A operand's source (``RowMajorA``: x is
// [M, K]).  ``partial`` and ``counters`` are the block's expert's.
template <class C, class B, int NS, class A = RowMajorA>
__device__ __forceinline__ bool mainloop(const void* __restrict__ x, const Streams<NS>& s,
                                         int M, int N, int K, int G, const Slice& sl,
                                         int k_len, int vec, int32_t* __restrict__ partial,
                                         int* __restrict__ counters, Acc<C, B, NS>& acc,
                                         A a = A()) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int is_last;
  using T = typename B::T;
  constexpr int SB = Stage<C, B, NS>::BYTES, BK = B::BK;
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  const int kbeg = sl.kz * k_len;
  const int kend = min(K, kbeg + k_len);
  const int nk = (kend - kbeg + BK - 1) / BK;
  Acc<C, B, NS> part;  // W4 only (dead otherwise)
#pragma unroll
  for (int st = 0; st < NS; ++st)
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NP; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[st][i][j][e][c] = part[st][i][j][e][c] = T(0);

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk)
      load_stage<C, B, NS>(smem + st * SB, xb, s, M, N, K, G, kbeg + st * BK, kend, vec, a);
    wmma::cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    wmma::cp_async_wait<STAGES - 2>();  // step it has landed (this thread's copies)
    __syncthreads();                    // ... everyone's; step it - 1 is consumed
    const int nxt = it + STAGES - 1;    // refill the stage step it - 1 used
    if (nxt < nk)
      load_stage<C, B, NS>(smem + (nxt % STAGES) * SB, xb, s, M, N, K, G, kbeg + nxt * BK,
                           kend, vec, a);
    wmma::cp_async_commit();
    compute_stage<C, B, NS>(smem + (it % STAGES) * SB, G, kbeg + it * BK, kend, part, acc);
  }
  wmma::cp_async_wait<0>();

  if constexpr (!B::FLOAT) {
    if (sl.split > 1) {  // split K: combine the int32 sums
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
                const int m = out_row<C>(i, c), n = out_col<C, B>(j, e, c);
                if (m < M && n < N)
                  atomicAdd(&partial[st * mn + static_cast<size_t>(m) * N + n],
                            acc[st][i][j][e][c]);
              }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0)
        is_last = atomicAdd(&counters[tile], 1) == sl.split - 1;
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
                const int m = out_row<C>(i, c), n = out_col<C, B>(j, e, c);
                if (m < M && n < N)
                  acc[st][i][j][e][c] =
                      atomicExch(&partial[st * mn + static_cast<size_t>(m) * N + n], 0);
              }
      if (threadIdx.x == 0) counters[tile] = 0;
    }
  }
  return true;
}

}  // namespace mma_gemm
