// int8_flash_attention: integer attention.  q int8 [B*H, S, D], k/v int8 [B*Hkv, Skv, D]
// (GQA: query head h reads kv head h / (H/Hkv)), causal or not:
//   scores   = (q . k) >> rshift                      int32 (int8 products, int32 sums)
//   p        = i_softmax(scores)                      int8 payload in [0, 127]
//   v_scale  : out = (sum_j p_j * (float(v_j) * s_v[j])) * f32(1/127)    f32 [B*H, S, D]
//   no scale : out =  sum_j p_j * v_j                                    int32 [B*H, S, D]
//
// Replaces the Pallas kernel ``repro/kernels/int8_flash_attention.py``
// ``int8_flash_attention`` (bodies ``_pass1_kernel``, ``_pass2_kernel``,
// ``_pass3_pv_kernel`` and ``_pass3_kernel``).  The TPU kernel streams K three
// times (row max; exp-sum; int8 p @ V) because an online integer softmax
// cannot rescale exactly; this kernel does the same, in one form for any Skv.
//
// Bound on the H100: operations.  The v_scale form's PV runs in f32 outside
// the tensor cores (2*S*Skv*D flops per head, halved by the causal mask:
// 0.26 ms at codeqwen1.5-7b's [4, 32, 1024, 128]); QK^T at the int8
// tensor-core rate costs about 9 us a pass there.  What held the SIMT form
// (PRs 14-16) at 6-14x its bound: QK^T by ``__dp4a`` behind a shared load
// each, 16 query rows a block (every K/V tile read 64 times a head), tiles
// loaded synchronously, a PV loop of 8 shared loads and 4 conversions per 32
// FMAs (an own V column per output at D = 80), and two integer divisions per
// (row, key).
//
// Design: two kernels of one launch over blocks of 64 query rows of a head
// (heavy row blocks, near the diagonal's end, scheduled first), in one form
// for any Skv:
// * ``int8_attention_stats_kernel`` (4 warps of 16 rows, about 100 registers,
//   four blocks an SM): passes 1 and 2, each row's max and exp-sum, into a
//   scratch the wrapper allocates;
// * ``int8_attention_kernel``: pass 3, the probabilities and PV (8 warps
//   with v_scale, 4 for the int32 form).
// * QK^T on ``mma.sync.m16n8k32`` s8 x s8 -> s32 (``warp_mma.cuh``): exact
//   integer sums, so every score, exp and probability keeps its bits.  A
//   warp's Q fragments stay in registers for the block's life; K rows are
//   zero-padded to whole 32-byte k steps (D = 80 takes three).
// * K (and, in pass 3, V and its scales) arrive in 64-key tiles by
//   ``cp.async`` through a ring of 3 stages, so the next tiles' copies
//   overlap this tile's products.  Rows are padded to an odd count of 16-byte
//   chunks: ``ldmatrix``'s eight rows never share a bank.  Key tiles wholly
//   above the diagonal are skipped (their probabilities are exactly 0: the
//   wrapper checks that the exp of a masked score, -(2^24) - max, is 0), and
//   tiles with no masked key take a path without the per-key test.
// * No integer division: ``/ q_ln2`` and ``/ l`` are multiply-highs by exact
//   reciprocals (``rcp``, ``div_rcp`` of ``int_exp.cuh``, shared with
//   int_softmax.cu: floor(n / d) = (n * m) >> sh for every 0 <= n < 2^31),
//   q_ln2's from the wrapper (``common.rcp``), l's once per row.
// * Pass 3, int32 form: warp w scores rows 16w .. 16w + 15 against a whole
//   tile; its probabilities are the A fragments of two int8 ``mma.sync`` k
//   steps in place (k order 2t, 2t+1, 8+2t, 9+2t within 16 keys); V's B
//   fragments come from ``ldmatrix.trans`` of the raw tile and two byte
//   permutes in the same order.  Exact.
// * Pass 3, v_scale form: warp w scores rows 16 * (w & 3) .. + 15 against
//   keys 32 * (w >> 2) .. + 31 of each tile (8 warps, 16 an SM).
//   Each V tile is dequantized once into shared memory as
//   ``__fmul_rn(float(v), s_v)`` (the reference's product); the warps write
//   their probabilities (f32) and, per 8 rows, a mask of the keys with a
//   nonzero probability; warp w then runs a register-blocked FFMA product
//   for rows 8w .. 8w + 7 (a lane: 4 rows x D/16 columns, 4 probabilities
//   and D/16 values of V per key) over the keys of its mask only.  (Fetching
//   the next key's operands during this key's FMAs ran slower.)  Each output sums key
//   by key from key 0 with ``fmaf``, the SIMT form's order: a skipped key's
//   terms are 0 * v, exact identities (at codeqwen's phase-3 inputs about
//   half the keys an 8-row group sees are skipped).
// Shared memory at D = 128: 27 KB (stats) and 109 KB with v_scale (two
// blocks an SM), 56 KB without.  D is a template argument, any multiple of
// 16 up to 128.
//
// Exactness: the integer scores, exps, sums and probabilities are bit-exact
// (the exp follows the oracle ``inumerics.i_exp``: the remainder is formed
// from the unclamped halving count); the int32 form is exact.  The f32 PV sum
// runs key by key, another order than the reference's einsum, so the v_scale
// form agrees to rtol 1e-5, atol 1e-6.  ``p_out`` (optional, int8
// [B*H, S, Skv]) receives the integer probabilities for the exact check.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_exp.cuh"
#include "warp_mma.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;     // the stats kernel's block
constexpr int PV_THREADS = 2 * THREADS; // the v_scale PV kernel's block: 8 warps
constexpr int BQ = 16 * WARPS;          // query rows per block
constexpr int BK = 64;                  // keys per tile
constexpr int NT = BK / 8;              // n8 score tiles per key tile
constexpr int STAGES = 3;               // stages of the cp.async ring
constexpr int PSTR = 20;                // f32 row of a warp's probabilities (16 + 4)
constexpr int NEG_INF = -(1 << 24);

struct Params {
  const int8_t* q;
  const int8_t* k;
  const int8_t* v;
  const float* vs;   // [B*Hkv, Skv] or null
  void* out;
  int8_t* p_out;     // [B*H, S, Skv] or null
  int h, hkv, s, skv;
  int causal, rshift, q_ln2, q_b, q_c, es;
  unsigned ln2_m;    // rcp(q_ln2)
  int ln2_sh;
  float rcp127;
};

// shared memory of head dim D: K rows padded to whole k32 steps, every row
// to an odd count of 16-byte chunks; a stage holds a K tile, a V tile and
// its scales; then (v_scale) the dequantized V tile and the warps'
// probabilities.  ``int8_flash_attention.block_smem`` mirrors it.
template <int D>
struct Lay {
  static constexpr int DP = (D + 31) / 32 * 32;
  static constexpr int KS = DP / 32;                     // k32 steps of QK^T
  static constexpr int LDK = DP + 16;                    // DP / 16 is even
  static constexpr int LDV = D + ((D / 16) % 2 == 0 ? 16 : 0);
  static constexpr int K_BYTES = BK * LDK, V_BYTES = BK * LDV;
  static constexpr int STAGE = K_BYTES + V_BYTES + BK * 4;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int VD = BK * D * 4;                  // dequantized V tile
  static constexpr int PS = WARPS * BK * PSTR * 4;       // probabilities
  static constexpr int MASKS = 2 * PV_THREADS / 32 * 4;  // nonzero keys per 8 rows
  static constexpr int bytes(bool vs) { return RING + (vs ? VD + PS + MASKS : 0); }
  static_assert(K_BYTES >= BQ * LDK, "the Q rows are staged in one K tile");
};

// i_exp(max(s - m, NEG_INF)) >> es in the oracle's order; s - m <= 0
__device__ __forceinline__ int int_exp(int s, int m, const Params& p) {
  const int qs = max(s - m, NEG_INF);
  const int z = div_rcp(static_cast<unsigned>(-qs), p.ln2_m, p.ln2_sh);
  const int t = qs + z * p.q_ln2 + p.q_b;   // q_p + q_b, q_p in (-q_ln2, 0]
  return ((t * t + p.q_c) >> min(z, 30)) >> p.es;
}

// the oracle's (e * 127 + l // 2) // l clamped to 127 (e >= 0: the wrapper
// checks q_c >= 0 and that the numerator stays below 2^31)
__device__ __forceinline__ int prob(int e, int l, unsigned lm, int lsh) {
  return min(div_rcp(static_cast<unsigned>(e * 127 + (l >> 1)), lm, lsh), 127);
}

// the block's view of one head: row block q0 (heavy ones first), its key
// tiles, the K, V and V-scale rows of its kv head; NTHR threads copy
template <int D, int NTHR>
struct Block {
  int bh, q0, n_tiles;
  const int8_t* kg;
  const int8_t* vg;
  const float* vsg;

  __device__ Block(const Params& p) {
    bh = blockIdx.y;
    q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
    const size_t kvh = static_cast<size_t>(bh / p.h) * p.hkv + (bh % p.h) / (p.h / p.hkv);
    kg = p.k + kvh * p.skv * D;
    vg = p.v + kvh * p.skv * D;
    vsg = p.vs != nullptr ? p.vs + kvh * p.skv : nullptr;
    const int n_keys = p.causal ? min(p.skv, q0 + BQ) : p.skv;
    n_tiles = (n_keys + BK - 1) / BK;
  }

  // the copies of key tile kt (K; with ``with_v`` V and, where given, its
  // scales) into stage ``st``, then one commit (every thread counts the
  // same groups)
  __device__ void issue(uint8_t* st, int kt, bool with_v, const Params& p) const {
    using L = Lay<D>;
    const int tid = threadIdx.x;
#pragma unroll
    for (int c = tid; c < BK * (L::DP / 16); c += NTHR) {
      const int r = c / (L::DP / 16), col = c % (L::DP / 16), key = kt * BK + r;
      const bool in = key < p.skv && col < D / 16;
      wmma::cp_async_16(st + r * L::LDK + 16 * col,
                        in ? kg + static_cast<size_t>(key) * D + 16 * col : kg, in ? 16 : 0);
    }
    if (with_v) {
      uint8_t* sv = st + L::K_BYTES;
#pragma unroll
      for (int c = tid; c < BK * (D / 16); c += NTHR) {
        const int r = c / (D / 16), col = c % (D / 16), key = kt * BK + r;
        const bool in = key < p.skv;
        wmma::cp_async_16(sv + r * L::LDV + 16 * col,
                          in ? vg + static_cast<size_t>(key) * D + 16 * col : vg, in ? 16 : 0);
      }
      if (vsg != nullptr && tid < BK) {
        const int key = kt * BK + tid;
        wmma::cp_async_4(sv + L::V_BYTES + 4 * tid, key < p.skv ? vsg + key : vsg,
                         key < p.skv ? 4 : 0);
      }
    }
    wmma::cp_async_commit();
  }

  // the copy of the Q rows (zero past S and past D) into ``qs``: one group
  __device__ void load_q(uint8_t* qs, const Params& p) const {
    using L = Lay<D>;
    const int8_t* qg = p.q + static_cast<size_t>(bh) * p.s * D;
    for (int c = threadIdx.x; c < BQ * (L::DP / 16); c += NTHR) {
      const int r = c / (L::DP / 16), col = c % (L::DP / 16), row = q0 + r;
      const bool in = row < p.s && col < D / 16;
      wmma::cp_async_16(qs + r * L::LDK + 16 * col,
                        in ? qg + static_cast<size_t>(row) * D + 16 * col : qg, in ? 16 : 0);
    }
    wmma::cp_async_commit();
  }
};

// the warp's integer scores >> rshift of 16 rows x 8 * NW keys: the K rows
// from ``kb`` (key 0 of the warp's range in a stage); n8 tile j holds keys
// 8j .. 8j + 7, and score c of tile j is row g + 8 * (c >> 1), key
// 8j + 2t + (c & 1)
template <int D, int NW>
__device__ __forceinline__ void tile_scores(const uint8_t* kb, const uint32_t (&qf)[Lay<D>::KS][4],
                                            int (&sc)[NW][4], int rshift) {
  using L = Lay<D>;
  const int lane = threadIdx.x & 31;
  // the lane's K row address in a tile pair: keys 8 * (lane >> 4) + (lane & 7)
  // of 16, bytes 16 * ((lane >> 3) & 1) of a k32 step
  kb += (8 * (lane >> 4) + (lane & 7)) * L::LDK + 16 * ((lane >> 3) & 1);
#pragma unroll
  for (int j = 0; j < NW; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0;
#pragma unroll
  for (int ks = 0; ks < L::KS; ++ks)
#pragma unroll
    for (int u = 0; u < NW / 2; ++u) {
      uint32_t b[4];
      wmma::ldmatrix_x4(b, kb + 16 * u * L::LDK + 32 * ks);
      wmma::mma_s8_16832(sc[2 * u], qf[ks], b[0], b[1]);
      wmma::mma_s8_16832(sc[2 * u + 1], qf[ks], b[2], b[3]);
    }
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) sc[j][c] >>= rshift;
}

// the Q fragments of staged rows 16 * rg16 .. + 15
template <int D>
__device__ __forceinline__ void q_fragments(const uint8_t* qs, int rg16,
                                            uint32_t (&qf)[Lay<D>::KS][4]) {
  using L = Lay<D>;
  const int lane = threadIdx.x & 31;
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 16 * (lane >> 4);
#pragma unroll
  for (int ks = 0; ks < L::KS; ++ks)
    wmma::ldmatrix_x4(qf[ks], qs + (16 * rg16 + lrow) * L::LDK + 32 * ks + lcol);
}

// unmasked keys [0, n_r) of query row ``row``
__device__ __forceinline__ int row_keys(int row, const Params& p) {
  return row >= p.s ? 0 : (p.causal ? min(row + 1, p.skv) : p.skv);
}

// true if keys [kbeg, kbeg + n) are unmasked for every row of row0 .. row0 + 15
__device__ __forceinline__ bool keys_full(int kbeg, int n, int row0, const Params& p) {
  return kbeg + n <= (p.causal ? min(row0 + 1, p.skv) : p.skv) && row0 + 16 <= p.s;
}

// Passes 1 and 2: each row's max m and exp-sum l over its unmasked keys,
// into stats[bh * S + row].  Scores only: about 100 registers, four blocks
// an SM.
template <int D>
__global__ void __launch_bounds__(THREADS, 4)
int8_attention_stats_kernel(Params p, int2* __restrict__ stats) {
  using L = Lay<D>;
  extern __shared__ __align__(16) uint8_t smem[];
  const Block<D, THREADS> blk(p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int steps = 2 * blk.n_tiles;
  blk.load_q(smem + (STAGES - 1) * L::K_BYTES, p);
  for (int i = 0; i < STAGES - 1; ++i)
    if (i < steps) blk.issue(smem + i * L::K_BYTES, i % blk.n_tiles, false, p);
    else wmma::cp_async_commit();
  wmma::cp_async_wait<STAGES - 1>();
  __syncthreads();
  uint32_t qf[L::KS][4];
  q_fragments<D>(smem + (STAGES - 1) * L::K_BYTES, warp, qf);
  const int row0 = blk.q0 + 16 * warp;
  int n_r[2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0, 0};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) n_r[rr] = row_keys(row0 + g + 8 * rr, p);
  for (int i = 0; i < steps; ++i) {
    wmma::cp_async_wait<STAGES - 2>();
    __syncthreads();                     // step i landed; step i - 1 is done everywhere
    if (i + STAGES - 1 < steps)
      blk.issue(smem + ((i + STAGES - 1) % STAGES) * L::K_BYTES, (i + STAGES - 1) % blk.n_tiles,
                false, p);
    else
      wmma::cp_async_commit();
    const int pass = i / blk.n_tiles, key0 = (i - pass * blk.n_tiles) * BK;
    int sc[NT][4];
    tile_scores<D, NT>(smem + (i % STAGES) * L::K_BYTES, qf, sc, p.rshift);
    const bool full = keys_full(key0, BK, row0, p);
    if (pass == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (full || key0 + 8 * j + 2 * t + (c & 1) < n_r[c >> 1])
            m[c >> 1] = max(m[c >> 1], sc[j][c]);
      if (i == blk.n_tiles - 1)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          m[rr] = max(m[rr], __shfl_xor_sync(0xffffffffu, m[rr], 1));
          m[rr] = max(m[rr], __shfl_xor_sync(0xffffffffu, m[rr], 2));
        }
    } else if (full) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) l[c >> 1] += int_exp(sc[j][c], m[c >> 1], p);
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (key0 + 8 * j + 2 * t + (c & 1) < n_r[c >> 1])
            l[c >> 1] += int_exp(sc[j][c], m[c >> 1], p);
    }
  }
  wmma::cp_async_wait<0>();
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    const int row = row0 + g + 8 * rr;
    if (t == 0 && row < p.s)
      stats[static_cast<size_t>(blk.bh) * p.s + row] = make_int2(m[rr], l[rr]);
  }
}

// Pass 3: the probabilities from the rows' stats, p_out, and PV.  Warp w
// computes the scores and probabilities of rows 16 * (w & 3) .. + 15 for
// keys 32 * (w >> 2) .. + 31 of each tile (v_scale, 8 warps) or all 64 keys
// (int32, 4 warps).  v_scale: the warps write their probabilities (f32)
// and, per 8 rows, a mask of the keys with a nonzero one to shared memory;
// warp w then owns rows 8w .. 8w + 7 of the product (a lane rows
// 8w + 4 * (lane >> 4) .. + 3 and D / 16 columns) and runs only the keys of
// its mask, in key order.  int32: each warp's probabilities are the A
// fragments of two k32 steps in place.
template <int D, bool VS>
__global__ void __launch_bounds__(VS ? PV_THREADS : THREADS, 2)
int8_attention_kernel(Params p, const int2* __restrict__ stats) {
  constexpr int NTHR = VS ? PV_THREADS : THREADS;
  constexpr int NW = VS ? BK / 16 : BK / 8;         // n8 score tiles of a warp
  using L = Lay<D>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  float* vd = reinterpret_cast<float*>(smem + L::RING);                 // [BK][D]
  float* ps = reinterpret_cast<float*>(smem + L::RING + L::VD);         // [4][BK][PSTR]
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + L::RING + L::VD + L::PS);  // [8][2]
  const Block<D, NTHR> blk(p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg16 = warp & 3, kh = warp >> 2;       // the warp's rows and keys of a tile
  const int n_tiles = blk.n_tiles;
  blk.load_q(ring + (STAGES - 1) * L::STAGE, p);
  for (int i = 0; i < STAGES - 1; ++i)
    if (i < n_tiles) blk.issue(ring + i * L::STAGE, i, true, p);
    else wmma::cp_async_commit();
  wmma::cp_async_wait<STAGES - 1>();
  __syncthreads();
  uint32_t qf[L::KS][4];
  q_fragments<D>(ring + (STAGES - 1) * L::STAGE, rg16, qf);

  // rows g and g + 8 of the warp's 16: unmasked keys, max, exp-sum and the
  // sum's reciprocal
  const int row0 = blk.q0 + 16 * rg16;
  int n_r[2], m[2], l[2], lsh[2];
  unsigned lm[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + g + 8 * rr;
    n_r[rr] = row_keys(row, p);
    const int2 st = row < p.s ? stats[static_cast<size_t>(blk.bh) * p.s + row]
                              : make_int2(NEG_INF, 0);
    m[rr] = st.x, l[rr] = max(st.y, 1);
    rcp(static_cast<unsigned>(l[rr]), lm[rr], lsh[rr]);
  }

  // the lane's outputs.  v_scale: rows 8 * warp + 4 * rg + r, columns
  // VW * cg + 16 * VW * c + e (CPL = D / 16 of them); int32: per 16-column
  // group jj an even and an odd fragment (columns 4t .. 4t + 3 of rows g,
  // g + 8 of the warp's 16)
  constexpr int CPL = D / 16;
  constexpr int VW = CPL % 4 == 0 ? 4 : (CPL % 2 == 0 ? 2 : 1);
  constexpr int NCH = CPL / VW;
  const int rg = lane >> 4, cg = lane & 15;
  float facc[VS ? 4 : 1][VS ? CPL : 1];
  int iacc[VS ? 1 : D / 16][2][4];
  if constexpr (VS) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CPL; ++c) facc[r][c] = 0.f;
  } else {
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c) iacc[jj][e][c] = 0;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    wmma::cp_async_wait<STAGES - 2>();
    __syncthreads();                     // tile kt landed; tile kt - 1 is done everywhere
    if (kt + STAGES - 1 < n_tiles)
      blk.issue(ring + ((kt + STAGES - 1) % STAGES) * L::STAGE, kt + STAGES - 1, true, p);
    else
      wmma::cp_async_commit();
    const uint8_t* st = ring + (kt % STAGES) * L::STAGE;
    const int kbeg = kt * BK + 8 * NW * kh;  // the warp's first key

    if constexpr (VS) {                  // the V tile dequantized once, for every warp
      const uint8_t* sv = st + L::K_BYTES;
      const float* svs = reinterpret_cast<const float*>(sv + L::V_BYTES);
      // a thread converts 4 bytes at a time: neighbouring lanes read
      // neighbouring words and write neighbouring 16-byte chunks
#pragma unroll 4
      for (int c = tid; c < BK * (D / 4); c += NTHR) {
        const int r = c / (D / 4), q4 = c % (D / 4);
        const int w = *reinterpret_cast<const int*>(sv + r * L::LDV + 4 * q4);
        const float s_v = svs[r];
        float f[4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          f[b] = __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> (8 * b))), s_v);
        reinterpret_cast<float4*>(vd + r * D)[q4] = make_float4(f[0], f[1], f[2], f[3]);
      }
    }

    // the probabilities of the warp's 16 rows x 32 keys (in place of the scores)
    int sc[NW][4];
    tile_scores<D, NW>(st + 8 * NW * kh * L::LDK, qf, sc, p.rshift);
    if (keys_full(kbeg, 8 * NW, row0, p)) {
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int rr = c >> 1;
          sc[j][c] = prob(int_exp(sc[j][c], m[rr], p), l[rr], lm[rr], lsh[rr]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int rr = c >> 1, key = kbeg + 8 * j + 2 * t + (c & 1);
          sc[j][c] = key < n_r[rr] ? prob(int_exp(sc[j][c], m[rr], p), l[rr], lm[rr], lsh[rr])
                                   : 0;
        }
    }
    if (p.p_out != nullptr)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = row0 + g + 8 * (c >> 1);
        if (row >= p.s) continue;
        int8_t* prow = p.p_out + (static_cast<size_t>(blk.bh) * p.s + row) * p.skv;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const int key = kbeg + 8 * j + 2 * t + (c & 1);
          if (key < p.skv) prow[key] = static_cast<int8_t>(sc[j][c]);
        }
      }
    if constexpr (VS) {
      // per 8 rows (rows g, or g + 8) the warp's keys with a nonzero
      // probability, bit 8j + 2t + e, OR-ed over the warp's lanes
      uint32_t nz[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (sc[j][c] != 0) nz[c >> 1] |= 1u << (8 * j + 2 * t + (c & 1));
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        nz[0] |= __shfl_xor_sync(0xffffffffu, nz[0], o);
        nz[1] |= __shfl_xor_sync(0xffffffffu, nz[1], o);
      }
      float* pw = ps + rg16 * BK * PSTR;            // [key][row] of the 16 rows
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          pw[(32 * kh + 8 * j + 2 * t + (c & 1)) * PSTR + g + 8 * (c >> 1)] =
              static_cast<float>(sc[j][c]);
      if (lane == 0) masks[2 * (2 * rg16) + kh] = nz[0], masks[2 * (2 * rg16 + 1) + kh] = nz[1];
      __syncthreads();                    // the dequantized V tile, probabilities, masks
      // rows 8 * warp .. + 7: the probabilities of group warp >> 1, rows
      // 8 * (warp & 1) + 4 * rg .. + 3
      const float* pr0 = ps + (warp >> 1) * BK * PSTR + 8 * (warp & 1) + 4 * rg;
      const float* v0 = vd + VW * cg;
      // the keys of the mask in order (a skipped key's terms are 0 * v,
      // exact identities)
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        uint32_t todo = masks[2 * warp + half];
        while (todo != 0u) {
          const int j = 32 * half + __ffs(static_cast<int>(todo)) - 1;
          todo &= todo - 1u;
          const float4 pa = *reinterpret_cast<const float4*>(pr0 + j * PSTR);
          const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
          float vv[CPL];
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const float* src = v0 + j * D + 16 * VW * c;
            if constexpr (VW == 4) {
              const float4 x = *reinterpret_cast<const float4*>(src);
              vv[4 * c] = x.x, vv[4 * c + 1] = x.y, vv[4 * c + 2] = x.z, vv[4 * c + 3] = x.w;
            } else if constexpr (VW == 2) {
              const float2 x = *reinterpret_cast<const float2*>(src);
              vv[2 * c] = x.x, vv[2 * c + 1] = x.y;
            } else {
              vv[c] = *src;
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < CPL; ++c) facc[r][c] = fmaf(pv[r], vv[c], facc[r][c]);
        }
      }
    } else {
      // A fragments: k positions 4t .. 4t + 3 of a 16-key half are keys 2t,
      // 2t + 1 (tile 2u) and 8 + 2t, 9 + 2t (tile 2u + 1)
      const uint8_t* sv = st + L::K_BYTES;
      const int j_end = min(BK, (p.causal ? min(row0 + 16, p.skv) : p.skv) - kt * BK);
#pragma unroll
      for (int s32 = 0; s32 < BK / 32; ++s32) {
        if (32 * s32 >= j_end) break;    // keys past the warp's last row: p = 0
        uint32_t a[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j0 = 4 * s32 + 2 * hh;
          a[2 * hh] = static_cast<uint32_t>(sc[j0][0]) | (static_cast<uint32_t>(sc[j0][1]) << 8) |
                      (static_cast<uint32_t>(sc[j0 + 1][0]) << 16) |
                      (static_cast<uint32_t>(sc[j0 + 1][1]) << 24);
          a[2 * hh + 1] = static_cast<uint32_t>(sc[j0][2]) |
                          (static_cast<uint32_t>(sc[j0][3]) << 8) |
                          (static_cast<uint32_t>(sc[j0 + 1][2]) << 16) |
                          (static_cast<uint32_t>(sc[j0 + 1][3]) << 24);
        }
#pragma unroll
        for (int jj = 0; jj < D / 16; ++jj) {
          uint32_t r[4];  // keys 32 s32 + lane: rows 2t, 2t + 1 of each 8 x 8 matrix
          wmma::ldmatrix_x4_trans(r, sv + (32 * s32 + lane) * L::LDV + 16 * jj);
          const uint32_t e0 = __byte_perm(r[0], r[1], 0x6420), o0 = __byte_perm(r[0], r[1], 0x7531);
          const uint32_t e1 = __byte_perm(r[2], r[3], 0x6420), o1 = __byte_perm(r[2], r[3], 0x7531);
          wmma::mma_s8_16832(iacc[jj][0], a, e0, e1);
          wmma::mma_s8_16832(iacc[jj][1], a, o0, o1);
        }
      }
    }
  }
  wmma::cp_async_wait<0>();

  // p_out of keys past the block's tiles: 0
  constexpr int WROWS = BQ * 32 / NTHR;             // rows a warp clears
  if (p.p_out != nullptr)
    for (int r = 0; r < WROWS; ++r) {
      const int row = blk.q0 + WROWS * warp + r;
      if (row >= p.s) break;
      int8_t* prow = p.p_out + (static_cast<size_t>(blk.bh) * p.s + row) * p.skv;
      for (int j = n_tiles * BK + lane; j < p.skv; j += 32) prow[j] = 0;
    }

  if constexpr (VS) {
    float* og = static_cast<float*>(p.out);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = blk.q0 + 8 * warp + 4 * rg + r;
      if (row >= p.s) continue;
      float* orow = og + (static_cast<size_t>(blk.bh) * p.s + row) * D + VW * cg;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < VW; ++e)
          orow[16 * VW * c + e] = __fmul_rn(facc[r][VW * c + e], p.rcp127);
    }
  } else {
    int* og = static_cast<int*>(p.out);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + g + 8 * rr;
      if (row >= p.s) continue;
      int* orow = og + (static_cast<size_t>(blk.bh) * p.s + row) * D + 4 * t;
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj)
        *reinterpret_cast<int4*>(orow + 16 * jj) =
            make_int4(iacc[jj][0][2 * rr], iacc[jj][1][2 * rr], iacc[jj][0][2 * rr + 1],
                      iacc[jj][1][2 * rr + 1]);
    }
  }
}

template <int D, bool VS>
int launch(const Params& p, int2* stats, int bh, cudaStream_t st) {
  using L = Lay<D>;
  const int s_smem = STAGES * L::K_BYTES, smem = L::bytes(VS);
  auto stats_kern = int8_attention_stats_kernel<D>;
  auto kern = int8_attention_kernel<D, VS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.s + BQ - 1) / BQ, bh);
  stats_kern<<<grid, THREADS, s_smem, st>>>(p, stats);
  kern<<<grid, VS ? PV_THREADS : THREADS, smem, st>>>(p, stats);
  return static_cast<int>(cudaGetLastError());
}

template <bool VS>
int launch_d(const Params& p, int2* stats, int d, int bh, cudaStream_t st) {
  switch (d) {   // any head dim that is a multiple of 16 up to 128
#define REPRO_IFA_CASE(D) \
  case D: return launch<D, VS>(p, stats, bh, st);
    REPRO_IFA_CASE(16) REPRO_IFA_CASE(32) REPRO_IFA_CASE(48) REPRO_IFA_CASE(64)
    REPRO_IFA_CASE(80) REPRO_IFA_CASE(96) REPRO_IFA_CASE(112) REPRO_IFA_CASE(128)
#undef REPRO_IFA_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_int8_flash_attention(const void* q, const void* k, const void* v,
                                          const void* v_scale, void* out, void* p_out, int b,
                                          int h, int hkv, int s, int skv, int d, int causal,
                                          int rshift, int q_ln2, int q_b, int q_c, int es,
                                          unsigned ln2_m, int ln2_sh, float rcp127,
                                          void* stats, void* stream) {
  if (b == 0 || s == 0) return static_cast<int>(cudaGetLastError());
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const int8_t*>(v);
  p.vs = static_cast<const float*>(v_scale);
  p.out = out;
  p.p_out = static_cast<int8_t*>(p_out);
  p.h = h, p.hkv = hkv, p.s = s, p.skv = skv;
  p.causal = causal, p.rshift = rshift, p.q_ln2 = q_ln2, p.q_b = q_b, p.q_c = q_c, p.es = es;
  p.ln2_m = ln2_m, p.ln2_sh = ln2_sh;
  p.rcp127 = rcp127;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int2* sp = static_cast<int2*>(stats);
  return v_scale != nullptr ? launch_d<true>(p, sp, d, b * h, st)
                            : launch_d<false>(p, sp, d, b * h, st);
}
