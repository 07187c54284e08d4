// The body shared by the port's two decode attentions (int8_kv_decode_attention
// over the dense ring cache, paged_decode_attention over the paged arena): T
// query rows per lane (T = 1 at decode; a packed t > 1 step's rows, each at
// its own position, in the multi-row form), GQA, an f32 online softmax split
// over the cache.  Each form (a .cu) only names where key j lives: its
// ``Form`` functor, named ``<kernel>_kernel`` so that both kernels of the
// form carry its name in a profile.
//
// Both caches are a table of ROWS, one row per (slot, kv head) holding D
// values plus, for int8 payloads, one f32 scale, and a position per slot
// (-1 = empty).  They differ only in where key j of lane b lives, which the
// ``Form`` functor says (``form(b, j)`` = the slot's index in the cache: dense
// b*S + j, paged pt[b, j / ps]*ps + j % ps), and in the rule for a lane with
// no valid slot (``Form::ZERO_DEAD``).  So a paged arena and a dense cache holding
// the same content give the same bits: every sum below runs in one order.
//
// A block per (lane, kv head, KV split, tile of R rows) holds the R x G query
// (row, head) pairs of that group; the cache is split into ``n_split`` chunks
// of ``chunk`` keys so that B*Hkv*n_split blocks fill the card (B*Hkv = 16
// alone would use 16 SMs).  The split comes from the lanes (``kv_split(B*Hkv,
// S)``), never from T, and every (row, head) pair runs exactly the arithmetic
// of a T = 1 launch at its position: the same tiles in the same order, each
// masked by the row's own position, the same combine.  So a row of the
// multi-row form equals a decode step at that position bit for bit, whatever
// R and whatever the other rows; R only sets how many rows share one read of
// each K/V tile.
//
// The arithmetic of a (row, head) pair, per tile of BS = 32 keys: a score per
// key (an ``fmaf`` chain over d in order of q by the dequantized key, int8
// times its scale with ``__fmul_rn``, the reference's product; bf16 payloads
// as they are; times the softmax scale), the tile's max by a shuffle tree,
// p = expf(s - m), their sum by a shuffle tree, alpha = expf(m_prev - m),
// l = l * alpha + sum, acc = acc * alpha + sum_j p_j * v_j (one ``fmaf`` per
// key, in key order).  Each chunk writes its unnormalized (m, l, acc) to a
// scratch; ``combine`` merges the chunks (rescaling each by exp(m - max m))
// and divides.  Masking reads positions only: a slot is valid iff 0 <= kpos
// <= qpos and, with a window, kpos > qpos - window; masked scores take the
// finite NEG = -1e30, keys past the chunk -inf.  With every slot masked the
// dense rule averages V, as its reference's softmax does, and the paged rule
// emits exact zeros, as its TPU kernel does.  ``expf``, not ``__expf``;
// offsets in ``size_t``.
//
// Bound on the H100: bytes (the valid slots' int8 K and V rows and scales,
// about 4*G flops per byte).  How the bytes arrive and how the threads are
// used:
// * a prescan of SEG tiles at a time resolves every key's slot (the paged
//   table read here, ahead of the copies) and position into shared memory,
//   marks which rows of the block have a valid key in each tile (a bit mask)
//   and lists the tiles to read;
// * the listed tiles' raw rows (K only where some row scores the tile) and
//   their f32 scales come by ``cp.async`` (16 bytes a payload chunk, 4 a
//   scale: a slot's scales lie Hkv floats apart) into a ring of STAGES
//   tiles: the next round's copies are in flight while one round is
//   computed.  K rows are padded to an odd number of 16-byte chunks, so the
//   eight keys a quarter-warp reads never share a bank;
// * a round is NR tiles and three barriers: every key of the round is scored
//   at once (a thread per key, each carrying up to PMAX pairs, the key's 16
//   bytes dequantized once per chunk at the point of use), then one warp per
//   pair runs the per-tile softmax updates in tile order, then a thread per
//   (pair group, d) runs the PV chains in key order, each V byte dequantized
//   once for its pairs.  (A three-stage pipeline of rounds, scores, softmax
//   and PV of three rounds at once, ran no faster at T = 1 and slower in the
//   multi-row form, whose blocks it made too large to share an SM.)
// Work follows the valid keys.  A (row, head) pair takes part only in the
// tiles that hold a valid key for its row, and a tile that holds none for
// any row of the block is not read.  This changes no bit: in a tile with no
// valid key for a row that already has one, p = exp(NEG - m) = 0 and the
// update is the identity; before a chunk's first valid key the sums it
// would gather are scaled by exp(NEG - m) = 0 there; a chunk with none for
// a live row is weighted exp(NEG - max m) = 0 by the combine.  So a row's
// bits depend only on its own valid keys, whatever rows share its block.
// A dead row (no valid key anywhere in its lane: a pad at position -1, a
// window past every key) under the dense rule needs the plain sum of V over
// every key instead: each block first finds its rows' liveness over the
// whole lane, and a block holding a dead row lists every tile of its chunk
// and sums its V (``dead``, in the order the softmax would add it, with
// p = 1), which the combine merges for dead rows.  Every block of a lane
// writes the same sums.
#pragma once
#include <cuda_bf16.h>
#include <math_constants.h>

#include "common.cuh"
#include "warp_mma.cuh"

namespace decode {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int BS = 32;             // keys per tile
constexpr int NR = 2;              // tiles per round
constexpr int STAGES = 4;          // tiles in the copy ring
constexpr int RING = STAGES / NR;  // rounds in the ring (RING - 1 in flight)
constexpr int SEG = 16;            // tiles prescanned at once (one ballot)
constexpr int KR = NR * BS;        // keys per round
constexpr int TPK = THREADS / KR;  // pair groups of the score phase
constexpr int PMAX = 8;            // (row, head) pairs a thread carries at once
constexpr int MAXI = 3;            // copy items of a thread per tile (D * kv bytes <= 256)
constexpr float NEG = -1e30f;
static_assert(STAGES % NR == 0 && RING >= 2, "whole rounds in the ring");
static_assert(SEG <= 32 && SEG % WARPS == 0, "a segment's tiles: one ballot, whole warps");
static_assert(THREADS % KR == 0 && KR % 32 == 0, "a score warp's keys lie in one tile");
static_assert(MAXI * THREADS >= BS * 17, "the copy items of a 256-byte row");

template <typename KT>
struct Kv {  // int8 payloads carry an f32 scale per (slot, head)
  static constexpr bool SCALED = true;
};
template <>
struct Kv<__nv_bfloat16> {
  static constexpr bool SCALED = false;
};

// shared memory of a block: the ring of STAGES stages (a K tile, then a V
// tile, each tile's rows followed by its BS scales), then the f32 and int32
// arrays (the wrapper's ``block_smem`` mirrors it)
struct Layout {
  int rb, ldk;     // payload row bytes, a K row's stride
  int kslot, vslot;  // bytes of a K tile, of a V tile
  __host__ __device__ Layout() : rb(0), ldk(0), kslot(0), vslot(0) {}
  __host__ __device__ Layout(int d, int kv_bytes, bool scaled)
      : rb(d * kv_bytes), ldk(rb + ((rb / 16) % 2 == 0 ? 16 : 0)),
        kslot(BS * ldk + (scaled ? BS * 4 : 0)), vslot(BS * rb + (scaled ? BS * 4 : 0)) {}
  __host__ __device__ int ring() const { return STAGES * (kslot + vslot); }
};

inline size_t smem_bytes(int g_n, int d, int rows, int kv_bytes, bool scaled) {
  const size_t cap = static_cast<size_t>(rows) * g_n;
  return static_cast<size_t>(Layout(d, kv_bytes, scaled).ring()) +
         sizeof(float) * (2 * cap * d + cap * KR + 2 * cap + cap * NR) +
         sizeof(int) * (2 * SEG * BS + 2 * SEG + 2 * rows + 1);
}

template <typename QT, typename KT>
struct Args {
  const QT* q;           // [B, T, Hq, D]
  const KT* kc;          // payload rows [slots, Hkv, D]
  const float* ks;       // their scales [slots, Hkv] (int8 only)
  const KT* vc;
  const float* vs;
  const int32_t* pos;    // [slots]
  const int32_t* qpos;   // [B, T]
  float* part;           // (m, l, acc) of every (lane, kv head, row, chunk)
  float* dead;           // the dense rule's V sums and counts
  int hq, hkv, s_len, d;
  float scale;
  int window, chunk, t_len, rows;
};

template <typename QT>
struct Merge {
  const float* part;
  const float* dead;
  QT* out;
  int hq, hkv, d, n_split, t_len;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// an int8 as f32, exactly, from ``bits`` = 0x4B000000 | (b + 128): the f32
// 2^23 + b + 128, minus 2^23 + 128 (integer and f32 operations at their
// full rate, where ``I2F`` runs at a fraction of it)
__device__ __forceinline__ float i8_f32(uint32_t bits) {
  return __fsub_rn(__uint_as_float(bits), 8388736.0f);
}

// 16 payload bytes -> dequantized values: int8 times the slot's scale, as
// ``__fmul_rn`` (the value the reference's dequant gives), or bf16 as it is
template <typename KT>
struct Chunk {
  static constexpr int E = 16;  // values in 16 bytes
  __device__ __forceinline__ static void load(const uint8_t* p, float s, float (&k)[E]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = w[i] ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        k[4 * i + b] = __fmul_rn(i8_f32(__byte_perm(x, 0x4B000000u, 0x7440 + b)), s);
    }
  }
  // one value of a V row
  __device__ __forceinline__ static float one(const uint8_t* p, float s) {
    return __fmul_rn(i8_f32(0x4B000000u | (static_cast<uint32_t>(*p) ^ 0x80u)), s);
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void load(const uint8_t* p, float, float (&k)[E]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      k[2 * i] = __uint_as_float(w[i] << 16);
      k[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static float one(const uint8_t* p, float) {
    return __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
  }
};

// key position kp is valid for a row at qp
__device__ __forceinline__ bool valid_key(int kp, int qp, int window) {
  bool v = kp >= 0 && kp <= qp;
  if (window) v = v && kp > qp - window;
  return v;
}

// the state of one block (shared arrays and its coordinates)
struct Block {
  uint8_t* ring;
  float *q_s, *acc_s, *p_s, *m_s, *l_s, *a_s;
  int *kp_s, *rows_s, *list_s, *qp_s, *live_s, *n_list_s;
  unsigned* tv_s;
  int g_n, n_r, rg_n, n_list;
  Layout L;
  // round r's tile e in the ring
  __device__ __forceinline__ uint8_t* ktile(int r, int e) const {
    return ring + ((r * NR + e) % STAGES) * (L.kslot + L.vslot);
  }
  __device__ __forceinline__ uint8_t* vtile(int r, int e) const { return ktile(r, e) + L.kslot; }
  __device__ __forceinline__ int entries(int r) const { return min(NR, n_list - r * NR); }
  __device__ __forceinline__ unsigned mask(int r, int e) const { return tv_s[list_s[r * NR + e]]; }
  // a row of the block has a valid key in round r (else only dead sums read it)
  __device__ __forceinline__ bool scored(int r) const {
    bool any = false;
    for (int e = 0; e < entries(r); ++e) any |= mask(r, e) != 0;
    return any;
  }
};

// the scores of round r: a thread per key of the round, each carrying P of
// its pair group's pairs at once
template <int P, typename QT, typename KT>
__device__ __forceinline__ void score(const Block& s, const Args<QT, KT>& a, int r) {
  constexpr int E = Chunk<KT>::E;
  const int kk = threadIdx.x % KR, pg = threadIdx.x / KR;
  const int e = kk / BS, j = kk % BS;
  if (e >= s.entries(r)) return;
  const int ti = s.list_s[r * NR + e];
  const unsigned tv = s.tv_s[ti];
  const int row = s.rows_s[ti * BS + j], kp = s.kp_s[ti * BS + j];
  const uint8_t* kt = s.ktile(r, e);
  const uint8_t* kr = kt + j * s.L.ldk;
  const float ksc =
      Kv<KT>::SCALED ? reinterpret_cast<const float*>(kt + BS * s.L.ldk)[j] : 1.0f;
  float* ps = s.p_s;
  for (int rg0 = pg; rg0 < s.rg_n; rg0 += TPK * P) {
    bool act[P], val[P];
    float dot[P];
    bool any = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int rg = rg0 + p * TPK;
      const int rr = rg / s.g_n;
      act[p] = rg < s.rg_n && (tv >> rr & 1u);
      val[p] = act[p] && row >= 0 && valid_key(kp, s.qp_s[rr], a.window);
      any |= val[p];
      dot[p] = 0.0f;
    }
    if (any) {
      for (int c = 0; c < a.d / E; ++c) {
        float kf[E];
        Chunk<KT>::load(kr + 16 * c, ksc, kf);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (!val[p]) continue;
          const float4* q4 =
              reinterpret_cast<const float4*>(s.q_s + (rg0 + p * TPK) * a.d + E * c);
#pragma unroll
          for (int x = 0; x < E / 4; ++x) {
            const float4 qv = q4[x];
            dot[p] = fmaf(qv.x, kf[4 * x], dot[p]);
            dot[p] = fmaf(qv.y, kf[4 * x + 1], dot[p]);
            dot[p] = fmaf(qv.z, kf[4 * x + 2], dot[p]);
            dot[p] = fmaf(qv.w, kf[4 * x + 3], dot[p]);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (act[p])
        ps[(rg0 + p * TPK) * KR + kk] =
            row < 0 ? -CUDART_INF_F : (val[p] ? dot[p] * a.scale : NEG);
  }
}

// the online softmax updates of round r, one warp per (row, head), tile by
// tile
__device__ __forceinline__ void softmax(const Block& s, int r) {
  const int lane = threadIdx.x & 31, n_e = s.entries(r);
  float* ps = s.p_s;
  float* as = s.a_s;
  for (int rg = threadIdx.x >> 5; rg < s.rg_n; rg += WARPS) {
    const int rr = rg / s.g_n;
    float m = s.m_s[rg], l = s.l_s[rg];
    for (int e = 0; e < n_e; ++e) {
      if (!(s.mask(r, e) >> rr & 1u)) continue;
      float* pr = ps + rg * KR + e * BS;
      float tmax = -CUDART_INF_F;
      tmax = fmaxf(tmax, pr[lane]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m, tmax);
      float sum = 0.0f;
      const float p = expf(pr[lane] - m_new);
      pr[lane] = p;
      sum += p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m - m_new);
      if (lane == 0) as[rg * NR + e] = alpha;
      l = l * alpha + sum;
      m = m_new;
    }
    if (lane == 0) {
      s.m_s[rg] = m;
      s.l_s[rg] = l;
    }
  }
}

// acc = acc * alpha + P @ V over round r: a thread per (pair group, d),
// each carrying P pairs whose V value it dequantizes once
template <int P, typename QT, typename KT>
__device__ __forceinline__ void pv(const Block& s, const Args<QT, KT>& a, int r) {
  const int tpd = THREADS / a.d;  // pair groups
  const int dd = threadIdx.x % a.d, pg = threadIdx.x / a.d, n_e = s.entries(r);
  if (pg >= tpd) return;
  const float* ps = s.p_s;
  const float* as = s.a_s;
  for (int rg0 = pg; rg0 < s.rg_n; rg0 += tpd * P) {
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int rg = rg0 + p * tpd;
      acc[p] = rg < s.rg_n ? s.acc_s[rg * a.d + dd] : 0.0f;
    }
    for (int e = 0; e < n_e; ++e) {
      const unsigned tv = s.mask(r, e);
      bool act[P];
      bool any = false;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int rg = rg0 + p * tpd;
        act[p] = rg < s.rg_n && (tv >> (rg / s.g_n) & 1u);
        if (act[p]) acc[p] = acc[p] * as[rg * NR + e];
        any |= act[p];
      }
      if (!any) continue;
      const uint8_t* vt_ = s.vtile(r, e);
      const uint8_t* vr = vt_ + dd * sizeof(KT);
      const float* vsc = reinterpret_cast<const float*>(vt_ + BS * s.L.rb);
      for (int j = 0; j < BS; ++j) {
        const float v = Chunk<KT>::one(vr + j * s.L.rb, Kv<KT>::SCALED ? vsc[j] : 1.0f);
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (act[p]) acc[p] = fmaf(ps[(rg0 + p * tpd) * KR + e * BS + j], v, acc[p]);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int rg = rg0 + p * tpd;
      if (rg < s.rg_n) s.acc_s[rg * a.d + dd] = acc[p];
    }
  }
}

// P, the pairs a thread carries: the fewest of 1, 2, 4, PMAX that cover its
// share of ``rg_n`` pairs over ``groups`` threads
__device__ __forceinline__ int pairs_per_thread(int rg_n, int groups) {
  const int n = (rg_n + groups - 1) / groups;
  return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : PMAX;
}

template <bool ZERO_DEAD, typename QT, typename KT, typename Form>
__device__ __forceinline__ void attend(const Args<QT, KT>& a, const Form& form) {
  extern __shared__ __align__(16) uint8_t smem[];
  Block s{};
  s.L = Layout(a.d, sizeof(KT), Kv<KT>::SCALED);
  const Layout& L = s.L;
  s.g_n = a.hq / a.hkv;
  const int r0 = blockIdx.z * a.rows;
  s.n_r = min(a.rows, a.t_len - r0);
  s.rg_n = s.n_r * s.g_n;              // (row, head) pairs of this block
  const int cap = a.rows * s.g_n;
  s.ring = smem;                                             // STAGES x (K, V tile)
  s.q_s = reinterpret_cast<float*>(smem + L.ring());         // [R*G][D]
  s.acc_s = s.q_s + cap * a.d;                               // [R*G][D]
  s.p_s = s.acc_s + cap * a.d;         // [R*G][KR] scores, then probabilities
  s.m_s = s.p_s + cap * KR;            // [R*G] running max
  s.l_s = s.m_s + cap;                 // [R*G] running sum
  s.a_s = s.l_s + cap;                 // [R*G][NR] rescale of each tile of the round
  s.kp_s = reinterpret_cast<int*>(s.a_s + cap * NR);  // [SEG*BS] each key's position
  s.rows_s = s.kp_s + SEG * BS;                       // [SEG*BS] its slot, -1 past the end
  s.tv_s = reinterpret_cast<unsigned*>(s.rows_s + SEG * BS);  // [SEG] bit r: row r has
                                                              // a valid key in the tile
  s.list_s = reinterpret_cast<int*>(s.tv_s + SEG);  // [SEG] the tiles to read, in order
  s.qp_s = s.list_s + SEG;                          // [R] the rows' positions
  s.live_s = s.qp_s + a.rows;                       // [R] 1: a valid key in the lane
  s.n_list_s = s.live_s + a.rows;
  const int b = blockIdx.x / a.hkv, h = blockIdx.x % a.hkv;
  const int g_n = s.g_n, n_r = s.n_r, rg_n = s.rg_n, d = a.d;
  const int k_begin = blockIdx.y * a.chunk, k_end = min(a.s_len, k_begin + a.chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < rg_n * d; i += THREADS) {
    const int rg = i / d, r = rg / g_n;
    const size_t row = static_cast<size_t>(b) * a.t_len + r0 + r;
    s.q_s[i] = to_f32(a.q[(row * a.hq + static_cast<size_t>(h) * g_n + rg % g_n) * d + i % d]);
    s.acc_s[i] = 0.0f;
  }
  for (int rg = tid; rg < rg_n; rg += THREADS) {
    s.m_s[rg] = NEG;
    s.l_s[rg] = 0.0f;
  }
  for (int r = tid; r < n_r; r += THREADS) {
    s.qp_s[r] = a.qpos[static_cast<size_t>(b) * a.t_len + r0 + r];
    s.live_s[r] = ZERO_DEAD;  // the paged rule needs no liveness
  }
  __syncthreads();
  // each row's liveness: a valid key anywhere in the lane (the scan stops
  // once every row has one, at once for a row at or past slot 0's position)
  for (int k0 = 0; !ZERO_DEAD && k0 < a.s_len; k0 += THREADS) {
    if (k0 + tid < a.s_len) {
      const int kp = a.pos[form(b, k0 + tid)];
      for (int r = 0; r < n_r; ++r)
        if (valid_key(kp, s.qp_s[r], a.window)) s.live_s[r] = 1;
    }
    __syncthreads();
    if (!__syncthreads_or(tid < n_r && !s.live_s[tid])) break;
  }
  const bool dead_sum = __syncthreads_or(tid < n_r && !s.live_s[tid]);
  float dsum = 0.0f, dcnt = 0.0f;  // the dense rule's V sum (column tid < d) and count

  // this thread's copy items of a tile: (key j, chunk c) with c < CH a K and
  // a V chunk of 16 bytes, c == CH the key's two scales
  const int ch = L.rb / 16;
  int it_j[MAXI], it_c[MAXI];
#pragma unroll
  for (int i = 0; i < MAXI; ++i) {
    const int y = tid + i * THREADS;
    const bool in = y < BS * (ch + 1) && (Kv<KT>::SCALED || y % (ch + 1) < ch);
    it_j[i] = in ? y / (ch + 1) : -1;
    it_c[i] = y % (ch + 1);
  }
  const uint8_t* kb = reinterpret_cast<const uint8_t*>(a.kc);
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(a.vc);

  for (int sb = k_begin; sb < k_end; sb += SEG * BS) {
    const int se = min(k_end, sb + SEG * BS);
    const int n_t = (se - sb + BS - 1) / BS;
    __syncthreads();  // the previous segment's readers are done
    // prescan: a warp per tile, a lane per key (loads first, then the bits)
    int row[SEG / WARPS], kp[SEG / WARPS];
#pragma unroll
    for (int it = 0; it < SEG / WARPS; ++it) {
      const int ti = warp + it * WARPS, key = sb + ti * BS + lane;
      row[it] = ti < n_t && key < k_end ? form(b, key) : -1;
    }
#pragma unroll
    for (int it = 0; it < SEG / WARPS; ++it) kp[it] = row[it] >= 0 ? a.pos[row[it]] : -1;
#pragma unroll
    for (int it = 0; it < SEG / WARPS; ++it) {
      const int ti = warp + it * WARPS;
      if (ti >= n_t) break;
      unsigned bits = 0;
      if (row[it] >= 0)
        for (int r = 0; r < n_r; ++r)
          bits |= static_cast<unsigned>(valid_key(kp[it], s.qp_s[r], a.window)) << r;
      bits = __reduce_or_sync(0xffffffffu, bits);
      s.rows_s[ti * BS + lane] = row[it];
      s.kp_s[ti * BS + lane] = kp[it];
      if (lane == 0) s.tv_s[ti] = bits;
    }
    __syncthreads();
    // the tiles to read: a valid key for some row, or every tile for a dead row
    if (warp == 0) {
      const bool need = lane < n_t && (s.tv_s[lane] != 0 || dead_sum);
      const unsigned mask = __ballot_sync(0xffffffffu, need);
      if (need) s.list_s[__popc(mask & ((1u << lane) - 1))] = lane;
      if (lane == 0) *s.n_list_s = __popc(mask);
    }
    __syncthreads();
    s.n_list = *s.n_list_s;
    const int n_rounds = (s.n_list + NR - 1) / NR;

    // the copies of round r (K only where a row scores the tile)
    auto issue = [&](int r) {
      for (int e = 0; e < s.entries(r); ++e) {
        const int ti = s.list_s[r * NR + e];
        const bool need_k = s.tv_s[ti] != 0;
        uint8_t* kt = s.ktile(r, e);
        uint8_t* vt = s.vtile(r, e);
#pragma unroll
        for (int i = 0; i < MAXI; ++i) {
          const int j = it_j[i], c = it_c[i];
          if (j < 0) continue;
          const int slot_row = s.rows_s[ti * BS + j];
          const size_t slot = slot_row >= 0 ? static_cast<size_t>(slot_row) * a.hkv + h : 0;
          const int n = slot_row >= 0 ? 16 : 0;
          if (c < ch) {
            const size_t off = slot * L.rb + 16 * c;
            if (need_k) wmma::cp_async_16(kt + j * L.ldk + 16 * c, kb + off, n);
            wmma::cp_async_16(vt + j * L.rb + 16 * c, vb + off, n);
          } else {
            if (need_k)
              wmma::cp_async_4(reinterpret_cast<float*>(kt + BS * L.ldk) + j, a.ks + slot,
                               n ? 4 : 0);
            wmma::cp_async_4(reinterpret_cast<float*>(vt + BS * L.rb) + j, a.vs + slot,
                             n ? 4 : 0);
          }
        }
      }
    };
    const int ps = pairs_per_thread(rg_n, TPK), pp = pairs_per_thread(rg_n, THREADS / d);
#pragma unroll
    for (int r = 0; r < RING - 1; ++r) {
      if (r < n_rounds) issue(r);
      wmma::cp_async_commit();
    }
    for (int r = 0; r < n_rounds; ++r) {
      wmma::cp_async_wait<RING - 2>();  // round r has landed (this thread's copies)
      __syncthreads();                   // ... everyone's; round r - 1 is consumed
      if (r + RING - 1 < n_rounds) issue(r + RING - 1);
      wmma::cp_async_commit();
      if (s.scored(r)) {
        if (ps == 1) score<1>(s, a, r);
        else if (ps == 2) score<2>(s, a, r);
        else if (ps == 4) score<4>(s, a, r);
        else score<PMAX>(s, a, r);
        __syncthreads();
        softmax(s, r);
        __syncthreads();
        if (pp == 1) pv<1>(s, a, r);
        else if (pp == 2) pv<2>(s, a, r);
        else if (pp == 4) pv<4>(s, a, r);
        else pv<PMAX>(s, a, r);
      }
      // a dead row's sums: p = exp(NEG - NEG) = 1 for every key of the chunk
      if (dead_sum && tid < d) {
        for (int e = 0; e < s.entries(r); ++e) {
          const int ti = s.list_s[r * NR + e];
          const uint8_t* vt = s.vtile(r, e);
          const float* vsc = reinterpret_cast<const float*>(vt + BS * L.rb);
          for (int j = 0; j < BS; ++j) {
            if (s.rows_s[ti * BS + j] < 0) continue;
            const float v = Chunk<KT>::one(vt + j * L.rb + tid * sizeof(KT),
                                           Kv<KT>::SCALED ? vsc[j] : 1.0f);
            dsum = fmaf(1.0f, v, dsum);
            dcnt += 1.0f;
          }
        }
      }
    }
    wmma::cp_async_wait<0>();
  }
  __syncthreads();  // a chunk with no tile: the initial values are written
  if (!ZERO_DEAD && dead_sum && tid < d) {
    float* db = a.dead + (static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y) * (d + 1);
    db[tid] = dsum;
    if (tid == 0) db[d] = dcnt;
  }
  // each row's (m, l, acc) of this chunk:
  // part[((bh * T + row) * n_split + split) * G * (D + 2) ...]
  const size_t stride = static_cast<size_t>(g_n) * (d + 2);
  for (int r = 0; r < n_r; ++r) {
    float* pb = a.part + ((static_cast<size_t>(blockIdx.x) * a.t_len + r0 + r) * gridDim.y +
                          blockIdx.y) * stride;
    const int base = r * g_n;
    for (int i = tid; i < g_n * d; i += THREADS) pb[i] = s.acc_s[base * d + i];
    for (int g = tid; g < g_n; g += THREADS) {
      pb[g_n * d + g] = s.m_s[base + g];
      pb[g_n * d + g_n + g] = s.l_s[base + g];
    }
  }
}

// merge the n_split chunks of one (lane, kv head, row) and normalize; a head
// with no valid slot in any chunk (max still NEG) emits exact zeros with
// ZERO_DEAD, else the chunks' V sums over their key counts
template <bool ZERO_DEAD, typename QT>
__device__ __forceinline__ void combine(const Merge<QT>& c) {
  const int g_n = c.hq / c.hkv, d = c.d, n_split = c.n_split;
  const int b = blockIdx.x / c.hkv, h = blockIdx.x % c.hkv, row = blockIdx.y;
  const size_t stride = static_cast<size_t>(g_n) * (d + 2);
  const float* pb =
      c.part + (static_cast<size_t>(blockIdx.x) * c.t_len + row) * n_split * stride;
  QT* ob = c.out +
           ((static_cast<size_t>(b) * c.t_len + row) * c.hq + static_cast<size_t>(h) * g_n) * d;
  for (int i = threadIdx.x; i < g_n * d; i += THREADS) {
    const int g = i / d;
    float m = NEG;
    for (int k = 0; k < n_split; ++k) m = fmaxf(m, pb[k * stride + g_n * d + g]);
    if (!(m > 0.5f * NEG)) {
      float l = 0.0f, acc = 0.0f;
      for (int k = 0; !ZERO_DEAD && k < n_split; ++k) {
        const float* db = c.dead + (static_cast<size_t>(blockIdx.x) * n_split + k) * (d + 1);
        l = fmaf(db[d], 1.0f, l);
        acc = fmaf(db[i % d], 1.0f, acc);
      }
      from_f32(ob + i, acc / fmaxf(l, 1e-30f));
      continue;
    }
    float l = 0.0f, acc = 0.0f;
    for (int k = 0; k < n_split; ++k) {
      const float w = expf(pb[k * stride + g_n * d + g] - m);
      l = fmaf(pb[k * stride + g_n * d + g_n + g], w, l);
      acc = fmaf(pb[k * stride + i], w, acc);
    }
    from_f32(ob + i, acc / fmaxf(l, 1e-30f));
  }
}

// three blocks an SM: 80 registers a thread, no spill (``scripts/chip_probe.py
// decode``, H100: a T = 1 launch at G = 1 took 15% less time than at the 96
// registers ptxas picks alone, the T = 256 form 12% less at G = 1 and 3%
// more at G = 12)
template <typename QT, typename KT, typename Form>
__global__ void __launch_bounds__(THREADS, 3) attend_kernel(Args<QT, KT> a, Form form) {
  attend<Form::ZERO_DEAD>(a, form);
}

template <typename QT, typename Form>
__global__ void __launch_bounds__(THREADS) combine_kernel(Merge<QT> c) {
  combine<Form::ZERO_DEAD>(c);
}

// both kernels of one form on ``stream``: ``attend_kernel`` over a grid of
// (B*Hkv, n_split, row tiles), then ``combine_kernel`` over (B*Hkv, T).
// ``a.part`` holds B*Hkv*T*n_split*G*(D+2) floats, then the dead rows'
// sums, B*Hkv*n_split*(D+1).  Returns the launches' CUDA error.
template <typename QT, typename KT, typename Form>
int launch(Args<QT, KT> a, Form form, void* out, int b, int n_split, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.hq / a.hkv, a.d, a.rows, sizeof(KT), Kv<KT>::SCALED);
  a.dead = a.part + static_cast<size_t>(b) * a.hq * a.t_len * n_split * (a.d + 2);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(attend_kernel<QT, KT, Form>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attend_kernel<QT, KT, Form>
      <<<dim3(b * a.hkv, n_split, (a.t_len + a.rows - 1) / a.rows), THREADS, smem, stream>>>(
          a, form);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<QT, Form><<<dim3(b * a.hkv, a.t_len), THREADS, 0, stream>>>(
      Merge<QT>{a.part, a.dead, static_cast<QT*>(out), a.hq, a.hkv, a.d, n_split, a.t_len});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode
