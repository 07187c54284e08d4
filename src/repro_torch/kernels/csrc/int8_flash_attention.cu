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
// cannot rescale exactly.  Bound on the H100: operations — the PV product
// runs in f32 outside the tensor cores (2*S*Skv*D flops per head, halved by
// the causal mask) against a few hundred KB of int8 inputs per head.
//
// Design: one block per (R query rows, head), in one of two forms that give
// the same bits.  Both compute a tile's R x BK integer scores with
// ``__dp4a`` (K in tiles of BK keys staged in shared memory, rows padded to
// an odd word count so that the 32 lanes of a warp read 32 banks), turn them
// into exps and int8 probabilities row by row (a warp owns rows w and w + 8),
// and accumulate p * v for R rows x D columns from V tiles in shared memory,
// V dequantized in-register (``__fmul_rn(float(v), s_v)``, the reference's
// f32 product), key by key in the same order.  Key tiles wholly above the
// diagonal are skipped: their probabilities are exactly 0 (the wrapper checks
// that the exp of a masked score, -(2^24) - max, is 0).
// * The block form keeps all R x Skv scores in shared memory, so QK^T runs
//   once: R = 16 rows keep S x Skv = 1024 x 1024 at 83 KB, two blocks per SM;
//   the score block bounds Skv at 3328.  (Its code is written out on its own:
//   built from the streaming form's helpers it ran slower.)
// * The streaming form, for any Skv (the wrapper takes it when the score
//   block does not fit), follows the TPU kernel's three passes over K — row
//   max, exp-sum, then the probabilities and PV — recomputing each tile's
//   scores in every pass (3x the QK^T work) in 27 KB of shared memory.
// D is a template argument, any multiple of 16 up to 128 (16-byte V loads
// need D % 16 == 0).  Where D divides the block's 256 threads (16-128 but 48,
// 80, 96, 112) a thread of the PV pass owns one column of R*D/256 rows; for
// the others (zamba2-2.7b's 80) it owns R*D/256 outputs of the row-major
// block, each reading its own V column.  Each output sums key by key in the
// same order either way.
//
// Exactness: the integer scores, exps, sums and probabilities are bit-exact
// (the exp follows the oracle ``inumerics.i_exp``: the remainder is formed
// from the unclamped halving count, so (q_p + q_b)^2 + q_c stays in int32;
// every ``//`` has non-negative operands, so C's ``/`` is the floor division);
// the int32 form is exact.  The f32 PV sum runs key by key (``fmaf``), another
// order than the reference's einsum, so the v_scale form agrees to rtol 1e-5,
// atol 1e-6.  ``p_out`` (optional, int8 [B*H, S, Skv]) receives the integer
// probabilities for the exact check.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 128;                 // keys per tile
constexpr int R = 16;                   // query rows per block
constexpr int NEG_INF = -(1 << 24);
constexpr int ROWS_PER_WARP = R / (THREADS / 32);

struct Params {
  const int8_t* q;
  const int8_t* k;
  const int8_t* v;
  const float* vs;   // [B*Hkv, Skv] or null
  void* out;
  int8_t* p_out;     // [B*H, S, Skv] or null
  int h, hkv, s, skv, skp;  // skp: Skv padded to whole tiles
  int causal, rshift, q_ln2, q_b, q_c, es;
  float rcp127;
};

// i_exp(max(s - m, NEG_INF)) >> es in the oracle's order; s - m <= 0
__device__ __forceinline__ int int_exp(int s, int m, const Params& p) {
  const int qs = max(s - m, NEG_INF);
  const int z = (-qs) / p.q_ln2;
  const int t = qs + z * p.q_ln2 + p.q_b;   // q_p + q_b, q_p in (-q_ln2, 0]
  return ((t * t + p.q_c) >> min(z, 30)) >> p.es;
}

__device__ __forceinline__ int prob(int e, int l) {
  return min(max((e * 127 + (l >> 1)) / l, 0), 127);
}

// keys of query row ``row`` that are not masked: [0, n_r)
__device__ __forceinline__ int row_keys(int row, const Params& p) {
  return row >= p.s ? 0 : (p.causal ? min(row + 1, p.skv) : p.skv);
}

// the PV output i (of R*D/THREADS) of this thread: row and column.  With D
// dividing THREADS a thread keeps one column of rows tid / D + (THREADS/D)*i;
// otherwise output i is element tid + THREADS*i of the row-major R x D block.
template <int D>
__device__ __forceinline__ int out_row(int i) {
  if constexpr (THREADS % D == 0) return threadIdx.x / D + (THREADS / D) * i;
  return (threadIdx.x + THREADS * i) / D;
}
template <int D>
__device__ __forceinline__ int out_col(int i) {
  if constexpr (THREADS % D == 0) return threadIdx.x % D;
  return (threadIdx.x + THREADS * i) % D;
}

// PV of one key tile for a D that does not divide THREADS (80 among them):
// each of the thread's outputs reads its own V column; per output the sum
// runs key by key in the same order as the other mapping, so the bits
// do not depend on it.  ``sc`` holds the probabilities (f32 for VS) at
// row stride ``stride`` from column ``col0``.
template <int D, bool VS, int RPT>
__device__ __forceinline__ void pv_outputs(const int* sc, int stride, int col0,
                                           const int8_t* vt, const float* vsc,
                                           float (&facc)[RPT], int (&iacc)[RPT]) {
#pragma unroll 2
  for (int j = 0; j < BK; j += 4) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = out_row<D>(i), d = out_col<D>(i);
      float vf[4];
      int vi[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        vi[u] = vt[(j + u) * D + d];
        if (VS) vf[u] = __fmul_rn(static_cast<float>(vi[u]), vsc[j + u]);
      }
      const int4 pw = *reinterpret_cast<const int4*>(sc + r * stride + col0 + j);
      if (VS) {
        facc[i] = fmaf(__int_as_float(pw.x), vf[0], facc[i]);
        facc[i] = fmaf(__int_as_float(pw.y), vf[1], facc[i]);
        facc[i] = fmaf(__int_as_float(pw.z), vf[2], facc[i]);
        facc[i] = fmaf(__int_as_float(pw.w), vf[3], facc[i]);
      } else {
        iacc[i] += pw.x * vi[0] + pw.y * vi[1] + pw.z * vi[2] + pw.w * vi[3];
      }
    }
  }
}

// the streaming form's view of one block's tensors and shared memory: one
// tile of R x BK scores, the Q rows, the K or V tile
template <int D>
struct Stream {
  static constexpr int W = D / 4;       // int8x4 words per row
  static constexpr int KW = W + 1;      // padded K row in shared memory
  int* sc;                              // [R][BK] scores, then probabilities
  int* qw;                              // [R][W]
  int* kw;                              // [BK][KW] K tile
  int8_t* vt;                           // [BK][D] V tile (the same bytes as the K tile)
  float* vsc;                           // [BK] V scales
  const int* kg;
  const int8_t* vg;
  size_t kvh;
  int bh, q0, n_tiles;

  __device__ Stream(unsigned char* smem, const Params& p) {
    sc = reinterpret_cast<int*>(smem);
    qw = sc + R * BK;
    unsigned char* tile = reinterpret_cast<unsigned char*>(qw + R * W);
    kw = reinterpret_cast<int*>(tile);
    vt = reinterpret_cast<int8_t*>(tile);
    vsc = reinterpret_cast<float*>(tile + BK * D);
    bh = blockIdx.y;
    q0 = blockIdx.x * R;
    const int g = p.h / p.hkv;
    kvh = static_cast<size_t>(bh / p.h) * p.hkv + (bh % p.h) / g;
    kg = reinterpret_cast<const int*>(p.k + kvh * p.skv * D);
    vg = p.v + kvh * p.skv * D;
    const int n_keys = p.causal ? min(p.skv, q0 + R) : p.skv;
    n_tiles = (n_keys + BK - 1) / BK;
    const int* qg = reinterpret_cast<const int*>(p.q + (static_cast<size_t>(bh) * p.s) * D);
    for (int i = threadIdx.x; i < R * W; i += THREADS) {
      const int r = i / W;
      qw[i] = (q0 + r < p.s) ? qg[(q0 + r) * W + i % W] : 0;
    }
  }

  // the integer scores of key tile kt into sc[r][j] (masked: NEG_INF); ends
  // with the block synchronized
  __device__ void scores(int kt, const Params& p) {
    __syncthreads();                     // the K tile buffer is free
    for (int i = threadIdx.x; i < BK * W; i += THREADS) {
      const int key = kt * BK + i / W;
      kw[(i / W) * KW + i % W] = key < p.skv ? kg[static_cast<size_t>(key) * W + i % W] : 0;
    }
    __syncthreads();
    const int j = threadIdx.x % BK, rg = threadIdx.x / BK;   // key of the tile, row group
    int acc[R / 2];
#pragma unroll
    for (int i = 0; i < R / 2; ++i) acc[i] = 0;
#pragma unroll 8
    for (int w = 0; w < W; ++w) {
      const int kv = kw[j * KW + w];
#pragma unroll
      for (int i = 0; i < R / 2; ++i) acc[i] = __dp4a(qw[(rg + 2 * i) * W + w], kv, acc[i]);
    }
    const int key = kt * BK + j;
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const int r = rg + 2 * i;
      const bool masked = key >= p.skv || (p.causal && key > q0 + r);
      sc[r * BK + j] = masked ? NEG_INF : (acc[i] >> p.rshift);
    }
    __syncthreads();
  }

  // the probability of row r at tile column j from its score's exp (key
  // kt*BK + j < n_r) or 0, over the score for PV (as f32 for the v_scale
  // form) and to p_out
  template <bool VS>
  __device__ __forceinline__ void put_prob(int r, int kt, int j, int n_r, int m, int l,
                                           const Params& p) {
    const int key = kt * BK + j;
    int* s = sc + r * BK + j;
    const int pj = key < n_r ? prob(int_exp(*s, m, p), l) : 0;
    if (p.p_out != nullptr && q0 + r < p.s && key < p.skv)
      p.p_out[(static_cast<size_t>(bh) * p.s + q0 + r) * p.skv + key] = static_cast<int8_t>(pj);
    if (VS)
      *reinterpret_cast<float*>(s) = static_cast<float>(pj);
    else
      *s = pj;
  }

  // p_out of row r past the block's key tiles: 0
  __device__ void zero_tail(int r, const Params& p) {
    if (p.p_out == nullptr || q0 + r >= p.s) return;
    int8_t* prow = p.p_out + (static_cast<size_t>(bh) * p.s + q0 + r) * p.skv;
    for (int j = n_tiles * BK + (threadIdx.x & 31); j < p.skv; j += 32) prow[j] = 0;
  }

  // V tile kt (and its scales) into shared memory; ends synchronized
  template <bool VS>
  __device__ void load_v(int kt, const Params& p) {
    __syncthreads();                     // the probabilities are written, the tile is free
    for (int i = threadIdx.x; i < BK * D / 16; i += THREADS) {
      const int key = kt * BK + (i * 16) / D;
      int4 val = make_int4(0, 0, 0, 0);
      if (key < p.skv)
        val = *reinterpret_cast<const int4*>(vg + static_cast<size_t>(kt) * BK * D + i * 16);
      reinterpret_cast<int4*>(vt)[i] = val;
    }
    if (VS)
      for (int i = threadIdx.x; i < BK; i += THREADS) {
        const int key = kt * BK + i;
        vsc[i] = key < p.skv ? p.vs[kvh * p.skv + key] : 0.f;
      }
    __syncthreads();
  }

  static constexpr int NRG = THREADS % D == 0 ? THREADS / D : 1;  // row groups of PV
  static constexpr int RPT = R * D / THREADS;     // outputs per thread
  static_assert(R * D % THREADS == 0, "every thread owns whole outputs");

  // acc[i] += sum over the tile's keys of p[r][j] * v[j][d], key by key
  template <bool VS>
  __device__ void pv(float (&facc)[RPT], int (&iacc)[RPT]) const {
    if constexpr (THREADS % D != 0) {
      pv_outputs<D, VS>(sc, BK, 0, vt, vsc, facc, iacc);
      return;
    }
    const int d = threadIdx.x % D, rg = threadIdx.x / D;
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float vf[4];
      int vi[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        vi[u] = vt[(j + u) * D + d];
        if (VS) vf[u] = __fmul_rn(static_cast<float>(vi[u]), vsc[j + u]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg + NRG * i;
        const int4 pw = *reinterpret_cast<const int4*>(sc + r * BK + j);
        if (VS) {
          facc[i] = fmaf(__int_as_float(pw.x), vf[0], facc[i]);
          facc[i] = fmaf(__int_as_float(pw.y), vf[1], facc[i]);
          facc[i] = fmaf(__int_as_float(pw.z), vf[2], facc[i]);
          facc[i] = fmaf(__int_as_float(pw.w), vf[3], facc[i]);
        } else {
          iacc[i] += pw.x * vi[0] + pw.y * vi[1] + pw.z * vi[2] + pw.w * vi[3];
        }
      }
    }
  }

  template <bool VS>
  __device__ void store(const float (&facc)[RPT], const int (&iacc)[RPT], const Params& p) const {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + out_row<D>(i);
      if (row >= p.s) continue;
      const size_t o = (static_cast<size_t>(bh) * p.s + row) * D + out_col<D>(i);
      if (VS)
        static_cast<float*>(p.out)[o] = __fmul_rn(facc[i], p.rcp127);
      else
        static_cast<int*>(p.out)[o] = iacc[i];
    }
  }
};

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block form: every score of the block's rows in shared memory
template <int D, bool VS>
__global__ void __launch_bounds__(THREADS)
int8_attention_kernel(Params p) {
  constexpr int W = D / 4;              // int8x4 words per row
  constexpr int KW = W + 1;             // padded K row in shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  int* sc = reinterpret_cast<int*>(smem);                    // [R][skp] scores/exps/probs
  int* qw = sc + R * p.skp;                                  // [R][W]
  unsigned char* tile = reinterpret_cast<unsigned char*>(qw + R * W);   // K or V tile
  int* kw = reinterpret_cast<int*>(tile);                    // [BK][KW]
  int8_t* vt = reinterpret_cast<int8_t*>(tile);              // [BK][D]
  float* vsc = reinterpret_cast<float*>(tile + BK * D);      // [BK]

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int g = p.h / p.hkv;
  const size_t kvh = static_cast<size_t>(bh / p.h) * p.hkv + (bh % p.h) / g;
  const int* qg = reinterpret_cast<const int*>(p.q + (static_cast<size_t>(bh) * p.s) * D);
  const int* kg = reinterpret_cast<const int*>(p.k + kvh * p.skv * D);
  const int8_t* vg = p.v + kvh * p.skv * D;
  const int n_keys = p.causal ? min(p.skv, q0 + R) : p.skv;
  const int n_tiles = (n_keys + BK - 1) / BK;

  for (int i = tid; i < R * W; i += THREADS) {
    const int r = i / W;
    qw[i] = (q0 + r < p.s) ? qg[(q0 + r) * W + i % W] : 0;
  }

  // ---- pass 1: integer scores of R rows x n_tiles*BK keys ----
  {
    const int j = tid % BK, rg = tid / BK;   // key of the tile, row group (0, 1)
    for (int kt = 0; kt < n_tiles; ++kt) {
      __syncthreads();                       // the previous tile is consumed
      for (int i = tid; i < BK * W; i += THREADS) {
        const int key = kt * BK + i / W;
        kw[(i / W) * KW + i % W] = key < p.skv ? kg[static_cast<size_t>(key) * W + i % W] : 0;
      }
      __syncthreads();
      int acc[R / 2];
#pragma unroll
      for (int i = 0; i < R / 2; ++i) acc[i] = 0;
#pragma unroll 8
      for (int w = 0; w < W; ++w) {
        const int kv = kw[j * KW + w];
#pragma unroll
        for (int i = 0; i < R / 2; ++i) acc[i] = __dp4a(qw[(rg + 2 * i) * W + w], kv, acc[i]);
      }
      const int key = kt * BK + j;
#pragma unroll
      for (int i = 0; i < R / 2; ++i) {
        const int r = rg + 2 * i;
        const bool masked = key >= p.skv || (p.causal && key > q0 + r);
        sc[r * p.skp + key] = masked ? NEG_INF : (acc[i] >> p.rshift);
      }
    }
  }
  __syncthreads();

  // ---- pass 2: per row (one warp each) max, exps, sum, int8 probabilities ----
  {
    const int lane = tid & 31, warp = tid >> 5;
    for (int r = warp; r < R; r += THREADS / 32) {
      const int row = q0 + r;
      int* srow = sc + r * p.skp;
      const int n_r = row >= p.s ? 0 : (p.causal ? min(row + 1, p.skv) : p.skv);
      int m = NEG_INF;
      for (int j = lane; j < n_r; j += 32) m = max(m, srow[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
      int l = 0;
      for (int j = lane; j < n_r; j += 32) {
        const int e = int_exp(srow[j], m, p);
        srow[j] = e;
        l += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      l = max(l, 1);
      int8_t* prow = (p.p_out != nullptr && row < p.s)
                         ? p.p_out + (static_cast<size_t>(bh) * p.s + row) * p.skv : nullptr;
      for (int j = lane; j < n_tiles * BK; j += 32) {
        const int pj = j < n_r ? min(max((srow[j] * 127 + (l >> 1)) / l, 0), 127) : 0;
        if (prow != nullptr && j < p.skv) prow[j] = static_cast<int8_t>(pj);
        if (VS)
          reinterpret_cast<float*>(srow)[j] = static_cast<float>(pj);
        else
          srow[j] = pj;
      }
      if (prow != nullptr)                   // keys beyond the causal tiles
        for (int j = n_tiles * BK + lane; j < p.skv; j += 32) prow[j] = 0;
    }
  }

  // ---- pass 3: out[r][d] = sum_j p[r][j] * v[j][d] over the block's key tiles ----
  // (D dividing THREADS: thread tid owns column tid % D of rows tid / D + NRG*i;
  // otherwise output i of thread tid is (tid + THREADS*i) / D, % D — pv_outputs)
  constexpr int NRG = THREADS % D == 0 ? THREADS / D : 1;   // row groups
  constexpr int RPT = R * D / THREADS;            // outputs per thread
  static_assert(R * D % THREADS == 0, "every thread owns whole outputs");
  const int d = tid % D, rg = tid / D;
  float facc[RPT];
  int iacc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) facc[i] = 0.f, iacc[i] = 0;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();                              // pass 2 / the previous tile is done
    for (int i = tid; i < BK * D / 16; i += THREADS) {
      const int key = kt * BK + (i * 16) / D;
      int4 val = make_int4(0, 0, 0, 0);
      if (key < p.skv)
        val = *reinterpret_cast<const int4*>(vg + static_cast<size_t>(kt) * BK * D + i * 16);
      reinterpret_cast<int4*>(vt)[i] = val;
    }
    if (VS)
      for (int i = tid; i < BK; i += THREADS) {
        const int key = kt * BK + i;
        vsc[i] = key < p.skv ? p.vs[kvh * p.skv + key] : 0.f;
      }
    __syncthreads();
    if constexpr (THREADS % D != 0) {
      pv_outputs<D, VS>(sc, p.skp, kt * BK, vt, vsc, facc, iacc);
      continue;
    }
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float vf[4];
      int vi[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        vi[u] = vt[(j + u) * D + d];
        if (VS) vf[u] = __fmul_rn(static_cast<float>(vi[u]), vsc[j + u]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg + NRG * i;
        const int4 pw = *reinterpret_cast<const int4*>(sc + r * p.skp + kt * BK + j);
        if (VS) {
          facc[i] = fmaf(__int_as_float(pw.x), vf[0], facc[i]);
          facc[i] = fmaf(__int_as_float(pw.y), vf[1], facc[i]);
          facc[i] = fmaf(__int_as_float(pw.z), vf[2], facc[i]);
          facc[i] = fmaf(__int_as_float(pw.w), vf[3], facc[i]);
        } else {
          iacc[i] += pw.x * vi[0] + pw.y * vi[1] + pw.z * vi[2] + pw.w * vi[3];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + out_row<D>(i);
    if (row >= p.s) continue;
    const size_t o = (static_cast<size_t>(bh) * p.s + row) * D + out_col<D>(i);
    if (VS)
      static_cast<float*>(p.out)[o] = __fmul_rn(facc[i], p.rcp127);
    else
      static_cast<int*>(p.out)[o] = iacc[i];
  }
}

// the streaming form: one tile of scores at a time, three passes over K
template <int D, bool VS>
__global__ void __launch_bounds__(THREADS)
int8_attention_stream_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stream<D> b(smem, p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int row[ROWS_PER_WARP], m[ROWS_PER_WARP], l[ROWS_PER_WARP], n_r[ROWS_PER_WARP];
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {   // a warp owns rows w and w + 8
    row[rr] = warp + (THREADS / 32) * rr;
    m[rr] = NEG_INF, l[rr] = 0;
    n_r[rr] = row_keys(b.q0 + row[rr], p);
  }

  // pass 1: row max
  for (int kt = 0; kt < b.n_tiles; ++kt) {
    b.scores(kt, p);
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr)
      for (int j = lane; j < BK; j += 32)
        if (kt * BK + j < n_r[rr]) m[rr] = max(m[rr], b.sc[row[rr] * BK + j]);
  }
  // pass 2: the integer exp-sum
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) m[rr] = warp_max(m[rr]);
  for (int kt = 0; kt < b.n_tiles; ++kt) {
    b.scores(kt, p);
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr)
      for (int j = lane; j < BK; j += 32)
        if (kt * BK + j < n_r[rr]) l[rr] += int_exp(b.sc[row[rr] * BK + j], m[rr], p);
  }
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) l[rr] = max(warp_sum(l[rr]), 1);

  // pass 3: the probabilities, then p @ V
  float facc[Stream<D>::RPT];
  int iacc[Stream<D>::RPT];
#pragma unroll
  for (int i = 0; i < Stream<D>::RPT; ++i) facc[i] = 0.f, iacc[i] = 0;
  for (int kt = 0; kt < b.n_tiles; ++kt) {
    b.scores(kt, p);
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr)
      for (int j = lane; j < BK; j += 32)
        b.template put_prob<VS>(row[rr], kt, j, n_r[rr], m[rr], l[rr], p);
    b.template load_v<VS>(kt, p);
    b.template pv<VS>(facc, iacc);
  }
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) b.zero_tail(row[rr], p);
  b.template store<VS>(facc, iacc, p);
}

// R rows of ``stride`` scores, the Q rows and the K or V tile; the wrapper's
// ``block_smem`` mirrors it (the streaming form's stride is BK)
size_t smem_bytes(int d, int stride) {
  const size_t k_tile = static_cast<size_t>(BK) * (d / 4 + 1) * 4;
  const size_t v_tile = static_cast<size_t>(BK) * d + BK * 4;
  return static_cast<size_t>(R) * stride * 4 + static_cast<size_t>(R) * d
         + (k_tile > v_tile ? k_tile : v_tile);
}

template <int D, bool VS>
int launch(const Params& p, int bh, int streaming, cudaStream_t st) {
  const size_t smem = smem_bytes(D, streaming ? BK : p.skp);
  auto kern = streaming ? int8_attention_stream_kernel<D, VS> : int8_attention_kernel<D, VS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.s + R - 1) / R, bh);
  kern<<<grid, THREADS, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool VS>
int launch_d(const Params& p, int d, int bh, int streaming, cudaStream_t st) {
  switch (d) {   // any head dim that is a multiple of 16 up to 128
#define REPRO_IFA_CASE(D) \
  case D: return launch<D, VS>(p, bh, streaming, st);
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
                                          float rcp127, int streaming, void* stream) {
  if (b == 0 || s == 0) return static_cast<int>(cudaGetLastError());
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const int8_t*>(v);
  p.vs = static_cast<const float*>(v_scale);
  p.out = out;
  p.p_out = static_cast<int8_t*>(p_out);
  p.h = h, p.hkv = hkv, p.s = s, p.skv = skv, p.skp = (skv + BK - 1) / BK * BK;
  p.causal = causal, p.rshift = rshift, p.q_ln2 = q_ln2, p.q_b = q_b, p.q_c = q_c, p.es = es;
  p.rcp127 = rcp127;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return v_scale != nullptr ? launch_d<true>(p, d, b * h, streaming, st)
                            : launch_d<false>(p, d, b * h, streaming, st);
}
