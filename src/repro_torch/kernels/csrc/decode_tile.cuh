// The body shared by the port's two decode attentions (int8_kv_decode_attention
// over the dense ring cache, paged_decode_attention over the paged arena): T
// query rows per lane (T = 1 at decode; a packed t > 1 step's rows, each at
// its own position, in the multi-row form), GQA, an f32 online softmax split
// over the cache.
//
// Both caches are a table of ROWS, one row per (slot, kv head) holding D
// values plus, for int8 payloads, one f32 scale, and a position per slot
// (-1 = empty).  They differ only in where key j of lane b lives, which the
// ``Rows`` functor says (``rows(b, j)`` = the slot's index in the cache: dense
// b*S + j, paged pt[b, j / ps]*ps + j % ps), and in the rule for a lane with
// no valid slot (``ZERO_DEAD``).  So a paged arena and a dense cache holding
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
// The block walks its chunk in tiles of BS keys.  Per tile: the first BS
// threads resolve the tile's rows and positions into shared memory (with
// ps = 16 a tile spans two physical pages, adjacent or not); the block
// dequantizes K and V into shared memory (int8 * scale with ``__fmul_rn``,
// the reference's product; bf16 payloads as they are), scores R*G x BS dot
// products (``fmaf`` in d order), and updates the running max, sum and G x D
// accumulator.  Each chunk writes its unnormalized (m, l, acc) to a scratch;
// ``combine_kernel`` merges the chunks (rescaling each by exp(m - max m)) and
// divides.  Masking reads positions only: a slot is valid iff 0 <= kpos <=
// qpos and, with a window, kpos > qpos - window; masked scores take the
// finite NEG = -1e30.  With every slot masked the dense rule averages V, as
// its reference's softmax does, and the paged rule emits exact zeros, as its
// TPU kernel does.  ``expf``, not ``__expf``; offsets in ``size_t``.
//
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
// whole lane, and a block holding a dead row sums its chunk's V (``dead``,
// in the order the softmax would add it, with p = 1), which the combine
// merges for dead rows.  Every block of a lane writes the same sums.
#pragma once
#include <cuda_bf16.h>
#include <math_constants.h>

#include "common.cuh"

namespace decode {

constexpr int THREADS = 256;
constexpr int BS = 32;  // keys per tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// element e of a cache payload, dequantized: int8 times its (slot, head)
// scale, or a bf16 payload as it is
__device__ __forceinline__ float load_kv(const int8_t* p, const float* s, size_t e, size_t row) {
  return __fmul_rn(static_cast<float>(p[e]), s[row]);
}
__device__ __forceinline__ float load_kv(const __nv_bfloat16* p, const float*, size_t e, size_t) {
  return __bfloat162float(p[e]);
}

// key position kp is valid for a row at qp
__device__ __forceinline__ bool valid_key(int kp, int qp, int window) {
  bool v = kp >= 0 && kp <= qp;
  if (window) v = v && kp > qp - window;
  return v;
}

template <typename QT, typename KT, bool ZERO_DEAD, typename Rows>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kc,
              const float* __restrict__ ks, const KT* __restrict__ vc,
              const float* __restrict__ vs, const int32_t* __restrict__ pos,
              const int32_t* __restrict__ qpos, float* __restrict__ part,
              float* __restrict__ dead, int hq, int hkv, int s_len, int d, float scale,
              int window, int chunk, int t_len, int rows, Rows rows_of) {
  extern __shared__ float smem[];
  const int g_n = hq / hkv;
  const int r0 = blockIdx.z * rows, n_r = min(rows, t_len - r0);
  const int rg_n = n_r * g_n;          // (row, head) pairs of this block
  const int cap = rows * g_n;
  float* q_s = smem;                   // [R*G][D]
  float* acc_s = q_s + cap * d;        // [R*G][D]
  float* k_s = acc_s + cap * d;        // [BS][D+1] dequantized K tile
  float* v_s = k_s + BS * (d + 1);     // [BS][D]   dequantized V tile
  float* p_s = v_s + BS * d;           // [R*G][BS] scores, then probabilities
  float* m_s = p_s + cap * BS;         // [R*G] running max
  float* l_s = m_s + cap;              // [R*G] running sum
  float* a_s = l_s + cap;              // [R*G] rescale of this tile
  int* row_s = reinterpret_cast<int*>(a_s + cap);  // [BS] the key's slot, -1 past the end
  int* kp_s = row_s + BS;                          // [BS] that slot's position
  int* qp_s = kp_s + BS;                           // [R] the rows' positions
  int* live_s = qp_s + rows;                       // [R] 1: a valid key in the lane
  unsigned* tv_s = reinterpret_cast<unsigned*>(live_s + rows);  // bit r: row r has a
                                                                // valid key in the tile
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int k_begin = blockIdx.y * chunk, k_end = min(s_len, k_begin + chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < rg_n * d; i += THREADS) {
    const int rg = i / d, r = rg / g_n;
    const size_t row = static_cast<size_t>(b) * t_len + r0 + r;
    q_s[i] = to_f32(q[(row * hq + static_cast<size_t>(h) * g_n + rg % g_n) * d + i % d]);
    acc_s[i] = 0.0f;
  }
  for (int rg = tid; rg < rg_n; rg += THREADS) {
    m_s[rg] = NEG;
    l_s[rg] = 0.0f;
  }
  for (int r = tid; r < n_r; r += THREADS) {
    qp_s[r] = qpos[static_cast<size_t>(b) * t_len + r0 + r];
    live_s[r] = ZERO_DEAD;  // the paged rule needs no liveness
  }
  __syncthreads();
  // each row's liveness: a valid key anywhere in the lane (the scan stops
  // once every row has one, at once for a row at or past slot 0's position)
  for (int k0 = 0; !ZERO_DEAD && k0 < s_len; k0 += THREADS) {
    if (k0 + tid < s_len) {
      const int kp = pos[rows_of(b, k0 + tid)];
      for (int r = 0; r < n_r; ++r)
        if (valid_key(kp, qp_s[r], window)) live_s[r] = 1;
    }
    __syncthreads();
    if (!__syncthreads_or(tid < n_r && !live_s[tid])) break;
  }
  const bool dead_sum = __syncthreads_or(tid < n_r && !live_s[tid]);
  float dsum = 0.0f, dcnt = 0.0f;  // the dense rule's V sum (column tid < d) and count

  for (int j0 = k_begin; j0 < k_end; j0 += BS) {
    // the tile's slots, and which rows have a valid key among them: warp 0,
    // a lane per key (the previous tile's readers finished at its last
    // barrier)
    unsigned bits = 0;
    if (warp == 0) {
      const int key = j0 + lane;
      int row = -1, kp = -1;
      if (key < k_end) {
        row = rows_of(b, key);
        kp = pos[row];
        for (int r = 0; r < n_r; ++r)
          bits |= static_cast<unsigned>(valid_key(kp, qp_s[r], window)) << r;
      }
      row_s[lane] = row;
      kp_s[lane] = kp;
      bits = __reduce_or_sync(0xffffffffu, bits);
      if (lane == 0) *tv_s = bits;
    }
    const bool scored = __syncthreads_or(bits != 0);
    if (!scored && !dead_sum) continue;
    const unsigned tv = *tv_s;
    // dequantize the K/V tile (keys past the end of the chunk are zero);
    // K only where a row scores it
    for (int i = tid; i < BS * d; i += THREADS) {
      const int j = i / d, dd = i % d, row = row_s[j];
      float kv = 0.0f, vv = 0.0f;
      if (row >= 0) {
        const size_t r = static_cast<size_t>(row) * hkv + h;
        if (scored) kv = load_kv(kc, ks, r * d + dd, r);
        vv = load_kv(vc, vs, r * d + dd, r);
      }
      k_s[j * (d + 1) + dd] = kv;
      v_s[j * d + dd] = vv;
    }
    __syncthreads();
    if (scored) {
      // scores: BS dot products per (row, head) of a row with a valid key
      // in the tile, each key masked by the row's own position
      for (int i = tid; i < rg_n * BS; i += THREADS) {
        const int rg = i / BS, j = i % BS, r = rg / g_n;
        if (!(tv >> r & 1u)) continue;
        float sc = -CUDART_INF_F;  // no such key: contributes exp(.) = 0
        if (row_s[j] >= 0) {
          sc = NEG;
          if (valid_key(kp_s[j], qp_s[r], window)) {
            float dot = 0.0f;
            const float* qr = q_s + rg * d;
            const float* kr = k_s + j * (d + 1);
            for (int dd = 0; dd < d; ++dd) dot = fmaf(qr[dd], kr[dd], dot);
            sc = dot * scale;
          }
        }
        p_s[i] = sc;
      }
    }
    __syncthreads();
    // online softmax update, one warp per (row, query head)
    for (int rg = warp; scored && rg < rg_n; rg += THREADS / 32) {
      if (!(tv >> (rg / g_n) & 1u)) continue;
      float tmax = -CUDART_INF_F;
      for (int j = lane; j < BS; j += 32) tmax = fmaxf(tmax, p_s[rg * BS + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_prev = m_s[rg];
      const float m_new = fmaxf(m_prev, tmax);
      float sum = 0.0f;
      for (int j = lane; j < BS; j += 32) {
        const float p = expf(p_s[rg * BS + j] - m_new);
        p_s[rg * BS + j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[rg] = alpha;
        l_s[rg] = l_s[rg] * alpha + sum;
        m_s[rg] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P @ V
    for (int i = tid; scored && i < rg_n * d; i += THREADS) {
      const int rg = i / d, dd = i % d;
      if (!(tv >> (rg / g_n) & 1u)) continue;
      float a = acc_s[i] * a_s[rg];
      const float* pr = p_s + rg * BS;
      for (int j = 0; j < BS; ++j) a = fmaf(pr[j], v_s[j * d + dd], a);
      acc_s[i] = a;
    }
    // a dead row's sums: p = exp(NEG - NEG) = 1 for every key of the chunk
    if (dead_sum && tid < d) {
      for (int j = 0; j < BS; ++j) {
        if (row_s[j] < 0) continue;
        dsum = fmaf(1.0f, v_s[j * d + tid], dsum);
        dcnt += 1.0f;
      }
    }
    __syncthreads();
  }
  __syncthreads();  // a chunk with no tile: the initial values are written
  if (!ZERO_DEAD && dead_sum && tid < d) {
    float* db = dead + (static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y) * (d + 1);
    db[tid] = dsum;
    if (tid == 0) db[d] = dcnt;
  }
  // each row's (m, l, acc) of this chunk:
  // part[((bh * T + row) * n_split + split) * G * (D + 2) ...]
  const size_t stride = static_cast<size_t>(g_n) * (d + 2);
  for (int r = 0; r < n_r; ++r) {
    float* pb = part + ((static_cast<size_t>(blockIdx.x) * t_len + r0 + r) * gridDim.y +
                        blockIdx.y) * stride;
    const int base = r * g_n;
    for (int i = tid; i < g_n * d; i += THREADS) pb[i] = acc_s[base * d + i];
    for (int g = tid; g < g_n; g += THREADS) {
      pb[g_n * d + g] = m_s[base + g];
      pb[g_n * d + g_n + g] = l_s[base + g];
    }
  }
}

// merge the n_split chunks of one (lane, kv head, row) and normalize; a head
// with no valid slot in any chunk (max still NEG) emits exact zeros with
// ZERO_DEAD, else the chunks' V sums over their key counts
template <typename QT, bool ZERO_DEAD>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ part, const float* __restrict__ dead,
               QT* __restrict__ out, int hq, int hkv, int d, int n_split, int t_len) {
  const int g_n = hq / hkv;
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv, row = blockIdx.y;
  const size_t stride = static_cast<size_t>(g_n) * (d + 2);
  const float* pb =
      part + (static_cast<size_t>(blockIdx.x) * t_len + row) * n_split * stride;
  QT* ob = out + ((static_cast<size_t>(b) * t_len + row) * hq + static_cast<size_t>(h) * g_n) * d;
  for (int i = threadIdx.x; i < g_n * d; i += THREADS) {
    const int g = i / d;
    float m = NEG;
    for (int c = 0; c < n_split; ++c) m = fmaxf(m, pb[c * stride + g_n * d + g]);
    if (!(m > 0.5f * NEG)) {
      float l = 0.0f, a = 0.0f;
      for (int c = 0; !ZERO_DEAD && c < n_split; ++c) {
        const float* db = dead + (static_cast<size_t>(blockIdx.x) * n_split + c) * (d + 1);
        l = fmaf(db[d], 1.0f, l);
        a = fmaf(db[i % d], 1.0f, a);
      }
      from_f32(ob + i, a / fmaxf(l, 1e-30f));
      continue;
    }
    float l = 0.0f, a = 0.0f;
    for (int c = 0; c < n_split; ++c) {
      const float w = expf(pb[c * stride + g_n * d + g] - m);
      l = fmaf(pb[c * stride + g_n * d + g_n + g], w, l);
      a = fmaf(pb[c * stride + i], w, a);
    }
    from_f32(ob + i, a / fmaxf(l, 1e-30f));
  }
}

// shared memory of a decode_kernel block holding ``rows`` query rows of G
// heads (the wrapper's ``block_smem`` mirrors it)
inline size_t smem_bytes(int g_n, int d, int rows) {
  const size_t rg = static_cast<size_t>(rows) * g_n;
  return sizeof(float) * (2 * rg * d + BS * (d + 1) + BS * d + rg * BS + 3 * rg) +
         sizeof(int) * (2 * BS + 2 * rows + 1);
}

// both kernels on ``stream``: q [B, T, Hq, D], payloads/scales/positions as
// ``rows_of`` addresses them, qpos [B, T] -> out [B, T, Hq, D]; a block
// serves ``rows`` of a lane's T rows; ``part`` holds
// B*Hkv*T*n_split*G*(D+2) floats, then the dead rows' sums, B*Hkv*n_split*(D+1).
// Returns the launches' CUDA error.
template <typename QT, typename KT, bool ZERO_DEAD, typename Rows>
int launch(const void* q, const void* kc, const void* ks, const void* vc, const void* vs,
           const void* pos, const void* qpos, void* out, int b, int hq, int hkv, int s_len,
           int d, float scale, int window, int n_split, int chunk, int t_len, int rows,
           void* part, Rows rows_of, cudaStream_t stream) {
  const size_t smem = smem_bytes(hq / hkv, d, rows);
  float* dead = static_cast<float*>(part) +
                static_cast<size_t>(b) * hq * t_len * n_split * (d + 2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(decode_kernel<QT, KT, ZERO_DEAD, Rows>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_kernel<QT, KT, ZERO_DEAD, Rows>
      <<<dim3(b * hkv, n_split, (t_len + rows - 1) / rows), THREADS, smem, stream>>>(
          static_cast<const QT*>(q), static_cast<const KT*>(kc), static_cast<const float*>(ks),
          static_cast<const KT*>(vc), static_cast<const float*>(vs),
          static_cast<const int32_t*>(pos), static_cast<const int32_t*>(qpos),
          static_cast<float*>(part), dead, hq, hkv, s_len, d, scale, window, chunk, t_len,
          rows, rows_of);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<QT, ZERO_DEAD><<<dim3(b * hkv, t_len), THREADS, 0, stream>>>(
      static_cast<const float*>(part), dead, static_cast<QT*>(out), hq, hkv, d, n_split,
      t_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode
