// The body shared by the port's two decode attentions (int8_kv_decode_attention
// over the dense ring cache, paged_decode_attention over the paged arena): one
// query token per lane, GQA, an f32 online softmax split over the cache.
//
// Both caches are a table of ROWS, one row per (slot, kv head) holding D
// values plus, for int8 payloads, one f32 scale, and a position per slot
// (-1 = empty).  They differ only in where key j of lane b lives, which the
// ``Rows`` functor says (``rows(b, j)`` = the slot's index in the cache: dense
// b*S + j, paged pt[b, j / ps]*ps + j % ps), and in the rule for a lane with
// no valid slot (``ZERO_DEAD``).  So a paged arena and a dense cache holding
// the same content give the same bits: every sum below runs in one order.
//
// A block per (lane, kv head, KV split) holds the G = Hq/Hkv query heads of
// that group; the cache is split into ``n_split`` chunks of ``chunk`` keys so
// that B*Hkv*n_split blocks fill the card (B*Hkv = 16 alone would use 16 SMs).
// The block walks its chunk in tiles of BS keys.  Per tile: the first BS
// threads resolve the tile's rows and positions into shared memory (with
// ps = 16 a tile spans two physical pages, adjacent or not); the block
// dequantizes K and V into shared memory (int8 * scale with ``__fmul_rn``,
// the reference's product; bf16 payloads as they are), scores G x BS dot
// products (``fmaf`` in d order), and updates the running max, sum and G x D
// accumulator.  Each chunk writes its unnormalized (m, l, acc) to a scratch;
// ``combine_kernel`` merges the chunks (rescaling each by exp(m - max m)) and
// divides.  Masking reads positions only: a slot is valid iff 0 <= kpos <=
// qpos and, with a window, kpos > qpos - window; masked scores take the
// finite NEG = -1e30.  With every slot masked the dense rule averages V, as
// its reference's softmax does, and the paged rule emits exact zeros, as its
// TPU kernel does.  ``expf``, not ``__expf``; offsets in ``size_t``.
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

template <typename QT, typename KT, typename Rows>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kc,
              const float* __restrict__ ks, const KT* __restrict__ vc,
              const float* __restrict__ vs, const int32_t* __restrict__ pos,
              const int32_t* __restrict__ qpos, float* __restrict__ part, int hq,
              int hkv, int s_len, int d, float scale, int window, int chunk, Rows rows) {
  extern __shared__ float smem[];
  const int g_n = hq / hkv;
  float* q_s = smem;                   // [G][D]
  float* acc_s = q_s + g_n * d;        // [G][D]
  float* k_s = acc_s + g_n * d;        // [BS][D+1] dequantized K tile
  float* v_s = k_s + BS * (d + 1);     // [BS][D]   dequantized V tile
  float* p_s = v_s + BS * d;           // [G][BS]   scores, then probabilities
  float* m_s = p_s + g_n * BS;         // [G] running max
  float* l_s = m_s + g_n;              // [G] running sum
  float* a_s = l_s + g_n;              // [G] rescale of this tile
  int* row_s = reinterpret_cast<int*>(a_s + g_n);  // [BS] the key's slot, -1 past the end
  int* kp_s = row_s + BS;                          // [BS] that slot's position
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int k_begin = blockIdx.y * chunk, k_end = min(s_len, k_begin + chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qp = qpos[b];
  const QT* qb = q + (static_cast<size_t>(b) * hq + static_cast<size_t>(h) * g_n) * d;
  for (int i = tid; i < g_n * d; i += THREADS) {
    q_s[i] = to_f32(qb[i]);
    acc_s[i] = 0.0f;
  }
  for (int g = tid; g < g_n; g += THREADS) {
    m_s[g] = NEG;
    l_s[g] = 0.0f;
  }

  for (int j0 = k_begin; j0 < k_end; j0 += BS) {
    // the tile's slots (the previous tile's readers finished at its last
    // barrier)
    if (tid < BS) {
      const int key = j0 + tid;
      int row = -1, kp = -1;
      if (key < k_end) {
        row = rows(b, key);
        kp = pos[row];
      }
      row_s[tid] = row;
      kp_s[tid] = kp;
    }
    __syncthreads();
    // dequantize the K/V tile (keys past the end of the chunk are zero)
    for (int i = tid; i < BS * d; i += THREADS) {
      const int j = i / d, dd = i % d, row = row_s[j];
      float kv = 0.0f, vv = 0.0f;
      if (row >= 0) {
        const size_t r = static_cast<size_t>(row) * hkv + h;
        kv = load_kv(kc, ks, r * d + dd, r);
        vv = load_kv(vc, vs, r * d + dd, r);
      }
      k_s[j * (d + 1) + dd] = kv;
      v_s[j * d + dd] = vv;
    }
    __syncthreads();
    // scores: G x BS dot products
    for (int i = tid; i < g_n * BS; i += THREADS) {
      const int g = i / BS, j = i % BS;
      float sc = -CUDART_INF_F;  // no such key: contributes exp(.) = 0
      if (row_s[j] >= 0) {
        float dot = 0.0f;
        const float* qr = q_s + g * d;
        const float* kr = k_s + j * (d + 1);
        for (int dd = 0; dd < d; ++dd) dot = fmaf(qr[dd], kr[dd], dot);
        const int kp = kp_s[j];
        bool valid = kp >= 0 && kp <= qp;
        if (window) valid = valid && kp > qp - window;
        sc = valid ? dot * scale : NEG;
      }
      p_s[i] = sc;
    }
    __syncthreads();
    // online softmax update, one warp per query head
    for (int g = warp; g < g_n; g += THREADS / 32) {
      float tmax = -CUDART_INF_F;
      for (int j = lane; j < BS; j += 32) tmax = fmaxf(tmax, p_s[g * BS + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, tmax);
      float sum = 0.0f;
      for (int j = lane; j < BS; j += 32) {
        const float p = expf(p_s[g * BS + j] - m_new);
        p_s[g * BS + j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P @ V
    for (int i = tid; i < g_n * d; i += THREADS) {
      const int g = i / d, dd = i % d;
      float a = acc_s[i] * a_s[g];
      const float* pr = p_s + g * BS;
      for (int j = 0; j < BS; ++j) a = fmaf(pr[j], v_s[j * d + dd], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }
  // this chunk's (m, l, acc): part[(bh * n_split + split) * G * (D + 2) ...]
  // (each thread reads back only what it wrote itself above, so a chunk with
  // no tile needs no barrier)
  float* pb = part + (static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y) * g_n * (d + 2);
  for (int i = tid; i < g_n * d; i += THREADS) pb[i] = acc_s[i];
  for (int g = tid; g < g_n; g += THREADS) {
    pb[g_n * d + g] = m_s[g];
    pb[g_n * d + g_n + g] = l_s[g];
  }
}

// merge the n_split chunks of one (lane, kv head) and normalize; with
// ZERO_DEAD a head with no valid slot in any chunk (max still NEG) emits
// exact zeros
template <typename QT, bool ZERO_DEAD>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ part, QT* __restrict__ out, int hq, int hkv,
               int d, int n_split) {
  const int g_n = hq / hkv;
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const size_t stride = static_cast<size_t>(g_n) * (d + 2);
  const float* pb = part + static_cast<size_t>(blockIdx.x) * n_split * stride;
  QT* ob = out + (static_cast<size_t>(b) * hq + static_cast<size_t>(h) * g_n) * d;
  for (int i = threadIdx.x; i < g_n * d; i += THREADS) {
    const int g = i / d;
    float m = NEG;
    for (int c = 0; c < n_split; ++c) m = fmaxf(m, pb[c * stride + g_n * d + g]);
    if (ZERO_DEAD && !(m > 0.5f * NEG)) {
      from_f32(ob + i, 0.0f);
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

// both kernels on ``stream``: q [B, Hq, D], payloads/scales/positions as
// ``rows`` addresses them, qpos [B] -> out [B, Hq, D]; ``part`` holds
// B*Hkv*n_split*G*(D+2) floats.  Returns the launches' CUDA error.
template <typename QT, typename KT, bool ZERO_DEAD, typename Rows>
int launch(const void* q, const void* kc, const void* ks, const void* vc, const void* vs,
           const void* pos, const void* qpos, void* out, int b, int hq, int hkv, int s_len,
           int d, float scale, int window, int n_split, int chunk, void* part, Rows rows,
           cudaStream_t stream) {
  const int g_n = hq / hkv;
  const size_t smem =
      sizeof(float) * (2 * g_n * d + BS * (d + 1) + BS * d + g_n * BS + 3 * g_n) +
      sizeof(int) * 2 * BS;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(decode_kernel<QT, KT, Rows>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_kernel<QT, KT, Rows><<<dim3(b * hkv, n_split), THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kc), static_cast<const float*>(ks),
      static_cast<const KT*>(vc), static_cast<const float*>(vs),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(qpos),
      static_cast<float*>(part), hq, hkv, s_len, d, scale, window, chunk, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<QT, ZERO_DEAD><<<b * hkv, THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<QT*>(out), hq, hkv, d, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode
