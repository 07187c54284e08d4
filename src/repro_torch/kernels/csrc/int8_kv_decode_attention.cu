// int8_kv_decode_attention: one query token per lane against the int8 ring
// KV cache with per-(token, head) f32 scales, GQA.
//   q [B, Hq, D] bf16|f32, k_q/v_q [B, S, Hkv, D] int8, k_s/v_s [B, S, Hkv, 1] f32,
//   pos_ids [B, S] int32 (-1 = empty slot), qpos [B] int32 -> out [B, Hq, D] (q's dtype)
//
// Replaces the Pallas kernel ``repro/kernels/int8_kv_decode_attention.py``
// ``int8_kv_decode_attention`` (body ``_kernel``).  Bound on the H100: bytes —
// the cache is read once as int8 (2*S*Hkv*D bytes per lane) for about 4*G
// flops per byte.  Design, simple first: a block per (lane, kv head, KV split)
// holds the G = Hq/Hkv query heads of that group; the TPU grid's sequential
// KV axis becomes a loop inside the block over tiles of BS keys, and the
// cache is split into ``n_split`` contiguous chunks so that B*Hkv*n_split
// blocks fill the card (B*Hkv = 16 alone would use 16 SMs).  Per tile the block
// dequantizes K and V into shared memory (int8 * scale, the reference's
// product), scores G x BS dot products, and updates an f32 online softmax
// (running max, sum and G x D accumulator in shared memory) and writes the
// chunk's unnormalized (m, l, acc) to a scratch; a second kernel merges the
// chunks (rescaling each by exp(m - max m)) and divides.  Masking follows
// the reference: a slot is valid iff 0 <= kpos <= qpos and, with a window,
// kpos > qpos - window; masked scores take the finite NEG = -1e30, so a lane
// with every slot masked averages V exactly as the reference's softmax does
// (no NaN).  ``expf``, not ``__expf``.  The sums run in another order than the
// reference's einsum: results agree to a tolerance, not bit for bit.
#include <cuda_bf16.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BS = 32;  // keys per tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename QT>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kq,
              const float* __restrict__ ks, const int8_t* __restrict__ vq,
              const float* __restrict__ vs, const int32_t* __restrict__ pos,
              const int32_t* __restrict__ qpos, float* __restrict__ part, int hq,
              int hkv, int s_len, int d, float scale, int window, int chunk) {
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
  __syncthreads();

  for (int j0 = k_begin; j0 < k_end; j0 += BS) {
    // dequantize the K/V tile (keys past the end of the cache are zero)
    for (int i = tid; i < BS * d; i += THREADS) {
      const int j = i / d, dd = i % d, key = j0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (key < k_end) {
        const size_t row = (static_cast<size_t>(b) * s_len + key) * hkv + h;
        kv = __fmul_rn(static_cast<float>(kq[row * d + dd]), ks[row]);
        vv = __fmul_rn(static_cast<float>(vq[row * d + dd]), vs[row]);
      }
      k_s[j * (d + 1) + dd] = kv;
      v_s[j * d + dd] = vv;
    }
    __syncthreads();
    // scores: G x BS dot products
    for (int i = tid; i < g_n * BS; i += THREADS) {
      const int g = i / BS, j = i % BS, key = j0 + j;
      float sc = -CUDART_INF_F;  // no such key: contributes exp(.) = 0
      if (key < k_end) {
        float dot = 0.0f;
        const float* qr = q_s + g * d;
        const float* kr = k_s + j * (d + 1);
        for (int dd = 0; dd < d; ++dd) dot = fmaf(qr[dd], kr[dd], dot);
        const int kp = pos[static_cast<size_t>(b) * s_len + key];
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
  float* pb = part + (static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y) * g_n * (d + 2);
  for (int i = tid; i < g_n * d; i += THREADS) pb[i] = acc_s[i];
  for (int g = tid; g < g_n; g += THREADS) {
    pb[g_n * d + g] = m_s[g];
    pb[g_n * d + g_n + g] = l_s[g];
  }
}

// merge the n_split chunks of one (lane, kv head) and normalize
template <typename QT>
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
    float l = 0.0f, a = 0.0f;
    for (int c = 0; c < n_split; ++c) {
      const float w = expf(pb[c * stride + g_n * d + g] - m);
      l = fmaf(pb[c * stride + g_n * d + g_n + g], w, l);
      a = fmaf(pb[c * stride + i], w, a);
    }
    from_f32(ob + i, a / fmaxf(l, 1e-30f));
  }
}

template <typename QT>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           const void* pos, const void* qpos, void* out, int b, int hq, int hkv, int s_len,
           int d, float scale, int window, int n_split, int chunk, void* part,
           cudaStream_t stream) {
  const int g_n = hq / hkv;
  const size_t smem =
      sizeof(float) * (2 * g_n * d + BS * (d + 1) + BS * d + g_n * BS + 3 * g_n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_kernel<QT><<<dim3(b * hkv, n_split), THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const int8_t*>(kq), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vq), static_cast<const float*>(vs),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(qpos),
      static_cast<float*>(part), hq, hkv, s_len, d, scale, window, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<QT><<<b * hkv, THREADS, 0, stream>>>(static_cast<const float*>(part),
                                                      static_cast<QT*>(out), hq, hkv, d,
                                                      n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_int8_kv_decode_attention(const void* q, int q_bf16, const void* kq,
                                              const void* ks, const void* vq, const void* vs,
                                              const void* pos, const void* qpos, void* out,
                                              int b, int hq, int hkv, int s_len, int d,
                                              float scale, int window, int n_split, int chunk,
                                              void* part, void* stream) {
  if (b == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return launch<__nv_bfloat16>(q, kq, ks, vq, vs, pos, qpos, out, b, hq, hkv, s_len, d,
                                 scale, window, n_split, chunk, part, st);
  return launch<float>(q, kq, ks, vq, vs, pos, qpos, out, b, hq, hkv, s_len, d, scale,
                       window, n_split, chunk, part, st);
}
