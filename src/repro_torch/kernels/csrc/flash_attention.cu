// flash_attention: bf16 attention forward with an f32 online softmax.
//   q bf16 [B*H, S, D], k/v bf16 [B*Hkv, Skv, D] (GQA: query head h reads kv head
//   h / (H/Hkv)) -> out bf16 [B*H, S, D];  out = softmax(q k^T * scale [+ causal mask]) v
//
// Replaces the Pallas kernel ``repro/kernels/flash_attention.py``
// ``flash_attention`` (body ``_kernel``).  Bound on the H100: operations — 4*S*Skv*D
// flops per head (halved by the causal mask) against 8*S*D bytes; this
// simple kernel runs them in f32 FMAs outside the tensor cores.
//
// Design: one block per (BQ = 64 query rows, head), walking key tiles of
// BK = 64 in order, as the TPU grid walks its KV axis: the tile's K (then V)
// is staged in shared memory as f32, rows padded to D + 1 floats so that a
// warp reads distinct banks; each thread scores 4 rows x 4 keys (``fmaf`` in
// d order, then ``* scale``), the 16 threads of a row reduce its max and sum
// with shuffles, and the same thread keeps that row's running (m, l) and its
// 4 x D/16 slice of the f32 accumulator.  D is a template argument: any
// multiple of 16 up to 128 (zamba2-2.7b's 80 among them; 16-byte loads need
// D % 8 == 0, the accumulator's column split D % 16 == 0).  Key tiles wholly above the
// diagonal are skipped; masked scores take the reference's -1e30 and their
// probabilities are exactly 0.  ``expf``, not ``__expf``; the output is
// acc / max(l, 1e-30) rounded to bf16.
//
// The plain version rounds nothing before the output either, but sums in
// another order and uses its own exp: the two agree within one bf16 rounding
// (rtol 2^-7, atol 1e-3).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr float NEG = -1e30f;

template <int D>
__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* src, int row0,
                                          int n_rows, int tid) {
  // BQ (= BK) rows of D bf16 into [64][D + 1] f32; rows past n_rows are 0
  for (int i = tid; i < 64 * D / 8; i += THREADS) {
    const int r = (i * 8) / D, c = (i * 8) % D;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows)
      raw = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int u = 0; u < 8; ++u) dst[r * (D + 1) + c + u] = __bfloat162float(v[u]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       int h, int hkv, int s, int skv, float scale, int causal) {
  constexpr int DC = D / 16;              // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [BQ][D+1]
  float* kvs = qs + BQ * (D + 1);         // [BK][D+1]  K, then V
  float* ps = kvs + BK * (D + 1);         // [BQ][BK+1] probabilities

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;   // rows tr*4..tr*4+3; keys tc + 16c; cols tc + 16c
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int g = h / hkv;
  const size_t kvh = static_cast<size_t>(bh / h) * hkv + (bh % h) / g;
  const __nv_bfloat16* qg = q + static_cast<size_t>(bh) * s * D;
  const __nv_bfloat16* kg = k + kvh * skv * D;
  const __nv_bfloat16* vg = v + kvh * skv * D;
  const int n_keys = causal ? min(skv, q0 + BQ) : skv;
  const int n_tiles = (n_keys + BK - 1) / BK;

  load_tile<D>(qs, qg, q0, s, tid);
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                      // V of the previous tile is consumed
    load_tile<D>(kvs, kg, k0, skv, tid);
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(tr * 4 + i) * (D + 1) + dd];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = kvs[(tc + 16 * c) * (D + 1) + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
    }
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr * 4 + i;
      bool valid[4];
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tc + 16 * c;
        valid[c] = key < skv && (!causal || key <= row);
        sc[i][c] = valid[c] ? sc[i][c] * scale : NEG;
        mx = fmaxf(mx, sc[i][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pv = valid[c] ? expf(sc[i][c] - m_new) : 0.f;
        ps[(tr * 4 + i) * (BK + 1) + tc + 16 * c] = pv;
        sum += pv;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha[i];
    }
    __syncthreads();                      // K is consumed, ps is written
    load_tile<D>(kvs, vg, k0, skv, tid);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(tr * 4 + i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = kvs[j * (D + 1) + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = out + (static_cast<size_t>(bh) * s + row) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tc + 16 * c] = __float2bfloat16_rn(acc[i][c] / denom);
  }
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           __nv_bfloat16* out, int bh, int h, int hkv, int s, int skv, float scale, int causal,
           cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(float)) * ((BQ + BK) * (D + 1) + BQ * (BK + 1));
  auto kern = flash_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BQ - 1) / BQ, bh);
  kern<<<grid, THREADS, smem, st>>>(q, k, v, out, h, hkv, s, skv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int b, int h, int hkv, int s, int skv, int d, float scale,
                                     int causal, void* stream) {
  if (b == 0 || s == 0) return static_cast<int>(cudaGetLastError());
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {   // any head dim that is a multiple of 16 up to 128
#define REPRO_FA_CASE(D) \
  case D: return launch<D>(qp, kp, vp, op, b * h, h, hkv, s, skv, scale, causal, st);
    REPRO_FA_CASE(16) REPRO_FA_CASE(32) REPRO_FA_CASE(48) REPRO_FA_CASE(64)
    REPRO_FA_CASE(80) REPRO_FA_CASE(96) REPRO_FA_CASE(112) REPRO_FA_CASE(128)
#undef REPRO_FA_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
