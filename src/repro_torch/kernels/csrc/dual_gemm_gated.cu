// dual_gemm_gated: the gated MLP hidden act(x @ w_gate) * (x @ w_up), both
// GEMMs over one shared A tile, in two forms:
//   int8   x [M, K] int8, xs [M] f32, w_up/w_gate [K, N] int8 with f32 column
//          scales [N]; int32 sums, integer SiLU/GELU at a static scale -> bf16
//   bf16   x [M, K], w_up/w_gate [K, N] bf16; f32 sums, float SiLU/GELU -> bf16
//
// Replaces the Pallas kernel ``repro/kernels/int8_gemm.py``
// ``dual_gemm_gated`` (body ``_dual_kernel``).  The int8 epilogue keeps the
// reference's jitted order (``ref.gated_mlp_w8a8_ref``): each stream
// dequantized as (acc * xs) * ws and rounded to bf16; the gate requantized at
// the static scale, integer activation, payload times f32(out scale) rounded
// to bf16; one bf16 product with the up projection — bit-exact.  The bf16
// form is ``_dual_kernel``'s float branch: f32 sums, act in f32
// (g * 1/(1 + exp(-g)), or the erf GELU), one bf16 rounding of act * up; it
// differs from the unfused plain version (``gated_mlp_ref``, which rounds
// each GEMM and the activation to bf16) by a few bf16 ulps.
//
// Bound on the H100: at decode (M = 8) bytes — [8,4096] x 2 x [4096,13440]
// reads 110 MB of int8 weights (33 us at 3.35 TB/s) or 220 MB of bf16
// (66 us); at prefill operations.  Design, simple first: the int8 form is
// the shared main loop of ``gemm_tile.cuh`` with two weight streams (one A
// tile in shared memory feeds both; two accumulator tiles in registers;
// split K as in int8_gemm) and the gate epilogue in registers.  The bf16
// form uses the same 64x64 tiles and 4x4 register tiles per stream with
// 32-deep K steps, bf16 widened to f32 in shared memory and f32 FMAs on
// the CUDA cores (no split K: the gated MLP's N = d_ff gives >= 200 tiles at
// decode), so neither form writes the [M, N] sums to device memory.
#include "gemm_tile.cuh"
#include "int_epilogue.cuh"

namespace {

__global__ void __launch_bounds__(gemm::THREADS)
dual_i8_kernel(const int8_t* __restrict__ x, gemm::Streams<2> s, const float* __restrict__ xs,
               const float* __restrict__ us, const float* __restrict__ gs, int M, int N, int K,
               int k_len, int vec, Act act, __nv_bfloat16* __restrict__ out,
               int32_t* __restrict__ partial, int* __restrict__ counters) {
  int acc[2][4][4];
  if (!gemm::mainloop<2, 0>(x, s, M, N, K, k_len, vec, partial, counters, acc)) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = gemm::out_m(i), n = gemm::out_n(j);
      if (m < M && n < N)
        out[static_cast<size_t>(m) * N + n] = gated_out(dequant(acc[0][i][j], xs[m], us[n], nullptr, n),
                                                        dequant(acc[1][i][j], xs[m], gs[n], nullptr, n),
                                                        act);
    }
}

constexpr int FK = 32;  // K depth of a bf16 step

// 8 bf16 values of a row from column c (masked past the row's end ``lim``)
__device__ __forceinline__ void load8(float* dst, const __nv_bfloat16* p, int c, int lim, int vec) {
  if (vec && c + 8 <= lim) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h[t]);
      dst[2 * t] = f.x;
      dst[2 * t + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t) dst[t] = c + t < lim ? __bfloat162float(p[t]) : 0.0f;
  }
}

__device__ __forceinline__ float act_f32(float g, int kind) {
  if (kind == ACT_SILU) return __fmul_rn(g, __frcp_rn(__fadd_rn(1.0f, expf(-g))));
  return 0.5f * g * (1.0f + erff(g * 0.70710678118654752f));
}

__global__ void __launch_bounds__(gemm::THREADS)
dual_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wu,
                 const __nv_bfloat16* __restrict__ wg, int M, int N, int K, int vec, int act,
                 __nv_bfloat16* __restrict__ out) {
  __shared__ float As[gemm::BM][FK + 1];  // As[m][k]
  __shared__ float Bs[2][FK][gemm::BN];   // Bs[st][k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * gemm::BN, m0 = blockIdx.y * gemm::BM;
  float acc[2][4][4];
#pragma unroll
  for (int st = 0; st < 2; ++st)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[st][i][j] = 0.0f;
  const int ar = tid >> 2, ac = (tid & 3) * 8;  // A: row ar, columns ac..ac+7
  const int br = tid >> 3, bc = (tid & 7) * 8;  // W: row br, columns bc..bc+7
  for (int k0 = 0; k0 < K; k0 += FK) {
    float v[8];
    {
      const int m = m0 + ar, k = k0 + ac;
      if (m < M) {
        load8(v, x + static_cast<size_t>(m) * K + k, k, K, vec);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = 0.0f;
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) As[ar][ac + t] = v[t];
    }
    const __nv_bfloat16* w[2] = {wu, wg};
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const int k = k0 + br, n = n0 + bc;
      if (k < K) {
        load8(v, w[st] + static_cast<size_t>(k) * N + n, n, N, vec);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = 0.0f;
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) Bs[st][br][bc + t] = v[t];
    }
    __syncthreads();
    if (m0 + ty < M) {
#pragma unroll 8
      for (int kk = 0; kk < FK; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kk];
#pragma unroll
        for (int st = 0; st < 2; ++st)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float b = Bs[st][kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[st][i][j] = __fmaf_rn(a[i], b, acc[st][i][j]);
          }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = gemm::out_m(i), n = gemm::out_n(j);
      if (m < M && n < N)
        out[static_cast<size_t>(m) * N + n] =
            __float2bfloat16_rn(__fmul_rn(act_f32(acc[1][i][j], act), acc[0][i][j]));
    }
}

}  // namespace

// act: 0 SiLU (silu consts used), 1 GELU (gelu consts used)
extern "C" int repro_dual_gemm_gated_i8(const void* x, const void* w_up, const void* up_scale,
                                        const void* w_gate, const void* gate_scale,
                                        const void* xs, int m, int n, int k, int act,
                                        float inv_act_scale, float act_out_scale, int s_ln2,
                                        int s_b, int s_c, int s_one, int g_b, int g_c,
                                        int g_one, int g_s1, int g_mult, int g_s2, void* out,
                                        int split, int k_len, int vec, void* partial,
                                        void* counters, void* stream) {
  const Act a{act, inv_act_scale, act_out_scale, SiluConsts{s_ln2, s_b, s_c, s_one},
              GeluConsts{g_b, g_c, g_one, g_s1, g_mult, g_s2}};
  const gemm::Streams<2> s{{static_cast<const int8_t*>(w_up), static_cast<const int8_t*>(w_gate)},
                           {nullptr, nullptr}};
  if (m > 0 && n > 0) {
    const dim3 grid((n + gemm::BN - 1) / gemm::BN, (m + gemm::BM - 1) / gemm::BM, split);
    dual_i8_kernel<<<grid, gemm::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), s, static_cast<const float*>(xs),
        static_cast<const float*>(up_scale), static_cast<const float*>(gate_scale), m, n, k,
        k_len, vec, a, static_cast<__nv_bfloat16*>(out), static_cast<int32_t*>(partial),
        static_cast<int*>(counters));
  }
  return static_cast<int>(cudaGetLastError());
}

// act: 0 SiLU, 1 GELU; vec: rows of x and W start 16-byte aligned and
// K, N are multiples of 8
extern "C" int repro_dual_gemm_gated_bf16(const void* x, const void* w_up, const void* w_gate,
                                          int m, int n, int k, int act, int vec, void* out,
                                          void* stream) {
  if (m > 0 && n > 0) {
    const dim3 grid((n + gemm::BN - 1) / gemm::BN, (m + gemm::BM - 1) / gemm::BM);
    dual_bf16_kernel<<<grid, gemm::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w_up),
        static_cast<const __nv_bfloat16*>(w_gate), m, n, k, vec, act,
        static_cast<__nv_bfloat16*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
