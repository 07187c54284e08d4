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
// each GEMM and the activation to bf16) by a few bf16 ulps.  Gradients (bf16
// form only): no backward kernel, as the reference has none; the wrapper
// runs this forward inside a torch.autograd.Function whose backward is
// autograd of ``gated_mlp_ref`` (``kernels/int8_gemm.py``).
//
// Bound on the H100: at decode (M = 8) bytes — [8,4096] x 2 x [4096,13440]
// reads 110 MB of int8 weights (33 us at 3.35 TB/s) or 220 MB of bf16
// (66 us); at prefill operations — [4096,4096] x 2 x [4096,13440] is 902 G
// operations, 0.456 ms at the int8 rate and 0.912 ms at the bf16 rate.
// Design: the tensor-core loop of ``gemm_mma.cuh`` with two weight streams
// over one shared A tile, A and both weight tiles in the reference's [K, N]
// layout through a 4-stage ``cp.async`` ring:
// * int8 (kind W8): ``mma.sync`` m16n8k32 with B fragments made from
//   ``ldmatrix.trans`` of permuted rows and two byte permutes; stages of
//   BK = 64 (A and 2 x [64, 128] int8: 78,848 bytes at the decode shape,
//   94,208 at the prefill shape, four stages, so two blocks an SM in both); decode
//   16 x 128 blocks with K split as in int4_gemm (exact int32 combine),
//   prefill 64 x 128 blocks of 8 warps;
// * bf16 (kind BF16): ``mma.sync`` m16n8k16 with f32 accumulators, A by
//   ``ldmatrix.x4``, B by ``ldmatrix.x4.trans``; stages of BK = 64; no split
//   K, so the same inputs give the same bits in every run: decode blocks of
//   16 x 64 (210 at N = 13440 for 132 SMs; 82,944 bytes of shared memory),
//   64 x 128 up to M = 128 (176,128 bytes), then 128 x 128 (8 warps of
//   64 x 32, 212,992 bytes).
// Neither form writes the [M, N] sums to device memory: the gate epilogue
// runs on the accumulator fragments in registers.  ``wgmma`` + TMA is the
// next step (see ``gemm_mma.cuh`` for why this stays on ``mma.sync``).
#include "gemm_mma.cuh"
#include "int_epilogue.cuh"

namespace {

using mma_gemm::BF16;
using mma_gemm::W8;

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
dual_gemm_gated_kernel_i8(const int8_t* __restrict__ x, mma_gemm::Streams<2> s,
                          const float* __restrict__ xs, const float* __restrict__ us,
                          const float* __restrict__ gs, int M, int N, int K, int split,
                          int k_len, int vec, Act act, __nv_bfloat16* __restrict__ out,
                          int32_t* __restrict__ partial, int* __restrict__ counters) {
  const mma_gemm::Slice sl(split);  // expert sl.expert of [E, M, K] x 2 [E, K, N]
  const size_t ex = sl.expert, mn = static_cast<size_t>(M) * N;
#pragma unroll
  for (int st = 0; st < 2; ++st) s.w[st] = static_cast<const int8_t*>(s.w[st]) + ex * K * N;
  xs += ex * M, us += ex * N, gs += ex * N, out += ex * mn;
  mma_gemm::Acc<C, W8, 2> acc;
  if (!mma_gemm::mainloop<C, W8, 2>(x + ex * M * K, s, M, N, K, 0, sl, k_len, vec,
                                    partial + 2 * ex * mn,
                                    counters + ex * gridDim.x * gridDim.y, acc))
    return;
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NP; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = mma_gemm::out_row<C>(i, c), n = mma_gemm::out_col<C, W8>(j, h, c);
          if (m < M && n < N)
            out[static_cast<size_t>(m) * N + n] =
                gated_out(dequant(acc[0][i][j][h][c], xs[m], us[n], nullptr, n),
                          dequant(acc[1][i][j][h][c], xs[m], gs[n], nullptr, n), act);
        }
}

__device__ __forceinline__ float act_f32(float g, int kind) {
  if (kind == ACT_SILU) return __fmul_rn(g, __frcp_rn(__fadd_rn(1.0f, expf(-g))));
  return 0.5f * g * (1.0f + erff(g * 0.70710678118654752f));
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
dual_gemm_gated_kernel_bf16(const __nv_bfloat16* __restrict__ x, mma_gemm::Streams<2> s,
                            int M, int N, int K, int vec, int act,
                            __nv_bfloat16* __restrict__ out) {
  const mma_gemm::Slice sl(1);  // expert blockIdx.z of [E, M, K] x 2 [E, K, N]; no split
  const size_t ex = sl.expert, mn = static_cast<size_t>(M) * N;
#pragma unroll
  for (int st = 0; st < 2; ++st)
    s.w[st] = static_cast<const __nv_bfloat16*>(s.w[st]) + ex * K * N;
  out += ex * mn;
  mma_gemm::Acc<C, BF16, 2> acc;
  mma_gemm::mainloop<C, BF16, 2>(x + ex * M * K, s, M, N, K, 0, sl, K, vec, nullptr, nullptr,
                                 acc);
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NP; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = mma_gemm::out_row<C>(i, c), n = mma_gemm::out_col<C, BF16>(j, h, c);
          if (m < M && n < N)
            out[static_cast<size_t>(m) * N + n] = __float2bfloat16_rn(
                __fmul_rn(act_f32(acc[1][i][j][h][c], act), acc[0][i][j][h][c]));
        }
}

template <class C>
int launch_i8(cudaStream_t stream, int experts, const void* x, const mma_gemm::Streams<2>& s,
              const void* xs, const void* us, const void* gs, int m, int n, int k, int split,
              int k_len, int vec, const Act& act, void* out, void* partial, void* counters) {
  const int smem = mma_gemm::Stage<C, W8, 2>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(dual_gemm_gated_kernel_i8<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + C::BN - 1) / C::BN, (m + C::BM - 1) / C::BM, experts * split);
  dual_gemm_gated_kernel_i8<C><<<grid, C::THREADS, smem, stream>>>(
      static_cast<const int8_t*>(x), s, static_cast<const float*>(xs),
      static_cast<const float*>(us), static_cast<const float*>(gs), m, n, k, split, k_len, vec,
      act,
      static_cast<__nv_bfloat16*>(out), static_cast<int32_t*>(partial),
      static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int launch_bf16(cudaStream_t stream, int experts, const void* x, const mma_gemm::Streams<2>& s,
                int m, int n, int k, int vec, int act, void* out) {
  const int smem = mma_gemm::Stage<C, BF16, 2>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(dual_gemm_gated_kernel_bf16<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + C::BN - 1) / C::BN, (m + C::BM - 1) / C::BM, experts);
  dual_gemm_gated_kernel_bf16<C><<<grid, C::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), s, m, n, k, vec, act,
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// act: 0 SiLU (silu consts used), 1 GELU (gelu consts used); bm 16: the
// decode shape, 64: the prefill shape (anything else returns
// cudaErrorInvalidValue); vec: K and N multiples of 16, operands 16-byte
// aligned.  experts > 1: the expert-batched form, x [E, M, K], both weights
// [E, K, N] with scales [E, N], xs [E, M], out [E, M, N], the split-K
// scratch E times one expert's
extern "C" int repro_dual_gemm_gated_i8(int experts, const void* x, const void* w_up, const void* up_scale,
                                        const void* w_gate, const void* gate_scale,
                                        const void* xs, int m, int n, int k, int act,
                                        float inv_act_scale, float act_out_scale, int s_ln2,
                                        int s_b, int s_c, int s_one, int g_b, int g_c,
                                        int g_one, int g_s1, int g_mult, int g_s2, void* out,
                                        int bm, int split, int k_len, int vec, void* partial,
                                        void* counters, void* stream) {
  const Act a{act, inv_act_scale, act_out_scale, SiluConsts{s_ln2, s_b, s_c, s_one},
              GeluConsts{g_b, g_c, g_one, g_s1, g_mult, g_s2}};
  const mma_gemm::Streams<2> s{{w_up, w_gate}, {nullptr, nullptr}};
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (experts < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == mma_gemm::Prefill::BM)
    return launch_i8<mma_gemm::Prefill>(st, experts, x, s, xs, up_scale, gate_scale, m, n, k,
                                        split, k_len, vec, a, out, partial, counters);
  if (bm == mma_gemm::Decode::BM)
    return launch_i8<mma_gemm::Decode>(st, experts, x, s, xs, up_scale, gate_scale, m, n, k,
                                       split, k_len, vec, a, out, partial, counters);
  return static_cast<int>(cudaErrorInvalidValue);
}

// act: 0 SiLU, 1 GELU; bm 16: the decode shape (16 x 64 blocks), 64 or 128:
// the prefill shapes (64 x 128, 128 x 128); vec: K and N multiples of 8,
// operands 16-byte aligned.  experts > 1: the expert-batched form, x
// [E, M, K], both weights [E, K, N], out [E, M, N]
extern "C" int repro_dual_gemm_gated_bf16(int experts, const void* x, const void* w_up,
                                          const void* w_gate, int m, int n, int k, int act,
                                          int bm, int vec, void* out, void* stream) {
  const mma_gemm::Streams<2> s{{w_up, w_gate}, {nullptr, nullptr}};
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (experts < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == mma_gemm::WidePrefill::BM)
    return launch_bf16<mma_gemm::WidePrefill>(st, experts, x, s, m, n, k, vec, act, out);
  if (bm == mma_gemm::MidPrefill::BM)
    return launch_bf16<mma_gemm::MidPrefill>(st, experts, x, s, m, n, k, vec, act, out);
  if (bm == mma_gemm::NarrowDecode::BM)
    return launch_bf16<mma_gemm::NarrowDecode>(st, experts, x, s, m, n, k, vec, act, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
