// dual_int4_gemm_gated: the W4A8 gated MLP hidden act(x @ gate) * (x @ up)
// over two packed int4 weight streams that share one A tile:
//   x [M, K] int8, xs [M] f32; up4/gate4 [K/2, N] packed int4 with int8 group
//   multipliers [K/G, N] and f32 column scales [N] -> bf16 [M, N]
//
// Replaces the Pallas kernel ``repro/kernels/int8_gemm.py``
// ``dual_int4_gemm_gated`` (body ``_dual_w4a8_kernel``).  Epilogue, in the
// reference's jitted order (``ref.gated_mlp_w4a8_ref``): each stream's int32
// group combine dequantized as (acc * ws) * xs and rounded to bf16; the gate
// requantized at the static activation scale (rint(g * f32(1/scale))),
// integer SiLU or GELU, its payload times f32(out scale) rounded to bf16;
// then one bf16 product with the up projection.  Bit-exact.
//
// Bound on the H100: at decode (M = 8) bytes — two half-byte weight streams
// ([8,4096] x 2 x [4096,13440]: 57 MB of nibbles, multipliers and scales,
// 17.0 us at 3.35 TB/s); at prefill operations ([4096,4096] x 2 x [4096,13440]: 902
// G int8 operations, 0.456 ms at 1979 TOP/s).  Design: the tensor-core loop
// of ``gemm_mma.cuh`` with two W4 streams — one A tile in shared memory
// feeds both; raw nibbles, multipliers and A through a 4-stage ``cp.async``
// ring; ``mma.sync`` m16n8k32 with each stream's group fold on its own
// fragments — in the decode shape (16 x 128 blocks of 4 warps, 87,040 bytes
// of shared memory, two blocks an SM; K split until each SM has ~32 KB of both
// streams' nibbles in flight; up to M = 32) or ``DualPrefill`` (32 x 128, 8
// warps of 16 x 32, 96,256 bytes, two blocks an SM: part and acc of two
// streams are 64 ints a thread; 32 x 32 warps, 128 ints, one block an SM,
// ran 4-14% slower).  The gate epilogue runs on the accumulator
// fragments in registers, so neither the [M, N] up nor the gate sums reach
// device memory.  ``wgmma`` + TMA is the next step (see ``gemm_mma.cuh``
// for why this stays on ``mma.sync``).
#include "gemm_mma.cuh"
#include "int_epilogue.cuh"

namespace {

using mma_gemm::W4;

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
dual_int4_gemm_gated_kernel(const int8_t* __restrict__ x, mma_gemm::Streams<2> s,
                            const float* __restrict__ xs, const float* __restrict__ us,
                            const float* __restrict__ gs, int M, int N, int K, int G,
                            int split, int k_len, int vec, Act act,
                            __nv_bfloat16* __restrict__ out, int32_t* __restrict__ partial,
                            int* __restrict__ counters) {
  // expert sl.expert of x [E, M, K], both streams [E, K/2, N] and [E, K/G, N]
  const mma_gemm::Slice sl(split);
  const size_t ex = sl.expert, mn = static_cast<size_t>(M) * N;
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    s.w[st] = static_cast<const int8_t*>(s.w[st]) + ex * (K / 2) * N;
    s.qmul[st] += ex * (K / G) * N;
  }
  xs += ex * M, us += ex * N, gs += ex * N, out += ex * mn;
  mma_gemm::Acc<C, W4, 2> acc;
  if (!mma_gemm::mainloop<C, W4, 2>(x + ex * M * K, s, M, N, K, G, sl, k_len, vec,
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
          const int m = mma_gemm::out_row<C>(i, c), n = mma_gemm::out_col<C, W4>(j, h, c);
          if (m < M && n < N)
            out[static_cast<size_t>(m) * N + n] =
                gated_out(dequant(acc[0][i][j][h][c], us[n], xs[m], nullptr, n),
                          dequant(acc[1][i][j][h][c], gs[n], xs[m], nullptr, n), act);
        }
}

template <class C>
int launch(cudaStream_t stream, int experts, const void* x, const mma_gemm::Streams<2>& s,
           const void* xs, const void* us, const void* gs, int m, int n, int k, int group,
           int split, int k_len, int vec, const Act& act, void* out, void* partial,
           void* counters) {
  const int smem = mma_gemm::Stage<C, W4, 2>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(dual_int4_gemm_gated_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + C::BN - 1) / C::BN, (m + C::BM - 1) / C::BM, experts * split);
  dual_int4_gemm_gated_kernel<C><<<grid, C::THREADS, smem, stream>>>(
      static_cast<const int8_t*>(x), s, static_cast<const float*>(xs),
      static_cast<const float*>(us), static_cast<const float*>(gs), m, n, k, group, split,
      k_len, vec, act, static_cast<__nv_bfloat16*>(out), static_cast<int32_t*>(partial),
      static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// act: 0 SiLU (silu consts used), 1 GELU (gelu consts used); group: 32, 64
// or 128; bm 16: the decode shape, 32: the prefill shape (anything else
// returns cudaErrorInvalidValue).  experts > 1: the expert-batched form, x
// [E, M, K], each stream [E, K/2, N] with multipliers [E, K/G, N] and scales
// [E, N], xs [E, M], out [E, M, N], the split-K scratch E times one expert's
extern "C" int repro_dual_int4_gemm_gated(
    int experts, const void* x, const void* up4, const void* up_mul, const void* up_scale,
    const void* gate4, const void* gate_mul, const void* gate_scale, const void* xs, int m,
    int n, int k, int group, int act, float inv_act_scale, float act_out_scale, int s_ln2,
    int s_b, int s_c, int s_one, int g_b, int g_c, int g_one, int g_s1, int g_mult, int g_s2,
    void* out, int bm, int split, int k_len, int vec, void* partial, void* counters,
    void* stream) {
  const Act a{act, inv_act_scale, act_out_scale, SiluConsts{s_ln2, s_b, s_c, s_one},
              GeluConsts{g_b, g_c, g_one, g_s1, g_mult, g_s2}};
  const mma_gemm::Streams<2> s{{up4, gate4},
                               {static_cast<const int8_t*>(up_mul),
                                static_cast<const int8_t*>(gate_mul)}};
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (group != 32 && group != 64 && group != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (experts < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == mma_gemm::DualPrefill::BM)
    return launch<mma_gemm::DualPrefill>(st, experts, x, s, xs, up_scale, gate_scale, m, n, k,
                                         group, split, k_len, vec, a, out, partial, counters);
  if (bm == mma_gemm::Decode::BM)
    return launch<mma_gemm::Decode>(st, experts, x, s, xs, up_scale, gate_scale, m, n, k,
                                    group, split, k_len, vec, a, out, partial, counters);
  return static_cast<int>(cudaErrorInvalidValue);
}
