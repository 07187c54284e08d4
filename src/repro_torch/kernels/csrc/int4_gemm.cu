// int4_gemm: int8 activations [M, K] x packed int4 weights [K/2, N] with
// two-level scales (per-group int8 multipliers qmul [K/G, N], per-column f32
// scale ws [N]) -> fused epilogue in the reference's jitted float order.
//
// Replaces the Pallas kernel ``repro/kernels/int8_gemm.py`` ``int4_gemm``
// (bodies ``_w4a8_kernel`` and ``_unpack_block``) with its three epilogues:
//   scaled       p = f32(acc) * ws[n];  h = p * xs[m]  (or fma(p, xs[m], bias[n]))
//                -> stream dtype (bf16 or f32)
//   scaled_add   scaled, then + residual in the stream dtype
//   scaled_gelu  scaled, rounded to the stream dtype and back, requantized at
//                the static GELU scale, integer GELU, int8 out
// ``acc`` is the int32 group combine sum_g qmul[g, n] * (x_g . w_g), exact
// in any order.  The W4A8 chain multiplies by the column scale FIRST (the
// reference writes ``acc * w_scale * x_scale``), the W8A8 chain by the row
// scale first: in f32 the two orders round differently.
//
// Bound on the H100: at decode (M = 8) bytes — half a byte of weight per
// 8 multiply-adds (mlp_down [8,13440]x[13440,4096]: 27.5 MB of nibbles, 8.2 us
// at 3.35 TB/s); at prefill rows and in the no-cache forwards (M = 4096)
// operations at the int8 tensor-core rate.  Design: the tensor-core loop of
// ``gemm_mma.cuh`` with one W4 stream — raw nibbles and A through a 4-stage
// ``cp.async`` ring, widened to int8 B fragments at the ``ldmatrix.trans``
// load, ``mma.sync`` m16n8k32 with the group fold on the accumulator
// fragments — in its decode shape (16 x 128 blocks of 4 warps, K split until
// each SM holds ~32 KB of weight in flight) or its prefill shape (64 x 128,
// 8 warps, two blocks an SM); the wrapper picks
// (``int8_gemm.w4_tiling``) and keeps each block's K range on group
// boundaries.  The packed bytes never widen in device memory.
#include "gemm_mma.cuh"
#include "int_epilogue.cuh"

namespace {

using mma_gemm::W4;

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
int4_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w4,
                 const int8_t* __restrict__ qmul, int M, int N, int K, int G, int split,
                 int k_len, int vec, Epi e0, int32_t* __restrict__ partial,
                 int* __restrict__ counters) {
  const mma_gemm::Slice sl(split);  // expert sl.expert of [E, M, K] x [E, K/2, N]
  const size_t ex = sl.expert, mn = static_cast<size_t>(M) * N;
  const mma_gemm::Streams<1> s{{w4 + ex * (K / 2) * N}, {qmul + ex * (K / G) * N}};
  const Epi e = epi_at(e0, sl.expert, M, N);
  mma_gemm::Acc<C, W4, 1> acc;
  if (!mma_gemm::mainloop<C, W4, 1>(x + ex * M * K, s, M, N, K, G, sl, k_len, vec,
                                    partial + ex * mn, counters + ex * gridDim.x * gridDim.y,
                                    acc))
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
          if (m < M && n < N) store_out(e, m, n, N, acc[0][i][j][h][c]);
        }
}

template <class C>
int launch(cudaStream_t stream, int experts, const void* x, const void* w4, const void* qmul,
           int m, int n, int k, int group, int split, int k_len, int vec, const Epi& e,
           void* partial, void* counters) {
  const int smem = mma_gemm::Stage<C, W4, 1>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(int4_gemm_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + C::BN - 1) / C::BN, (m + C::BM - 1) / C::BM, experts * split);
  int4_gemm_kernel<C><<<grid, C::THREADS, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w4),
      static_cast<const int8_t*>(qmul), m, n, k, group, split, k_len, vec, e,
      static_cast<int32_t*>(partial), static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// group: 32, 64 or 128; bm 16: the decode shape, 64: the prefill shape;
// anything else returns cudaErrorInvalidValue.  experts > 1: the
// expert-batched form, x [E, M, K], w4 [E, K/2, N], qmul [E, K/G, N], xs
// [E, M], ws [E, N], out [E, M, N] (no bias or residual), the split-K scratch
// E times one expert's
extern "C" int repro_int4_gemm(int experts, const void* x, const void* w4, const void* qmul, int m, int n,
                               int k, int group, int epilogue, int stream_f32,
                               const void* xs, const void* ws, const void* bias,
                               const void* res, void* out, float inv_gelu_scale, int q_b,
                               int q_c, int q_one, int s1, int mult, int s2, int rq_s1,
                               int rq_mult, int rq_s2, int bm, int split,
                               int k_len, int vec,
                               void* partial, void* counters, void* stream) {
  Epi e;
  e.kind = epilogue;
  e.stream_f32 = stream_f32;
  e.w_first = 1;
  e.xs = static_cast<const float*>(xs);
  e.ws = static_cast<const float*>(ws);
  e.bias = static_cast<const float*>(bias);
  e.res = res;
  e.out = out;
  e.inv_gelu_scale = inv_gelu_scale;
  e.gelu = GeluConsts{q_b, q_c, q_one, s1, mult, s2};
  e.rq = RequantConsts{rq_s1, rq_mult, rq_s2};  // unused: no requant* epilogue at W4A8
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (group != 32 && group != 64 && group != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (experts < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == mma_gemm::Prefill::BM)
    return launch<mma_gemm::Prefill>(st, experts, x, w4, qmul, m, n, k, group, split, k_len,
                                     vec, e, partial, counters);
  if (bm == mma_gemm::Decode::BM)
    return launch<mma_gemm::Decode>(st, experts, x, w4, qmul, m, n, k, group, split, k_len,
                                    vec, e, partial, counters);
  return static_cast<int>(cudaErrorInvalidValue);
}
