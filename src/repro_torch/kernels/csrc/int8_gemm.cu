// int8_gemm: int8 [M, K] x int8 [K, N] -> int32 accumulator, finished by a
// fused epilogue in the reference's jitted float order.
//
// Replaces the Pallas kernel ``repro/kernels/int8_gemm.py`` ``int8_gemm``
// (body ``_kernel``) with its seven epilogues:
//   none         int32 accumulator out
//   requant      requant_block(acc) (shift, 16-bit multiply, shift) -> int8
//   requant_gelu integer GELU of the accumulator at a static scale -> int8
//   requant_add  requant_block(acc) + an int8 residual, saturated -> int8
//   scaled       p = f32(acc) * xs[m];  h = p * ws[n]  (or fma(p, ws[n], bias[n]))
//                -> stream dtype (bf16 or f32)
//   scaled_add   scaled, then + residual in the stream dtype
//   scaled_gelu  scaled, rounded to the stream dtype and back, requantized at
//                the static GELU scale (rint(h * f32(1/scale))), integer GELU,
//                int8 out
// The bias is one fused multiply-add (XLA:CPU contracts it under jit); the
// bias-free chain is two separate multiplies; the bf16 residual add rounds
// once from the f32 sum, as PyTorch and XLA do.
//
// Bound on the H100: at decode rows (M <= 64) bytes — every weight byte is
// read once for M multiply-adds (the f32 head [8,4096]x[4096,92416]: 379 MB,
// 0.113 ms at 3.35 TB/s); at prefill rows and in the no-cache forwards
// (M = 4096) operations at the int8 tensor-core rate.  Design: the
// tensor-core loop of ``gemm_mma.cuh`` with one W8 stream — A and the int8
// [K, N] weight tile through a 4-stage ``cp.async`` ring, B fragments from
// ``ldmatrix.trans`` at permuted rows and two byte permutes, ``mma.sync``
// m16n8k32 with exact int32 sums — in its decode shape (16 x 128 blocks of 4
// warps, K split until each SM holds ~32 KB of weight in flight, the int32
// combine exact in any order) or its prefill shapes (64 x 128, 8 warps, two
// blocks an SM; 128 x 128, 8 warps of 64 x 32, one an SM, for deep K at
// scoring rows); the wrapper picks (``int8_gemm.w8_tiling``, which keeps
// the probe that decided each choice).  Each output
// fragment is finished in registers by ``store_out`` of ``int_epilogue.cuh``
// on int4_gemm's column map ("even"/"odd" columns 4t .. 4t + 3 of rows g and
// g + 8).  Integer sums are exact in any order, so every output equals the
// plain version's bit for bit.
#include "gemm_mma.cuh"
#include "int_epilogue.cuh"

namespace {

using mma_gemm::W8;

// RQ: the requant family of epilogues (a kernel of its own, see ``store_out``)
template <class C, bool RQ>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, int M, int N,
                 int K, int split, int k_len, int vec, Epi e0, int32_t* __restrict__ partial,
                 int* __restrict__ counters) {
  const mma_gemm::Slice sl(split);  // expert sl.expert of [E, M, K] x [E, K, N]
  const size_t mn = static_cast<size_t>(M) * N;
  const mma_gemm::Streams<1> s{{w + static_cast<size_t>(sl.expert) * K * N}, {nullptr}};
  const Epi e = epi_at(e0, sl.expert, M, N);
  mma_gemm::Acc<C, W8, 1> acc;
  if (!mma_gemm::mainloop<C, W8, 1>(x + static_cast<size_t>(sl.expert) * M * K, s, M, N, K, 0,
                                    sl, k_len, vec, partial + sl.expert * mn,
                                    counters + sl.expert * gridDim.x * gridDim.y, acc))
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
          if (m < M && n < N) store_out<RQ>(e, m, n, N, acc[0][i][j][h][c]);
        }
}

template <class C, bool RQ>
int launch(cudaStream_t stream, int experts, const void* x, const void* w, int m, int n, int k,
           int split, int k_len, int vec, const Epi& e, void* partial, void* counters) {
  const int smem = mma_gemm::Stage<C, W8, 1>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_kernel<C, RQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + C::BN - 1) / C::BN, (m + C::BM - 1) / C::BM, experts * split);
  int8_gemm_kernel<C, RQ><<<grid, C::THREADS, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), m, n, k, split, k_len, vec,
      e,
      static_cast<int32_t*>(partial), static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}

template <bool RQ>
int launch_bm(cudaStream_t stream, int bm, int experts, const void* x, const void* w, int m,
              int n, int k, int split, int k_len, int vec, const Epi& e, void* partial,
              void* counters) {
  if (bm == mma_gemm::WidePrefill::BM)
    return launch<mma_gemm::WidePrefill, RQ>(stream, experts, x, w, m, n, k, split, k_len, vec,
                                             e, partial, counters);
  if (bm == mma_gemm::Prefill::BM)
    return launch<mma_gemm::Prefill, RQ>(stream, experts, x, w, m, n, k, split, k_len, vec, e,
                                         partial, counters);
  if (bm == mma_gemm::Decode::BM)
    return launch<mma_gemm::Decode, RQ>(stream, experts, x, w, m, n, k, split, k_len, vec, e,
                                        partial, counters);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bm 16: the decode shape, 64 or 128: the prefill shapes (anything else
// returns cudaErrorInvalidValue); vec: K and N multiples of 16, operands 16-byte
// aligned.  experts > 1: the expert-batched form, x [E, M, K], w [E, K, N],
// xs [E, M], ws [E, N], out [E, M, N] (no bias or residual), the split-K
// scratch E times one expert's
extern "C" int repro_int8_gemm(int experts, const void* x, const void* w, int m, int n, int k,
                               int epilogue, int stream_f32, const void* xs,
                               const void* ws, const void* bias, const void* res,
                               void* out, float inv_gelu_scale, int q_b, int q_c,
                               int q_one, int s1, int mult, int s2, int rq_s1, int rq_mult,
                               int rq_s2, int bm, int split, int k_len, int vec,
                               void* partial, void* counters, void* stream) {
  Epi e;
  e.kind = epilogue;
  e.stream_f32 = stream_f32;
  e.w_first = 0;
  e.xs = static_cast<const float*>(xs);
  e.ws = static_cast<const float*>(ws);
  e.bias = static_cast<const float*>(bias);
  e.res = res;
  e.out = out;
  e.inv_gelu_scale = inv_gelu_scale;
  e.gelu = GeluConsts{q_b, q_c, q_one, s1, mult, s2};
  e.rq = RequantConsts{rq_s1, rq_mult, rq_s2};
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (experts < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (epilogue >= EPI_REQUANT && epilogue <= EPI_REQUANT_ADD)
    return launch_bm<true>(st, bm, experts, x, w, m, n, k, split, k_len, vec, e, partial,
                           counters);
  return launch_bm<false>(st, bm, experts, x, w, m, n, k, split, k_len, vec, e, partial,
                          counters);
}
