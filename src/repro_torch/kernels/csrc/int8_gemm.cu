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
// Bound on the H100: at decode (M = 8) bytes — every weight byte is read once
// for 8 multiply-adds; at prefill buckets (M up to 2048) operations.  Design,
// simple first: the shared main loop of ``gemm_tile.cuh`` (64x64 output
// tiles, 64-deep K steps, ``__dp4a`` on 4x4 register tiles, W read in its
// [K, N] layout and transposed in registers, split K with an exact int32
// combine when the tiles alone cannot fill the card) with one weight stream,
// then ``store_out`` of ``int_epilogue.cuh``.
#include "gemm_tile.cuh"
#include "int_epilogue.cuh"

namespace {

// RQ: the requant family of epilogues (a kernel of its own, see ``store_out``)
template <bool RQ>
__global__ void __launch_bounds__(gemm::THREADS)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, int M, int N,
                 int K, int k_len, int vec, Epi e, int32_t* __restrict__ partial,
                 int* __restrict__ counters) {
  int acc[4][4];
  if (!gemm::mainloop(x, w, M, N, K, k_len, vec, partial, counters, acc)) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = gemm::out_m(i), n = gemm::out_n(j);
      if (m < M && n < N) store_out<RQ>(e, m, n, N, acc[i][j]);
    }
}

}  // namespace

extern "C" int repro_int8_gemm(const void* x, const void* w, int m, int n, int k,
                               int epilogue, int stream_f32, const void* xs,
                               const void* ws, const void* bias, const void* res,
                               void* out, float inv_gelu_scale, int q_b, int q_c,
                               int q_one, int s1, int mult, int s2, int rq_s1, int rq_mult,
                               int rq_s2, int split, int k_len, int vec, void* partial,
                               void* counters, void* stream) {
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
  if (m > 0 && n > 0) {
    const dim3 grid((n + gemm::BN - 1) / gemm::BN, (m + gemm::BM - 1) / gemm::BM, split);
    const bool rq = epilogue >= EPI_REQUANT && epilogue <= EPI_REQUANT_ADD;
    auto kern = rq ? int8_gemm_kernel<true> : int8_gemm_kernel<false>;
    kern<<<grid, gemm::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), m, n, k, k_len, vec,
        e, static_cast<int32_t*>(partial), static_cast<int*>(counters));
  }
  return static_cast<int>(cudaGetLastError());
}
