// bf16_gemm: the float linear of the bf16 models, x [M, K] bf16 @ w [K, N]
// bf16 (+ bias [N] bf16) -> bf16 [M, N]: f32 sums, one rounding to bf16,
// then the bias added in bf16 (one more rounding), as ``layers.linear``
// computes it.
//
// Replaces no Pallas kernel: the reference leaves its float linears to
// XLA's dot (``repro/models/layers.py`` ``linear``), and the port ran them
// as ``torch.matmul``.  It is added because cuBLAS picks its algorithm by
// shape (split K among them), so the column-sharded q/k/v at decode rows and
// the row-sharded ``wo``/``w_out`` at M / tp rows summed K in another order
// than tp 1, and bf16 tensor-parallel serving was not bit-identical to tp 1
// (ROADMAP C20).  Here every output element's K sum runs in one fixed order
// — 16-deep ``mma.sync`` steps from k = 0 to K, never split — whatever M, N
// or the tile, so a column shard or a row block of a launch equals the
// matching slice of the unsharded launch bit for bit.
//
// Bound on the H100: at decode rows (M <= 32) bytes — every weight byte is
// read once ([8,4096]x[4096,4096]: 33.6 MB, 10 us at 3.35 TB/s); at prefill
// rows operations at the bf16 tensor-core rate ([4096,4096]x[4096,13440]:
// 451 G operations, 0.456 ms at 989 TFLOP/s).  Design: ``gemm_mma.cuh``'s
// BF16 main loop with one weight stream (the loop dual_gemm_gated's bf16
// form runs with two): A and the [K, N] weight tile through a 4-stage
// ``cp.async`` ring, ``ldmatrix.x4`` / ``.x4.trans`` fragments,
// ``mma.sync.m16n8k16`` with f32 accumulators; tiles from
// ``int8_gemm.bf16_tiling`` (16 x 64 blocks up to M = 32, 64 x 128 up to
// M = 128, 128 x 128 past it).  No split of K means few blocks at decode
// rows on narrow N (64 blocks at N = 4096): the cost of the fixed order.
// The epilogue runs on the accumulator fragments in registers.
#include <cuda_bf16.h>

#include "gemm_mma.cuh"

namespace {

using mma_gemm::BF16;

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
bf16_gemm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ bias, int M, int N, int K, int vec,
                 __nv_bfloat16* __restrict__ out) {
  const mma_gemm::Slice sl(1);  // one expert, no split
  const mma_gemm::Streams<1> s{{w}, {nullptr}};
  mma_gemm::Acc<C, BF16, 1> acc;
  mma_gemm::mainloop<C, BF16, 1>(x, s, M, N, K, 0, sl, K, vec, nullptr, nullptr, acc);
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NP; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = mma_gemm::out_row<C>(i, c), n = mma_gemm::out_col<C, BF16>(j, h, c);
          if (m < M && n < N) {
            __nv_bfloat16 v = __float2bfloat16_rn(acc[0][i][j][h][c]);
            if (bias != nullptr)
              v = __float2bfloat16_rn(__fadd_rn(__bfloat162float(v), __bfloat162float(bias[n])));
            out[static_cast<size_t>(m) * N + n] = v;
          }
        }
}

template <class C>
int launch(cudaStream_t stream, const void* x, const void* w, const void* bias, int m, int n,
           int k, int vec, void* out) {
  const int smem = mma_gemm::Stage<C, BF16, 1>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(bf16_gemm_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + C::BN - 1) / C::BN, (m + C::BM - 1) / C::BM, 1);
  bf16_gemm_kernel<C><<<grid, C::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), m, n, k, vec, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bias: NULL or bf16 [N]; bm 16: the decode shape (16 x 64 blocks), 64 or
// 128: the prefill shapes (64 x 128, 128 x 128), anything else returns
// cudaErrorInvalidValue; vec: K and N multiples of 8, operands 16-byte
// aligned (else the stages fill by byte loads)
extern "C" int repro_bf16_gemm(const void* x, const void* w, const void* bias, int m, int n,
                               int k, int bm, int vec, void* out, void* stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == mma_gemm::WidePrefill::BM)
    return launch<mma_gemm::WidePrefill>(st, x, w, bias, m, n, k, vec, out);
  if (bm == mma_gemm::MidPrefill::BM)
    return launch<mma_gemm::MidPrefill>(st, x, w, bias, m, n, k, vec, out);
  if (bm == mma_gemm::NarrowDecode::BM)
    return launch<mma_gemm::NarrowDecode>(st, x, w, bias, m, n, k, vec, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
