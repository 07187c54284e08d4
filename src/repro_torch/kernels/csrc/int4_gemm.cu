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
// at 3.35 TB/s); at prefill buckets operations.  Design, simple first: the
// shared main loop of ``gemm_tile.cuh`` with one packed stream — each thread
// loads two packed row words (4 columns each), sign-extends the nibbles in
// registers into the int8 words ``__dp4a`` reads, and folds each group's
// int32 sums into the accumulator times qmul when the group ends; the
// packed bytes never widen in device memory.  Split K as in int8_gemm, with
// each block's K range on group boundaries.
#include "gemm_tile.cuh"
#include "int_epilogue.cuh"

namespace {

template <int G>
__global__ void __launch_bounds__(gemm::THREADS)
int4_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w4,
                 const int8_t* __restrict__ qmul, int M, int N, int K, int k_len, int vec, Epi e,
                 int32_t* __restrict__ partial, int* __restrict__ counters) {
  const gemm::Streams<1> s{{w4}, {qmul}};
  int acc[1][4][4];
  if (!gemm::mainloop<1, G>(x, s, M, N, K, k_len, vec, partial, counters, acc)) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = gemm::out_m(i), n = gemm::out_n(j);
      if (m < M && n < N) store_out(e, m, n, N, acc[0][i][j]);
    }
}

template <int G>
void launch(const dim3& grid, cudaStream_t stream, const void* x, const void* w4,
            const void* qmul, int m, int n, int k, int k_len, int vec, const Epi& e,
            void* partial, void* counters) {
  int4_gemm_kernel<G><<<grid, gemm::THREADS, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w4),
      static_cast<const int8_t*>(qmul), m, n, k, k_len, vec, e,
      static_cast<int32_t*>(partial), static_cast<int*>(counters));
}

}  // namespace

// group: 32, 64 or 128 (anything else returns cudaErrorInvalidValue)
extern "C" int repro_int4_gemm(const void* x, const void* w4, const void* qmul, int m, int n,
                               int k, int group, int epilogue, int stream_f32,
                               const void* xs, const void* ws, const void* bias,
                               const void* res, void* out, float inv_gelu_scale, int q_b,
                               int q_c, int q_one, int s1, int mult, int s2, int rq_s1,
                               int rq_mult, int rq_s2, int split, int k_len, int vec,
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
  const dim3 grid((n + gemm::BN - 1) / gemm::BN, (m + gemm::BM - 1) / gemm::BM, split);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 32: launch<32>(grid, st, x, w4, qmul, m, n, k, k_len, vec, e, partial, counters); break;
    case 64: launch<64>(grid, st, x, w4, qmul, m, n, k, k_len, vec, e, partial, counters); break;
    case 128: launch<128>(grid, st, x, w4, qmul, m, n, k, k_len, vec, e, partial, counters); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
