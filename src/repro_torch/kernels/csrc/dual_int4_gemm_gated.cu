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
// ([8,4096] x 2 x [4096,13440]: 55 MB of nibbles, 16.4 us at 3.35 TB/s); at
// prefill operations.  Design, simple first: the shared main loop of
// ``gemm_tile.cuh`` with two packed streams — one A tile in shared memory
// feeds both, each thread keeps two accumulator tiles and two group tiles in
// registers, and the gate epilogue runs in registers, so neither the
// [M, N] up nor the gate sums reach device memory.  Split K as in int8_gemm.
#include "gemm_tile.cuh"
#include "int_epilogue.cuh"

namespace {

template <int G>
__global__ void __launch_bounds__(gemm::THREADS)
dual_int4_kernel(const int8_t* __restrict__ x, gemm::Streams<2> s, const float* __restrict__ xs,
                 const float* __restrict__ us, const float* __restrict__ gs, int M, int N, int K,
                 int k_len, int vec, Act act, __nv_bfloat16* __restrict__ out,
                 int32_t* __restrict__ partial, int* __restrict__ counters) {
  int acc[2][4][4];
  if (!gemm::mainloop<2, G>(x, s, M, N, K, k_len, vec, partial, counters, acc)) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = gemm::out_m(i), n = gemm::out_n(j);
      if (m < M && n < N)
        out[static_cast<size_t>(m) * N + n] = gated_out(dequant(acc[0][i][j], us[n], xs[m], nullptr, n),
                                                        dequant(acc[1][i][j], gs[n], xs[m], nullptr, n),
                                                        act);
    }
}

template <int G>
void launch(const dim3& grid, cudaStream_t stream, const void* x, const gemm::Streams<2>& s,
            const void* xs, const void* us, const void* gs, int m, int n, int k, int k_len,
            int vec, const Act& act, void* out, void* partial, void* counters) {
  dual_int4_kernel<G><<<grid, gemm::THREADS, 0, stream>>>(
      static_cast<const int8_t*>(x), s, static_cast<const float*>(xs),
      static_cast<const float*>(us), static_cast<const float*>(gs), m, n, k, k_len, vec, act,
      static_cast<__nv_bfloat16*>(out), static_cast<int32_t*>(partial),
      static_cast<int*>(counters));
}

}  // namespace

// act: 0 SiLU (silu consts used), 1 GELU (gelu consts used); group: 32, 64
// or 128 (anything else returns cudaErrorInvalidValue)
extern "C" int repro_dual_int4_gemm_gated(
    const void* x, const void* up4, const void* up_mul, const void* up_scale,
    const void* gate4, const void* gate_mul, const void* gate_scale, const void* xs, int m,
    int n, int k, int group, int act, float inv_act_scale, float act_out_scale, int s_ln2,
    int s_b, int s_c, int s_one, int g_b, int g_c, int g_one, int g_s1, int g_mult, int g_s2,
    void* out, int split, int k_len, int vec, void* partial, void* counters, void* stream) {
  const Act a{act, inv_act_scale, act_out_scale, SiluConsts{s_ln2, s_b, s_c, s_one},
              GeluConsts{g_b, g_c, g_one, g_s1, g_mult, g_s2}};
  const gemm::Streams<2> s{{static_cast<const int8_t*>(up4), static_cast<const int8_t*>(gate4)},
                           {static_cast<const int8_t*>(up_mul),
                            static_cast<const int8_t*>(gate_mul)}};
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n + gemm::BN - 1) / gemm::BN, (m + gemm::BM - 1) / gemm::BM, split);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 32:
      launch<32>(grid, st, x, s, xs, up_scale, gate_scale, m, n, k, k_len, vec, a, out, partial,
                 counters);
      break;
    case 64:
      launch<64>(grid, st, x, s, xs, up_scale, gate_scale, m, n, k, k_len, vec, a, out, partial,
                 counters);
      break;
    case 128:
      launch<128>(grid, st, x, s, xs, up_scale, gate_scale, m, n, k, k_len, vec, a, out,
                  partial, counters);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
