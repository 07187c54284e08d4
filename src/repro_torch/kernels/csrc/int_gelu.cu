// int_gelu: int32 payload [n] (real value x * scale) -> int8 GELU at
// ``gelu_out_scale(scale)``: the I-BERT erf polynomial, then a requant to
// int8 (``gelu_block``), the paper's ``gelu``.
//
// Replaces the Pallas kernel ``repro/kernels/int_gelu.py`` ``int_gelu``
// (body ``_kernel``).  Bound on the H100: bytes (4 in, 1 out per value).
// Design: ``elementwise.cuh``'s map with ``gelu_block``, the block the fused
// ``scaled_gelu`` and ``requant_gelu`` epilogues run; the polynomial and
// requant constants come from the host (``int_gelu.gelu_consts``).
// Bit-exact against the plain version for any int32 input: where the
// reference's q * (q_erf + q_one) leaves int32 (a raw GEMM accumulator) it
// wraps, and so does ``gelu_block``.
#include "elementwise.cuh"

namespace {

struct Gelu {
  GeluConsts c;
  __device__ __forceinline__ int operator()(int v) const { return gelu_block(v, c); }
};

}  // namespace

extern "C" int repro_int_gelu(const void* x, void* out, int n, int q_b, int q_c, int q_one,
                              int s1, int mult, int s2, int vec, void* stream) {
  return elementwise::launch<int8_t>(x, out, n, vec,
                                     Gelu{GeluConsts{q_b, q_c, q_one, s1, mult, s2}}, stream);
}
