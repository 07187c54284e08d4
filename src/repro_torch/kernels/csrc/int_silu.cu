// int_silu: int32 payload [n] (real value x * scale, int8 or int16 range) ->
// int32 SiLU payload at ``silu_out_scale(scale)`` (|out| <= 127 * |x|): the
// shift-exp sigmoid times the input (``silu_block``), the SwiGLU gate's
// integer non-linearity.
//
// Replaces the Pallas kernel ``repro/kernels/int_silu.py`` ``int_silu``
// (body ``_kernel``).  Bound on the H100: bytes (4 in, 4 out per value).
// Design: ``elementwise.cuh``'s map with ``silu_block``, the block the fused
// gated-MLP epilogues run; the exp constants come from the host
// (``int_silu.silu_consts``).  Bit-exact against the plain version.
#include "elementwise.cuh"

namespace {

struct Silu {
  SiluConsts c;
  __device__ __forceinline__ int operator()(int v) const { return silu_block(v, c); }
};

}  // namespace

extern "C" int repro_int_silu(const void* x, void* out, int n, int q_ln2, int q_b, int q_c,
                              int q_one, int vec, void* stream) {
  return elementwise::launch<int32_t>(x, out, n, vec, Silu{SiluConsts{q_ln2, q_b, q_c, q_one}},
                                      stream);
}
