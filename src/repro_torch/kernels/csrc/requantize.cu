// requantize_i32: int32 payload [n] -> int8 through ``requant_block``
// (shift with round-half-up, clip to int16, 16-bit multiply, shift, clip to
// int8), the paper's ``quant``.
//
// Replaces the Pallas kernel ``repro/kernels/quantize.py`` ``requantize_i32``
// (body ``_requant_kernel``).  Bound on the H100: bytes (4 in, 1 out per
// value).  Design: ``elementwise.cuh``'s map with ``requant_block``, the
// block every requant epilogue runs (``int_epilogue.cuh``); bit-exact
// against the plain version, wrapping where the reference's int32 wraps.
#include "elementwise.cuh"

namespace {

struct Requant {
  RequantConsts r;
  __device__ __forceinline__ int operator()(int v) const { return requant_block(v, r); }
};

}  // namespace

extern "C" int repro_requantize_i32(const void* x, void* out, int n, int s1, int mult, int s2,
                                    int vec, void* stream) {
  return elementwise::launch<int8_t>(x, out, n, vec, Requant{RequantConsts{s1, mult, s2}},
                                     stream);
}
