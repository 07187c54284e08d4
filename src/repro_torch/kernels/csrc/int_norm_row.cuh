// B9's integer LayerNorm / RMSNorm arithmetic, the one body that both forms
// in int_layernorm.cu share: the standalone kernel (int32 rows in, int32
// out) and the fused norm -> quantize form.  Exactly
// ``core.inumerics.i_layernorm``:
//
//   mean  = the row sum rounded half away from zero over d (sign split;
//           LayerNorm only), c = clamp(q - mean, -255, 255)
//   var   = (sum((c * c) >> vshift) / d) << vshift   (vshift keeps the sum
//           in int32 for rows past 2^15; the host computes it from d)
//   std16 = max(isqrt(var << 8), 1)                   (Newton, 8 steps)
//   out   = floor_div(c << 11, std16) * gamma (+ beta << 7 for LayerNorm)
//
// The reference's ``//`` is a floor division: with a negative ``c`` it
// rounds toward minus infinity, where C++ ``/`` truncates, so ``floor_div``
// writes it out.
#pragma once
#include "common.cuh"

namespace int_norm {

constexpr int FRAC = 7;  // fractional bits of the normalized value

// floor(a / b) for b > 0
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// floor(sqrt(n)) by Newton iteration, exactly ``inumerics.i_sqrt``
__device__ __forceinline__ int isqrt_newton(int n) {
  n = max(n, 0);
  const int bl = 32 - __clz(max(n, 1));
  int x = 1 << ((bl + 1) / 2);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    x = max(x, 1);
    x = min(x, (x + n / x) >> 1);
  }
  return n == 0 ? 0 : x;
}

__device__ __forceinline__ int mean_of(int sum, int d) {
  return sum >= 0 ? (sum + d / 2) / d : -((-sum + d / 2) / d);
}

__device__ __forceinline__ int centred(int q, int mean) { return min(max(q - mean, -255), 255); }

__device__ __forceinline__ int square(int c, int vshift) { return (c * c) >> vshift; }

__device__ __forceinline__ int std16_of(int square_sum, int d, int vshift) {
  const int var = (square_sum / d) << vshift;
  return max(isqrt_newton(var << 8), 1);
}

__device__ __forceinline__ int out(int c, int std16, int gamma, int beta, int rms_only) {
  int o = floor_div(c * (1 << (FRAC + 4)), std16) * gamma;
  if (!rms_only) o += beta * (1 << FRAC);
  return o;
}

}  // namespace int_norm
