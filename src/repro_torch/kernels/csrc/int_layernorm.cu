// int_layernorm: integer LayerNorm / RMSNorm over the last axis,
// int32 [M, D] + int32 gamma/beta [D] -> int32 [M, D].
//
// Replaces the Pallas kernel ``repro/kernels/int_layernorm.py``
// ``int_layernorm`` (body ``_kernel``), itself ``core.inumerics.i_layernorm``.
// Bound on the H100: bytes (4 in, 4 out per element; the integer work is a
// few ops per element plus one Newton square root per row).  Design: one
// block per row; two block reductions (sum, then sum of squares); the row is
// read three times, the later reads from L1/L2.
//
// Bit-exact against the plain version.  The reference's ``//`` is a floor
// division: ``(c << 11) // std16`` with a negative ``c`` rounds toward minus
// infinity, where C++ ``/`` truncates, so ``floor_div`` writes it out.  The
// mean keeps the reference's sign-split rounding and ``vshift`` pre-shift.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
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

__global__ void __launch_bounds__(THREADS)
int_layernorm_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ gamma,
                     const int32_t* __restrict__ beta, int32_t* __restrict__ out,
                     int d, int rms_only, int vshift) {
  __shared__ int shm[32];
  const size_t row = blockIdx.x;
  const int32_t* xr = x + row * d;
  int32_t* orow = out + row * d;
  int mean = 0;
  if (!rms_only) {
    int s = 0;
    for (int i = threadIdx.x; i < d; i += THREADS) s += xr[i];
    s = block_reduce(s, AddOp(), shm);
    mean = s >= 0 ? (s + d / 2) / d : -((-s + d / 2) / d);
  }
  int v = 0;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    const int c = min(max(xr[i] - mean, -255), 255);
    v += (c * c) >> vshift;
  }
  v = block_reduce(v, AddOp(), shm);
  const int var = (v / d) << vshift;
  const int std16 = max(isqrt_newton(var << 8), 1);
  for (int i = threadIdx.x; i < d; i += THREADS) {
    const int c = min(max(xr[i] - mean, -255), 255);
    int o = floor_div(c * (1 << (FRAC + 4)), std16) * gamma[i];
    if (!rms_only) o += beta[i] * (1 << FRAC);
    orow[i] = o;
  }
}

}  // namespace

extern "C" int repro_int_layernorm(const void* x, const void* gamma, const void* beta,
                                   void* out, int m, int d, int rms_only, int vshift,
                                   void* stream) {
  if (m > 0)
    int_layernorm_kernel<<<m, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(x), static_cast<const int32_t*>(gamma),
        static_cast<const int32_t*>(beta), static_cast<int32_t*>(out), d, rms_only,
        vshift);
  return static_cast<int>(cudaGetLastError());
}
