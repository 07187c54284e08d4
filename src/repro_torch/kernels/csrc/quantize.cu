// quantize_rows: f32 [M, D] -> int8 [M, D] + f32 row scale [M].
//
// Replaces the Pallas kernel ``repro/kernels/quantize.py`` ``quantize_rows``
// (body ``_quant_kernel``).  Bound on the H100: bytes — it reads 4 bytes and
// writes 1 per element, with two flops of work.  Design: one block per row
// (D = 3072 or 12288 on starcoder2-3b), a block-wide absmax reduction, then a
// second pass over the row that the first pass left in L1/L2.  The scale is
// ``max(amax, 1e-8) * f32(1/127)``: the reference divides by 127.0 under
// ``jax.jit``, which XLA turns into that product.  Division by the scale is a
// true IEEE division, rounded half to even like ``jnp.round``.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int d) {
  __shared__ float shm[32];
  const size_t row = blockIdx.x;
  const float* xr = x + row * d;
  int8_t* qr = q + row * d;
  float amax = 0.0f;
  for (int i = threadIdx.x; i < d; i += THREADS) amax = fmaxf(amax, fabsf(xr[i]));
  amax = block_reduce(amax, MaxOp(), shm);
  const float s = __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
  for (int i = threadIdx.x; i < d; i += THREADS) {
    float v = rintf(__fdiv_rn(xr[i], s));
    v = fminf(fmaxf(v, -128.0f), 127.0f);
    qr[i] = static_cast<int8_t>(static_cast<int>(v));
  }
  if (threadIdx.x == 0) scale[row] = s;
}

}  // namespace

extern "C" int repro_quantize_rows(const void* x, void* q, void* scale, int m, int d,
                                   void* stream) {
  if (m > 0)
    quantize_rows_kernel<<<m, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), d);
  return static_cast<int>(cudaGetLastError());
}
