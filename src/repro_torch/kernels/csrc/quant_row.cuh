// B1's row quantization, the one body that quantize.cu (``quantize_rows``)
// and int_layernorm.cu (the fused norm -> quantize form) share, so that the
// two cannot drift apart.
//
//   scale = max(amax, 1e-8) * f32(1/127)      (the reference's ``amax / 127.0``
//                                              under jax.jit: XLA multiplies by
//                                              the f32 reciprocal)
//   q     = clamp(rint(x / scale), -128, 127) (a true IEEE division, rounded
//                                              half to even like ``jnp.round``)
//
// ``Chunk<T>`` moves 16 bytes of a bf16 or f32 row between device memory and
// float registers: the rows a block holds are read once, 16 bytes a thread.
#pragma once
#include <cuda_bf16.h>

#include "common.cuh"

namespace quant_row {

__device__ __forceinline__ float scale_of(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
}

__device__ __forceinline__ int quantize(float x, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, s)), -128.0f), 127.0f));
}

// 16 bytes of T: ``load`` widens them to N floats, ``round`` rounds a float
// to T and back (the residual dtype's rounding), ``store`` writes N floats
// that ``round`` already rounded
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 c = *reinterpret_cast<const float4*>(p);
    v[0] = c.x;
    v[1] = c.y;
    v[2] = c.z;
    v[3] = c.w;
  }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 c = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  // exact: each value is already a bf16 held as a float
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (__float_as_uint(v[2 * i]) >> 16) | (__float_as_uint(v[2 * i + 1]) & 0xffff0000u);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// N int8 values (N = 4 or 8) packed into one 4- or 8-byte store
template <int N>
__device__ __forceinline__ void store_q(int8_t* p, const int* q) {
  uint32_t w[N / 4];
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    w[i] = (q[4 * i] & 0xff) | (q[4 * i + 1] & 0xff) << 8 | (q[4 * i + 2] & 0xff) << 16 |
           static_cast<uint32_t>(q[4 * i + 3] & 0xff) << 24;
  if constexpr (N == 4)
    *reinterpret_cast<uint32_t*>(p) = w[0];
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// the absmax of a row held by NT threads (NT = 32: one warp, shuffles only;
// NT = blockDim.x: the block, through ``shm``)
template <int NT>
__device__ __forceinline__ float row_max(float v, float* shm) {
  if constexpr (NT == 32) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  } else {
    return block_reduce(v, MaxOp(), shm);
  }
}

}  // namespace quant_row
