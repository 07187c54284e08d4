// Shared device helpers for the port's kernels.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct AddOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a + b; }
};

// Reduce ``v`` over the whole block (blockDim.x a multiple of 32); every
// thread gets the result.  ``shm`` holds 32 values; the leading barrier
// makes back-to-back calls on the same ``shm`` safe.
template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, Op op, T* shm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) shm[warp] = v;
  __syncthreads();
  T r = shm[0];
  for (int i = 1; i < n_warps; ++i) r = op(r, shm[i]);
  return r;
}
