// The stand-alone elementwise integer kernels (``requantize.cu``,
// ``int_gelu.cu``, ``int_silu.cu``): out[i] = f(x[i]) over a flat int32
// payload, ``f`` one of the in-register blocks of ``int_epilogue.cuh`` that
// the fused GEMM epilogues run, so each launch equals its epilogue by
// construction.
//
// Bound on the H100: bytes (4 in, 1 or 4 out per value; a few dozen integer
// operations each).  Design: a grid-stride loop, each thread mapping 4
// consecutive values per step with one 16-byte load and one 4- or 16-byte
// store (the wrapper passes ``vec`` = 0 for a pointer that is not 16-byte
// aligned, and the loop then runs one value at a time); about 8 blocks of
// 256 threads per SM.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_epilogue.cuh"

namespace elementwise {

constexpr int THREADS = 256;

template <typename Out>
struct Vec4;
template <>
struct Vec4<int8_t> {
  using T = char4;
};
template <>
struct Vec4<int32_t> {
  using T = int4;
};

template <typename Out, typename F>
__global__ void __launch_bounds__(THREADS)
map_kernel(const int32_t* __restrict__ x, Out* __restrict__ out, int n, int vec, F f) {
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int n4 = vec ? n / 4 : 0;
  using V = typename Vec4<Out>::T;
  for (int i = first; i < n4; i += stride) {
    const int4 v = reinterpret_cast<const int4*>(x)[i];
    V o;
    o.x = f(v.x);
    o.y = f(v.y);
    o.z = f(v.z);
    o.w = f(v.w);
    reinterpret_cast<V*>(out)[i] = o;
  }
  for (int i = 4 * n4 + first; i < n; i += stride) out[i] = static_cast<Out>(f(x[i]));
}

template <typename Out, typename F>
int launch(const void* x, void* out, int n, int vec, F f, void* stream) {
  if (n > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int per = vec ? 4 * THREADS : THREADS;  // values one block maps per step
    const int want = (n + per - 1) / per, cap = 8 * (sms > 0 ? sms : 1);
    const int blocks = want < cap ? want : cap;
    map_kernel<Out, F><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(x), static_cast<Out*>(out), n, vec, f);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace elementwise
