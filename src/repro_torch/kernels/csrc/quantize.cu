// quantize_rows: bf16 or f32 [M, D] -> int8 [M, D] + f32 row scale [M].
//
// Replaces the Pallas kernel ``repro/kernels/quantize.py`` ``quantize_rows``
// (body ``_quant_kernel``).  Bound on the H100: bytes — it reads 2 or 4
// bytes and writes 1 per element, with a few operations of work — and, at
// the main path's shapes (8 decode rows of 3072-13440, the KV write's rows
// of the head dim), a launch's fixed time.  Design: the row is read once,
// 16 bytes a thread, into registers (``quant_row::Chunk``); the absmax is a
// shuffle tree (plus one shared-memory exchange when a block holds the
// row); the quantized values leave in 4- or 8-byte stores.  Rows of up to
// 1024 values take one warp each, eight rows to a 256-thread block (the
// KV write's [lanes x kv heads, head_dim] rows); wider rows take a block
// each.  The inputs are read as they come (bf16 residual-stream rows need
// no f32 copy first).  Rows whose length or address is not a multiple of
// 16 bytes, or past what registers hold, take a two-pass form that reads
// element by element: this is the integer library's entry, which takes any
// row (the fused norm form, the main path's only, refuses such rows).  The arithmetic is ``quant_row.cuh``'s, which the fused norm
// form in int_layernorm.cu shares.
#include <cuda_bf16.h>

#include "quant_row.cuh"

namespace {

constexpr int THREADS = 256;

// NT threads a row (32: a warp, 256: the block), CH 16-byte chunks a thread
template <typename T, int NT, int CH>
__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int m, int d) {
  using C = quant_row::Chunk<T>;
  constexpr int N = C::N;
  __shared__ float shm[32];
  const int lane = threadIdx.x % NT;
  const size_t row = static_cast<size_t>(blockIdx.x) * (THREADS / NT) + threadIdx.x / NT;
  if (row >= static_cast<size_t>(m)) return;  // whole warps (NT = 32 only)
  const int nch = d / N;
  const T* xr = x + row * d;
  float v[CH][N];
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int c = lane + k * NT;
    if (c < nch) {
      C::load(xr + static_cast<size_t>(c) * N, v[k]);
#pragma unroll
      for (int j = 0; j < N; ++j) amax = fmaxf(amax, fabsf(v[k][j]));
    }
  }
  const float s = quant_row::scale_of(quant_row::row_max<NT>(amax, shm));
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int c = lane + k * NT;
    if (c < nch) {
      int qv[N];
#pragma unroll
      for (int j = 0; j < N; ++j) qv[j] = quant_row::quantize(v[k][j], s);
      quant_row::store_q<N>(q + row * d + static_cast<size_t>(c) * N, qv);
    }
  }
  if (lane == 0) scale[row] = s;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// any row length: one block a row, the absmax pass, then a second pass over
// the row that the first left in L1/L2
template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel_any(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale, int d) {
  __shared__ float shm[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  float amax = 0.0f;
  for (int i = threadIdx.x; i < d; i += THREADS) amax = fmaxf(amax, fabsf(to_float(xr[i])));
  const float s = quant_row::scale_of(block_reduce(amax, MaxOp(), shm));
  for (int i = threadIdx.x; i < d; i += THREADS)
    q[row * d + i] = static_cast<int8_t>(quant_row::quantize(to_float(xr[i]), s));
  if (threadIdx.x == 0) scale[row] = s;
}

template <typename T, int NT>
cudaError_t launch_resident(const T* x, int8_t* q, float* scale, int m, int d, int ch,
                            cudaStream_t st) {
  const int grid = (m + THREADS / NT - 1) / (THREADS / NT);
  switch (ch) {
    case 1: quantize_rows_kernel<T, NT, 1><<<grid, THREADS, 0, st>>>(x, q, scale, m, d); break;
    case 2: quantize_rows_kernel<T, NT, 2><<<grid, THREADS, 0, st>>>(x, q, scale, m, d); break;
    case 4: quantize_rows_kernel<T, NT, 4><<<grid, THREADS, 0, st>>>(x, q, scale, m, d); break;
    case 8: quantize_rows_kernel<T, NT, 8><<<grid, THREADS, 0, st>>>(x, q, scale, m, d); break;
    case 16:
      if constexpr (NT == THREADS) {
        quantize_rows_kernel<T, NT, 16><<<grid, THREADS, 0, st>>>(x, q, scale, m, d);
        break;
      }
      [[fallthrough]];
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the register-resident form where x's rows are 16-byte chunks at 16-byte
// addresses and q takes N-byte stores; the element-wise form otherwise
template <typename T>
cudaError_t launch(const T* x, int8_t* q, float* scale, int m, int d, cudaStream_t st) {
  constexpr int N = quant_row::Chunk<T>::N;
  const int nch = d / N;
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % N == 0 &&
      d % N == 0) {
    const int nt = d <= 1024 ? 32 : THREADS;
    const int per = (nch + nt - 1) / nt;
    int ch = 1;
    while (ch < per) ch *= 2;
    if (nt == 32) return launch_resident<T, 32>(x, q, scale, m, d, ch, st);
    if (ch <= 16) return launch_resident<T, THREADS>(x, q, scale, m, d, ch, st);
  }
  quantize_rows_kernel_any<T><<<m, THREADS, 0, st>>>(x, q, scale, d);
  return cudaGetLastError();
}

}  // namespace

// x: f32 (bf16 = 0) or bf16 (bf16 = 1) rows, any length and alignment
extern "C" int repro_quantize_rows(const void* x, void* q, void* scale, int m, int d,
                                   int bf16, void* stream) {
  if (m <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(scale);
  const cudaError_t err =
      bf16 ? launch(static_cast<const __nv_bfloat16*>(x), qp, sp, m, d, st)
           : launch(static_cast<const float*>(x), qp, sp, m, d, st);
  return static_cast<int>(err);
}
