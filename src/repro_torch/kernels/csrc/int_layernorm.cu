// int_layernorm: integer LayerNorm / RMSNorm over the last axis, in two
// forms that share ``int_norm_row.cuh``'s arithmetic.
//
// Replaces the Pallas kernel ``repro/kernels/int_layernorm.py``
// ``int_layernorm`` (body ``_kernel``), itself ``core.inumerics.i_layernorm``.
// Bound on the H100: bytes, and at the main path's 8 decode rows a launch's
// fixed time.
//
// ``repro_int_layernorm`` (the integer library's ``layernorm_i8``): int32
// [M, D] + int32 gamma/beta [D] -> int32 [M, D].  One block per row; two
// block reductions (sum, then sum of squares); the row is read three
// times, the later reads from L1/L2.
//
// ``repro_int_layernorm_rows`` (the models' norm, ``norm_int`` and the
// quantization of its output for the next integer GEMM): bf16 or f32 rows
// [M, D] -> the normed rows in the same dtype, their int8 payload and f32
// row scales — in one launch what was B1, a cast, B9, a cast, the dequant,
// a cast and B1 again:
//   1. B1 on x (``quant_row.cuh``);
//   2. B9 on the int8 payload;
//   3. the dequant ``float(o) * (gb_s * 2^-7)``, rounded once, with gb_s
//      read from the device (no host copy), then rounded to the residual
//      dtype;
//   4. B1 again, on those rounded values.
// One block of 256 threads per row; the row is read once, 16 bytes a
// thread, and stays in registers (D = 2560, 3072, 4096 in bf16: two chunks
// of 8 a thread); each of the four reductions (absmax, sum, sum of squares,
// absmax) is a shuffle tree plus one shared-memory exchange; gamma and beta
// come in 16-byte loads from L2.  It writes 2 + 1 bytes an element and 4 a
// row, against the chain's dozen passes over the row.
//
// Bit-exact against the plain versions.  The norm output can pass 2^24
// (|c << 11| over std16 = 1, times gamma up to 127), so its conversion to
// f32 rounds: ``__int2float_rn``, as ``.float()`` does.
#include <cuda_bf16.h>

#include "int_norm_row.cuh"
#include "quant_row.cuh"

namespace {

constexpr int THREADS = 256;

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
    mean = int_norm::mean_of(block_reduce(s, AddOp(), shm), d);
  }
  int v = 0;
  for (int i = threadIdx.x; i < d; i += THREADS)
    v += int_norm::square(int_norm::centred(xr[i], mean), vshift);
  const int std16 = int_norm::std16_of(block_reduce(v, AddOp(), shm), d, vshift);
  for (int i = threadIdx.x; i < d; i += THREADS)
    orow[i] = int_norm::out(int_norm::centred(xr[i], mean), std16, gamma[i], beta[i],
                            rms_only);
}

// N int32 values (N = 4 or 8) in 16-byte loads
template <int N>
__device__ __forceinline__ void load_i32(const int32_t* p, int* v) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const int4 c = reinterpret_cast<const int4*>(p)[i];
    v[4 * i] = c.x;
    v[4 * i + 1] = c.y;
    v[4 * i + 2] = c.z;
    v[4 * i + 3] = c.w;
  }
}

// CH 16-byte chunks of the row a thread
template <typename T, int CH>
__global__ void __launch_bounds__(THREADS)
int_layernorm_kernel_rows(const T* __restrict__ x, const int32_t* __restrict__ gamma,
                          const int32_t* __restrict__ beta, const float* __restrict__ gb_s,
                          T* __restrict__ h, int8_t* __restrict__ hq,
                          float* __restrict__ hs, int d, int rms_only, int vshift) {
  using C = quant_row::Chunk<T>;
  constexpr int N = C::N;
  __shared__ float shf[32];
  __shared__ int shi[32];
  const size_t row = blockIdx.x;
  const int nch = d / N;
  float v[CH][N];
  int c[CH][N];

  // 1. the row into registers, B1 on it
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < nch) {
      C::load(x + row * d + static_cast<size_t>(i) * N, v[k]);
#pragma unroll
      for (int j = 0; j < N; ++j) amax = fmaxf(amax, fabsf(v[k][j]));
    }
  }
  const float s = quant_row::scale_of(block_reduce(amax, MaxOp(), shf));
  int sum = 0;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    if (threadIdx.x + k * THREADS < nch) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        c[k][j] = quant_row::quantize(v[k][j], s);
        sum += c[k][j];
      }
    }
  }

  // 2. B9 on the int8 payload
  const int mean = rms_only ? 0 : int_norm::mean_of(block_reduce(sum, AddOp(), shi), d);
  int sq = 0;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    if (threadIdx.x + k * THREADS < nch) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        c[k][j] = int_norm::centred(c[k][j], mean);
        sq += int_norm::square(c[k][j], vshift);
      }
    }
  }
  const int std16 = int_norm::std16_of(block_reduce(sq, AddOp(), shi), d, vshift);

  // 3. the dequant, rounded to the residual dtype
  const float step = __fmul_rn(*gb_s, 0x1p-7f);
  float amax2 = 0.0f;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < nch) {
      int g[N], b[N] = {};
      load_i32<N>(gamma + static_cast<size_t>(i) * N, g);
      if (!rms_only) load_i32<N>(beta + static_cast<size_t>(i) * N, b);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int o = int_norm::out(c[k][j], std16, g[j], b[j], rms_only);
        v[k][j] = C::round(__fmul_rn(__int2float_rn(o), step));
        amax2 = fmaxf(amax2, fabsf(v[k][j]));
      }
    }
  }

  // 4. B1 on the rounded rows; every output written once
  const float s2 = quant_row::scale_of(block_reduce(amax2, MaxOp(), shf));
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < nch) {
      const size_t at = row * d + static_cast<size_t>(i) * N;
      C::store(h + at, v[k]);
#pragma unroll
      for (int j = 0; j < N; ++j) c[k][j] = quant_row::quantize(v[k][j], s2);
      quant_row::store_q<N>(hq + at, c[k]);
    }
  }
  if (threadIdx.x == 0) hs[row] = s2;
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// refuses (cudaErrorInvalidValue) rows it cannot hold in registers: D not a
// multiple of 16 bytes, an operand off its 16-byte (hq: N-byte) alignment,
// or more than 8 chunks a thread (2048 a row)
template <typename T>
cudaError_t launch_rows(const T* x, const int32_t* gamma, const int32_t* beta,
                        const float* gb_s, T* h, int8_t* hq, float* hs, int m, int d,
                        int rms_only, int vshift, cudaStream_t st) {
  constexpr int N = quant_row::Chunk<T>::N;
  if (d % N != 0 || !aligned(x, 16) || !aligned(h, 16) || !aligned(gamma, 16) ||
      !aligned(beta, 16) || !aligned(hq, N))
    return cudaErrorInvalidValue;
  const int per = (d / N + THREADS - 1) / THREADS;
#define ROWS_CASE(CH)                                                                   \
  case CH:                                                                              \
    int_layernorm_kernel_rows<T, CH><<<m, THREADS, 0, st>>>(x, gamma, beta, gb_s, h, hq, \
                                                           hs, d, rms_only, vshift);    \
    break;
  switch (per <= 1 ? 1 : per <= 2 ? 2 : per <= 4 ? 4 : per <= 8 ? 8 : 0) {
    ROWS_CASE(1)
    ROWS_CASE(2)
    ROWS_CASE(4)
    ROWS_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef ROWS_CASE
  return cudaGetLastError();
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

// x, h: f32 (bf16 = 0) or bf16 (bf16 = 1) [M, D]; gb_s: one f32 on the
// device.  Returns cudaErrorInvalidValue, launching nothing, for rows that
// ``launch_rows`` cannot hold.
extern "C" int repro_int_layernorm_rows(const void* x, const void* gamma, const void* beta,
                                        const void* gb_s, void* h, void* hq, void* hs, int m,
                                        int d, int bf16, int rms_only, int vshift,
                                        void* stream) {
  if (m <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const int32_t*>(gamma);
  const auto* b = static_cast<const int32_t*>(beta);
  const auto* gs = static_cast<const float*>(gb_s);
  auto* q = static_cast<int8_t*>(hq);
  auto* s = static_cast<float*>(hs);
  const cudaError_t err =
      bf16 ? launch_rows(static_cast<const __nv_bfloat16*>(x), g, b, gs,
                         static_cast<__nv_bfloat16*>(h), q, s, m, d, rms_only, vshift, st)
           : launch_rows(static_cast<const float*>(x), g, b, gs, static_cast<float*>(h), q,
                         s, m, d, rms_only, vshift, st);
  return static_cast<int>(err);
}
