// int8_gemm: int8 [M, K] x int8 [K, N] -> int32 accumulator, finished by a
// fused epilogue in the reference's jitted float order.
//
// Replaces the Pallas kernel ``repro/kernels/int8_gemm.py`` ``int8_gemm``
// (body ``_kernel``) for the epilogues the serving path runs:
//   none         int32 accumulator out
//   scaled       p = f32(acc) * xs[m];  h = p * ws[n]  (or fma(p, ws[n], bias[n]))
//                -> stream dtype (bf16 or f32)
//   scaled_add   scaled, then + residual in the stream dtype
//   scaled_gelu  scaled, rounded to the stream dtype and back, requantized at
//                the static GELU scale (rint(h * f32(1/scale))), integer GELU,
//                int8 out
// The bias is one fused multiply-add (XLA:CPU contracts it under jit); the
// bias-free chain is two separate multiplies; the bf16 residual add rounds
// once from the f32 sum, as PyTorch and XLA do.
//
// Bound on the H100: at decode (M = 8) bytes — every weight byte is read once
// for 8 multiply-adds; at prefill buckets (M up to 2048) operations.  Design,
// simple first: 64x64 output tiles, K in 64-deep steps through shared memory,
// 256 threads each owning a 4x4 register tile of int32 sums built with
// ``__dp4a``.  A is row-major and loads as 16-byte vectors; W stays in the
// reference's [K, N] layout: each thread reads a 4(k) x 4(n) byte block as
// four 4-byte row words and transposes it in registers (``__byte_perm``), so
// shared memory holds K-contiguous words for both operands.  Ragged M, N and
// K are masked in the kernel.  When the M x N tiles alone cannot fill the
// card (decode), K is split across blocks: each block atomically adds its
// int32 partial sums into a workspace, and the last block of a tile (a
// per-tile counter) takes the sums, resets the workspace and counter to zero
// for the next launch, and runs the epilogue.  Integer adds are exact in any
// order, so the split changes no bit.  The workspace is shared by launches on
// one stream only.
#include <cuda_bf16.h>

#include "common.cuh"
#include "int_epilogue.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 64, THREADS = 256;
constexpr int KW = BK / 4;  // 32-bit words in one K step of a row

enum { EPI_NONE = 0, EPI_SCALED = 1, EPI_SCALED_ADD = 2, EPI_SCALED_GELU = 3 };

struct Epi {
  int kind;
  int stream_f32;  // 1: f32 stream/out, 0: bf16
  const float* xs;
  const float* ws;
  const float* bias;
  const void* res;
  void* out;
  float inv_gelu_scale;
  GeluConsts gelu;
};

__device__ __forceinline__ void store_out(const Epi& e, int m, int n, int N, int acc) {
  const size_t idx = static_cast<size_t>(m) * N + n;
  if (e.kind == EPI_NONE) {
    static_cast<int32_t*>(e.out)[idx] = acc;
    return;
  }
  const float p = __fmul_rn(__int2float_rn(acc), e.xs[m]);
  const float h = e.bias ? __fmaf_rn(p, e.ws[n], e.bias[n]) : __fmul_rn(p, e.ws[n]);
  if (e.kind == EPI_SCALED_GELU) {
    const float hs = e.stream_f32 ? h : __bfloat162float(__float2bfloat16_rn(h));
    float qf = rintf(__fmul_rn(hs, e.inv_gelu_scale));
    qf = fminf(fmaxf(qf, -128.0f), 127.0f);
    static_cast<int8_t*>(e.out)[idx] =
        static_cast<int8_t>(gelu_block(static_cast<int>(qf), e.gelu));
    return;
  }
  if (e.stream_f32) {
    float o = h;
    if (e.kind == EPI_SCALED_ADD) o = __fadd_rn(o, static_cast<const float*>(e.res)[idx]);
    static_cast<float*>(e.out)[idx] = o;
  } else {
    __nv_bfloat16 o = __float2bfloat16_rn(h);
    if (e.kind == EPI_SCALED_ADD) {
      const float r = __bfloat162float(static_cast<const __nv_bfloat16*>(e.res)[idx]);
      o = __float2bfloat16_rn(__fadd_rn(__bfloat162float(o), r));
    }
    static_cast<__nv_bfloat16*>(e.out)[idx] = o;
  }
}

// 4 bytes of x[m, k..k+3] (k may run past kend: masked to 0)
__device__ __forceinline__ unsigned pack_row(const int8_t* p, int k, int kend) {
  unsigned v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (k + b < kend) v |= static_cast<unsigned>(static_cast<uint8_t>(p[b])) << (8 * b);
  return v;
}

__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, int M, int N,
                 int K, int k_len, int vec, Epi e, int32_t* __restrict__ partial,
                 int* __restrict__ counters) {
  __shared__ int32_t As[BM][KW + 1];  // As[m][kw]: x[m0+m, k0+4kw .. +3]
  __shared__ int32_t Bs[BN][KW + 1];  // Bs[n][kw]: w[k0+4kw .. +3, n0+n]
  __shared__ int is_last;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_len;
  const int kend = min(K, kbeg + k_len);
  // this thread owns rows m0 + ty + 16i and columns n0 + tx + 16j
  const bool active = m0 + ty < M;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  const int ar = tid >> 2, ac = (tid & 3) * 16;  // A: row ar, bytes ac..ac+15
  const int bk = (tid >> 4) * 4, bn = (tid & 15) * 4;  // W: 4x4 block at (bk, bn)

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    {  // A tile
      const int m = m0 + ar, k = k0 + ac;
      int4 v = make_int4(0, 0, 0, 0);
      if (m < M) {
        const int8_t* p = x + static_cast<size_t>(m) * K + k;
        if (vec && k + 16 <= kend) {
          v = *reinterpret_cast<const int4*>(p);
        } else {
          v.x = static_cast<int>(pack_row(p, k, kend));
          v.y = static_cast<int>(pack_row(p + 4, k + 4, kend));
          v.z = static_cast<int>(pack_row(p + 8, k + 8, kend));
          v.w = static_cast<int>(pack_row(p + 12, k + 12, kend));
        }
      }
      As[ar][ac / 4 + 0] = v.x;
      As[ar][ac / 4 + 1] = v.y;
      As[ar][ac / 4 + 2] = v.z;
      As[ar][ac / 4 + 3] = v.w;
    }
    {  // W tile: four row words, transposed into four K-contiguous column words
      unsigned r[4];
      const int n = n0 + bn;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + bk + i;
        unsigned v = 0;
        if (k < kend) {
          const int8_t* p = w + static_cast<size_t>(k) * N + n;
          if (vec && n + 4 <= N) {
            v = *reinterpret_cast<const unsigned*>(p);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (n + j < N) v |= static_cast<unsigned>(static_cast<uint8_t>(p[j])) << (8 * j);
          }
        }
        r[i] = v;
      }
      const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
      const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
      const unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
      const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
      Bs[bn + 0][bk / 4] = static_cast<int>(__byte_perm(t0, t2, 0x5410));  // column n+0
      Bs[bn + 1][bk / 4] = static_cast<int>(__byte_perm(t0, t2, 0x7632));
      Bs[bn + 2][bk / 4] = static_cast<int>(__byte_perm(t1, t3, 0x5410));
      Bs[bn + 3][bk / 4] = static_cast<int>(__byte_perm(t1, t3, 0x7632));
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kw = 0; kw < KW; ++kw) {
        int a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kw];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][kw];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if (gridDim.z > 1) {  // split K: combine the int32 partial sums
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (active) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
          if (m < M && n < N) atomicAdd(&partial[static_cast<size_t>(m) * N + n], acc[i][j]);
        }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(&counters[tile], 1) == static_cast<int>(gridDim.z) - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    if (active) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
          if (m < M && n < N)
            acc[i][j] = atomicExch(&partial[static_cast<size_t>(m) * N + n], 0);
        }
    }
    if (tid == 0) counters[tile] = 0;
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
        if (m < M && n < N) store_out(e, m, n, N, acc[i][j]);
      }
  }
}

}  // namespace

extern "C" int repro_int8_gemm(const void* x, const void* w, int m, int n, int k,
                               int epilogue, int stream_f32, const void* xs,
                               const void* ws, const void* bias, const void* res,
                               void* out, float inv_gelu_scale, int q_b, int q_c,
                               int q_one, int s1, int mult, int s2, int split, int k_len,
                               int vec, void* partial, void* counters, void* stream) {
  Epi e;
  e.kind = epilogue;
  e.stream_f32 = stream_f32;
  e.xs = static_cast<const float*>(xs);
  e.ws = static_cast<const float*>(ws);
  e.bias = static_cast<const float*>(bias);
  e.res = res;
  e.out = out;
  e.inv_gelu_scale = inv_gelu_scale;
  e.gelu = GeluConsts{q_b, q_c, q_one, s1, mult, s2};
  if (m > 0 && n > 0) {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, split);
    int8_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), m, n, k, k_len, vec,
        e, static_cast<int32_t*>(partial), static_cast<int*>(counters));
  }
  return static_cast<int>(cudaGetLastError());
}
