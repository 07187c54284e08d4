// The SIMT main loop of the port's int8 GEMM (int8_gemm) and the tiles that
// int8_conv2d's implicit GEMM shares: int8 activations [M, K] x one int8
// weight [K, N].  (The W4A8 GEMMs and both gated-MLP dual GEMMs run the
// tensor-core loop of ``gemm_mma.cuh``.)
//
// A block owns a 64x64 output tile and walks its K range in 64-deep steps
// through shared memory; 256 threads each keep a 4x4 register tile of int32
// sums, built with ``__dp4a``.  A is row-major and loads as 16-byte vectors.
// W stays in the reference's [K, N] layout: each thread reads four row words
// of 4 columns and transposes the 4x4 bytes (``__byte_perm``) so shared
// memory holds K-contiguous words for both operands.  Ragged M, N and K are
// masked.
//
// Split K: when the M x N tiles alone cannot fill the card, K is split across
// blocks (gridDim.z).  Each block atomically adds its int32 sums into a
// workspace [M][N]; the last block of a tile (a per-tile counter) takes the
// totals, resets workspace and counter to zero for the next launch, and
// runs the epilogue.  Integer adds are exact in any order, so the split
// changes no bit.  The workspace is shared by launches on one stream only.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm {

constexpr int BM = 64, BN = 64, BK = 64, THREADS = 256;
constexpr int KW = BK / 4;  // 32-bit words in one K step of a row

// the 4x4 outputs of this thread: rows m0 + ty + 16i, columns n0 + tx + 16j
__device__ __forceinline__ int out_m(int i) { return blockIdx.y * BM + (threadIdx.x >> 4) + 16 * i; }
__device__ __forceinline__ int out_n(int j) { return blockIdx.x * BN + (threadIdx.x & 15) + 16 * j; }

// 4 bytes of x[m, k..k+3] (k may run past kend: masked to 0)
__device__ __forceinline__ unsigned pack_row(const int8_t* p, int k, int kend) {
  unsigned v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (k + b < kend) v |= static_cast<unsigned>(static_cast<uint8_t>(p[b])) << (8 * b);
  return v;
}

// 4 bytes of a weight row at columns n..n+3 (columns past N read as 0)
__device__ __forceinline__ unsigned load_word(const int8_t* p, int n, int N, int vec) {
  if (vec && n + 4 <= N) return *reinterpret_cast<const unsigned*>(p);
  unsigned v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n + j < N) v |= static_cast<unsigned>(static_cast<uint8_t>(p[j])) << (8 * j);
  return v;
}

__device__ __forceinline__ void load_a(int32_t (*As)[KW + 1], const int8_t* __restrict__ x,
                                       int M, int K, int m0, int k0, int kend, int vec) {
  const int tid = threadIdx.x;
  const int ar = tid >> 2, ac = (tid & 3) * 16;  // row ar, bytes ac..ac+15
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

// W tile step: this thread's 4(k) x 4(n) block at (k0 + bk, n0 + bn), with
// row words r[i] = w[k0 + bk + i, n0 + bn .. +3], stored as four column words
__device__ __forceinline__ void store_cols(int32_t (*Bs)[KW + 1], const unsigned (&r)[4]) {
  const int bk = (threadIdx.x >> 4) * 4, bn = (threadIdx.x & 15) * 4;
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  Bs[bn + 0][bk / 4] = static_cast<int>(__byte_perm(t0, t2, 0x5410));  // column n+0
  Bs[bn + 1][bk / 4] = static_cast<int>(__byte_perm(t0, t2, 0x7632));
  Bs[bn + 2][bk / 4] = static_cast<int>(__byte_perm(t1, t3, 0x5410));
  Bs[bn + 3][bk / 4] = static_cast<int>(__byte_perm(t1, t3, 0x7632));
}

// int8 W [K, N]
__device__ __forceinline__ void load_w8(int32_t (*Bs)[KW + 1], const int8_t* __restrict__ w,
                                        int N, int n0, int k0, int kend, int vec) {
  const int bk = (threadIdx.x >> 4) * 4, n = n0 + (threadIdx.x & 15) * 4;
  unsigned r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + bk + i;
    r[i] = k < kend ? load_word(w + static_cast<size_t>(k) * N + n, n, N, vec) : 0u;
  }
  store_cols(Bs, r);
}

// Run this block's K range and the split-K combine.  Returns true in the
// block that holds the tile's totals in ``acc`` and must run the epilogue.
__device__ __forceinline__ bool mainloop(const int8_t* __restrict__ x,
                                         const int8_t* __restrict__ w, int M, int N, int K,
                                         int k_len, int vec, int32_t* __restrict__ partial,
                                         int* __restrict__ counters, int (&acc)[4][4]) {
  __shared__ int32_t As[BM][KW + 1];  // As[m][kw]: x[m0+m, k0+4kw .. +3]
  __shared__ int32_t Bs[BN][KW + 1];  // Bs[n][kw]: w[k0+4kw .. +3, n0+n]
  __shared__ int is_last;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_len;
  const int kend = min(K, kbeg + k_len);
  const bool active = m0 + ty < M;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    load_a(As, x, M, K, m0, k0, kend, vec);
    load_w8(Bs, w, N, n0, k0, kend, vec);
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

  if (gridDim.z > 1) {  // split K: combine the int32 sums
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (active) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = out_m(i), n = out_n(j);
          if (m < M && n < N) atomicAdd(&partial[static_cast<size_t>(m) * N + n], acc[i][j]);
        }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(&counters[tile], 1) == static_cast<int>(gridDim.z) - 1;
    __syncthreads();
    if (!is_last) return false;
    __threadfence();
    if (active) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = out_m(i), n = out_n(j);
          if (m < M && n < N)
            acc[i][j] = atomicExch(&partial[static_cast<size_t>(m) * N + n], 0);
        }
    }
    if (tid == 0) counters[tile] = 0;
  }
  return active;
}

}  // namespace gemm
