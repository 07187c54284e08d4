// The SIMT tiles of the port's int8 implicit-GEMM convolution (int8_conv2d,
// B15), its only user: every int8 GEMM runs the tensor-core loop of
// ``gemm_mma.cuh``, and B15 moves onto it (retiring this header) in its
// turn on the redesign queue.
//
// A block owns a 64x64 output tile and walks its K range in 64-deep steps
// through shared memory; 256 threads each keep a 4x4 register tile of int32
// sums, built with ``__dp4a``.  W stays in the reference's [K, N] layout:
// each thread reads four row words of 4 columns and transposes the 4x4 bytes
// (``__byte_perm``, ``store_cols``) so shared memory holds K-contiguous words
// for both operands.  Ragged N is masked.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm {

constexpr int BM = 64, BN = 64, BK = 64, THREADS = 256;
constexpr int KW = BK / 4;  // 32-bit words in one K step of a row

// the 4x4 outputs of this thread: rows m0 + ty + 16i, columns n0 + tx + 16j
__device__ __forceinline__ int out_m(int i) { return blockIdx.y * BM + (threadIdx.x >> 4) + 16 * i; }
__device__ __forceinline__ int out_n(int j) { return blockIdx.x * BN + (threadIdx.x & 15) + 16 * j; }

// 4 bytes of a weight row at columns n..n+3 (columns past N read as 0)
__device__ __forceinline__ unsigned load_word(const int8_t* p, int n, int N, int vec) {
  if (vec && n + 4 <= N) return *reinterpret_cast<const unsigned*>(p);
  unsigned v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n + j < N) v |= static_cast<unsigned>(static_cast<uint8_t>(p[j])) << (8 * j);
  return v;
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

}  // namespace gemm
