// int8_conv2d: x int8 [N, H, W, C] (NHWC) * w int8 [KH, KW, C, O] (HWIO),
// stride 1, VALID, + bias int32 [O] -> int32 [N, OH, OW, O], or int8 through
// ``requant_block`` (shift, int16 clip, 16-bit multiply, shift), the paper's
// ``conv``.
//
// Replaces the Pallas kernel ``repro/kernels/conv2d.py`` ``int8_conv2d``
// (body ``_kernel``).  The TPU kernel holds a whole image in VMEM and runs
// KH*KW channel contractions on the MXU.  Bound on the H100: bytes for the
// patch embed (a 1x1 conv over 768 channels reads each input and weight byte
// once for 768 or 6272 multiply-adds, and writes int32), operations for a 3x3
// conv over 64 channels.  Design, simple first: an implicit GEMM on the
// SIMT tiles of ``gemm_tile.cuh`` (its only user): the rows are the
// N*OH*OW output pixels, the columns the O output channels, the depth the
// KH*KW*Cp window (C zero-padded to Cp, a multiple of 4, so every
// ``__dp4a`` word holds four channels of one tap: the Table II input has
// C = 3).  A block owns 64 pixels
// x 64 channels and stages, per 64-deep step, its pixels' window words in
// shared memory (one 4-byte load per word when C % 4 == 0) and the matching
// weight rows transposed in registers (``store_cols``); 256 threads keep 4x4
// int32 sums each.  The epilogue adds the bias (int32, wrapping as the
// reference's add does) and requantizes in-register.  No ``wgmma`` or TMA yet.
//
// Exact: every product and sum is an integer; the int32 sums never wrap for
// KH*KW*C*128*128 < 2^31 (the wrapper checks).
#include "gemm_tile.cuh"
#include "int_epilogue.cuh"

namespace {

using gemm::BK;
using gemm::BM;
using gemm::BN;
using gemm::KW;

struct Conv {
  const int8_t* x;
  const int8_t* w;
  const int32_t* bias;
  void* out;
  int H, W, C, KWd, O, OW, OHW;
  int Cp;      // C padded to a multiple of 4
  int M;       // N * OH * OW output pixels
  int K;       // KH * KW * Cp padded window depth
  int requant;
  RequantConsts rq;
  int vec_x;   // C % 4 == 0 and x 4-byte aligned: a window word is one load
  int vec_w;   // O % 4 == 0 and w 4-byte aligned: a weight row word is one load
};

// 4 channels c..c+3 of one tap of the window at ``px`` (the pixel's top-left
// input), at padded depth k = (i * KW + j) * Cp + c; 0 past K or C
__device__ __forceinline__ unsigned window_word(const Conv& p, const int8_t* px, int k) {
  if (k >= p.K) return 0u;
  const int c = k % p.Cp, ij = k / p.Cp;
  const int i = ij / p.KWd, j = ij - i * p.KWd;
  const int8_t* src = px + (static_cast<size_t>(i) * p.W + j) * p.C + c;
  if (p.vec_x) return *reinterpret_cast<const unsigned*>(src);
  unsigned v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (c + b < p.C) v |= static_cast<unsigned>(static_cast<uint8_t>(src[b])) << (8 * b);
  return v;
}

__global__ void __launch_bounds__(gemm::THREADS) int8_conv2d_kernel(Conv p) {
  __shared__ int32_t As[BM][KW + 1];  // As[m][kw]: window of pixel m0+m at depth k0+4kw
  __shared__ int32_t Bs[BN][KW + 1];  // Bs[n][kw]: w rows k0+4kw .. +3, channel n0+n
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const bool active = m0 + ty < p.M;

  // the pixel whose window words this thread stages: row ar, words aw..aw+3
  const int ar = tid >> 2, aw = (tid & 3) * 4;
  const int8_t* px = nullptr;
  if (m0 + ar < p.M) {
    const int m = m0 + ar, img = m / p.OHW, oy = (m % p.OHW) / p.OW, ox = m % p.OW;
    px = p.x + ((static_cast<size_t>(img) * p.H + oy) * p.W + ox) * p.C;
  }
  // the weight block this thread stages: depth rows bk..bk+3, channels nw..nw+3
  const int bk = (tid >> 4) * 4, nw = n0 + (tid & 15) * 4;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      As[ar][aw + u] = px ? static_cast<int>(window_word(p, px, k0 + 4 * (aw + u))) : 0;
    unsigned r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + bk + i, c = kp % p.Cp;
      const size_t row = static_cast<size_t>(kp / p.Cp) * p.C + c;  // HWIO row of (tap, c)
      r[i] = (kp < p.K && c < p.C) ? gemm::load_word(p.w + row * p.O + nw, nw, p.O, p.vec_w)
                                   : 0u;
    }
    gemm::store_cols(Bs, r);
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
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = gemm::out_m(i), n = gemm::out_n(j);
      if (m >= p.M || n >= p.O) continue;
      const size_t o = static_cast<size_t>(m) * p.O + n;
      const int v = wrap_add(acc[i][j], p.bias[n]);
      if (p.requant)
        static_cast<int8_t*>(p.out)[o] = static_cast<int8_t>(requant_block(v, p.rq));
      else
        static_cast<int32_t*>(p.out)[o] = v;
    }
}

}  // namespace

extern "C" int repro_int8_conv2d(const void* x, const void* w, const void* bias, void* out,
                                 int n, int h, int wd, int c, int kh, int kw, int o,
                                 int requant, int s1, int mult, int s2, int vec_x, int vec_w,
                                 void* stream) {
  Conv p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.bias = static_cast<const int32_t*>(bias);
  p.out = out;
  p.H = h, p.W = wd, p.C = c, p.KWd = kw, p.O = o;
  const int oh = h - kh + 1;
  p.OW = wd - kw + 1;
  p.OHW = oh * p.OW;
  p.Cp = (c + 3) / 4 * 4;
  p.M = n * p.OHW;
  p.K = kh * kw * p.Cp;
  p.requant = requant;
  p.rq = RequantConsts{s1, mult, s2};
  p.vec_x = vec_x, p.vec_w = vec_w;
  if (p.M > 0 && o > 0) {
    const dim3 grid((o + BN - 1) / BN, (p.M + BM - 1) / BM);
    int8_conv2d_kernel<<<grid, gemm::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
