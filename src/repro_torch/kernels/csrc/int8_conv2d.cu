// int8_conv2d: x int8 [N, H, W, C] (NHWC) * w int8 [KH, KW, C, O] (HWIO),
// stride 1, VALID, + bias int32 [O] -> int32 [N, OH, OW, O], or int8 through
// ``requant_block`` (shift, int16 clip, 16-bit multiply, shift), the paper's
// ``conv``.
//
// Replaces the Pallas kernel ``repro/kernels/conv2d.py`` ``int8_conv2d``
// (body ``_kernel``).  The TPU kernel holds a whole image in VMEM and runs
// KH*KW channel contractions on the MXU.  Bound on the H100: bytes for the
// patch embed (a 1x1 conv over 768 channels reads each input and weight byte
// once for 768 or 6272 multiply-adds, and writes int32: 19.3 of its 24.7 MB
// are the output) and for a 3x3 conv over 64 channels (its int32 output
// again), operations only for wide O and deep windows.  What held the first
// form, on SIMT tiles of its own, at 5% of that bound: ``__dp4a`` on the
// CUDA cores with 2 shared loads per 4 products, stages loaded through
// registers between two barriers, two divisions and a modulo per 4-byte
// window word and per weight word, the weight tile transposed in registers,
// and 4 x 4 scattered int32 stores a thread.
//
// Design: an implicit GEMM on the tensor-core loop of ``gemm_mma.cuh``
// (``mainloop<C, W8, 1, ConvA<C>>``): rows are the N*OH*OW output pixels,
// columns the O output channels, depth the KH*KW*C window; products on
// ``mma.sync.m16n8k32`` s8 x s8 -> s32 through the 4-stage ``cp.async``
// ring.  The HWIO weight is the [K, N] matrix the W8 stage reads as it is
// (row (i*KW + j)*C + c).  The A stage is gathered (``ConvA``): pixel m and
// depth k map to x + ((img*H + oy + i)*W + ox + j)*C + c; each thread
// computes its rows' pixel bases once per block, and walks its chunk's
// window position by BK a stage without a division.  Within window row i
// the taps j and channels c are KW*C contiguous bytes, so where C % 16 == 0
// and x is 16-byte aligned each 16-byte chunk is one ``cp.async.cg`` (at
// 3x3 over C = 64, a 64-deep stage is one tap); otherwise (C = 3, ragged C,
// an unaligned x) the chunk fills by byte loads, the depth zero-padded to the
// mma's k.  The weight stage is ``cp.async`` where O % 16 == 0 and w is
// aligned, else byte loads.  The epilogue runs in registers: the bias added
// with the reference's int32 wrap, then int32 out, or ``requant_block`` to
// int8; a lane's four consecutive columns (4t .. 4t + 3 of a row) leave as
// one 16-byte (int32) or 4-byte (int8) store where O % 4 == 0.  Tiles: the
// wrapper picks (``conv2d.tiling``; ``scripts/chip_probe.py conv`` times
// them all).
//
// Exact: every product and sum is an integer; the int32 sums never wrap for
// KH*KW*C*128*128 < 2^31 (the wrapper checks).
#include "gemm_mma.cuh"
#include "int_epilogue.cuh"

namespace {

using mma_gemm::W8;

// the tilings ``conv2d.CONFIGS`` names: (BM, BN) and the blocks an SM the
// launch bounds ask for
using Wide = mma_gemm::WidePrefill;         // 128 x 128, 8 warps of 64 x 32
using Prefill = mma_gemm::Prefill;          // 64 x 128, 8 warps of 32 x 32, 2 an SM
using Third = mma_gemm::Cfg<3, 4, 2, 2, 2>;   // 96 x 128, 12 warps of 32 x 32, 2 an SM
using Narrow = mma_gemm::Cfg<4, 2, 2, 2, 2>;  // 128 x 64, 8 warps of 32 x 32, 2 an SM
using Half = mma_gemm::Cfg<4, 2, 1, 2, 4>;    // 64 x 64, 8 warps of 16 x 32, 4 an SM
using Tiny = mma_gemm::Cfg<4, 1, 1, 1, 4>;    // 64 x 16, 4 warps of 16 x 16, 4 an SM

struct Conv {
  const int8_t* x;
  const int8_t* w;
  const int32_t* bias;
  void* out;
  int H, W, C, KWd, O, OW, OHW;
  int M;         // N * OH * OW output pixels
  int K;         // KH * KW * C window depth
  RequantConsts rq;
  int vec_x;     // C % 16 == 0 and x 16-byte aligned: a window chunk is one cp.async
  int vec_w;     // O % 16 == 0 and w 16-byte aligned: a weight chunk is one cp.async
  int vec_out;   // O % 4 == 0: a lane's 4 columns are one store
};

// The gathered A source: this thread's stage rows r_t + j * RS (j < R) and
// its 16-byte chunk at column c of each, as ``load_tile`` assigns them.
// kk is the chunk's depth in the stage ``load`` is next called for; the
// depth lies in window row i = kk / (KW*C), at byte rem = kk - i*KW*C of the
// row's contiguous KW*C bytes, which start at seg = i*W*C past the pixel.
template <class C>
struct ConvA {
  static constexpr int CH = W8::BK / 16, RS = C::THREADS / CH, R = (C::BM + RS - 1) / RS;
  const int8_t* px[R];  // the rows' pixels (the window's top-left input); nullptr past M
  int kwc, wc, vec;
  int kk, seg, rem;

  __device__ __forceinline__ explicit ConvA(const Conv& p)
      : kwc(p.KWd * p.C), wc(p.W * p.C), vec(p.vec_x) {
    const int r_t = threadIdx.x / CH, c = 16 * (threadIdx.x % CH);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = r_t + j * RS, m = blockIdx.y * C::BM + r;
      px[j] = nullptr;
      if ((C::BM % RS == 0 || r < C::BM) && m < p.M) {
        const int img = m / p.OHW, q = m - img * p.OHW, oy = q / p.OW, ox = q - oy * p.OW;
        px[j] = p.x + ((static_cast<size_t>(img) * p.H + oy) * p.W + ox) * p.C;
      }
    }
    kk = c;
    const int i = c / kwc;
    seg = i * wc;
    rem = c - i * kwc;
  }

  // the stage at depth k0 (= kk - c: stages come in order from depth 0)
  template <class C2, class B>
  __device__ __forceinline__ void load(uint8_t* dst, int lda, const uint8_t* __restrict__ x,
                                       int, int, int, int kend, int) {
    const int r_t = threadIdx.x / CH, c = 16 * (threadIdx.x % CH);
    uint8_t* d0 = dst + r_t * lda + c;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (C::BM % RS != 0 && r_t + j * RS >= C::BM) break;
      uint8_t* d = d0 + j * RS * lda;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(px[j]);
      if (vec) {  // kend = K is a multiple of 16: a chunk is all in or all out
        const bool in = src != nullptr && kk < kend;
        wmma::cp_async_16(d, in ? src + seg + rem : x, in ? 16 : 0);
      } else {
        int s = seg, q = rem;
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          d[b] = (src != nullptr && kk + b < kend) ? src[s + q] : 0;
          if (++q == kwc) q = 0, s += wc;
        }
      }
    }
    kk += W8::BK;
    rem += W8::BK;
    while (rem >= kwc) rem -= kwc, seg += wc;
  }
};

template <class C, bool RQ>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS) int8_conv2d_kernel(Conv p) {
  const mma_gemm::Streams<1> s{{p.w}, {nullptr}};
  mma_gemm::Acc<C, W8, 1> acc;
  mma_gemm::mainloop<C, W8, 1>(p.x, s, p.M, p.O, p.K, 0, mma_gemm::Slice(1), p.K, p.vec_w,
                               nullptr, nullptr, acc, ConvA<C>(p));
#pragma unroll
  for (int j = 0; j < C::NP; ++j) {
    // lane (g, t) holds columns n .. n + 3 of rows g and g + 8 of each m tile
    const int n = mma_gemm::out_col<C, W8>(j, 0, 0);
    int b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = n + q < p.O ? p.bias[n + q] : 0;
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mma_gemm::out_row<C>(i, 2 * h);
        if (m >= p.M) continue;
        int v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // column n + q: even/odd q & 1, fragment 2h + q / 2
          v[q] = wrap_add(acc[0][i][j][q & 1][2 * h + (q >> 1)], b[q]);
          if (RQ) v[q] = requant_block(v[q], p.rq);
        }
        const size_t o = static_cast<size_t>(m) * p.O + n;
        if (RQ) {
          int8_t* out = static_cast<int8_t*>(p.out) + o;
          if (p.vec_out && n + 3 < p.O) {
            *reinterpret_cast<unsigned*>(out) =
                (static_cast<unsigned>(v[0]) & 0xFFu) | ((static_cast<unsigned>(v[1]) & 0xFFu) << 8) |
                ((static_cast<unsigned>(v[2]) & 0xFFu) << 16) | (static_cast<unsigned>(v[3]) << 24);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (n + q < p.O) out[q] = static_cast<int8_t>(v[q]);
          }
        } else {
          int32_t* out = static_cast<int32_t*>(p.out) + o;
          if (p.vec_out && n + 3 < p.O) {
            *reinterpret_cast<int4*>(out) = make_int4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (n + q < p.O) out[q] = v[q];
          }
        }
      }
  }
}

template <class C, bool RQ>
int launch(const Conv& p, cudaStream_t stream) {
  const int smem = mma_gemm::Stage<C, W8, 1>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(int8_conv2d_kernel<C, RQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.O + C::BN - 1) / C::BN, (p.M + C::BM - 1) / C::BM);
  int8_conv2d_kernel<C, RQ><<<grid, C::THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool RQ>
int launch_tile(const Conv& p, int bm, int bn, cudaStream_t stream) {
  if (bm == Wide::BM && bn == Wide::BN) return launch<Wide, RQ>(p, stream);
  if (bm == Prefill::BM && bn == Prefill::BN) return launch<Prefill, RQ>(p, stream);
  if (bm == Third::BM && bn == Third::BN) return launch<Third, RQ>(p, stream);
  if (bm == Narrow::BM && bn == Narrow::BN) return launch<Narrow, RQ>(p, stream);
  if (bm == Half::BM && bn == Half::BN) return launch<Half, RQ>(p, stream);
  if (bm == Tiny::BM && bn == Tiny::BN) return launch<Tiny, RQ>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// (bm, bn): one of the tilings above (anything else returns
// cudaErrorInvalidValue); vec_x, vec_w, vec_out as ``Conv`` states them
extern "C" int repro_int8_conv2d(const void* x, const void* w, const void* bias, void* out,
                                 int n, int h, int wd, int c, int kh, int kw, int o,
                                 int requant, int s1, int mult, int s2, int bm, int bn,
                                 int vec_x, int vec_w, int vec_out, void* stream) {
  Conv p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.bias = static_cast<const int32_t*>(bias);
  p.out = out;
  p.H = h, p.W = wd, p.C = c, p.KWd = kw, p.O = o;
  const int oh = h - kh + 1;
  p.OW = wd - kw + 1;
  p.OHW = oh * p.OW;
  p.M = n * p.OHW;
  p.K = kh * kw * c;
  p.rq = RequantConsts{s1, mult, s2};
  p.vec_x = vec_x, p.vec_w = vec_w, p.vec_out = vec_out;
  if (p.M <= 0 || o <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return requant ? launch_tile<true>(p, bm, bn, st) : launch_tile<false>(p, bm, bn, st);
}
