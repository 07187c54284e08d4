// flash_attention: bf16 attention forward with an f32 online softmax.
//   q bf16 [B*H, S, D], k/v bf16 [B*Hkv, Skv, D] (GQA: query head h reads kv head
//   h / (H/Hkv)) -> out bf16 [B*H, S, D];  out = softmax(q k^T * scale [+ causal mask]) v
//
// Replaces the Pallas kernel ``repro/kernels/flash_attention.py``
// ``flash_attention`` (body ``_kernel``).  Bound on the H100: operations — 4*S*Skv*D
// flops per head (halved by the causal mask) at the bf16 tensor-core rate,
// against 8*S*D bytes; a kernel that keeps S and P out of device memory
// and feeds the tensor cores from shared memory while the next K/V tiles
// are in flight runs near that bound.
//
// Design (FA2-class, ``mma.sync`` since ``wgmma`` wants a warpgroup of 64 rows
// per product and this first tensor-core form keeps one warp per 16 rows):
// * one block of 4 warps per (BQ = 64 query rows, head); warp w owns rows
//   16w..16w+15 and keeps their Q fragments in registers (``ldmatrix``
//   once), their f32 accumulator (16 x D) and running (m, l); two blocks
//   fit an SM (~200 registers a thread, 87 KB of shared memory at D = 128);
// * K and V tiles of BK = 64 keys stream through a 2-stage ring of 16-byte
//   ``cp.async.cg`` copies, bf16 in shared memory, rows padded by one
//   16-byte chunk (an odd row stride in chunks: ``ldmatrix``'s eight rows
//   fall on eight distinct bank groups for every D, 80 among them, where an
//   XOR swizzle would need a power-of-two chunk count); the copy of tile
//   j + 1 is in flight while tile j is computed, one barrier per tile
//   (8 warps over 128 rows, or a 3-stage ring, ran slower on the card);
// * S = Q K^T with ``mma.sync.m16n8k16`` (bf16 in, f32 sums; K fragments by
//   ``ldmatrix``), scaled, masked and reduced in registers (the row max and
//   sum over a lane quad with ``__shfl_xor_sync``);  P = exp(S - m) is
//   split in registers into bf16 hi = bf16(P) and lo = bf16(P - hi), each
//   used directly as the A fragment of O += P V (the accumulator layout of
//   two adjacent 8-key tiles is the A layout of one 16-key step; V fragments
//   by ``ldmatrix.trans``, shared by the two products); P never touches
//   shared memory;  l sums the f32 probabilities;
// * causal: key tiles wholly above the block's rows are not loaded, a warp
//   skips a tile wholly above its own rows, and only tiles crossing a warp's
//   diagonal (or the key count) are masked, at the reference's -1e30, whose
//   probabilities are exactly 0;  blocks run longest-first;
// * out = acc / max(l, 1e-30) rounded once to bf16, staged in the warp's own
//   Q rows and written with 16-byte stores.
// D is a template argument: any multiple of 16 up to 128 (the QK^T depth
// steps by 16, the output width by 8).
// Gradients: no backward kernel.  The reference has none (it trains
// through ``ref.flash_attention_ref`` and XLA's autodiff); the wrapper runs
// this forward inside a torch.autograd.Function whose backward is autograd
// of the plain version recomputed from the saved q/k/v
// (``kernels/flash_attention.py``).
//
// Numerics: the bf16 products are exact in f32 and only their summation
// order differs from the plain version; exp(x) is ``exp2f(x * log2 e)``.
// P in one bf16 term (what a TPU does: an f32 ``dot_general`` at default
// precision is one bf16 pass) misses rtol 2^-7, atol 1e-3 on early causal
// rows, where one probability carries the row (2^-9 of it times |v|);
// hi + lo carries P to 2^-17 for a third more tensor-core work
// (``flash_attention_tiled_ref`` is this order in plain PyTorch).  Kernel
// and plain version agree within rtol 2^-7, atol 1e-3.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int STAGES = 2;       // K/V tiles in the ring
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int LD = D + 8;          // row stride in bf16 (odd in 16-byte chunks)
  static constexpr int Q = BQ * LD;         // the block's query rows
  static constexpr int KV = BK * LD;        // one K or V tile
  static constexpr int BYTES = 2 * (Q + STAGES * 2 * KV);
};

// rows row0 .. row0 + N_ROWS - 1 of a [n_rows, D] bf16 matrix into shared
// [N_ROWS][LD]; rows at or past n_rows are zero-filled
template <int D, int N_ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int n_rows) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < N_ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < n_rows;
    const __nv_bfloat16* s = src + static_cast<size_t>(ok ? row0 + r : 0) * D + c * 8;
    wmma::cp_async_16(dst + r * Layout<D>::LD + c * 8, s, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       int h, int hkv, int s, int skv, float scale, int causal) {
  constexpr int LD = Layout<D>::LD, KV = Layout<D>::KV;
  constexpr int KD = D / 16;   // 16-deep steps of QK^T
  constexpr int ND = D / 8;    // 8-wide output tiles
  constexpr int NK = BK / 8;   // 8-key score tiles
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kvs = qs + Layout<D>::Q;   // STAGES x (K tile, V tile)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal blocks first
  const int grp = h / hkv;
  const size_t kvh = static_cast<size_t>(bh / h) * hkv + (bh % h) / grp;
  const __nv_bfloat16* qg = q + static_cast<size_t>(bh) * s * D;
  const __nv_bfloat16* kg = k + kvh * skv * D;
  const __nv_bfloat16* vg = v + kvh * skv * D;
  const int n_keys = causal ? min(skv, q0 + BQ) : skv;
  const int n_tiles = (n_keys + BK - 1) / BK;
  const int wrow0 = q0 + 16 * warp;  // this warp's first query row

  load_rows<D, BQ>(qs, qg, q0, s);
  wmma::cp_async_commit();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) {
      __nv_bfloat16* ks = kvs + st * 2 * KV;
      load_rows<D, BK>(ks, kg, st * BK, skv);
      load_rows<D, BK>(ks + KV, vg, st * BK, skv);
    }
    wmma::cp_async_commit();
  }
  wmma::cp_async_wait<STAGES - 1>();  // Q has landed
  __syncthreads();
  uint32_t qf[KD][4];
  {
    const __nv_bfloat16* row =
        qs + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) wmma::ldmatrix_x4(qf[kk], row + 16 * kk);
  }

  float o[ND][4], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    wmma::cp_async_wait<STAGES - 2>();  // tile it has landed (this thread's copies)
    __syncthreads();                    // ... everyone's; tile it - 1 is consumed
    {
      const int nt = it + STAGES - 1;   // refill the stage tile it - 1 used
      if (nt < n_tiles) {
        __nv_bfloat16* ks = kvs + (nt % STAGES) * 2 * KV;
        load_rows<D, BK>(ks, kg, nt * BK, skv);
        load_rows<D, BK>(ks + KV, vg, nt * BK, skv);
      }
      wmma::cp_async_commit();
    }
    const int k0 = it * BK;
    if (causal && k0 > wrow0 + 15) continue;  // every key above this warp's rows
    const __nv_bfloat16* ks = kvs + (it % STAGES) * 2 * KV;
    const __nv_bfloat16* vs = ks + KV;

    // S = Q K^T: 16 rows x 64 keys, f32
    float sc[NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    {
      const __nv_bfloat16* row = ks + ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          uint32_t b[4];
          wmma::ldmatrix_x4(b, row + 16 * np * LD + 16 * kk);
          wmma::mma_bf16_16816(sc[2 * np], qf[kk], b[0], b[1]);
          wmma::mma_bf16_16816(sc[2 * np + 1], qf[kk], b[2], b[3]);
        }
    }

    // scale, mask, online softmax (rows g and g + 8 of the warp)
    const bool masked = (causal && k0 + BK - 1 > wrow0) || k0 + BK > skv;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nt][e] * scale;
        if (masked) {
          const int key = k0 + 8 * nt + 2 * t + (e & 1);
          const int row = wrow0 + g + 8 * (e >> 1);
          if (key >= skv || (causal && key > row)) x = NEG;
        }
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f((m[r] - m_new) * LOG2E);
      m[r] = m_new;
    }
    uint32_t ph[NK][2], pl[NK][2];  // P = hi + lo in bf16: rows g, g + 8 of each 8-key tile
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      const float p0 = exp2f((sc[nt][0] - m[0]) * LOG2E);
      const float p1 = exp2f((sc[nt][1] - m[0]) * LOG2E);
      const float p2 = exp2f((sc[nt][2] - m[1]) * LOG2E);
      const float p3 = exp2f((sc[nt][3] - m[1]) * LOG2E);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      wmma::split_bf16(p0, p1, ph[nt][0], pl[nt][0]);
      wmma::split_bf16(p2, p3, ph[nt][1], pl[nt][1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];  // this lane's share
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V: 16 rows x D, 16 keys per step
    {
      const __nv_bfloat16* row = vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t ah[4] = {ph[2 * kk][0], ph[2 * kk][1], ph[2 * kk + 1][0],
                                ph[2 * kk + 1][1]};
        const uint32_t al[4] = {pl[2 * kk][0], pl[2 * kk][1], pl[2 * kk + 1][0],
                                pl[2 * kk + 1][1]};
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t b[4];
          wmma::ldmatrix_x4_trans(b, row + 16 * kk * LD + 16 * dp);
          wmma::mma_bf16_16816(o[2 * dp], ah, b[0], b[1]);
          wmma::mma_bf16_16816(o[2 * dp + 1], ah, b[2], b[3]);
          wmma::mma_bf16_16816(o[2 * dp], al, b[0], b[1]);
          wmma::mma_bf16_16816(o[2 * dp + 1], al, b[2], b[3]);
        }
      }
    }
  }

  // out = acc / max(l, 1e-30), through the warp's own Q rows (no longer read)
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* os = qs + 16 * warp * LD;
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    *reinterpret_cast<uint32_t*>(os + g * LD + 8 * dt + 2 * t) =
        wmma::pack_bf16(o[dt][0] / den[0], o[dt][1] / den[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + 8 * dt + 2 * t) =
        wmma::pack_bf16(o[dt][2] / den[1], o[dt][3] / den[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * ND; i += 32) {
    const int r = i / ND, c = i % ND;
    if (wrow0 + r < s)
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(bh) * s + wrow0 + r) * D + 8 * c) =
          *reinterpret_cast<const uint4*>(os + r * LD + 8 * c);
  }
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           __nv_bfloat16* out, int bh, int h, int hkv, int s, int skv, float scale, int causal,
           cudaStream_t st) {
  const int smem = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BQ - 1) / BQ, bh);
  flash_attention_kernel<D><<<grid, THREADS, smem, st>>>(q, k, v, out, h, hkv, s, skv, scale,
                                                         causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int b, int h, int hkv, int s, int skv, int d, float scale,
                                     int causal, void* stream) {
  if (b == 0 || s == 0) return static_cast<int>(cudaGetLastError());
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {   // any head dim that is a multiple of 16 up to 128
#define REPRO_FA_CASE(D) \
  case D: return launch<D>(qp, kp, vp, op, b * h, h, hkv, s, skv, scale, causal, st);
    REPRO_FA_CASE(16) REPRO_FA_CASE(32) REPRO_FA_CASE(48) REPRO_FA_CASE(64)
    REPRO_FA_CASE(80) REPRO_FA_CASE(96) REPRO_FA_CASE(112) REPRO_FA_CASE(128)
#undef REPRO_FA_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
