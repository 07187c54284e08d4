// ssd_scan: the chunked Mamba-2 SSD scan, f32.
//   x [B, T, H, P], dt [B, T, H] (softplus'd), A [H] (negative), Bm/Cm [B, T, N]
//   (one per lane, shared by the heads) -> y [B, T, H, P] and the final state
//   [B, H, N, P].  T is a multiple of the chunk L = 128; the scan starts from a
//   zero state.  Per chunk, with cum the in-chunk cumsum of dt*A:
//     y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i . H
//     H   = exp(cum_L) H + sum_j exp(cum_L - cum_j) dt_j B_j x_j^T
//   No D-skip and no gating: those stay in ``models/ssm.py``'s glue.
//
// Replaces the Pallas kernel ``repro/kernels/ssd_scan.py`` ``ssd_scan``
// (body ``_kernel``), whose grid (B*H, chunks) walks the chunks of one head in
// order with the (N, P) state in VMEM scratch, and whose test broadcasts B and
// C over the heads.  Bound on the H100: operations — per (lane, head, chunk)
// about 4 MFLOP of f32 products (the L x L weights' C.B^T, the weights times
// x, C times the state, the state update) against 96 KB of x, B, C read and
// 32 KB of y written; f32 on the CUDA cores (TF32 tensor cores would not keep
// the reference's 3e-4).
//
// Design: one block of 256 threads per (lane, head) carries the state through
// the chunks of its sequence in shared memory — the TPU grid's sequential
// chunk axis becomes a loop inside the block.  Per chunk the block stages the
// x tile [L][P], the lane's B and C tiles [L][N+1] (rows padded so that the 16
// rows a warp reads sit in distinct banks) and dt; warp 0 forms cum with a
// shuffle scan; each thread then computes an 8 x 8 patch of the weights
// W = (C.B^T) o exp(cum_i - cum_j) o dt_j (zero above the diagonal, where the
// reference masks the exponent to -1e30), an 8 x P/16 patch of y (the
// intra-chunk product stops at the thread's last row) plus exp(cum_i) C_i.H,
// and an N/16 x P/16 patch of the new state.  Shared memory at P = N = 64:
// 184 KB, one block per SM; B = 4 lanes x 80 heads of zamba2-2.7b are 320
// blocks.  ``expf`` and IEEE division, no fast math; sums run in other orders
// than the reference's einsums, so the kernel agrees with the plain version
// within rtol = atol = 3e-4 (the reference's own tolerance for its kernel).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int L = 128;   // steps per chunk

template <int P, int N>
struct Layout {          // shared memory, in floats
  static constexpr int BN = N + 1;   // padded B / C row
  static constexpr int LW = L + 1;   // padded weight row
  static constexpr int X = L * P;
  static constexpr int BC = L * BN;
  static constexpr int S = N * P;
  static constexpr int W = L * LW;
  static constexpr int TOTAL = X + 2 * BC + S + W + 4 * L;
};

template <int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ h_out, int t_len, int h_n) {
  using Lay = Layout<P, N>;
  constexpr int BN = Lay::BN, LW = Lay::LW, PC = P / 16, NR = N / 16;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;              // [L][P]   x of the chunk
  float* bs = xs + Lay::X;       // [L][BN]  B of the chunk
  float* cs = bs + Lay::BC;      // [L][BN]  C of the chunk
  float* hs = cs + Lay::BC;      // [N][P]   the state
  float* ws = hs + Lay::S;       // [L][LW]  intra-chunk weights
  float* cum = ws + Lay::W;      // [L]      in-chunk cumsum of dt * A
  float* dts = cum + L;          // [L]      dt
  float* ecum = dts + L;         // [L]      exp(cum_i)
  float* wj = ecum + L;          // [L]      exp(cum_L - cum_j) dt_j

  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.x / h_n, hh = blockIdx.x % h_n;
  const float a_h = a[hh];
  const int t16 = tid / 16, c16 = tid % 16;   // the thread's patch row and column
  for (int i = tid; i < N * P; i += THREADS) hs[i] = 0.0f;

  for (int c0 = 0; c0 < t_len; c0 += L) {
    const size_t t0 = static_cast<size_t>(b) * t_len + c0;   // (lane, step) row of step 0
    // 1. the chunk's tiles (the previous chunk's readers passed its last barrier)
    for (int i = tid; i < L * P; i += THREADS) {
      const int l = i / P, p = i % P;
      xs[i] = x[((t0 + l) * h_n + hh) * P + p];
    }
    for (int i = tid; i < L * N; i += THREADS) {
      const int l = i / N, n = i % N;
      bs[l * BN + n] = bm[(t0 + l) * N + n];
      cs[l * BN + n] = cm[(t0 + l) * N + n];
    }
    for (int l = tid; l < L; l += THREADS) dts[l] = dt[(t0 + l) * h_n + hh];
    __syncthreads();
    // 2. cum: each lane of warp 0 sums 4 steps, then a shuffle scan of the sums
    if (tid < 32) {
      float v[L / 32], run = 0.0f;
#pragma unroll
      for (int k = 0; k < L / 32; ++k) {
        run += dts[lane * (L / 32) + k] * a_h;
        v[k] = run;
      }
      float tot = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, tot, o);
        if (lane >= o) tot += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, tot, 1);
      if (lane == 0) excl = 0.0f;
#pragma unroll
      for (int k = 0; k < L / 32; ++k) cum[lane * (L / 32) + k] = excl + v[k];
    }
    __syncthreads();
    for (int l = tid; l < L; l += THREADS) {
      ecum[l] = expf(cum[l]);
      wj[l] = expf(cum[L - 1] - cum[l]) * dts[l];
    }
    // 3. the weights: rows t16*8 + r, columns c16 + 16*k
    {
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[r][k] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) cv[r] = cs[(t16 * 8 + r) * BN + n];
#pragma unroll
        for (int k = 0; k < 8; ++k) bv[k] = bs[(c16 + 16 * k) * BN + n];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[r][k] = fmaf(cv[r], bv[k], acc[r][k]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = t16 * 8 + r;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int j = c16 + 16 * k;
          ws[i * LW + j] = j <= i ? acc[r][k] * expf(cum[i] - cum[j]) * dts[j] : 0.0f;
        }
      }
    }
    __syncthreads();
    // 4. y: rows t16*8 + r, columns c16 + 16*k
    {
      float acc[8][PC], ch[8][PC];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < PC; ++k) acc[r][k] = 0.0f, ch[r][k] = 0.0f;
      const int j_end = t16 * 8 + 8;   // weights past the thread's last row are 0
      for (int j = 0; j < j_end; ++j) {
        float wv[8], xv[PC];
#pragma unroll
        for (int r = 0; r < 8; ++r) wv[r] = ws[(t16 * 8 + r) * LW + j];
#pragma unroll
        for (int k = 0; k < PC; ++k) xv[k] = xs[j * P + c16 + 16 * k];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int k = 0; k < PC; ++k) acc[r][k] = fmaf(wv[r], xv[k], acc[r][k]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[8], hv[PC];
#pragma unroll
        for (int r = 0; r < 8; ++r) cv[r] = cs[(t16 * 8 + r) * BN + n];
#pragma unroll
        for (int k = 0; k < PC; ++k) hv[k] = hs[n * P + c16 + 16 * k];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int k = 0; k < PC; ++k) ch[r][k] = fmaf(cv[r], hv[k], ch[r][k]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = t16 * 8 + r;
        float* yr = y + ((t0 + i) * h_n + hh) * P + c16;
#pragma unroll
        for (int k = 0; k < PC; ++k) yr[16 * k] = acc[r][k] + ecum[i] * ch[r][k];
      }
    }
    __syncthreads();
    // 5. the state: rows t16 + 16*r, columns c16 + 16*k
    {
      float acc[NR][PC];
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int k = 0; k < PC; ++k) acc[r][k] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < L; ++j) {
        const float w = wj[j];
        float bv[NR], xv[PC];
#pragma unroll
        for (int r = 0; r < NR; ++r) bv[r] = bs[j * BN + t16 + 16 * r] * w;
#pragma unroll
        for (int k = 0; k < PC; ++k) xv[k] = xs[j * P + c16 + 16 * k];
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int k = 0; k < PC; ++k) acc[r][k] = fmaf(bv[r], xv[k], acc[r][k]);
      }
      const float dec = expf(cum[L - 1]);
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int k = 0; k < PC; ++k) {
          float* hp = hs + (t16 + 16 * r) * P + c16 + 16 * k;
          *hp = dec * *hp + acc[r][k];
        }
    }
    __syncthreads();
  }
  float* ho = h_out + static_cast<size_t>(blockIdx.x) * N * P;
  for (int i = tid; i < N * P; i += THREADS) ho[i] = hs[i];
}

template <int P, int N>
int launch(const float* x, const float* dt, const float* a, const float* bm, const float* cm,
           float* y, float* h_out, int b, int t_len, int h_n, cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(float)) * Layout<P, N>::TOTAL;
  auto kern = ssd_scan_kernel<P, N>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<b * h_n, THREADS, smem, st>>>(x, dt, a, bm, cm, y, h_out, t_len, h_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a, const void* bm,
                              const void* cm, void* y, void* h_out, int b, int t_len, int h_n,
                              int p, int n, void* stream) {
  if (b == 0 || h_n == 0) return static_cast<int>(cudaGetLastError());
  if (t_len % L != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const float*>(x);
  const auto* dp = static_cast<const float*>(dt);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(bm);
  const auto* cp = static_cast<const float*>(cm);
  auto* yp = static_cast<float*>(y);
  auto* hp = static_cast<float*>(h_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the model's head width (``_mamba_dims``: 64) and state sizes (64;
  // 16 in the reduced configs)
  if (p == 64 && n == 64) return launch<64, 64>(xp, dp, ap, bp, cp, yp, hp, b, t_len, h_n, st);
  if (p == 64 && n == 16) return launch<64, 16>(xp, dp, ap, bp, cp, yp, hp, b, t_len, h_n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
