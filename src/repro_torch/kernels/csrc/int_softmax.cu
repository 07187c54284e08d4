// int_softmax: the paper's integer softmax over the last axis,
// int8 or int32 payload [M, N] (+ optional keep-mask, one byte a value,
// nonzero = keep) -> int8 [M, N] in [0, 127].
//
// Replaces the Pallas kernel ``repro/kernels/int_softmax.py`` ``int_softmax``
// (body ``_kernel``), itself ``core.inumerics.i_softmax``.  Bound on the H100:
// bytes (1 or 4 in, 1 out, 1 mask byte per value; about 15 integer
// operations a value).  What held the first form at 18% of that
// bound: a 256-thread block per row with three passes over it and two
// block-wide reductions (at N = 1024, four values a thread: each block a
// chain of dependent latencies), the integer exp computed twice a value, an
// integer division in every exp (/ q_ln2) and in every probability (/ l),
// scalar loads and byte stores.
//
// Design:
// * Row-resident form (N <= ROW_LIMIT = 8192): WPR warps a row (1 up to
//   N = 1024, then 2, 4, 8), 8 / WPR rows a 256-thread block, every row
//   of the launch resident at once.  A lane holds
//   G groups of 16 consecutive values (G = 1 up to N = 512, else 2: at most
//   32 values a lane, in registers).  Each value and mask byte is read once,
//   a group by 16-byte loads (four for int32, one for int8, one for the
//   mask); the row max and the exp-sum are warp reductions
//   (``__reduce_max_sync``, ``__reduce_add_sync``), through shared memory
//   only across the WPR warps of one row; each exp is computed once and kept
//   in registers; a group's 16 probabilities are one 16-byte store.
// * Long-row form (N > ROW_LIMIT, up to the wrapper's 2^17): a 512-thread
//   block per row streams it three times with the same group loads (max,
//   exp-sum, probabilities), four groups a thread in flight (1024 threads,
//   capped at 64 registers, spilled them and ran 36% slower), the exp
//   computed again in the third pass; the second and third reads come from
//   L2 (a row is at most 512 KB).
// * No integer division: the halving count -qs // q_ln2 is a multiply-high
//   by q_ln2's exact reciprocal (from the wrapper, ``common.rcp``), the
//   probability's // l one by l's (``rcp`` of ``int_exp.cuh``, once a row);
//   both exact for numerators below 2^31 (-qs <= 2^24; e * 127 + l / 2 <
//   2^31, which the wrapper checks).  The mask's row r % mask_rows (a mask
//   broadcast over leading dimensions, uncopied) is a multiply-high too.
// * A row that is not a multiple of 16 values, or an operand that is not
//   16-byte aligned, takes scalar loads and stores (``vec`` = 0).
// One call is one launch, whichever form the wrapper picks
// (``int_softmax.form``).
//
// Bit-exact against the plain version.  The integer exp follows the oracle's
// order (``inumerics.i_exp``): the remainder q_p = qs + z*q_ln2 is formed with
// the unclamped halving count z, which keeps q_p in (-q_ln2, 0] and
// (q_p + q_b)^2 + q_c below 2^31 (the wrapper checks q_b^2 + q_c < 2^31); only
// the shift is clamped to 30.  (The Pallas kernel clamps z first, and for
// scores more than 30*q_ln2 below the row max squares a value past int32.)
// e < 2^14 after the ``es`` shift, so e*127 + l/2 and the row sum stay in
// int32 for rows of up to 2^17 entries.  Rows whose values span 2^31 or more
// wrap in the reference's q - max; the kernel's subtraction, square and sums
// are unsigned, so it wraps there too without undefined behaviour, but it
// does not reproduce such rows.
#include <climits>

#include "common.cuh"
#include "int_exp.cuh"

namespace {

constexpr int THREADS = 256;       // the row-resident form's block: 8 warps
constexpr int LONG_THREADS = 512;  // the long-row form's block
constexpr int NEG_INF = -(1 << 24);

struct Args {
  const void* x;
  const uint8_t* mask;  // nullptr: no mask
  int8_t* out;
  int m, n;
  int mask_rows;        // row r reads mask row r % mask_rows
  unsigned mr_m;        // rcp(mask_rows)
  int mr_sh;
  int q_ln2, q_b, q_c, es;
  unsigned ln2_m;       // rcp(q_ln2)
  int ln2_sh;
  int vec;              // n % 16 == 0 and every operand 16-byte aligned
};

struct IntMaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return max(a, b); }
};
struct UAddOp {
  __device__ __forceinline__ unsigned operator()(unsigned a, unsigned b) const { return a + b; }
};

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// e = i_exp(max(q - q_max, NEG_INF)) >> es, as ``inumerics.i_softmax``
__device__ __forceinline__ int int_exp(int q, int q_max, const Args& p) {
  const int qs = max(wrap_sub(q, q_max), NEG_INF);
  const int z = div_rcp(static_cast<unsigned>(max(-qs, 0)), p.ln2_m, p.ln2_sh);
  const unsigned t = static_cast<unsigned>(qs + z * p.q_ln2) + static_cast<unsigned>(p.q_b);
  const int poly = static_cast<int>(t * t + static_cast<unsigned>(p.q_c));
  return (poly >> min(z, 30)) >> p.es;
}

// the oracle's (e * 127 + l // 2) // l clamped to [0, 127]; the numerator
// is non-negative below 2^31 on every row the reference does not wrap (a
// negative one, in a row that does, gives 0 as the first form's did)
__device__ __forceinline__ int prob(int e, int half, unsigned lm, int lsh) {
  const int num = static_cast<int>(static_cast<unsigned>(e) * 127u + static_cast<unsigned>(half));
  return min(div_rcp(static_cast<unsigned>(max(num, 0)), lm, lsh), 127);
}

__device__ __forceinline__ const uint8_t* mask_row(const Args& p, int row) {
  if (p.mask == nullptr) return nullptr;
  const int r = row - div_rcp(static_cast<unsigned>(row), p.mr_m, p.mr_sh) * p.mask_rows;
  return p.mask + static_cast<size_t>(r) * p.n;
}

// 4 mask bytes of 0 or 1 -> 4 keep bits (byte b -> bit b): each byte's
// bit lands in bits 24..27 of the product, no two terms in one bit
__device__ __forceinline__ unsigned keep4(unsigned w) {
  return ((w & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ int lane_byte(unsigned w, int b) {
  return static_cast<int8_t>(static_cast<uint8_t>(w >> (8 * b)));
}

// the 16 values at e0 .. e0 + 15 of a row: v[k] the payload where kept,
// NEG_INF where masked, INT_MIN past the row's end (the max's identity);
// returns the kept bits (bit k: in the row and its mask byte nonzero)
template <typename T>
__device__ __forceinline__ unsigned load_group(const T* __restrict__ xr,
                                               const uint8_t* __restrict__ mr, int e0, int n,
                                               int vec, int (&v)[16]) {
  unsigned keep = 0;
  if (vec) {  // n % 16 == 0: a group is all in the row or all past it
    if (e0 < n) {
      const uint4 w4 = mr != nullptr ? *reinterpret_cast<const uint4*>(mr + e0) : uint4{};
      if constexpr (sizeof(T) == 4) {
        const int4* s = reinterpret_cast<const int4*>(xr + e0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int4 w = s[q];
          v[4 * q] = w.x, v[4 * q + 1] = w.y, v[4 * q + 2] = w.z, v[4 * q + 3] = w.w;
        }
      } else {
        const uint4 w = *reinterpret_cast<const uint4*>(xr + e0);
        const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = lane_byte(ws[k >> 2], k & 3);
      }
      keep = 0xFFFFu;
      if (mr != nullptr)  // the mask's bytes are 0 or 1 (the wrapper's bool)
        keep = keep4(w4.x) | keep4(w4.y) << 4 | keep4(w4.z) << 8 | keep4(w4.w) << 12;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int e = e0 + k;
      if (e < n) {
        v[k] = static_cast<int>(xr[e]);
        if (mr == nullptr || mr[e] != 0) keep |= 1u << k;
      }
    }
  }
  if (keep != 0xFFFFu) {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (!((keep >> k) & 1u)) v[k] = e0 + k < n ? NEG_INF : INT_MIN;
  }
  return keep;
}

// the group's exps in place (0 where not kept); returns their sum.  A
// group wholly kept or wholly dropped (most of them, under a causal mask)
// takes no per-value test.
__device__ __forceinline__ unsigned exp_group(int (&v)[16], unsigned keep, int mx,
                                              const Args& p) {
  unsigned l = 0;
  if (keep == 0xFFFFu) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      v[k] = int_exp(v[k], mx, p);
      l += static_cast<unsigned>(v[k]);
    }
  } else if (keep == 0u) {
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = 0;
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      v[k] = ((keep >> k) & 1u) ? int_exp(v[k], mx, p) : 0;
      l += static_cast<unsigned>(v[k]);
    }
  }
  return l;
}

// a group's 16 probabilities at e0 .. e0 + 15 (past the row's end: none)
__device__ __forceinline__ void store_group(int8_t* __restrict__ orow, int e0, int n, int vec,
                                            const int (&pr)[16]) {
  if (vec) {
    if (e0 < n) {
      unsigned w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = static_cast<unsigned>(pr[4 * q]) | (static_cast<unsigned>(pr[4 * q + 1]) << 8) |
               (static_cast<unsigned>(pr[4 * q + 2]) << 16) |
               (static_cast<unsigned>(pr[4 * q + 3]) << 24);
      *reinterpret_cast<uint4*>(orow + e0) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (e0 + k < n) orow[e0 + k] = static_cast<int8_t>(pr[k]);
  }
}

// Row-resident form: WPR warps a row, each lane G groups of 16 values;
// group g of lane l in the row's warp w starts at 16 * ((g * WPR + w) * 32 + l).
// A block holds 8 / WPR rows, and every row of a launch is resident at once
// (64 registers a thread, four blocks an SM): all loads reach the memory
// system up front, and warps whose rows have landed compute while others
// wait.  (A grid of two blocks an SM, each loading its next rows into a
// second set of registers while it finished the current ones, needed 128
// registers and ran slower.)
template <typename T, int G, int WPR>
__global__ void __launch_bounds__(THREADS) int_softmax_kernel(Args p) {
  constexpr int RPB = THREADS / 32 / WPR;  // rows a block
  __shared__ int red_max[THREADS / 32];
  __shared__ unsigned red_sum[THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * RPB + warp / WPR, wr = warp % WPR;
  const bool live = row < p.m;  // a dead row still joins the block's barriers
  const T* xr = static_cast<const T*>(p.x) + static_cast<size_t>(live ? row : 0) * p.n;
  const uint8_t* mr = mask_row(p, live ? row : 0);
  int8_t* orow = p.out + static_cast<size_t>(live ? row : 0) * p.n;
  const int n = live ? p.n : 0;

  int v[G][16];
  unsigned keep[G];
  int mx = INT_MIN;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    keep[g] = load_group(xr, mr, 16 * ((g * WPR + wr) * 32 + lane), n, p.vec, v[g]);
#pragma unroll
    for (int k = 0; k < 16; ++k) mx = max(mx, v[g][k]);
  }
  mx = __reduce_max_sync(0xffffffffu, mx);
  if constexpr (WPR > 1) {
    if (lane == 0) red_max[warp] = mx;
    __syncthreads();
    mx = red_max[warp - wr];
#pragma unroll
    for (int w = 1; w < WPR; ++w) mx = max(mx, red_max[warp - wr + w]);
  }
  unsigned l = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) l += exp_group(v[g], keep[g], mx, p);
  l = __reduce_add_sync(0xffffffffu, l);
  if constexpr (WPR > 1) {
    if (lane == 0) red_sum[warp] = l;
    __syncthreads();
    l = red_sum[warp - wr];
#pragma unroll
    for (int w = 1; w < WPR; ++w) l += red_sum[warp - wr + w];
  }
  const int ls = max(static_cast<int>(l), 1);
  unsigned lm;
  int lsh;
  rcp(static_cast<unsigned>(ls), lm, lsh);
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int k = 0; k < 16; ++k) v[g][k] = prob(v[g][k], ls >> 1, lm, lsh);
    store_group(orow, 16 * ((g * WPR + wr) * 32 + lane), n, p.vec, v[g]);
  }
}

// Long-row form: a block per row, three streaming passes; each thread
// loads U groups (U * 16 values, U * 64 bytes of int32) before it uses them
template <typename T>
__global__ void __launch_bounds__(LONG_THREADS) int_softmax_long_kernel(Args p) {
  constexpr int U = 4, STEP = 16 * LONG_THREADS;
  __shared__ int red_max[32];
  __shared__ unsigned red_sum[32];
  const int row = blockIdx.x;
  const T* xr = static_cast<const T*>(p.x) + static_cast<size_t>(row) * p.n;
  const uint8_t* mr = mask_row(p, row);
  int8_t* orow = p.out + static_cast<size_t>(row) * p.n;
  int v[U][16];
  unsigned keep[U];
  int mx = INT_MIN;
  for (int b0 = 16 * threadIdx.x; b0 < p.n; b0 += U * STEP) {
#pragma unroll
    for (int u = 0; u < U; ++u) keep[u] = load_group(xr, mr, b0 + u * STEP, p.n, p.vec, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < 16; ++k) mx = max(mx, v[u][k]);
  }
  mx = block_reduce(mx, IntMaxOp(), red_max);
  unsigned l = 0;
  for (int b0 = 16 * threadIdx.x; b0 < p.n; b0 += U * STEP) {
#pragma unroll
    for (int u = 0; u < U; ++u) keep[u] = load_group(xr, mr, b0 + u * STEP, p.n, p.vec, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) l += exp_group(v[u], keep[u], mx, p);
  }
  l = block_reduce(l, UAddOp(), red_sum);
  const int ls = max(static_cast<int>(l), 1);
  unsigned lm;
  int lsh;
  rcp(static_cast<unsigned>(ls), lm, lsh);
  for (int b0 = 16 * threadIdx.x; b0 < p.n; b0 += U * STEP) {
#pragma unroll
    for (int u = 0; u < U; ++u) keep[u] = load_group(xr, mr, b0 + u * STEP, p.n, p.vec, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      exp_group(v[u], keep[u], mx, p);
#pragma unroll
      for (int k = 0; k < 16; ++k) v[u][k] = prob(v[u][k], ls >> 1, lm, lsh);
      store_group(orow, b0 + u * STEP, p.n, p.vec, v[u]);
    }
  }
}

template <typename T>
int launch(const Args& p, int form, cudaStream_t st) {
  // form: 1, 2, 4 or 8 warps a row (G = 1 for form 0 at one warp), or -1: long rows
  switch (form) {
    case 0:
      int_softmax_kernel<T, 1, 1><<<(p.m + 7) / 8, THREADS, 0, st>>>(p);
      break;
    case 1:
      int_softmax_kernel<T, 2, 1><<<(p.m + 7) / 8, THREADS, 0, st>>>(p);
      break;
    case 2:
      int_softmax_kernel<T, 2, 2><<<(p.m + 3) / 4, THREADS, 0, st>>>(p);
      break;
    case 4:
      int_softmax_kernel<T, 2, 4><<<(p.m + 1) / 2, THREADS, 0, st>>>(p);
      break;
    case 8:
      int_softmax_kernel<T, 2, 8><<<p.m, THREADS, 0, st>>>(p);
      break;
    case -1:
      int_softmax_long_kernel<T><<<p.m, LONG_THREADS, 0, st>>>(p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// form: 0 (one warp a row, 16 values a lane), 1, 2, 4, 8 (warps a row, 32
// values a lane) or -1 (a block per row, streamed); ``int_softmax.form``
// picks it from n.  mask_rows: the mask's rows (row r reads r % mask_rows).
extern "C" int repro_int_softmax(const void* x, int x_i32, const void* mask, int mask_rows,
                                 unsigned mr_m, int mr_sh, void* out, int m, int n, int q_ln2,
                                 int q_b, int q_c, int es, unsigned ln2_m, int ln2_sh, int form,
                                 int vec, void* stream) {
  Args p;
  p.x = x;
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<int8_t*>(out);
  p.m = m, p.n = n;
  p.mask_rows = mask_rows, p.mr_m = mr_m, p.mr_sh = mr_sh;
  p.q_ln2 = q_ln2, p.q_b = q_b, p.q_c = q_c, p.es = es;
  p.ln2_m = ln2_m, p.ln2_sh = ln2_sh;
  p.vec = vec;
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_i32 ? launch<int32_t>(p, form, st) : launch<int8_t>(p, form, st);
}
