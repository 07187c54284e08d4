// int_softmax: the paper's integer softmax over the last axis,
// int8 or int32 payload [M, N] (+ optional int8 keep-mask [M, N]) -> int8 [M, N] in [0, 127].
//
// Replaces the Pallas kernel ``repro/kernels/int_softmax.py`` ``int_softmax``
// (body ``_kernel``), itself ``core.inumerics.i_softmax``.  Bound on the H100:
// bytes (1 or 4 in, 1 out, 1 mask byte per element; the integer work is about
// 15 operations per element).  Design: one block per row; the row is read
// three times (max, exp-sum, output), the later reads from L1/L2; the exp
// constants (q_ln2, q_b, q_c, es) come from the host, computed in Python as
// the reference computes them, never recomputed here.
//
// Bit-exact against the plain version.  The integer exp follows the oracle's
// order (``inumerics.i_exp``): the remainder q_p = qs + z*q_ln2 is formed with
// the unclamped halving count z, which keeps q_p in (-q_ln2, 0] and
// (q_p + q_b)^2 + q_c below 2^31 (the wrapper checks q_b^2 + q_c < 2^31); only
// the shift is clamped to 30.  (The Pallas kernel clamps z first, and for
// scores more than 30*q_ln2 below the row max squares a value past int32.)
// Every ``//`` of the reference has non-negative operands here (-qs >= 0,
// e*127 + l/2 >= 0, l >= 1), so C's truncating ``/`` is the floor division.
// e < 2^14 after the ``es`` shift, so e*127 + l/2 and the row sum stay in
// int32 for rows of up to 2^17 entries (the wrapper checks N).  Rows whose
// values span 2^31 or more wrap in the reference's q - max; the kernel's
// subtraction and square are unsigned, so it wraps there too without
// undefined behaviour, but it does not reproduce such rows.
#include <climits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NEG_INF = -(1 << 24);

struct IntMaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return max(a, b); }
};

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// e = i_exp(max(q - q_max, NEG_INF)) >> es, as ``inumerics.i_softmax``
__device__ __forceinline__ int int_exp(int q, int q_max, int q_ln2, int q_b, int q_c, int es) {
  const int qs = max(wrap_sub(q, q_max), NEG_INF);
  const int z = max(-qs, 0) / q_ln2;
  const unsigned t = static_cast<unsigned>(qs + z * q_ln2) + static_cast<unsigned>(q_b);
  const int poly = static_cast<int>(t * t + static_cast<unsigned>(q_c));
  return (poly >> min(z, 30)) >> es;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
int_softmax_kernel(const T* __restrict__ x, const int8_t* __restrict__ mask,
                   int8_t* __restrict__ out, int n, int q_ln2, int q_b, int q_c, int es) {
  __shared__ int shm[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * n;
  const int8_t* mr = mask == nullptr ? nullptr : mask + row * n;
  int8_t* orow = out + row * n;
  // masked entries take part in the max as NEG_INF, as in the reference
  int m = INT_MIN;
  for (int i = threadIdx.x; i < n; i += THREADS)
    m = max(m, (mr == nullptr || mr[i]) ? static_cast<int>(xr[i]) : NEG_INF);
  m = block_reduce(m, IntMaxOp(), shm);
  int l = 0;
  for (int i = threadIdx.x; i < n; i += THREADS)
    if (mr == nullptr || mr[i]) l += int_exp(static_cast<int>(xr[i]), m, q_ln2, q_b, q_c, es);
  l = max(block_reduce(l, AddOp(), shm), 1);
  const int half = l >> 1;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int e = (mr == nullptr || mr[i])
                      ? int_exp(static_cast<int>(xr[i]), m, q_ln2, q_b, q_c, es) : 0;
    orow[i] = static_cast<int8_t>(min(max((e * 127 + half) / l, 0), 127));
  }
}

}  // namespace

extern "C" int repro_int_softmax(const void* x, int x_i32, const void* mask, void* out, int m,
                                 int n, int q_ln2, int q_b, int q_c, int es, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* mk = static_cast<const int8_t*>(mask);
  int8_t* o = static_cast<int8_t*>(out);
  if (m > 0) {
    if (x_i32)
      int_softmax_kernel<int32_t><<<m, THREADS, 0, st>>>(static_cast<const int32_t*>(x), mk, o,
                                                         n, q_ln2, q_b, q_c, es);
    else
      int_softmax_kernel<int8_t><<<m, THREADS, 0, st>>>(static_cast<const int8_t*>(x), mk, o,
                                                        n, q_ln2, q_b, q_c, es);
  }
  return static_cast<int>(cudaGetLastError());
}
