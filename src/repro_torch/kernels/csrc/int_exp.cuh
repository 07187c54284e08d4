// Exact reciprocals for the integer softmaxes (int_softmax.cu,
// int8_flash_attention.cu): the halving count -q // q_ln2 of the integer exp
// and the probability's (e * 127 + l // 2) // l are multiply-highs, not
// integer divisions (a 32-bit ``/`` by a runtime divisor is a
// multi-instruction sequence on the card).  ``kernels/common.py`` ``rcp`` is
// the same function on the host: the wrappers pass q_ln2's, the kernels
// compute the exp-sum l's once per row.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// floor(n / d) = (n * m) >> sh for 0 <= n < 2^31 from d's (m, sh) = rcp(d),
// as the high word of the 32 x 32-bit product (2n) * m shifted by sh - 31
// (0 .. 31): the same value without a 64-bit shift, d = 1 (sh = 31) too
__device__ __forceinline__ int div_rcp(unsigned n, unsigned m, int sh) {
  return static_cast<int>(__umulhi(n << 1, m) >> (sh - 31));
}

// the exact reciprocal of d >= 1: sh = 31 + ceil(log2 d), m = ceil(2^sh / d)
// (< 2^32); n * (m * d - 2^sh) < 2^sh for n < 2^31 makes the product exact
__device__ __forceinline__ void rcp(unsigned d, unsigned& m, int& sh) {
  sh = 31 + (d > 1 ? 32 - __clz(d - 1) : 0);
  m = static_cast<unsigned>(((1ull << sh) + d - 1) / d);
}
