// In-register integer epilogues: CUDA twins of ``kernels/common.py``
// ``requant_block`` and ``kernels/int_gelu.py`` ``gelu_block`` (themselves
// the port of ``repro/kernels/common.py:54`` and ``int_gelu.py:36``).
//
// Right shifts of signed ints are arithmetic on nvcc, as in JAX; no value
// here leaves int32 (|q*(q_erf+q_one)| < 2^19 for int8-range q).
#pragma once
#include <stdint.h>

struct GeluConsts {
  int q_b, q_c, q_one;  // erf polynomial constants at the activation scale
  int s1, mult, s2;     // requant to the int8 output scale
};

__device__ __forceinline__ int requant_block(int acc, int s1, int mult, int s2) {
  if (s1 > 0) acc = (acc + (1 << (s1 - 1))) >> s1;
  acc = min(max(acc, -(1 << 15)), (1 << 15) - 1) * mult;
  if (s2 > 0) acc = (acc + (1 << (s2 - 1))) >> s2;
  return min(max(acc, -128), 127);
}

__device__ __forceinline__ int gelu_block(int q, const GeluConsts& c) {
  const int sgn = (q > 0) - (q < 0);
  const int q_abs = min(abs(q), -c.q_b);
  const int t = q_abs + c.q_b;
  const int q_erf = sgn * (t * t + c.q_c);
  const int acc = -(q * (q_erf + c.q_one));  // s_out < 0 in the raw formula
  return requant_block(acc, c.s1, c.mult, c.s2);
}
