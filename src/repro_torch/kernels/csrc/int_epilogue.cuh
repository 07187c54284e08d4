// In-register epilogues of the integer GEMMs.
//
// ``requant_block``, ``gelu_block`` and ``silu_block`` are the CUDA twins of
// ``kernels/common.py`` ``requant_block``, ``kernels/int_gelu.py``
// ``gelu_block`` and ``kernels/int_silu.py`` ``silu_block`` (themselves the
// port of ``repro/kernels/common.py:54``, ``int_gelu.py:36`` and
// ``int_silu.py:32``).  Right shifts of signed ints are arithmetic on nvcc,
// as in JAX; every C++ ``/`` here has a non-negative numerator and a
// positive divisor, so it is the reference's floor division; no value leaves
// int32 (|q*(q_erf+q_one)| < 2^19 and |q*sig| <= 128*127 for int8-range q).
// The stand-alone launches (``requantize.cu``, ``int_gelu.cu``) and the
// ``requant*`` epilogues take any int32, and there the reference's int32
// arithmetic wraps (a GEMM accumulator times the erf term, a bias near the
// int32 range plus the rounding term): those steps are written as unsigned
// arithmetic, which wraps the same way with no undefined behaviour.
//
// The float steps keep the reference's order under ``jax.jit`` on XLA:CPU,
// each rounding written out (nvcc would contract a*b+c otherwise):
//   W8A8 (int8 weights)   p = acc * xs;  h = p * ws   or fma(p, ws, bias)
//   W4A8 (int4 weights)   p = acc * ws;  h = p * xs   or fma(p, xs, bias)
// then the stream dtype (bf16 or f32), and
//   scaled_add   + residual in the stream dtype (one rounding of the f32 sum)
//   scaled_gelu  requant at the static scale (rint(h * f32(1/scale))), GELU
//   gated        act(gate) * up, both rounded to bf16 first, the integer
//                act's payload dequantized by one f32 multiply, one bf16
//                rounding of the product.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

struct GeluConsts {
  int q_b, q_c, q_one;  // erf polynomial constants at the activation scale
  int s1, mult, s2;     // requant to the int8 output scale
};

struct SiluConsts {
  int q_ln2, q_b, q_c;  // shift-exp constants at the activation scale
  int q_one;            // 1.0 in the exp scale
};

struct RequantConsts {
  int s1, mult, s2;  // shift, 16-bit multiplier, shift (each shift in [0, 30])
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// |clamped acc * mult| < 2^15 * 2^15: the multiply and the second rounding
// add stay in int32
__device__ __forceinline__ int requant_block(int acc, int s1, int mult, int s2) {
  if (s1 > 0) acc = wrap_add(acc, 1 << (s1 - 1)) >> s1;
  acc = min(max(acc, -(1 << 15)), (1 << 15) - 1) * mult;
  if (s2 > 0) acc = (acc + (1 << (s2 - 1))) >> s2;
  return min(max(acc, -128), 127);
}

__device__ __forceinline__ int requant_block(int acc, const RequantConsts& r) {
  return requant_block(acc, r.s1, r.mult, r.s2);
}

__device__ __forceinline__ int gelu_block(int q, const GeluConsts& c) {
  const int sgn = (q > 0) - (q < 0);
  const int q_abs = min(abs(q), -c.q_b);
  const int t = q_abs + c.q_b;
  const int q_erf = sgn * (t * t + c.q_c);
  // -(q * (q_erf + q_one)): s_out < 0 in the raw formula
  const int acc = static_cast<int>(0u - static_cast<unsigned>(wrap_mul(q, q_erf + c.q_one)));
  return requant_block(acc, c.s1, c.mult, c.s2);
}

// i_silu: q * i_sigmoid(q), sigmoid from the shift-exp of -|q|
__device__ __forceinline__ int silu_block(int q, const SiluConsts& c) {
  const int qn = -abs(q);                 // <= 0
  int z = (-qn) / c.q_ln2;                // halvings (floor: -qn >= 0)
  const int t = qn + z * c.q_ln2 + c.q_b; // remainder in (-q_ln2, 0], + q_b
  z = min(z, 30);
  const int e = (t * t + c.q_c) >> z;     // exp(-|x|), > 0
  const int denom = max(c.q_one + e, 1);
  const int sig = q >= 0 ? (c.q_one * 127 + (denom >> 1)) / denom
                         : (e * 127 + (denom >> 1)) / denom;
  return q * min(max(sig, 0), 127);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// f32 dequant of an int32 sum: ``first`` is the scale the reference
// multiplies by first (xs for W8A8, ws for W4A8).
__device__ __forceinline__ float dequant(int acc, float first, float second, const float* bias,
                                         int n) {
  const float p = __fmul_rn(__int2float_rn(acc), first);
  return bias ? __fmaf_rn(p, second, bias[n]) : __fmul_rn(p, second);
}

// the reference's seven, in its order (``int8_gemm.EPILOGUES``)
enum {
  EPI_NONE = 0,
  EPI_REQUANT = 1,
  EPI_REQUANT_GELU = 2,
  EPI_REQUANT_ADD = 3,
  EPI_SCALED = 4,
  EPI_SCALED_GELU = 5,
  EPI_SCALED_ADD = 6
};

// the single-stream epilogues (int8_gemm, int4_gemm)
struct Epi {
  int kind;
  int stream_f32;  // 1: f32 stream/out, 0: bf16
  int w_first;     // 1: acc * ws * xs (W4A8), 0: acc * xs * ws (W8A8)
  const float* xs;
  const float* ws;
  const float* bias;
  const void* res;
  void* out;
  float inv_gelu_scale;
  GeluConsts gelu;
  RequantConsts rq;  // requant, requant_add
};

// Epilogue ``e`` of an expert-batched launch moved to expert ``ex``: row
// scales [E, M], column scales [E, N] and outputs [E, M, N] (the batched
// forms take no bias and no residual).
__device__ __forceinline__ Epi epi_at(Epi e, int ex, int M, int N) {
  const size_t mn = static_cast<size_t>(M) * N;
  const int out_bytes = e.kind == EPI_NONE ? 4
                        : (e.kind <= EPI_REQUANT_ADD || e.kind == EPI_SCALED_GELU) ? 1
                        : e.stream_f32 ? 4 : 2;
  if (e.xs) e.xs += static_cast<size_t>(ex) * M;
  if (e.ws) e.ws += static_cast<size_t>(ex) * N;
  e.out = static_cast<char*>(e.out) + mn * ex * out_bytes;
  return e;
}

// ``RQ``: the requant family (int8_gemm only; int8 out), compiled as a
// kernel of its own so that the scaled family's code stays as it was (one
// function holding both, inlined into a thread's 16 outputs, made ptxas take
// minutes per GEMM and the scaled epilogues slower).
template <bool RQ = false>
__device__ __forceinline__ void store_out(const Epi& e, int m, int n, int N, int acc) {
  const size_t idx = static_cast<size_t>(m) * N + n;
  if constexpr (RQ) {
    int q;
    if (e.kind == EPI_REQUANT_GELU) {  // integer GELU of the accumulator itself
      q = gelu_block(acc, e.gelu);
    } else {
      q = requant_block(acc, e.rq);
      if (e.kind == EPI_REQUANT_ADD)   // saturating int8 residual add
        q = min(max(q + static_cast<int>(static_cast<const int8_t*>(e.res)[idx]), -128), 127);
    }
    static_cast<int8_t*>(e.out)[idx] = static_cast<int8_t>(q);
    return;
  }
  if (e.kind == EPI_NONE) {
    static_cast<int32_t*>(e.out)[idx] = acc;
    return;
  }
  const float h = e.w_first ? dequant(acc, e.ws[n], e.xs[m], e.bias, n)
                            : dequant(acc, e.xs[m], e.ws[n], e.bias, n);
  if (e.kind == EPI_SCALED_GELU) {
    const float hs = e.stream_f32 ? h : bf16_round(h);
    float qf = rintf(__fmul_rn(hs, e.inv_gelu_scale));
    qf = fminf(fmaxf(qf, -128.0f), 127.0f);
    static_cast<int8_t*>(e.out)[idx] =
        static_cast<int8_t>(gelu_block(static_cast<int>(qf), e.gelu));
    return;
  }
  if (e.stream_f32) {
    float o = h;
    if (e.kind == EPI_SCALED_ADD) o = __fadd_rn(o, static_cast<const float*>(e.res)[idx]);
    static_cast<float*>(e.out)[idx] = o;
  } else {
    __nv_bfloat16 o = __float2bfloat16_rn(h);
    if (e.kind == EPI_SCALED_ADD) {
      const float r = __bfloat162float(static_cast<const __nv_bfloat16*>(e.res)[idx]);
      o = __float2bfloat16_rn(__fadd_rn(__bfloat162float(o), r));
    }
    static_cast<__nv_bfloat16*>(e.out)[idx] = o;
  }
}

enum { ACT_SILU = 0, ACT_GELU = 1 };

// the integer gate activation at a static scale
struct Act {
  int kind;
  float inv_scale;  // f32(1 / act_scale): the jitted form of g / act_scale
  float out_scale;  // f32(silu_out_scale or gelu_out_scale)
  SiluConsts silu;
  GeluConsts gelu;
};

// act(gate) * up of the integer gated MLP, bf16 out: ``up``/``gate`` are the
// f32 dequantized sums
__device__ __forceinline__ __nv_bfloat16 gated_out(float up, float gate, const Act& a) {
  const float h = bf16_round(up);
  const float g = bf16_round(gate);
  float qf = rintf(__fmul_rn(g, a.inv_scale));
  const int q = static_cast<int>(fminf(fmaxf(qf, -128.0f), 127.0f));
  const int pay = a.kind == ACT_SILU ? silu_block(q, a.silu) : gelu_block(q, a.gelu);
  const float act = bf16_round(__fmul_rn(__int2float_rn(pay), a.out_scale));
  return __float2bfloat16_rn(__fmul_rn(act, h));
}
