// int8_kv_decode_attention: one query token per lane against the int8 ring
// KV cache with per-(token, head) f32 scales, GQA.
//   q [B, Hq, D] bf16|f32, k_q/v_q [B, S, Hkv, D] int8, k_s/v_s [B, S, Hkv, 1] f32,
//   pos_ids [B, S] int32 (-1 = empty slot), qpos [B] int32 -> out [B, Hq, D] (q's dtype)
//
// Replaces the Pallas kernel ``repro/kernels/int8_kv_decode_attention.py``
// ``int8_kv_decode_attention`` (body ``_kernel``).  Bound on the H100: bytes —
// the cache is read once as int8 (2*S*Hkv*D bytes per lane) for about 4*G
// flops per byte.  The body is ``decode_tile.cuh``'s, shared with
// ``paged_decode_attention``: the TPU grid's sequential KV axis becomes a
// loop inside the block over tiles of BS keys, split into ``n_split``
// contiguous chunks that a second kernel merges.  Key j of lane b is slot
// b*S + j.  A lane with every slot masked averages V exactly as the
// reference's softmax does (no NaN).  The sums run in another order than the
// reference's einsum: results agree to a tolerance, not bit for bit.
#include "decode_tile.cuh"

namespace {

// key j of lane b: slot b*S + j of the [B, S] cache
struct DenseRows {
  int s_len;
  __device__ __forceinline__ int operator()(int b, int key) const { return b * s_len + key; }
};

}  // namespace

extern "C" int repro_int8_kv_decode_attention(const void* q, int q_bf16, const void* kq,
                                              const void* ks, const void* vq, const void* vs,
                                              const void* pos, const void* qpos, void* out,
                                              int b, int hq, int hkv, int s_len, int d,
                                              float scale, int window, int n_split, int chunk,
                                              void* part, void* stream) {
  if (b == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DenseRows rows{s_len};
  if (q_bf16)
    return decode::launch<__nv_bfloat16, int8_t, false>(q, kq, ks, vq, vs, pos, qpos, out, b,
                                                        hq, hkv, s_len, d, scale, window,
                                                        n_split, chunk, part, rows, st);
  return decode::launch<float, int8_t, false>(q, kq, ks, vq, vs, pos, qpos, out, b, hq, hkv,
                                              s_len, d, scale, window, n_split, chunk, part,
                                              rows, st);
}
