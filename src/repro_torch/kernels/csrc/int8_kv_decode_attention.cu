// int8_kv_decode_attention: T query rows per lane (T = 1 at decode; the rows of
// a packed t > 1 step in the multi-row form) against the int8 ring KV cache
// with per-(token, head) f32 scales, GQA.
//   q [B, T, Hq, D] bf16|f32, k_q/v_q [B, S, Hkv, D] int8, k_s/v_s [B, S, Hkv, 1] f32,
//   pos_ids [B, S] int32 (-1 = empty slot), qpos [B, T] int32 -> out [B, T, Hq, D]
//
// Replaces the Pallas kernel ``repro/kernels/int8_kv_decode_attention.py``
// ``int8_kv_decode_attention`` (body ``_kernel``).  Bound on the H100: bytes —
// the slots valid for some row are read once as int8 (2*Hkv*D bytes per slot,
// plus the positions of every slot) for about 4*G flops per byte; tiles
// with no valid key are skipped.  The body is ``decode_tile.cuh``'s, shared with
// ``paged_decode_attention``: the TPU grid's sequential KV axis becomes a
// loop inside the block over tiles of BS keys, their raw rows streamed by
// ``cp.async`` through a ring of tiles and dequantized at the point of use,
// split into ``n_split`` contiguous chunks that a second kernel merges.  Key
// j of lane b is slot b*S + j.  A lane with every slot masked averages V
// exactly as the reference's softmax does (no NaN).  The sums run in another
// order than the reference's einsum: results agree to a tolerance, not bit
// for bit.  A row of the multi-row form is bit-equal to a T = 1 launch at its
// position with the same B (the body's note): a lane's tokens do not depend
// on the schedule.
#include "decode_tile.cuh"

namespace {

// the dense form: key j of lane b is slot b*S + j of the [B, S] cache; named
// after the kernel, which profiles list by it
struct int8_kv_decode_attention_kernel {
  static constexpr bool ZERO_DEAD = false;  // a dead row averages V
  int s_len;
  __device__ __forceinline__ int operator()(int b, int key) const { return b * s_len + key; }
};

template <typename QT>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           const void* pos, const void* qpos, void* out, int b, int hq, int hkv, int s_len,
           int d, float scale, int window, int n_split, int chunk, int t_len, int rows,
           void* part, cudaStream_t stream) {
  const decode::Args<QT, int8_t> a{
      static_cast<const QT*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<const int32_t*>(pos),
      static_cast<const int32_t*>(qpos), static_cast<float*>(part), nullptr, hq, hkv, s_len,
      d, scale, window, chunk, t_len, rows};
  return decode::launch<QT, int8_t>(a, int8_kv_decode_attention_kernel{s_len}, out, b,
                                    n_split, stream);
}

}  // namespace

// d: a multiple of 16 up to 256; k_q and v_q 16-byte aligned
extern "C" int repro_int8_kv_decode_attention(const void* q, int q_bf16, const void* kq,
                                              const void* ks, const void* vq, const void* vs,
                                              const void* pos, const void* qpos, void* out,
                                              int b, int hq, int hkv, int s_len, int d,
                                              float scale, int window, int n_split, int chunk,
                                              int t_len, int rows, void* part,
                                              void* stream) {
  if (b == 0 || t_len == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return launch<__nv_bfloat16>(q, kq, ks, vq, vs, pos, qpos, out, b, hq, hkv, s_len, d,
                                 scale, window, n_split, chunk, t_len, rows, part, st);
  return launch<float>(q, kq, ks, vq, vs, pos, qpos, out, b, hq, hkv, s_len, d, scale,
                       window, n_split, chunk, t_len, rows, part, st);
}
