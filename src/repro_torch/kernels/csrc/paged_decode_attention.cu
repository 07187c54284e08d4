// paged_decode_attention: T query rows per lane (T = 1 at decode; the rows of a
// packed t > 1 step in the multi-row form) against the PAGED KV arena, GQA,
// int8 pages with per-(token, head) f32 scales or bf16 pages.
//   q [B, T, Hq, D] bf16|f32; pk/pv [n_pages, ps, Hkv, D] int8 (+ pks/pvs
//   [n_pages, ps, Hkv, 1] f32) or bf16 (no scales); ppos [n_pages, ps] int32
//   (-1 = empty slot); pt [B, MP] int32 page table (0 = the null page);
//   qpos [B, T] int32 (-1 = idle row) -> out [B, T, Hq, D] (q's dtype)
//
// Replaces the Pallas kernel ``repro/kernels/paged_attention.py:94``
// ``paged_decode_attention`` (body ``_kernel``), whose page table rides the
// TPU's scalar prefetch so that each grid step DMAs one physical page.  Bound
// on the H100: bytes — the live pages are read once (at most 2*MP*ps*Hkv*D
// payload bytes per lane plus 8 bytes of scales and 4 of ppos per slot, ~69
// MB per codeqwen1.5-7b step at 8 lanes x 1024 full slots x 32 layers, as
// the dense kernel; tiles with no valid key are skipped) plus the page
// table, for about 4*G flops per byte.
//
// Design: the body of the port's dense kernel, ``decode_tile.cuh``, with key
// j of lane b at page pt[b, j / ps], slot j % ps (the table is read by the
// body's prescan into shared memory ahead of the ``cp.async`` copies of the
// keys' rows; a tile of 32 keys spans two physical pages at ps = 16, which
// need not be adjacent or unshared).  With the dense split (``kv_split(B*Hkv,
// MP*ps)``), the paged kernel over an arena equals the dense kernel over the
// same content laid out densely, BIT FOR BIT, for any live lane: a paged
// drain then gives a dense drain's tokens.  Masking comes from ``ppos`` only
// (a page copied on write keeps ``keep`` valid slots; the null page's are
// -1), never from a lane's length.  Out-of-range table entries clamp into
// the arena, as the reference's oracle clips them.  The merge takes the TPU
// kernel's dead-lane rule: a (lane, head) with no valid slot (an idle lane,
// an all-null table, a window that excludes everything) emits exact zeros
// where the dense kernel averages V.
#include "decode_tile.cuh"

namespace {

// the paged form: key j of lane b is slot j % ps of physical page pt[b, j /
// ps] of the arena; named after the kernel, which profiles list by it
struct paged_decode_attention_kernel {
  static constexpr bool ZERO_DEAD = true;  // a dead (lane, head) emits zeros
  const int32_t* pt;
  int n_pages, ps, mp;
  __device__ __forceinline__ int operator()(int b, int key) const {
    const int page = min(max(pt[static_cast<size_t>(b) * mp + key / ps], 0), n_pages - 1);
    return page * ps + key % ps;
  }
};

template <typename QT, typename KT>
int launch(const void* q, const void* pk, const void* pks, const void* pv, const void* pvs,
           const void* ppos, const void* qpos, void* out, int b, int hq, int hkv, int s_len,
           int d, float scale, int window, int n_split, int chunk, int t_len, int rows,
           void* part, paged_decode_attention_kernel form, cudaStream_t stream) {
  const decode::Args<QT, KT> a{
      static_cast<const QT*>(q), static_cast<const KT*>(pk), static_cast<const float*>(pks),
      static_cast<const KT*>(pv), static_cast<const float*>(pvs),
      static_cast<const int32_t*>(ppos), static_cast<const int32_t*>(qpos),
      static_cast<float*>(part), nullptr, hq, hkv, s_len, d, scale, window, chunk, t_len,
      rows};
  return decode::launch<QT, KT>(a, form, out, b, n_split, stream);
}

template <typename QT>
int launch_pages(int kv_int8, const void* q, const void* pk, const void* pks, const void* pv,
                 const void* pvs, const void* ppos, const void* qpos, void* out, int b,
                 int hq, int hkv, int s_len, int d, float scale, int window, int n_split,
                 int chunk, int t_len, int rows, void* part,
                 paged_decode_attention_kernel form, cudaStream_t stream) {
  if (kv_int8)
    return launch<QT, int8_t>(q, pk, pks, pv, pvs, ppos, qpos, out, b, hq, hkv, s_len, d,
                              scale, window, n_split, chunk, t_len, rows, part, form,
                              stream);
  return launch<QT, __nv_bfloat16>(q, pk, pks, pv, pvs, ppos, qpos, out, b, hq, hkv, s_len, d,
                                   scale, window, n_split, chunk, t_len, rows, part, form,
                                   stream);
}

}  // namespace

// d: a multiple of 16 (int8 pages) or 8 (bf16) with at most 256 bytes a row;
// pk and pv 16-byte aligned
extern "C" int repro_paged_decode_attention(const void* q, int q_bf16, const void* pk,
                                            const void* pks, const void* pv, const void* pvs,
                                            int kv_int8, const void* ppos, const void* pt,
                                            const void* qpos, void* out, int b, int hq,
                                            int hkv, int n_pages, int ps, int mp, int d,
                                            float scale, int window, int n_split, int chunk,
                                            int t_len, int rows, void* part,
                                            void* stream) {
  if (b == 0 || t_len == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const paged_decode_attention_kernel form{static_cast<const int32_t*>(pt), n_pages, ps, mp};
  if (q_bf16)
    return launch_pages<__nv_bfloat16>(kv_int8, q, pk, pks, pv, pvs, ppos, qpos, out, b, hq,
                                       hkv, mp * ps, d, scale, window, n_split, chunk, t_len,
                                       rows, part, form, st);
  return launch_pages<float>(kv_int8, q, pk, pks, pv, pvs, ppos, qpos, out, b, hq, hkv,
                             mp * ps, d, scale, window, n_split, chunk, t_len, rows, part,
                             form, st);
}
