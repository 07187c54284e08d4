// bf16_gemm: the float linear of the bf16 models, x [M, K] bf16 @ w [K, N]
// bf16 (+ bias [N] bf16) -> bf16 [M, N]: f32 sums, one rounding to bf16,
// then the bias added in bf16 (one more rounding), as ``layers.linear``
// computes it.
//
// Replaces no Pallas kernel: the reference leaves its float linears to
// XLA's dot (``repro/models/layers.py`` ``linear``), and the port ran them
// as ``torch.matmul``.  It is added because cuBLAS picks its algorithm by
// shape (split K among them), so the column-sharded q/k/v at decode rows and
// the row-sharded ``wo``/``w_out`` at M / tp rows summed K in another order
// than tp 1, and bf16 tensor-parallel serving was not bit-identical to tp 1
// (ROADMAP C20).
//
// Bound on the H100: at decode rows (M <= 64) bytes — every weight byte is
// read once ([8,4096]x[4096,4096]: 33.6 MB, 10 us at 3.35 TB/s); at scoring
// and training rows operations at the bf16 tensor-core rate
// ([4096,4096]x[4096,4096]: 137 G operations, 0.139 ms at 989 TFLOP/s),
// which only ``wgmma`` reaches (``mma.sync``, this kernel's first loop, ran
// at 24-27% of it).  The one K order adds a floor of its own at decode rows:
// an output's K / 16 ``wgmma`` steps depend each on the last (measured
// ~64 ns a step on the H100, 54 us at K = 13440), and no split may hide it.
//
// Design: a Hopper main loop, warp-specialised.
// * Warpgroup 0 is the producer: one thread issues the TMA loads
//   (``cp.async.bulk.tensor.2d``, completion on an ``mbarrier``) of the A
//   tile [BM, 64] (K-major) and the W tile [64, BN] (W as it lies, [K, N]:
//   the weights are never re-laid out, training updates them every step)
//   into a ring of STAGES stages with 128-byte swizzle (64-byte for BN = 32,
//   whose rows are 64 bytes); it gives its registers up (``setmaxnreg``) to
//   the consumers.
// * Warpgroups 1.. are the consumers, 64 rows each: per stage four
//   ``wgmma.mma_async.m64nBNk16.f32.bf16.bf16`` with A K-major and W read as
//   a transposed (N-major) B operand, both from shared memory by
//   descriptor; the f32 sums stay in registers.  One batch of ``wgmma`` is
//   kept in flight: a stage goes back to the producer (its ``empty``
//   barrier) once the batch after it has been issued and its own is done.
// * The epilogue runs on the accumulators in registers: round to bf16, add
//   the bias in bf16, store the rows below M and the columns below N.
// * Tiles (``bf16_gemm.bf16_gemm_tiling``): decode rows, 64 x 32 or 64 x 64
//   blocks, two an SM (96-210 blocks at N = 3072-13440 with no split of K),
//   with >= 32 KB of weight in flight a block; at M <= 8 a stage holds 8 rows
//   of x (1 KB, read by wgmma as all 64 rows) and the ring 12-20 stages;
//   scoring and training rows, 128 x 256, 128 x 128 (two consumers) or
//   64 x 128, whichever leaves the fewest SMs idle in the last wave.  Blocks
//   walk the output in bands of 8 row tiles, so a wave shares its A and W
//   tiles in L2.  A block loads only the rows of x below M (rounded up to 8).
// * The C entry builds both tensor maps per launch with
//   ``cuTensorMapEncodeTiled``, reached through ``cudaGetDriverEntryPoint``
//   (no ``-lcuda``), and passes them as ``__grid_constant__`` parameters.
//   TMA zero-fills rows past M, columns past N and K past the last stage.
//
// Why C20 stays closed: every output element's f32 sum runs from k = 0 to K
// in ``wgmma`` k16 steps, in order, in the registers of the one block that
// owns the element: never split, never combined with atomics.  The tile,
// the ring depth and the block that computes it change nothing in that
// order, and a row of x or a column of w enters no other row's or column's
// sums.  What this rests on, measured on the card rather than documented:
// ``wgmma`` gives an element the same bits at every instruction width N in
// {32, 64, 128, 256} (chip_smoke phase 3 launches every tiling the entry
// takes on the same inputs and requires them ``torch.equal``).  TMA needs
// 16-byte aligned operands and row strides; the wrapper pads a K or N that
// is not a multiple of 8 with zeros (a zero product adds nothing, and the
// real values keep their k16 groups).
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;     // K per stage: one 128-byte swizzle row of bf16
constexpr int KSTEP = 16;  // K per wgmma
constexpr int GROUP_M = 8;  // row tiles per band of the block order

// BM rows (BM / 64 consumer warpgroups) x BN columns, STAGES in the ring,
// BLOCKS blocks an SM; X_ROWS rows of x in a stage: BM, or 8 for M <= 8,
// whose wgmma reads those 8 rows as each of its eight 8-row groups (a
// stride of 0 between them), so a stage holds 1 KB of x and the ring more
// weight
template <int BM_, int BN_, int STAGES_, int BLOCKS_, int X_ROWS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_, BLOCKS = BLOCKS_;
  static constexpr int X_ROWS = X_ROWS_, A_SBO = X_ROWS == 8 ? 0 : 1024;
  static constexpr int CONSUMERS = BM / 64;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  // registers a consumer thread takes from what the producer (down to
  // PRODUCER_REGS) gives up, within the SM's 64K shared by BLOCKS blocks
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS_MAX =
      ((65536 / BLOCKS - 128 * PRODUCER_REGS) / (128 * CONSUMERS)) & ~7;
  static constexpr int CONSUMER_REGS = CONSUMER_REGS_MAX < 232 ? CONSUMER_REGS_MAX : 232;
  static constexpr int WBOX = BN < 64 ? BN : 64;  // W box width, columns
  static constexpr int WROW = WBOX * 2;           // its row (swizzle span), bytes
  static constexpr int WBOX_BYTES = BK * WROW;
  static constexpr int A_BYTES = X_ROWS * BK * 2, W_BYTES = BK * BN * 2;
  // the stages, 1024-byte aligned, then 2 x STAGES mbarriers; + alignment slack
  static constexpr int SMEM = 1024 + STAGES * (A_BYTES + W_BYTES) + 16 * STAGES;
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
  static_assert(X_ROWS == BM || (X_ROWS == 8 && BM == 64), "x rows of a stage");
  static_assert(BN == 32 || BN == 64 || BN == 128 || BN == 256, "a wgmma width");
};

// the tilings the entry takes (bf16_gemm.TILINGS lists the same)
using Gemv32 = Tile<64, 32, 20, 2, 8>;
using Gemv64 = Tile<64, 64, 12, 2, 8>;
using Decode32 = Tile<64, 32, 9, 2, 64>;
using Decode64 = Tile<64, 64, 6, 2, 64>;
using Mid128 = Tile<64, 128, 6, 1, 64>;
using Wide128 = Tile<128, 128, 6, 1, 128>;
using Wide256 = Tile<128, 256, 4, 1, 128>;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// one 2-D box of ``map`` at (inner c0, outer c1) into shared memory, its
// bytes counted on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// a wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle (1: 128 bytes, 2: 64 bytes)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swizzle << 62);
}

// the accumulators may not move while a wgmma owns them
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define R0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define R16 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define R32 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define R48 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define R64 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define R80 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define R96 \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
#define R112 \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)
#define F64(i) F16(i), F16(i + 16), F16(i + 32), F16(i + 48)
// d (+)= A [64 x 16] (K-major) x B [16 x N] (N-major: trans-b 1), scale-d 1;
// DA, DB, ONE: the operand numbers after the N / 2 accumulators
#define WGMMA_OP(N, REGS, DA, DB, ONE)                                              \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " ONE ", 0;\n"                                 \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, " DA ", " DB \
  ", p, 1, 1, 0, 1;\n}\n"

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(WGMMA_OP(32, R0, "%16", "%17", "%18") : F16(0) : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(WGMMA_OP(64, R0 ", " R16, "%32", "%33", "%34")
               : F16(0), F16(16)
               : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(WGMMA_OP(128, R0 ", " R16 ", " R32 ", " R48, "%64", "%65", "%66")
               : F64(0)
               : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma<256>(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(WGMMA_OP(256, R0 ", " R16 ", " R32 ", " R48 ", " R64 ", " R80 ", " R96 ", " R112,
                        "%128", "%129", "%130")
               : F64(0), F64(64)
               : "l"(da), "l"(db), "r"(1));
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::BLOCKS)
bf16_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w,
                 const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M,
                 int N, int K, int a_rows) {
  extern __shared__ uint8_t smem_raw[];
  // stages at a 1024-byte boundary: the swizzle pattern repeats every 1024
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t a0 = base, w0 = base + T::STAGES * T::A_BYTES;
  const uint32_t full0 = w0 + T::STAGES * T::W_BYTES, empty0 = full0 + 8 * T::STAGES;

  // the block's output tile: bands of GROUP_M row tiles, columns within
  const int tiles_m = (M + T::BM - 1) / T::BM, tiles_n = (N + T::BN - 1) / T::BN;
  const int per_band = GROUP_M * tiles_n, band = blockIdx.x / per_band;
  const int first_m = band * GROUP_M, band_m = min(tiles_m - first_m, GROUP_M);
  const int in_band = blockIdx.x % per_band;
  const int m0 = (first_m + in_band % band_m) * T::BM, n0 = (in_band / band_m) * T::BN;
  const int k_tiles = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, T::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % T::STAGES, round = kt / T::STAGES;
        if (round > 0) mbar_wait(empty0 + 8 * s, (round - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, a_rows * BK * 2 + T::W_BYTES);
        tma_load(a0 + s * T::A_BYTES, &map_x, kt * BK, m0, full);
#pragma unroll
        for (int c = 0; c < T::BN / T::WBOX; ++c)
          tma_load(w0 + s * T::W_BYTES + c * T::WBOX_BYTES, &map_w, n0 + c * T::WBOX, kt * BK,
                   full);
      }
    }
  } else {
    // a consumer: rows m0 + 64 * (wg - 1) .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
    const int c = wg - 1;
    float acc[T::BN / 2];
#pragma unroll
    for (int i = 0; i < T::BN / 2; ++i) acc[i] = 0.f;
    constexpr uint64_t W_SWIZZLE = T::WROW == 128 ? 1 : 2;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % T::STAGES;
      mbar_wait(full0 + 8 * s, (kt / T::STAGES) & 1);
      const uint32_t a = a0 + s * T::A_BYTES + c * 64 * BK * 2;  // c = 0 where X_ROWS = 8
      const uint32_t w = w0 + s * T::W_BYTES;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / KSTEP; ++kk) {
        // A: rows of 128 bytes, 8-row groups A_SBO apart, k16 = 32 bytes on
        // W: rows of WROW bytes, 8-row groups 8 * WROW apart, WBOX-column
        //    boxes WBOX_BYTES apart, k16 = 16 rows on
        const uint64_t da = gmma_desc(a + kk * KSTEP * 2, 16, T::A_SBO, 1);
        const uint64_t db =
            gmma_desc(w + kk * KSTEP * T::WROW, T::WBOX_BYTES, 8 * T::WROW, W_SWIZZLE);
        wgmma<T::BN>(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(acc);
      // the batch before this one is done: its stage goes back
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(empty0 + 8 * ((kt - 1) % T::STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);

    // acc[4j + h] of thread (warp v, lane l): row 16v + l/4 (+8 for h >= 2),
    // column 8j + 2(l % 4) + h % 2
    const int t = threadIdx.x % 128, v = t / 32, l = t % 32;
    const int row = m0 + 64 * c + 16 * v + l / 4;
#pragma unroll
    for (int j = 0; j < T::BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (l % 4);
      if (n >= N) continue;  // N is even: n + 1 < N too
      float b0 = 0.f, b1 = 0.f;
      if (bias != nullptr) {
        b0 = __bfloat162float(bias[n]);
        b1 = __bfloat162float(bias[n + 1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row + 8 * h;
        if (m >= M) continue;
        __nv_bfloat16 v0 = __float2bfloat16_rn(acc[4 * j + 2 * h]);
        __nv_bfloat16 v1 = __float2bfloat16_rn(acc[4 * j + 2 * h + 1]);
        if (bias != nullptr) {
          v0 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(v0), b0));
          v1 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(v1), b1));
        }
        __nv_bfloat162 pair;
        pair.x = v0;
        pair.y = v1;
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m) * N + n) = pair;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major bf16 [rows, cols] operand as 2-D boxes of [box_rows, box_cols]
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
            int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class T>
int launch(cudaStream_t stream, const void* x, const void* w, const void* bias, int m, int n,
           int k, void* out) {
  static bool sized = false;  // the shared-memory limit, once per tiling
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        bf16_gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // the rows of x a block loads: X_ROWS, or M rounded up to whole 8-row
  // swizzle groups when M is smaller (wgmma reads the others and their sums
  // are never stored)
  if (m > T::X_ROWS && T::X_ROWS < T::BM) return static_cast<int>(cudaErrorInvalidValue);
  const int a_rows = m < T::X_ROWS ? (m + 7) / 8 * 8 : T::X_ROWS;
  CUtensorMap map_x, map_w;
  if (!encode(fn, &map_x, x, m, k, a_rows, BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(fn, &map_w, w, k, n, BK, T::WBOX,
              T::WROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = ((m + T::BM - 1) / T::BM) * ((n + T::BN - 1) / T::BN);
  bf16_gemm_kernel<T><<<blocks, T::THREADS, T::SMEM, stream>>>(
      map_x, map_w, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), m,
      n, k, a_rows);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
bool is(int bm, int bn, int stages) {
  return bm == T::BM && bn == T::BN && stages == T::STAGES;
}

template <class T>
int attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, bf16_gemm_kernel<T>);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = T::SMEM;
  return static_cast<int>(err);
}

}  // namespace

// Resources of tiling (bm, bn, stages): out[0] registers a thread (as
// compiled), out[1] local bytes a thread (spills), out[2] the dynamic
// shared memory a block asks for; cudaErrorInvalidValue for a tiling the
// entry does not take.
extern "C" int repro_bf16_gemm_attrs(int bm, int bn, int stages, int* out) {
  if (is<Gemv32>(bm, bn, stages)) return attrs<Gemv32>(out);
  if (is<Gemv64>(bm, bn, stages)) return attrs<Gemv64>(out);
  if (is<Decode32>(bm, bn, stages)) return attrs<Decode32>(out);
  if (is<Decode64>(bm, bn, stages)) return attrs<Decode64>(out);
  if (is<Mid128>(bm, bn, stages)) return attrs<Mid128>(out);
  if (is<Wide128>(bm, bn, stages)) return attrs<Wide128>(out);
  if (is<Wide256>(bm, bn, stages)) return attrs<Wide256>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x [m, k], w [k, n] bf16, 16-byte aligned, k and n multiples of 8 (row
// strides of whole 16-byte units, as TMA needs); bias NULL or bf16 [n];
// (bm, bn, stages) one of the tilings above; else cudaErrorInvalidValue
extern "C" int repro_bf16_gemm(const void* x, const void* w, const void* bias, int m, int n,
                               int k, int bm, int bn, int stages, void* out, void* stream) {
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);  // nothing to compute
  if (m < 0 || n < 0 || k <= 0 || k % 8 || n % 8 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is<Gemv32>(bm, bn, stages)) return launch<Gemv32>(st, x, w, bias, m, n, k, out);
  if (is<Gemv64>(bm, bn, stages)) return launch<Gemv64>(st, x, w, bias, m, n, k, out);
  if (is<Decode32>(bm, bn, stages)) return launch<Decode32>(st, x, w, bias, m, n, k, out);
  if (is<Decode64>(bm, bn, stages)) return launch<Decode64>(st, x, w, bias, m, n, k, out);
  if (is<Mid128>(bm, bn, stages)) return launch<Mid128>(st, x, w, bias, m, n, k, out);
  if (is<Wide128>(bm, bn, stages)) return launch<Wide128>(st, x, w, bias, m, n, k, out);
  if (is<Wide256>(bm, bn, stages)) return launch<Wide256>(st, x, w, bias, m, n, k, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
