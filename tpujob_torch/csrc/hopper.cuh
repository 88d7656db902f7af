// Hopper (sm_90a) building blocks of the flash kernels flash_fwd.cu,
// flash_dq.cu and flash_dkv.cu: TMA tensor maps and loads, mbarriers, wgmma
// descriptors and instructions, setmaxnreg.
//
// Tiles in shared memory are [rows][D] bf16, one D*2-byte row per tile
// row, written by TMA with the swizzle of that row width (Rows<D>): at
// D = 64 a row is 128 bytes and the 128-byte swizzle puts 16-byte chunk c
// of row r at chunk c ^ (r % 8); at D = 32 a row is 64 bytes and the
// 64-byte swizzle puts it at c ^ ((r / 2) % 4).  Either way an 8-row group
// is one swizzle atom (8 * D * 2 bytes), and a tile starts on a 1024-byte
// boundary, which every atom size divides.  wgmma reads such a tile two
// ways:
//   K-major  (the D columns are the reduction axis): an m64 A operand or
//            an N-row B operand; one k16 step is +32 bytes along the row.
//   MN-major (the rows are the reduction axis, the D columns are N): a
//            transposed B operand; one k16 step is +16 rows.
// In both, the stride between 8-row groups (SBO) is one atom; N = D is one
// swizzle atom wide, so LBO is unused.
//
// Accumulator (fp32, m64nN) of thread `tid` of a warpgroup, w = tid / 32,
// g = (tid % 32) / 4, t = tid % 4: element d[4j + e] holds row
// 16w + g + 8 (e >> 1), column 8j + 2t + (e & 1), j < N / 8.  The bf16 A
// register fragment of k16 step kk is the pair of n8 blocks 2kk, 2kk + 1
// of that layout (a_from_acc), which is how P and dS feed the next product
// without leaving registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpujob_hopper {

constexpr int kAlignBytes = 1024;  // a tile's start: the largest atom

// The layout of a [rows][D] bf16 tile, for the head dims the kernels are
// built for: its row bytes, its swizzle atom (8 rows), the TMA swizzle and
// the wgmma descriptor's layout type of that row width.
template <int D>
struct Rows;
template <>
struct Rows<64> {
  static constexpr int kBytes = 128;
  static constexpr int kAtom = 8 * kBytes;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr uint64_t kLayout = 1;  // 128-byte swizzle
};
template <>
struct Rows<32> {
  static constexpr int kBytes = 64;
  static constexpr int kAtom = 8 * kBytes;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
  static constexpr uint64_t kLayout = 2;  // 64-byte swizzle
};

// ---------------------------------------------------------------------------
// host: TMA tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime's entry-point
// query, so the library links no -lcuda
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over a contiguous [B, S, H, D] bf16 tensor (dims innermost
// first: D, H, S, B), box D x 1 x `rows` x 1: one head's `rows` sequence
// rows as a [rows][D] tile, swizzled as Rows<D> says.  Rows past S read as
// zero, which masks the ragged edge of every load.  Returns 0 on success.
template <int D>
inline int encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H,
                       int rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return (int)cudaErrorInitializationError;
  constexpr cuuint64_t row = Rows<D>::kBytes;
  const cuuint64_t dims[4] = {D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, (cuuint64_t)H * row,
                                 (cuuint64_t)S * H * row};
  const cuuint32_t box[4] = {D, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, Rows<D>::kSwizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// device: addresses, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary (of the shared address) at or after p; a
// kernel asks for 1024 bytes more dynamic shared memory than it uses
__device__ __forceinline__ uint8_t* align_atom(uint8_t* p) {
  const uint32_t rem = smem_addr(p) & (kAlignBytes - 1);
  return p + ((kAlignBytes - rem) & (kAlignBytes - 1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// arrive, and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed (the
// spin stays inside one asm block, as CUTLASS's barrier wait does)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// one [rows][D] tile of a [B, S, H, D] map: sequence row `row`, head h,
// batch b, completing on `bar`
__device__ __forceinline__ void tma_load_bshd(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row, int h,
                                              int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(0), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// named barrier `id` (1-15; 0 is __syncthreads') of `threads` threads:
// sync waits for the count, arrive counts without waiting
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// device: warpgroup register budget
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// shared-memory matrix descriptor of a swizzled [rows][D] tile at `p`
// (see the top of this file): start >> 4, LBO 16 B (unused), SBO one
// atom, layout type of Rows<D>
template <int D>
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(Rows<D>::kAtom >> 4) << 32) | (Rows<D>::kLayout << 62);
}

// descriptor offsets of k16 step kk (in 16-byte units, added to the start)
__device__ __forceinline__ uint64_t kmajor_step(int kk) { return 2 * kk; }
template <int D>
__device__ __forceinline__ uint64_t mnmajor_step(int kk) {
  return (16 * Rows<D>::kBytes >> 4) * kk;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across an
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// two fp32 values as one bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the bf16 A fragment of k16 step kk from an fp32 accumulator
template <int R>
__device__ __forceinline__ void a_from_acc(const float (&d)[R], int kk,
                                           uint32_t a[4]) {
  a[0] = pack_bf16x2(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16x2(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16x2(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16x2(d[8 * kk + 6], d[8 * kk + 7]);
}

#define TPJ_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                  "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B from shared memory,
// both K-major; `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TPJ_D8(0), TPJ_D8(8), TPJ_D8(16), TPJ_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TPJ_D8(0), TPJ_D8(8), TPJ_D8(16), TPJ_D8(24), TPJ_D8(32), TPJ_D8(40),
        TPJ_D8(48), TPJ_D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x N] += A[64 x 16] . B[16 x N], A from registers (a_from_acc
// layout), B MN-major (transposed) in shared memory; N = 64 or 32, as the
// accumulator's size (N / 2 floats a thread) says
__device__ __forceinline__ void wgmma_m64nN_rs_t(float (&d)[32],
                                                 const uint32_t a[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TPJ_D8(0), TPJ_D8(8), TPJ_D8(16), TPJ_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64nN_rs_t(float (&d)[16],
                                                 const uint32_t a[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : TPJ_D8(0), TPJ_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef TPJ_D8

// ---------------------------------------------------------------------------
// device: epilogue and math
// ---------------------------------------------------------------------------

// 2^x (the approximate unit, as __expf uses)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a warpgroup's m64nN fp32 accumulator (R = N / 2 floats a thread), cast
// to bf16, into rows row0 .. row0+63 of `base` (rows `stride` elements
// apart); rows at or past `rows` are skipped
template <int R>
__device__ __forceinline__ void store_acc_rows(__nv_bfloat16* base,
                                               long stride,
                                               const float (&d)[R], int row0,
                                               int rows) {
  const int tid = threadIdx.x % 128;
  const int g = (tid % 32) / 4, t = tid % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 16 * (tid / 32) + g + 8 * half;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
      *reinterpret_cast<uint32_t*>(base + (long)r * stride + 8 * j + 2 * t) =
          pack_bf16x2(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
  }
}

}  // namespace tpujob_hopper
