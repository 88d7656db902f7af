// Tensor-core pieces of the general flash backward, B2a (flash_dq_any.cu)
// and B3a (flash_dkv_any.cu): fp32 or bf16 inputs at head dim 1-256 on
// Hopper's wgmma (sm_90a), the tiles copied asynchronously into shared
// memory by TMA or by a producer warpgroup.
//
// The two kernels are one pattern with the roles of queries and keys
// swapped.  A block owns F "fixed" rows (queries in dQ, keys in dK/dV),
// kept in shared memory for the whole block, and walks the other sequence
// in "streamed" tiles of 64 rows (wgmma's M) through a 2-stage ring that a
// producer warpgroup fills.  The fixed rows are split between F / 32
// consumer warpgroups of N = 32 rows each; with two, one's fragment loads
// and P / dS arithmetic run while the other's wgmmas do (two consumers of
// 32 rows took fp32 dQ from 0.911 to 0.772 ms against one of 64,
// kernels.ab).  For each streamed tile, each consumer:
//   1. first products over the head dim: acc = Y X^T (64 streamed x N
//      fixed), A = the streamed tile Y from registers, B = its rows of the
//      fixed tile X in shared memory;
//   2. P and dS from the accumulators in registers (each kernel's own);
//   3. P / dS written to shared memory transposed, as W [N fixed][64
//      streamed], in two parts (the split below);
//   4. second products over the streamed rows: Z^T += Y^T W, head dim x N
//      in 64-row blocks (Z = dQ, dK or dV), A = Y read transposed into
//      registers, B = W.
// Z^T stays in registers for the whole block and is stored transposed.
//
// Trouble 1, the operand majors: wgmma's tf32 reads both shared-memory
// operands K-major only (the transpose bits exist for 16-bit types).  So
// every shared-memory operand here is K-major as stored: X is [fixed][d]
// for the products over d, W is written [fixed][streamed] for the products
// over the streamed rows.  The operands that would need the other major
// (Y^T in step 4) are A operands, loaded element by element in wgmma's
// register-fragment layout from the untransposed tile.  bf16 takes the same
// route, so the two dtypes share one code path.
//
// Split precision (the accuracy of fp32 arithmetic on tensor cores):
//   fp32 (3xTF32): each operand x is big + small, big = x rounded to tf32
//     (11 significant bits), small = x - big rounded to tf32 too: 22 of
//     fp32's 24 significant bits.  A product is big.big + big.small +
//     small.big, each pass a wgmma .tf32 into the fp32 accumulator; the
//     dropped small.small and small's rounding are about 2^-22 relative
//     (tests/test_torch_split.py emulates the plan).  X's small part is a
//     second shared tile (made once a block), Y's is made in registers as
//     the fragments are loaded, W is written as two tiles.  The tensor core
//     truncates as it accumulates, so each batch of four k-steps goes into
//     a zeroed accumulator that is added to the sum with an fp32 add, the
//     batch's small passes before its big ones: about one truncation a
//     k-step.
//   bf16: the first products (S, dP) are exact products of bf16 inputs:
//     one bf16 wgmma each.  P and dS are fp32 values; one rounding to bf16
//     (2^-9) is the 1e-3 x row rms of ANY_TOL's bf16 row term, so W holds a
//     bf16 high part and a bf16 low part (x - high): two wgmmas each.
//
// Trouble 2, row widths: a tile is stored as 128-byte column panels, panel
// p holding columns [p E, p E + E) (E = 32 fp32 or 64 bf16 values) of
// every row, [rows][128 bytes] with the 128-byte swizzle (16-byte chunk c
// of row r at c ^ (r % 8)), each panel on a 1024-byte boundary.  One wgmma
// k-step is 32 bytes of K: 4 steps a panel, and the descriptor steps to
// the next panel (rows x 128 bytes on) every fourth (kstep).  hopper.cuh's
// Rows<D> and the tuned kernels are left as they are.
//
// Trouble 3, copies: TMA needs each global stride (H d bytes) a multiple
// of 16 bytes and 16-byte aligned bases, so it takes fp32 at d % 4 == 0 and
// bf16 at d % 8 == 0 (and d at least one panel).  One box a panel (E
// columns x rows), zero-filled past S and past d.  Every other input is
// copied by the producer warpgroup's 128 threads with plain loads into the
// same swizzled layout, zeros past S and d, then fence.proxy.async (wgmma
// reads through the async proxy) and an mbarrier arrive.  The host picks
// the path before the launch (use_tma); either way the producer fills the
// next stage while the consumer computes on the current one.
//
// Trouble 4, the budget: F = 64 fixed rows (two consumers), or 32 (one)
// where 64 does not fit a block's 227 KB of shared memory (fp32 at DP =
// 128: 226.5 KB at F = 32; bf16 at DP = 256).  Registers: 168 a thread
// with two consumers (384 threads), 255 with one; ptxas -v reports none
// spilled.  setmaxnreg's budgets (40 for the producer, 232 for the
// consumers) made ptxas spill, so none is set.  fp32 at DP = 256 (fixed
// tiles, their small parts and two 64-row streamed tiles of 1 KB rows:
// over 227 KB even at F = 32 and one stage) does not fit: there each
// takes a kernel of its own, chosen by the C entry point before the
// launch, with F = 16 fixed rows split once (64 KB), the two streamed
// tiles raw (their A fragments split in registers) in one buffer each,
// released one at a time, and two consumers, one on each first product
// at once, each with half of Z^T's rows: flash_dkv_any_kernel_f32_256 (Q
// and dO, W by tile parity: 64 + 128 + 32 KB) and
// flash_dq_any_kernel_f32_256 (K and V, V released after dP, K after
// both halves of dQ^T += K^T dS: 64 + 128 + 12 KB).
//
// Trouble 5, padding: the first products run ceil(d / 8) k-steps (tf32) or
// ceil(d / 16) (bf16), not DP / 8 or DP / 16.
//
// ptxas and wgmma: every batch of wgmmas is waited for (wait_group 0)
// before its A registers are reloaded or its accumulators read, and the
// warpgroup index is broadcast from lane 0, so ptxas neither serializes
// the wgmmas (C7518) nor injects waits (C7517).
#pragma once

#include "flash_any.cuh"
#include "hopper.cuh"

namespace tpujob_flash_tc {

using tpujob_flash::bf16;
using namespace tpujob_hopper;

constexpr int kRows = 64;         // streamed rows a tile: wgmma's M
constexpr int kStages = 2;        // streamed tiles in flight
constexpr int kPanel = 128;       // bytes of a panel row (the swizzle span)
constexpr int kFixedBar = 1;      // named barrier of all consumers
constexpr int kConsumerBar = 2;   // + c: named barrier of consumer c
// the fp32 head-dim-256 kernels' exchange between their two consumers
// (they use no per-consumer barrier, so 3 is free for it)
constexpr int kPBar = 3;          // named barrier: P written (consumer 0)
constexpr int kDsBar = 4;         // dS written (consumer 1)

// The tiles of input type T at padded head dim DP.
template <class T, int DP>
struct TcGeom {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kEPP = kPanel / (int)sizeof(T);  // values a panel row
  static constexpr int kNP = (DP + kEPP - 1) / kEPP;    // panels a row
  static constexpr int kCols = kNP * kEPP;              // stored columns
  static constexpr int F = (kF32 && DP >= 128) || DP >= 256 ? 32 : 64;
  static constexpr int kNC = F / 32;                    // consumer warpgroups
  static constexpr int N = F / kNC;                     // fixed rows of each
  static constexpr int kBlockThreads = 128 * (1 + kNC);
  static constexpr int kMB = (DP + 63) / 64;            // 64-row blocks of Z^T
  static constexpr int kKW = kF32 ? 8 : 16;             // K of a k-step
  static constexpr int kXT = kF32 ? 4 : 2;              // X1, X2 (+ smalls)
};

// Shared memory of a block; NW = W tiles (1: dS; 2: P and dS).  Every tile
// is a multiple of 1024 bytes, so each starts on a swizzle atom.
template <class T, int DP, int NW>
struct TcSmem {
  using G = TcGeom<T, DP>;
  T x[G::kXT][G::F * G::kCols];       // X1, X2, then their small parts
  T y[kStages][2][kRows * G::kCols];  // Y1, Y2 of each stage
  T w[G::kNC][NW][2][G::N * kRows];   // each consumer's W, two parts
  float row_lse[kStages][kRows];      // streamed rows' lse
  float row_delta[kStages][kRows];
  float fix_lse[64];                  // fixed rows' lse
  float fix_delta[64];
  uint64_t fixed_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// ---------------------------------------------------------------------------
// host: a TMA map whose box is one panel
// ---------------------------------------------------------------------------

// A 4-D map over a contiguous [B, S, H, d] tensor of T (dims innermost
// first: d, H, S, B), box E x 1 x rows x 1: one panel of one head's `rows`
// sequence rows, 128-byte swizzled.  Columns past d and rows past S read
// as zero.  Returns 0 on success.
template <class T>
inline int encode_panels(CUtensorMap* map, const void* ptr, int B, int S,
                         int H, int d, int rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return (int)cudaErrorInitializationError;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {d * es, (cuuint64_t)H * d * es,
                                 (cuuint64_t)S * H * d * es};
  const cuuint32_t box[4] = {(cuuint32_t)(kPanel / es), 1, (cuuint32_t)rows,
                             1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, estride,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Whether TMA takes these tensors: a row stride of a multiple of 16 bytes,
// at least one panel of columns, 16-byte aligned bases.
template <class T>
inline bool tma_takes(int d, const void* const* ptrs, int n) {
  if ((d * (int)sizeof(T)) % 16 || d < kPanel / (int)sizeof(T)) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

// ---------------------------------------------------------------------------
// device: the panel layout
// ---------------------------------------------------------------------------

// byte offset of element (r, c) of a panel tile of R rows
template <class T, int R>
__device__ __forceinline__ int tile_off(int r, int c) {
  constexpr int epp = kPanel / (int)sizeof(T);
  const int byte = (c % epp) * (int)sizeof(T);
  return (c / epp) * (R * kPanel) + r * kPanel +
         ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
}

template <class T, int R>
__device__ __forceinline__ T& at(T* tile, int r, int c) {
  return *reinterpret_cast<T*>(reinterpret_cast<uint8_t*>(tile) +
                               tile_off<T, R>(r, c));
}

template <class T, int R>
__device__ __forceinline__ const T& at(const T* tile, int r, int c) {
  return *reinterpret_cast<const T*>(reinterpret_cast<const uint8_t*>(tile) +
                                     tile_off<T, R>(r, c));
}

// wgmma descriptor of a K-major panel tile at p: start >> 4, LBO unused,
// SBO one 8-row atom (1024 bytes), 128-byte swizzle
__device__ __forceinline__ uint64_t panel_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// descriptor offset (16-byte units) of k-step ks (32 bytes of K) in a
// panel tile of R rows: the panel, then the step within it
template <int R>
__device__ __forceinline__ uint64_t kstep(int ks) {
  return (uint64_t)((ks >> 2) * R * (kPanel / 16) + (ks & 3) * 2);
}

// orders this thread's generic shared-memory writes before later reads
// by the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// device: the split
// ---------------------------------------------------------------------------

// x rounded to tf32 (low 13 mantissa bits cleared, to nearest, ties away)
__device__ __forceinline__ float tf32_big(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// x as big + small, both tf32 (small rounded too, so the tensor core reads
// it exactly): 22 of fp32's 24 significant bits
__device__ __forceinline__ float tf32_small(float x, float big) {
  return tf32_big(x - big);
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  const float b = tf32_big(x);
  big = __float_as_uint(b);
  small = __float_as_uint(tf32_small(x, b));
}

__device__ __forceinline__ uint32_t bf16_bits(bf16 x) {
  return (uint32_t)__bfloat16_as_ushort(x);
}

// ---------------------------------------------------------------------------
// device: wgmma, A from registers, B K-major in shared memory, d += A B
// ---------------------------------------------------------------------------

#define TPJ_TC_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])

// m64n64k8, tf32
__device__ __forceinline__ void mma_tf32(float (&d)[32], const uint32_t a[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : TPJ_TC_D8(0), TPJ_TC_D8(8), TPJ_TC_D8(16), TPJ_TC_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// m64n32k8, tf32
__device__ __forceinline__ void mma_tf32(float (&d)[16], const uint32_t a[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : TPJ_TC_D8(0), TPJ_TC_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// m64n16k8, tf32
__device__ __forceinline__ void mma_tf32(float (&d)[8], const uint32_t a[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : TPJ_TC_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// m64n64k16, bf16, B not transposed (K-major)
__device__ __forceinline__ void mma_bf16(float (&d)[32], const uint32_t a[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : TPJ_TC_D8(0), TPJ_TC_D8(8), TPJ_TC_D8(16), TPJ_TC_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// m64n32k16, bf16, B not transposed (K-major)
__device__ __forceinline__ void mma_bf16(float (&d)[16], const uint32_t a[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : TPJ_TC_D8(0), TPJ_TC_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef TPJ_TC_D8

// ---------------------------------------------------------------------------
// device: A fragments from a 64-row streamed tile
// ---------------------------------------------------------------------------

// Thread tid of the warpgroup (w = tid / 32, g = (tid % 32) / 4, t = tid %
// 4) holds, of an m64 A operand's k-step, rows 16w + g and 16w + g + 8 and
// columns t, t + 4 (tf32, four values) or 2t, 2t + 1, 2t + 8, 2t + 9
// (bf16, four pairs).  kTrans false: A = Y, its rows the tile's rows, K its
// columns.  kTrans true: A = Y^T from row m0 (a head-dim column), K the
// tile's rows; columns past the C stored ones read as zero.

template <bool kTrans, int C>
__device__ __forceinline__ void frag_tf32(const float* y, int ks, int m0,
                                          uint32_t big[4], uint32_t small[4]) {
  const int tid = threadIdx.x % 128;
  const int r = m0 + 16 * (tid / 32) + (tid % 32) / 4, t = tid % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ar = r + 8 * (i & 1), ak = t + 4 * (i >> 1);
    float x;
    if (kTrans)  // 8 tile rows a k-step: one swizzle atom on, same pattern
      x = ar < C ? *reinterpret_cast<const float*>(
                       reinterpret_cast<const uint8_t*>(y) +
                       tile_off<float, kRows>(ak, ar) + ks * 8 * kPanel)
                 : 0.f;
    else
      x = at<float, kRows>(y, ar, 8 * ks + ak);
    split_tf32(x, big[i], small[i]);
  }
}

template <bool kTrans, int C>
__device__ __forceinline__ void frag_bf16(const bf16* y, int ks, int m0,
                                          uint32_t a[4]) {
  const int tid = threadIdx.x % 128;
  const int r = m0 + 16 * (tid / 32) + (tid % 32) / 4, t = tid % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ar = r + 8 * (i & 1), ak = 2 * t + 8 * (i >> 1);
    if (kTrans) {  // 16 tile rows a k-step: two swizzle atoms on
      const uint8_t* p = reinterpret_cast<const uint8_t*>(y) +
                         ks * 16 * kPanel;
      a[i] = ar < C
                 ? bf16_bits(*reinterpret_cast<const bf16*>(
                       p + tile_off<bf16, kRows>(ak, ar))) |
                       (bf16_bits(*reinterpret_cast<const bf16*>(
                            p + tile_off<bf16, kRows>(ak + 1, ar)))
                        << 16)
                 : 0u;
    } else {
      a[i] = *reinterpret_cast<const uint32_t*>(
          &at<bf16, kRows>(y, ar, 16 * ks + ak));
    }
  }
}

// ---------------------------------------------------------------------------
// device: the products
// ---------------------------------------------------------------------------

// acc (m64nN) += Y X^T over k-steps ks .. ks + NS - 1 of the head dim, one
// batch of wgmmas, waited for (X's descriptor dx, its small part's dxs for
// fp32; X is a tile of R rows).  The tensor core truncates as it
// accumulates, by up to an ulp of the running sum, and where dP - D cancels
// (a row with one dominant key) a chain of such truncations shows in dQ.
// So fp32 sums the batch into a zeroed accumulator, the small passes before
// the big ones (a small value added to a big sum loses its own size, about
// an ulp of the sum), and adds it to acc in fp32: about one truncation a
// k-step.  Four k-steps a batch: a batch ends in a wait for the tensor
// cores before its registers are reloaded, and fewer waits are faster
// (fp32 dQ 0.753 -> 0.713 ms at GPT's shape, kernels.ab).
template <class T, int N, int R, int C, int NS>
__device__ __forceinline__ void first_chunk(float (&acc)[N / 2], const T* y,
                                            uint64_t dx, uint64_t dxs,
                                            int ks) {
  if constexpr (sizeof(T) == 4) {
    uint32_t big[NS][4], small[NS][4];
    float part[N / 2];
#pragma unroll
    for (int u = 0; u < NS; ++u)
      frag_tf32<false, C>(y, ks + u, 0, big[u], small[u]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) part[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < NS; ++u) {  // the small passes first, then the big
      mma_tf32(part, big[u], dxs + kstep<R>(ks + u));
      mma_tf32(part, small[u], dx + kstep<R>(ks + u));
    }
#pragma unroll
    for (int u = 0; u < NS; ++u) mma_tf32(part, big[u], dx + kstep<R>(ks + u));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
  } else {
    uint32_t a[NS][4];
#pragma unroll
    for (int u = 0; u < NS; ++u) frag_bf16<false, C>(y, ks + u, 0, a[u]);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < NS; ++u) mma_bf16(acc, a[u], dx + kstep<R>(ks + u));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
}

// acc = Y X^T over the head dim's nks k-steps, kBatch a batch.
template <class T, int N, int R, int C, int kBatch = 4>
__device__ __forceinline__ void first_product(float (&acc)[N / 2], const T* y,
                                              uint64_t dx, uint64_t dxs,
                                              int nks) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  int ks = 0;
  for (; ks + kBatch <= nks; ks += kBatch)
    first_chunk<T, N, R, C, kBatch>(acc, y, dx, dxs, ks);
  for (; ks < nks; ++ks) first_chunk<T, N, R, C, 1>(acc, y, dx, dxs, ks);
}

// z += Y^T W over the tile's 64 streamed rows, for head-dim rows m0 ..
// m0 + 63 of Z^T; dw0 / dw1 are W's two parts (big and small for fp32,
// high and low for bf16).  fp32 sums each batch of four k-steps into a
// zeroed accumulator, small passes first, and adds that to z (as
// first_chunk).
template <class T, int N, int C, int kBatch = 4>
__device__ __forceinline__ void second_product(float (&z)[N / 2], const T* y,
                                               int m0, uint64_t dw0,
                                               uint64_t dw1) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int ks = 0; ks < kRows / 8; ks += kBatch) {
      uint32_t big[kBatch][4], small[kBatch][4];
      float part[N / 2];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        frag_tf32<true, C>(y, ks + u, m0, big[u], small[u]);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) part[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {  // the small passes first
        mma_tf32(part, big[u], dw1 + kstep<N>(ks + u));
        mma_tf32(part, small[u], dw0 + kstep<N>(ks + u));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        mma_tf32(part, big[u], dw0 + kstep<N>(ks + u));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) z[i] += part[i];
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ks += 2) {
      uint32_t a[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) frag_bf16<true, C>(y, ks + u, m0, a[u]);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint64_t o = kstep<N>(ks + u);
        mma_bf16(z, a[u], dw1 + o);
        mma_bf16(z, a[u], dw0 + o);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(z);
    }
  }
}

// Element 4j + e of an m64nN accumulator (streamed row 16w + g + 8(e >> 1),
// fixed column 8j + 2t + (e & 1)) into W [N fixed][64 streamed], split.
// (Row 8j + c lies j swizzle atoms past row c, in the same pattern.)
template <class T, int N>
__device__ __forceinline__ void put_w(T* w0, T* w1, int j, int e, float v) {
  const int tid = threadIdx.x % 128;
  const int sr = 16 * (tid / 32) + (tid % 32) / 4 + 8 * (e >> 1);
  const int off = tile_off<T, N>(2 * (tid % 4) + (e & 1), sr) + j * 8 * kPanel;
  T* p0 = reinterpret_cast<T*>(reinterpret_cast<uint8_t*>(w0) + off);
  T* p1 = reinterpret_cast<T*>(reinterpret_cast<uint8_t*>(w1) + off);
  if constexpr (sizeof(T) == 4) {
    const float big = tf32_big(v);
    *p0 = big;
    *p1 = tf32_small(v, big);
  } else {
    const bf16 hi = __float2bfloat16(v);
    *p0 = hi;
    *p1 = __float2bfloat16(v - __bfloat162float(hi));
  }
}

// The value put_w wrote at element 4j + e, from its two parts (22 of
// fp32's 24 bits, 17 in bf16).
template <class T, int N>
__device__ __forceinline__ float get_w(const T* w0, const T* w1, int j,
                                       int e) {
  const int tid = threadIdx.x % 128;
  const int sr = 16 * (tid / 32) + (tid % 32) / 4 + 8 * (e >> 1);
  const int off = tile_off<T, N>(2 * (tid % 4) + (e & 1), sr) + j * 8 * kPanel;
  return tpujob_flash_any::to_f(*reinterpret_cast<const T*>(
             reinterpret_cast<const uint8_t*>(w0) + off)) +
         tpujob_flash_any::to_f(*reinterpret_cast<const T*>(
             reinterpret_cast<const uint8_t*>(w1) + off));
}

// The fixed tile x [N values] rounded to tf32 in place and its small part
// into xs, by the NC consumer warpgroups (threads 128 on).
template <int N, int NC>
__device__ __forceinline__ void split_fixed(float* x, float* xs) {
  for (int i = threadIdx.x - 128; i < N; i += 128 * NC) {
    const float v = x[i], big = tf32_big(v);
    x[i] = big;
    xs[i] = tf32_small(v, big);
  }
}

// P = exp(scale s - lse) as the plain version rounds it: the product
// rounded (no fused multiply-add), then the difference, then expf.  (A
// log2(e)-scaled ex2 rounds the argument otherwise, by up to 1e-6 relative
// in P where |scale s| is about 10.)
__device__ __forceinline__ float prob(float s, float scale, float lse) {
  return expf(__fmul_rn(s, scale) - lse);
}

// Z^T's 64-row block m0 (head-dim rows) of fixed rows f0 .. f0 + F - 1
// into out [B, S, H, d] at (b, h): rows past d and fixed rows past S are
// skipped.
template <class T, int N>
__device__ __forceinline__ void store_zt(T* out, const float (&z)[N / 2],
                                         int m0, int f0, int b, int h, int H,
                                         int S, int d) {
  const int tid = threadIdx.x % 128;
  const int r = m0 + 16 * (tid / 32) + (tid % 32) / 4, t = tid % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dr = r + 8 * (e >> 1), f = f0 + 8 * j + 2 * t + (e & 1);
      if (dr < d && f < S)
        out[((long)(b * S + f) * H + h) * d + dr] =
            tpujob_flash_any::from_f<T>(z[4 * j + e]);
    }
}

// ---------------------------------------------------------------------------
// device: the producer's copies
// ---------------------------------------------------------------------------

// Rows row0 .. row0 + R - 1 of x [B, S, H, d] at (b, h) into the panel
// tile dst (C stored columns) by the producer's 128 threads, zeros past S
// and past d.
template <class T, int R, int C>
__device__ __forceinline__ void copy_tile(T* dst, const T* x, int b, int h,
                                          int H, int S, int d, int row0) {
  for (int i = threadIdx.x % 128; i < R * C; i += 128) {
    const int r = i / C, c = i % C, s = row0 + r;
    T v = tpujob_flash_any::from_f<T>(0.f);
    if (s < S && c < d) v = x[((long)(b * S + s) * H + h) * d + c];
    at<T, R>(dst, r, c) = v;
  }
}

// panel p of a tile: columns p E .. of sequence row `row`, head h, batch b
__device__ __forceinline__ void tma_load_panel(void* dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int col, int row,
                                               int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(col), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// Two tiles (R rows from row0 of x0 and x1) into d0 and d1, completing on
// `bar` (128 arrivals, one a producer thread): by TMA (thread 0 expects the
// bytes and issues one load a panel) or by the producer's plain copies.
template <class T, int R, int C>
__device__ __forceinline__ void produce(T* d0, T* d1, const CUtensorMap* m0,
                                        const CUtensorMap* m1, const T* x0,
                                        const T* x1, uint64_t* bar,
                                        int use_tma, int row0, int b, int h,
                                        int H, int S, int d) {
  constexpr int epp = kPanel / (int)sizeof(T);
  if (use_tma) {
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar, 2 * R * C * (int)sizeof(T));
#pragma unroll
      for (int p = 0; p < C / epp; ++p) {
        tma_load_panel(reinterpret_cast<uint8_t*>(d0) + p * R * kPanel, m0,
                       bar, p * epp, row0, h, b);
        tma_load_panel(reinterpret_cast<uint8_t*>(d1) + p * R * kPanel, m1,
                       bar, p * epp, row0, h, b);
      }
    } else {
      mbar_arrive(bar);
    }
  } else {
    copy_tile<T, R, C>(d0, x0, b, h, H, S, d, row0);
    copy_tile<T, R, C>(d1, x1, b, h, H, S, d, row0);
    fence_async_shared();
    mbar_arrive(bar);
  }
}

// One tile (R rows from row0 of x) into dst, completing on `bar` (128
// arrivals, one a producer thread): by TMA (thread 0 expects the bytes and
// issues one load for each panel that holds one of the d real columns; the
// others are never read) or by the producer's plain copies.
template <class T, int R, int C>
__device__ __forceinline__ void produce_tile(T* dst, const CUtensorMap* map,
                                             const T* x, uint64_t* bar,
                                             int use_tma, int row0, int b,
                                             int h, int H, int S, int d) {
  constexpr int epp = kPanel / (int)sizeof(T);
  if (use_tma) {
    if (threadIdx.x % 128 == 0) {
      const int np = (d + epp - 1) / epp;
      mbar_arrive_expect_tx(bar, np * R * kPanel);
      for (int p = 0; p < np; ++p)
        tma_load_panel(reinterpret_cast<uint8_t*>(dst) + p * R * kPanel, map,
                       bar, p * epp, row0, h, b);
    } else {
      mbar_arrive(bar);
    }
  } else {
    copy_tile<T, R, C>(dst, x, b, h, H, S, d, row0);
    fence_async_shared();
    mbar_arrive(bar);
  }
}

// Barriers of a block: a phase of fixed_full or full completes on the
// producer's 128 arrivals, one of empty on the NC consumers' 128 NC.
template <int NC, class Sm>
__device__ __forceinline__ void init_barriers(Sm& sm) {
  if (threadIdx.x == 0) {
    mbar_init(&sm.fixed_full, 128);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 128);
      mbar_init(&sm.empty[s], 128 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

}  // namespace tpujob_flash_tc
