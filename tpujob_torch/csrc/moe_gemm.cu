// The grouped matrix products of a dropless expert layer for Hopper
// (sm_90a), bf16 in, fp32 accumulation (workloads/moe_gemm.py).
//
// Replaces no Pallas kernel: the JAX package's expert layer
// (tpujob/workloads/parallel.py:moe_ffn) dispatches by dense one-hot einsums
// with a capacity, whose [b, s, E, capacity] tensors grow with the experts
// (ROADMAP D.8).  A dropless layer sorts the b*s*k assignments by expert
// into a buffer of exactly that many rows, and each expert multiplies its
// own rows: a product over ragged groups whose sizes live on the card only
// (offsets [E + 1] int32; tiles [E + 1], each expert's first 128-row tile,
// tiles[E] the count), so the step that runs it captures into one graph.
//
//   tpujob_moe_gemm_fwd  out[rows of e] = a[rows of e] . w[e]    w [E, K, N]
//   tpujob_moe_gemm_dx   out[rows of e] = a[rows of e] . w[e]^T  w [E, N, K]
//   tpujob_moe_gemm_dw   dw[e] = a[rows of e]^T . g[rows of e], fp32 out
//
// Bound on an H100 SXM: at the Mellum2 cell's shapes ([131072, 2304] x
// [64, 2304, 1792] and [131072, 896] x [64, 896, 2304]) each product does
// 500-700 operations a byte it must move, above the card's 295, so the
// tensor cores bound it (989 TFLOP/s bf16): about 1.1 ms for the first
// product and 0.55 ms for the second, in each pass.
//
// Design: one output tile of 128 rows by BN columns a block (BN 256, or
// 128 where N is no multiple of 256), three warpgroups as in the flash
// kernels: a producer whose one thread keeps a kStages ring of 64-deep
// reduction steps full by TMA (a full and an empty mbarrier a stage; TMA's
// zero fill masks every edge past the tensor), and two consumers of 64 rows
// each, running wgmma m64nBNk16 from shared memory into fp32 registers.
// Every tile in shared memory is rows of 64 bf16 (128 bytes) under the
// 128-byte swizzle; wgmma reads a tile K-major (the 128 bytes are the
// reduction) or MN-major (the rows are the reduction; a BN-wide operand is
// BN / 64 such panels, LBO apart).
//   fwd, dx: the grid walks ceil(R / 128) + E row tiles, each inside one
//     expert (found by a binary search of `tiles`); tiles past tiles[E] exit
//     at once.  A is K-major; B is w[e], MN-major in fwd and K-major in dx.
//     Rows of the next expert that a tile's last load brings in are
//     computed and not stored.
//   dw: one block an (expert, M tile, N tile), its loop over the expert's
//     rows in steps of 64 starting at offsets[e]; both operands MN-major.
//     Rows of the next expert in the last step are zeroed in A before its
//     product.  An expert with no rows gets zeros.
// No row is padded or copied and nothing is allocated; K, M and N are
// multiples of 64 (the wrapper checks).
#include "hopper.cuh"

using namespace tpujob_hopper;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kBM = 128;       // rows a block: two consumer warpgroups of 64
constexpr int kBK = 64;        // a reduction step: one 128-byte bf16 row
constexpr int kStages = 4;     // ring depth
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kProducerRegs = 40;   // setmaxnreg budgets: 40 x 128 +
constexpr int kConsumerRegs = 232;  // 232 x 256 of the SM's 65,536
constexpr int kConsumerThreads = 256;
constexpr int kPanel = 64 * 64;     // elements of a [64][64] panel
constexpr int kPanelBytes = kPanel * 2;

template <int BN>
struct Smem {
  bf16 a[kStages][kBM * kBK];
  bf16 b[kStages][kBK * BN];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
template <int BN>
constexpr int kSmemBytes = sizeof(Smem<BN>) + kAlignBytes;

#define TPJ_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                  "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], both in shared memory; TA / TB
// 1 reads A / B MN-major (transposed), 0 K-major; `accumulate` 0 overwrites
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : TPJ_D8(0), TPJ_D8(8), TPJ_D8(16), TPJ_D8(24), TPJ_D8(32), TPJ_D8(40),
        TPJ_D8(48), TPJ_D8(56)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[64 x 256] (+)= A[64 x 16] . B[16 x 256], as wgmma_m64n128
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : TPJ_D8(0), TPJ_D8(8), TPJ_D8(16), TPJ_D8(24), TPJ_D8(32), TPJ_D8(40),
        TPJ_D8(48), TPJ_D8(56), TPJ_D8(64), TPJ_D8(72), TPJ_D8(80),
        TPJ_D8(88), TPJ_D8(96), TPJ_D8(104), TPJ_D8(112), TPJ_D8(120)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

#undef TPJ_D8

// one k16 step of a 64-row warpgroup: d (+)= A . B at BN columns
template <int TA, int TB>
__device__ __forceinline__ void wgmma_step(float (&d)[128], uint64_t da,
                                           uint64_t db, int accumulate) {
  wgmma_m64n256<TA, TB>(d, da, db, accumulate);
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  wgmma_m64n128<TA, TB>(d, da, db, accumulate);
}

// descriptor of an MN-major operand made of [64 reduction rows][64] panels
// `lbo` bytes apart (128-byte swizzle; SBO: 8 reduction rows, 1024 bytes)
__device__ __forceinline__ uint64_t desc_mn(const void* p, int lbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}
// a k16 step along the reduction: K-major +32 bytes, MN-major +16 rows
template <int T>
__device__ __forceinline__ uint64_t k_step(int kk) {
  return T ? (uint64_t)(16 * 128 >> 4) * kk : (uint64_t)2 * kk;
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int BN>
__device__ __forceinline__ void init_barriers(Smem<BN>& sm) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// the consumers' side of one reduction step: wait for stage `i`'s tiles,
// issue its four k16 products and, once the previous step's are done,
// hand that step's stage back to the producer
template <int TA, int TB, int R>
__device__ __forceinline__ void consume(float (&acc)[R], uint64_t* full,
                                        uint64_t* empty, int i, uint64_t da,
                                        uint64_t db) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_step<TA, TB>(acc, da + k_step<TA>(kk), db + k_step<TB>(kk), 1);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(acc);
  if (i > 0) mbar_arrive(&empty[(i - 1) % kStages]);
}

// the warpgroup's accumulator (64 rows x BN, fp32) as bf16 rows row0 ..
// row0+63 of `out` [.., N] from column n0; rows at or past `rows` skipped
template <int R>
__device__ __forceinline__ void store_bf16(bf16* out, int N, const float (&d)[R],
                                           int row0, int rows, int n0) {
  const int tid = threadIdx.x % 128;
  const int g = (tid % 32) / 4, t = tid % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 16 * (tid / 32) + g + 8 * half;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
      if (n0 + 8 * j < N)
        *reinterpret_cast<uint32_t*>(out + (long)r * N + n0 + 8 * j + 2 * t) =
            pack_bf16x2(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
  }
}

// rows of a grouped product: the body of tpujob_moe_gemm_fwd (TB 1: w[e]
// [K, N], MN-major) and tpujob_moe_gemm_dx (TB 0: w[e] [N, K], K-major)
template <int BN, int TB>
__device__ __forceinline__ void rows_body(const CUtensorMap& tmA,
                                          const CUtensorMap& tmB, bf16* out,
                                          const int* offsets, const int* tiles,
                                          int N, int K, int E) {
  extern __shared__ uint8_t smem_raw[];
  Smem<BN>& sm = *reinterpret_cast<Smem<BN>*>(align_atom(smem_raw));
  const int tile = blockIdx.y;
  if (tile >= tiles[E]) return;  // past the last tile: the whole block
  // the tile's expert: the last e < E with tiles[e] <= tile (an empty
  // expert's tiles[e] equals the next one's, so e holds rows)
  int e = 0, hi = E;
  while (hi - e > 1) {
    const int mid = (e + hi) / 2;
    if (tiles[mid] <= tile) e = mid; else hi = mid;
  }
  const int row0 = offsets[e] + (tile - tiles[e]) * kBM;
  const int row1 = offsets[e + 1];
  const int n0 = blockIdx.x * BN;
  const int steps = K / kBK;
  // warp-uniform to ptxas (broadcast from lane 0), so that no branch it
  // takes for divergent runs with wgmma results in flight (its C7518)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  init_barriers(sm);

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages;
        mbar_wait(&sm.empty[s], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[s], (kBM + BN) * kBK * 2);
        tma_load_2d(sm.a[s], &tmA, &sm.full[s], i * kBK, row0);
        if (TB) {
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_load_3d(sm.b[s] + p * kPanel, &tmB, &sm.full[s], n0 + 64 * p,
                        i * kBK, e);
        } else {
          tma_load_3d(sm.b[s], &tmB, &sm.full[s], i * kBK, n0, e);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < steps; ++i) {
      const int s = i % kStages;
      mbar_wait(&sm.full[s], (i / kStages) & 1);
      const uint64_t da = smem_desc<64>(sm.a[s] + cw * 64 * kBK);
      const uint64_t db = TB ? desc_mn(sm.b[s], kPanelBytes)
                             : smem_desc<64>(sm.b[s]);
      consume<0, TB>(acc, sm.full, sm.empty, i, da, db);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    store_bf16(out, N, acc, row0 + 64 * cw, row1, n0);
  }
}

}  // namespace

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
tpujob_moe_gemm_fwd(const __grid_constant__ CUtensorMap tmA,
                    const __grid_constant__ CUtensorMap tmB, bf16* out,
                    const int* offsets, const int* tiles, int N, int K,
                    int E) {
  rows_body<BN, 1>(tmA, tmB, out, offsets, tiles, N, K, E);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
tpujob_moe_gemm_dx(const __grid_constant__ CUtensorMap tmA,
                   const __grid_constant__ CUtensorMap tmB, bf16* out,
                   const int* offsets, const int* tiles, int N, int K, int E) {
  rows_body<BN, 0>(tmA, tmB, out, offsets, tiles, N, K, E);
}

// dw[e] [M, N] = a[rows of e]^T . g[rows of e]: a [R, M] and g [R, N]
// through 2-D maps with [64][64] boxes, read MN-major
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
tpujob_moe_gemm_dw(const __grid_constant__ CUtensorMap tmA,
                   const __grid_constant__ CUtensorMap tmG, float* dw,
                   const int* offsets, int M, int N) {
  extern __shared__ uint8_t smem_raw[];
  Smem<BN>& sm = *reinterpret_cast<Smem<BN>*>(align_atom(smem_raw));
  const int e = blockIdx.z;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
  // the expert's rows and the loop over them, warp-uniform to ptxas (as
  // the warpgroup index below): its loop runs with wgmma in flight
  const int lo = __shfl_sync(0xffffffffu, offsets[e], 0);
  const int hi = __shfl_sync(0xffffffffu, offsets[e + 1], 0);
  const int steps = (hi - lo + kBK - 1) / kBK;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  init_barriers(sm);

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages;
        const int r = lo + i * kBK;
        mbar_wait(&sm.empty[s], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[s], (kBM + BN) * kBK * 2);
#pragma unroll
        for (int p = 0; p < kBM / 64; ++p)
          tma_load_2d(sm.a[s] + p * kPanel, &tmA, &sm.full[s], m0 + 64 * p, r);
#pragma unroll
        for (int p = 0; p < BN / 64; ++p)
          tma_load_2d(sm.b[s] + p * kPanel, &tmG, &sm.full[s], n0 + 64 * p, r);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < steps; ++i) {
      const int s = i % kStages;
      mbar_wait(&sm.full[s], (i / kStages) & 1);
      bf16* panel = sm.a[s] + cw * kPanel;
      const int valid = hi - (lo + i * kBK);
      if (valid < kBK) {
        // the last step holds rows of the next expert: zero them in this
        // warpgroup's A panel (whole 128-byte rows, so the swizzle does
        // not matter), with nothing in flight while the threads diverge
        wgmma_wait<0>();
        fence_regs(acc);
        uint4* chunks = reinterpret_cast<uint4*>(panel);
#pragma unroll
        for (int c = 0; c < kPanelBytes / 16 / 128; ++c) {
          const int idx = tid + 128 * c;
          const uint4 v = chunks[idx];
          const bool dead = idx / 8 >= valid;
          chunks[idx] = dead ? make_uint4(0, 0, 0, 0) : v;
        }
        fence_proxy_async();
        named_bar_sync(1 + cw, 128);
      }
      consume<1, 1>(acc, sm.full, sm.empty, i, desc_mn(panel, kPanelBytes),
                    desc_mn(sm.b[s], kPanelBytes));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // fp32 out: row m0 + 64 cw + 16 w + g + 8 half, columns n0 + 8 j + 2 t
    const int g = (tid % 32) / 4, t = tid % 4;
    float* base = dw + (long)e * M * N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + 64 * cw + 16 * (tid / 32) + g + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        if (n0 + 8 * j < N)
          *reinterpret_cast<float2*>(base + (long)m * N + n0 + 8 * j + 2 * t) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

namespace {

// a map over a contiguous row-major bf16 tensor, dims innermost first,
// with a `box` of the same rank and the 128-byte swizzle (box[0] = 64)
int encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return (int)cudaErrorInitializationError;
  cuuint64_t strides[2];
  strides[0] = dims[0] * 2;
  if (rank > 2) strides[1] = strides[0] * dims[1];
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(ptr), dims, strides, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN>
int launch_rows(int transposed, const void* a, const void* w, void* out,
                const int* offsets, const int* tiles, int R, int K, int N,
                int E, cudaStream_t stream) {
  CUtensorMap ma, mb;
  const cuuint64_t da[2] = {(cuuint64_t)K, (cuuint64_t)R};
  const cuuint32_t ba[2] = {kBK, kBM};
  // fwd: w [E, K, N] in [64][64] panels; dx: w [E, N, K] in [BN][64] tiles
  const cuuint64_t dwt[3] = {(cuuint64_t)(transposed ? K : N),
                             (cuuint64_t)(transposed ? N : K), (cuuint64_t)E};
  const cuuint32_t bw[3] = {64, (cuuint32_t)(transposed ? BN : kBK), 1};
  int rc;
  if ((rc = encode(&ma, a, 2, da, ba)) || (rc = encode(&mb, w, 3, dwt, bw)))
    return rc;
  auto kernel = transposed ? tpujob_moe_gemm_dx<BN> : tpujob_moe_gemm_fwd<BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<BN>);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BN - 1) / BN, (R + kBM - 1) / kBM + E);
  kernel<<<grid, kThreads, kSmemBytes<BN>, stream>>>(ma, mb, (bf16*)out,
                                                     offsets, tiles, N, K, E);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_dw(const void* a, const void* g, void* dw, const int* offsets,
              int R, int M, int N, int E, cudaStream_t stream) {
  CUtensorMap ma, mg;
  const cuuint64_t da[2] = {(cuuint64_t)M, (cuuint64_t)R};
  const cuuint64_t dg[2] = {(cuuint64_t)N, (cuuint64_t)R};
  const cuuint32_t box[2] = {64, kBK};
  int rc;
  if ((rc = encode(&ma, a, 2, da, box)) || (rc = encode(&mg, g, 2, dg, box)))
    return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      tpujob_moe_gemm_dw<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes<BN>);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BN - 1) / BN, (M + kBM - 1) / kBM, E);
  tpujob_moe_gemm_dw<BN><<<grid, kThreads, kSmemBytes<BN>, stream>>>(
      ma, mg, (float*)dw, offsets, M, N);
  return (int)cudaGetLastError();
}

bool bad_dims(int R, int K, int N, int E) {
  return R <= 0 || E <= 0 || K <= 0 || N <= 0 || K % 64 || N % 64;
}

}  // namespace

// out [R, N] bf16 = a [R, K] times w[e] of each expert's rows: w [E, K, N]
// (transposed 0, tpujob_moe_gemm_fwd) or [E, N, K] read as its transpose
// (transposed 1, tpujob_moe_gemm_dx).  offsets and tiles as above.
extern "C" int tpujob_moe_gemm_rows(const void* a, const void* w, void* out,
                                    const void* offsets, const void* tiles,
                                    int R, int K, int N, int E, int transposed,
                                    void* stream) {
  if (bad_dims(R, K, N, E)) return (int)cudaErrorInvalidValue;
  const int* off = static_cast<const int*>(offsets);
  const int* til = static_cast<const int*>(tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return N % 256 == 0
             ? launch_rows<256>(transposed, a, w, out, off, til, R, K, N, E, s)
             : launch_rows<128>(transposed, a, w, out, off, til, R, K, N, E, s);
}

// dw [E, M, N] fp32 = a [R, M]^T g [R, N] over each expert's rows
// (tpujob_moe_gemm_dw)
extern "C" int tpujob_moe_gemm_weights(const void* a, const void* g, void* dw,
                                       const void* offsets, int R, int M,
                                       int N, int E, void* stream) {
  if (bad_dims(R, M, N, E)) return (int)cudaErrorInvalidValue;
  const int* off = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return N % 256 == 0 ? launch_dw<256>(a, g, dw, off, R, M, N, E, s)
                      : launch_dw<128>(a, g, dw, off, R, M, N, E, s);
}
