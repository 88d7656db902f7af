// The general flash kernels' own route for bf16 at head dim exactly 128
// (B1a-B3a's bf16 d=128 kernels): flash_fwd_any_kernel_bf16,
// flash_dq_any_kernel_bf16 and flash_dkv_any_kernel_bf16, each launched
// by a C entry point of its own in its source (tpujob_flash_*_bf16_128 in
// flash_fwd_any.cu, flash_dq_any.cu, flash_dkv_any.cu), which flash.route
// picks on dtype bf16 and d == 128 alone.
// Every other input keeps the general kernels (flash_fwd_tc.cuh,
// flash_tc.cuh).  Each kernel is a template on the head dim, instantiated
// at 128 only, so that a source compiles its own kernel and not the other
// two.
//
// They replace, for this input, the Pallas kernels of
// tpujob/workloads/flash.py that B1a-B3a replace (_flash_kernel,
// _dq_kernel, _dkv_kernel) and compute the same functions in the same
// arithmetic as the general bf16 route (flash_any.cuh): S and dP one bf16
// wgmma pass each (exact products of bf16 inputs, fp32 sums); P and dS,
// fp32 values, as a bf16 high part and a bf16 low part (x - high), two
// wgmmas each; every sum in fp32.
//
// Bound on an H100 SXM at Mellum2's attention (b 2, s 8192, h 32, d 128;
// window 1,024 and full causal): the FLOPs, 4 / 6 / 8 x d x the visible
// pairs for the forward / dQ / dK-dV, over 989 TFLOP/s (0.26 / 0.39 / 0.52
// ms a windowed launch, 1.11 / 1.67 / 2.22 full); the bytes (q, k, v, o,
// dO, dq, dk, dv: 134 MB each) take 0.16-0.24 ms: bound by operations.
// The split runs S and dP once and the products with P and dS twice: 1.5x,
// 1.33x and 1.5x of that bound.
//
// Why a kernel of its own: the general kernels were designed for fp32 and
// any head dim (flash_tc.cuh's troubles 1-4): N = 32 fixed rows a consumer
// in the backward, 64-key tiles in the forward, a 2-stage ring, no
// setmaxnreg, and every A operand of the backward's second products
// (Y^T) loaded element by element into registers, with a wait after each
// batch.  bf16 needs none of that: wgmma reads bf16 shared-memory operands
// transposed (MN-major) itself.  So here:
//   - A block has a producer warpgroup (setmaxnreg down to kProducerRegs)
//     whose one thread keeps a TMA ring full, and two consumer warpgroups
//     (setmaxnreg up to kConsumerRegs) of 64 rows each, 128 fixed rows a
//     block.  Full and empty mbarriers a stage.
//   - A [rows][128] bf16 tile is two 128-byte column panels, panel p
//     holding columns 64p .. 64p + 63 of every row, 128-byte swizzled (as
//     flash_tc.cuh's panels), one TMA box a panel (encode_panels).  Read
//     K-major (the 128 columns as the reduction axis) one k16 step is 32
//     bytes along a panel row, the second panel from step 4 (kstep); read
//     MN-major (the rows as the reduction axis, N = 128 columns) the two
//     panels are the descriptor's two 64-column atoms, LBO apart (mn_desc).
//   - The first products (S, dP) take both operands from shared memory;
//     the second products take P or dS from registers, where the first
//     product left them (the accumulator layout is wgmma's A fragment),
//     split in place, and Y^T (V, K, Q or dO) MN-major from shared memory:
//     no fragment is loaded element by element.
//   - The accumulators (O, dQ, or dK and dV) stay in registers for the
//     whole block and are stored once.  No atomics, so two launches on the
//     same inputs give the same bits.
//   - Tiles dead under the causal mask or the window are not loaded
//     (flash_common.cuh's k_range / q_range), tiles dead for one consumer's
//     rows not computed, and only tiles crossing the diagonal, the window
//     or the ragged edge masked.  TMA zero-fills rows past S.
// Per kernel:
//   forward: 128 queries a block, 128-key K and V tiles through a 3-stage
//     ring (224 KB).  S of key tile n is issued with P V of tile n-1, so
//     the softmax of tile n runs while P V does, and the two consumers
//     take turns to issue (named barriers), as the tuned B1 (flash_fwd.cu)
//     does; the longest causal q-tiles first.
//   dQ: 128 queries a block (Q and dO resident), 64-key K and V tiles
//     through a 4-stage ring; S and dP are issued behind the dQ product of
//     the tile before, P is formed while dP runs (flash_dq.cu's pipeline).
//   dK/dV: 128 keys a block (K and V resident), 64-query Q and dO tiles
//     with their lse and D through a 4-stage ring; P^T is formed while
//     dP^T runs, and both second products are issued together.
#pragma once

#include "flash_tc.cuh"

namespace tpujob_flash_bf16 {

using namespace tpujob_hopper;
using tpujob_flash::bf16;
using tpujob_flash::kNegInf;
using tpujob_flash_any::Args;
using tpujob_flash_tc::kPanel;
using tpujob_flash_tc::kstep;
using tpujob_flash_tc::panel_desc;
using tpujob_flash_tc::tma_load_panel;

constexpr int kD = 128;              // the head dim of this route
constexpr int kRowBytes = kD * 2;    // a bf16 row: two panels' rows
constexpr int kBlockThreads = 384;   // producer + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 24;    // setmaxnreg budgets: 24 x 128 +
constexpr int kConsumerRegs = 240;   // 240 x 256 of the SM's 65,536
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTurnBar = 1;          // + c: forward consumer c's turn

// forward: queries a block, keys a tile, ring depth
constexpr int kFwdBM = 128, kFwdKT = 128, kFwdStages = 3;
// dQ: queries a block, keys a tile, ring depth
constexpr int kDqBM = 128, kDqKT = 64, kDqStages = 4;
// dK/dV: keys a block, queries a tile, ring depth
constexpr int kDkvBN = 128, kDkvQT = 64, kDkvStages = 4;

// Shared memory of each kernel.  Every tile is a multiple of 1024 bytes,
// so each starts on a swizzle atom.
struct FwdSmem {
  bf16 q[kFwdBM * kD];
  bf16 k[kFwdStages][kFwdKT * kD];
  bf16 v[kFwdStages][kFwdKT * kD];
  uint64_t q_full;
  uint64_t full[kFwdStages];
  uint64_t empty[kFwdStages];
};

struct DqSmem {
  bf16 q[kDqBM * kD];
  bf16 dout[kDqBM * kD];
  bf16 k[kDqStages][kDqKT * kD];
  bf16 v[kDqStages][kDqKT * kD];
  float lse[kDqBM];  // lse * log2(e): P = 2^(scale log2(e) S - this)
  float delta[kDqBM];
  uint64_t q_full;
  uint64_t full[kDqStages];
  uint64_t empty[kDqStages];
};

struct DkvSmem {
  bf16 k[kDkvBN * kD];
  bf16 v[kDkvBN * kD];
  bf16 q[kDkvStages][kDkvQT * kD];
  bf16 dout[kDkvStages][kDkvQT * kD];
  float lse[kDkvStages][kDkvQT];  // times log2(e), as DqSmem's
  float delta[kDkvStages][kDkvQT];
  uint64_t kv_full;
  uint64_t full[kDkvStages];
  uint64_t empty[kDkvStages];
};

// ---------------------------------------------------------------------------
// device: tiles and descriptors
// ---------------------------------------------------------------------------

// R rows of one head (row `row`, head h, batch b) of a [B, S, H, 128] map
// whose box is one panel, into the two panels of dst, completing on bar
template <int R>
__device__ __forceinline__ void tma_rows(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int h,
                                         int b) {
  tma_load_panel(dst, map, bar, 0, row, h, b);
  tma_load_panel(reinterpret_cast<uint8_t*>(dst) + R * kPanel, map, bar, 64,
                 row, h, b);
}

// rows r0 .. of a [R][128] panel tile: the K-major descriptor of the
// first panel (kstep<R> reaches the second)
__device__ __forceinline__ uint64_t rows_desc(const bf16* tile, int r0) {
  return panel_desc(reinterpret_cast<const uint8_t*>(tile) + r0 * kPanel);
}

// A [R][128] panel tile read MN-major as an N = 128 B operand: the two
// 64-column panels are the two swizzle atoms along N, R * 128 bytes apart
// (LBO); 8-row groups along K 1024 bytes apart (SBO); 128-byte swizzle
template <int R>
__device__ __forceinline__ uint64_t mn_desc(const bf16* tile) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) |
         ((uint64_t)(R * kPanel / 16) << 16) | (64ull << 32) | (1ull << 62);
}

// descriptor offset (16-byte units) of MN-major k16 step kk: 16 rows on
__device__ __forceinline__ uint64_t mn_step(int kk) {
  return (uint64_t)(16 * kPanel / 16) * kk;
}

// ---------------------------------------------------------------------------
// device: wgmma, and P / dS split into A fragments
// ---------------------------------------------------------------------------

#define TPJ_B16_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])

// d[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (the
// accumulator layout's pair of n8 blocks), B MN-major in shared memory
__device__ __forceinline__ void wgmma_m64n128_rs_t(float (&d)[64],
                                                   const uint32_t a[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, "
      "%68, p, 1, 1, 1;\n}\n"
      : TPJ_B16_D8(0), TPJ_B16_D8(8), TPJ_B16_D8(16), TPJ_B16_D8(24),
        TPJ_B16_D8(32), TPJ_B16_D8(40), TPJ_B16_D8(48), TPJ_B16_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef TPJ_B16_D8

// k16 step kk of an fp32 accumulator x as a bf16 A fragment in two parts:
// hi = x rounded to bf16, lo = x - hi rounded to bf16 (17 of fp32's 24
// significant bits together)
template <int R>
__device__ __forceinline__ void split_frag(const float (&x)[R], int kk,
                                           uint32_t hi[4], uint32_t lo[4]) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const float x0 = x[8 * kk + 2 * w], x1 = x[8 * kk + 2 * w + 1];
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
    hi[w] = *reinterpret_cast<const uint32_t*>(&h2);
    lo[w] = pack_bf16x2(x0 - __low2float(h2), x1 - __high2float(h2));
  }
}

// v[0] = op(v[0], ..., v[15]) in four levels
template <class Op>
__device__ __forceinline__ float tree16(float (&v)[16], Op op) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = op(v[j], v[j + 8]);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = op(v[j], v[j + 4]);
  v[0] = op(op(v[0], v[2]), op(v[1], v[3]));
  return v[0];
}

// ---------------------------------------------------------------------------
// B1a, bf16 at head dim 128
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_fwd_any_kernel_bf16(const __grid_constant__ CUtensorMap tmQ,
                              const __grid_constant__ CUtensorMap tmK,
                              const __grid_constant__ CUtensorMap tmV,
                              const Args a) {
  static_assert(D == kD, "the route is built for head dim 128");
  extern __shared__ uint8_t smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(align_atom(smem_raw));
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdBM;  // longest first
  int kt_begin, kt_end;
  tpujob_flash::k_range<kFwdBM, kFwdKT>(q0, a.Sk, a.causal, a.window,
                                        &kt_begin, &kt_end);
  // warp-uniform to ptxas (see flash_fwd.cu)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&sm.q_full, kFwdBM * kRowBytes);
      tma_rows<kFwdBM>(sm.q, &tmQ, &sm.q_full, q0, h, b);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int s = i % kFwdStages;
        mbar_wait(&sm.empty[s], ((i / kFwdStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[s], 2 * kFwdKT * kRowBytes);
        tma_rows<kFwdKT>(sm.k[s], &tmK, &sm.full[s], kt * kFwdKT, h, b);
        tma_rows<kFwdKT>(sm.v[s], &tmV, &sm.full[s], kt * kFwdKT, h, b);
      }
    }
    return;
  }

  // ---- consumers: 64 queries each, from r0 ----
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1, tid = threadIdx.x % 128, t = tid % 4;
  const int r0 = q0 + 64 * cw;
  const int wr = 16 * (tid / 32) + (tid % 32) / 4;
  const int qrow[2] = {r0 + wr, r0 + wr + 8};  // the thread's two rows
  // the keys each of them sees: key_lo[r] .. key_hi[r]
  int key_lo[2], key_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_hi[r] = a.causal ? min(qrow[r], a.Sk - 1) : a.Sk - 1;
    key_lo[r] = (a.causal && a.window > 0) ? qrow[r] - a.window + 1 : 0;
  }
  // the key tiles one of rows r0 .. r0 + 63 sees; none past Sq
  int live_b = kt_begin, live_e = kt_end;
  if (a.causal) {
    live_e = min(kt_end, (r0 + 63) / kFwdKT + 1);
    if (a.window > 0)
      live_b = max(kt_begin, max(r0 - a.window + 1, 0) / kFwdKT);
  }
  if (r0 >= a.Sq) live_e = live_b;
  const float scale_log2 = a.scale * kLog2e;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float sc[kFwdKT / 2];  // S of the newest tile, then its P
  // P's two parts, of the tile whose P V is in flight
  uint32_t hi[kFwdKT / 16][4], lo[kFwdKT / 16][4];

  auto stage = [&](int kt) { return (kt - kt_begin) % kFwdStages; };
  auto wait_full = [&](int kt) {
    mbar_wait(&sm.full[stage(kt)], ((kt - kt_begin) / kFwdStages) & 1);
  };
  // S = Q K^T (64 x 128 fp32, both K-major), issued and committed
  const uint64_t desc_q = rows_desc(sm.q, 64 * cw);
  auto issue_s = [&](int kt) {
    wait_full(kt);
    const uint64_t desc_k = rows_desc(sm.k[stage(kt)], 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n128_ss(sc, desc_q + kstep<kFwdBM>(kk),
                       desc_k + kstep<kFwdKT>(kk), kk > 0);
    wgmma_commit();
  };
  // O += P V, P's low part then its high part, V MN-major
  auto issue_pv = [&](int kt) {
    const uint64_t desc_v = mn_desc<kFwdKT>(sm.v[stage(kt)]);
#pragma unroll
    for (int kk = 0; kk < kFwdKT / 16; ++kk) {
      wgmma_m64n128_rs_t(o, lo[kk], desc_v + mn_step(kk));
      wgmma_m64n128_rs_t(o, hi[kk], desc_v + mn_step(kk));
    }
    wgmma_commit();
  };
  // the online softmax of sc in place, in base 2 (edge tiles masked to
  // -inf, so that their P is exactly 0): updates m and l, returns O's
  // rescale
  auto softmax = [&](int kt, float alpha[2]) {
    const int k0 = kt * kFwdKT;
    const bool edge =
        k0 + kFwdKT > a.Sk ||
        (a.causal && (k0 + kFwdKT - 1 > r0 ||
                      (a.window > 0 && r0 + 63 - k0 >= a.window)));
    if (edge) {
      const float masked = __int_as_float(0xff800000u);
#pragma unroll
      for (int j = 0; j < kFwdKT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          if (key > key_hi[e >> 1] || key < key_lo[e >> 1])
            sc[4 * j + e] = masked;
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float red[kFwdKT / 8];
#pragma unroll
      for (int j = 0; j < kFwdKT / 8; ++j)
        red[j] = fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]);
      const float rmax = tpujob_flash::quad_max(
          tree16(red, [](float x, float y) { return fmaxf(x, y); }));
      const float mnew = fmaxf(m[r], rmax * scale_log2);
      alpha[r] = ex2(m[r] - mnew);
      m[r] = mnew;
    }
#pragma unroll
    for (int j = 0; j < kFwdKT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -m[e >> 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float red[kFwdKT / 8];
#pragma unroll
      for (int j = 0; j < kFwdKT / 8; ++j)
        red[j] = sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
      l[r] = l[r] * alpha[r] + tpujob_flash::quad_sum(tree16(
                                   red, [](float x, float y) { return x + y; }));
    }
  };
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kFwdKT / 16; ++kk) split_frag(sc, kk, hi[kk], lo[kk]);
  };
  // the two consumers take turns to issue their products (named barriers
  // kTurnBar + c), so that one's softmax runs while the other's products
  // hold the tensor cores; each takes kt_end - kt_begin + 1 turns, as
  // flash_fwd.cu's
  const int turns = kt_end - kt_begin + 1;
  int turn = 0;
  auto turn_begin = [&]() { named_bar_sync(kTurnBar + cw, kConsumerThreads); };
  auto turn_end = [&]() {
    if (cw == 0 || ++turn < turns)
      named_bar_arrive(kTurnBar + 1 - cw, kConsumerThreads);
  };
  auto pass_over = [&](int kt) {  // a key tile dead for these rows
    wait_full(kt);
    mbar_arrive(&sm.empty[stage(kt)]);
    turn_begin();
    turn_end();
  };

  if (cw == 0) named_bar_arrive(kTurnBar, kConsumerThreads);
  mbar_wait(&sm.q_full, 0);
  for (int kt = kt_begin; kt < min(live_b, kt_end); ++kt) pass_over(kt);
  if (live_b < live_e) {
    float alpha[2];
    turn_begin();
    issue_s(live_b);
    turn_end();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(live_b, alpha);
    split_p();
    for (int kt = live_b + 1; kt < live_e; ++kt) {
      turn_begin();
      issue_s(kt);
      issue_pv(kt - 1);
      turn_end();
      wgmma_wait<1>();  // S of tile kt
      fence_regs(sc);
      softmax(kt, alpha);
      wgmma_wait<0>();  // P V of tile kt - 1
      fence_regs(o);
      mbar_arrive(&sm.empty[stage(kt - 1)]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
      split_p();
    }
    fence_regs(o);
    turn_begin();
    wgmma_fence();
    issue_pv(live_e - 1);
    turn_end();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&sm.empty[stage(live_e - 1)]);
  } else {
    turn_begin();  // the turn of the products this warpgroup skips
    turn_end();
  }
  for (int kt = max(live_b, live_e); kt < kt_end; ++kt) pass_over(kt);

  // o / l (0 for a row that saw no key), lse = m ln 2 + log l
  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                        l[1] > 0.f ? 1.f / l[1] : 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= inv[e >> 1];
  store_acc_rows((bf16*)a.out0 + ((long)b * a.Sq * a.H + h) * D,
                 (long)a.H * D, o, r0, a.Sq);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qrow[r] < a.Sq)
        a.lse_out[(long)bh * a.Sq + qrow[r]] =
            m[r] * 0.6931471805599453f + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// B2a, bf16 at head dim 128
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_dq_any_kernel_bf16(const __grid_constant__ CUtensorMap tmQ,
                             const __grid_constant__ CUtensorMap tmK,
                             const __grid_constant__ CUtensorMap tmV,
                             const __grid_constant__ CUtensorMap tmDO,
                             const Args a) {
  static_assert(D == kD, "the route is built for head dim 128");
  extern __shared__ uint8_t smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(align_atom(smem_raw));
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqBM;  // longest first
  int kt_begin, kt_end;
  tpujob_flash::k_range<kDqBM, kDqKT>(q0, a.Sk, a.causal, a.window,
                                      &kt_begin, &kt_end);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 33);  // warp 0's lanes, and the TMA issue
#pragma unroll
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: warp 0 the query side, warp 1 the K/V ring ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.q_full, 2 * kDqBM * kRowBytes);
        tma_rows<kDqBM>(sm.q, &tmQ, &sm.q_full, q0, h, b);
        tma_rows<kDqBM>(sm.dout, &tmDO, &sm.q_full, q0, h, b);
      }
      for (int r = lane; r < kDqBM; r += 32) {
        const bool ok = q0 + r < a.Sq;
        sm.lse[r] = ok ? a.lse[(long)bh * a.Sq + q0 + r] * kLog2e : 0.f;
        sm.delta[r] = ok ? a.delta[(long)bh * a.Sq + q0 + r] : 0.f;
      }
      mbar_arrive(&sm.q_full);
    } else if (threadIdx.x == 32) {
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int s = i % kDqStages;
        mbar_wait(&sm.empty[s], ((i / kDqStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[s], 2 * kDqKT * kRowBytes);
        tma_rows<kDqKT>(sm.k[s], &tmK, &sm.full[s], kt * kDqKT, h, b);
        tma_rows<kDqKT>(sm.v[s], &tmV, &sm.full[s], kt * kDqKT, h, b);
      }
    }
    return;
  }

  // ---- consumers: 64 queries each, from r0 ----
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1, tid = threadIdx.x % 128, t = tid % 4;
  const int r0 = q0 + 64 * cw;
  const int lrow = 64 * cw + 16 * (tid / 32) + (tid % 32) / 4;
  const int qrow[2] = {q0 + lrow, q0 + lrow + 8};
  int key_lo[2], key_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_hi[r] = a.causal ? min(qrow[r], a.Sk - 1) : a.Sk - 1;
    key_lo[r] = (a.causal && a.window > 0) ? qrow[r] - a.window + 1 : 0;
  }
  int live_b = kt_begin, live_e = kt_end;
  if (a.causal) {
    live_e = min(kt_end, (r0 + 63) / kDqKT + 1);
    if (a.window > 0)
      live_b = max(kt_begin, max(r0 - a.window + 1, 0) / kDqKT);
  }
  if (r0 >= a.Sq) live_e = live_b;
  const float scale_log2 = a.scale * kLog2e;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float sc[kDqKT / 2], dp[kDqKT / 2];  // S then P; dP then dS
  // dS's two parts, of the tile whose dQ product is in flight
  uint32_t hi[kDqKT / 16][4], lo[kDqKT / 16][4];

  auto stage = [&](int kt) { return (kt - kt_begin) % kDqStages; };
  auto wait_full = [&](int kt) {
    mbar_wait(&sm.full[stage(kt)], ((kt - kt_begin) / kDqStages) & 1);
  };
  auto pass_over = [&](int kt) {
    wait_full(kt);
    mbar_arrive(&sm.empty[stage(kt)]);
  };

  mbar_wait(&sm.q_full, 0);
  const float lse2[2] = {sm.lse[lrow], sm.lse[lrow + 8]};
  const float dlt[2] = {sm.delta[lrow], sm.delta[lrow + 8]};
  const uint64_t desc_q = rows_desc(sm.q, 64 * cw);
  const uint64_t desc_do = rows_desc(sm.dout, 64 * cw);
  for (int kt = kt_begin; kt < min(live_b, kt_end); ++kt) pass_over(kt);
  // the dQ product of key tile n-1 runs ahead of S and dP of tile n, and
  // P of tile n is formed while its dP runs
  for (int kt = live_b; kt < live_e; ++kt) {
    const int s = stage(kt), k0 = kt * kDqKT;
    wait_full(kt);
    const uint64_t desc_k = rows_desc(sm.k[s], 0);
    const uint64_t desc_v = rows_desc(sm.v[s], 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64_ss(sc, desc_q + kstep<kDqBM>(kk),
                      desc_k + kstep<kDqKT>(kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64_ss(dp, desc_do + kstep<kDqBM>(kk),
                      desc_v + kstep<kDqKT>(kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // tile n-1's dQ product, and S
    fence_regs(sc);
    if (kt > live_b) mbar_arrive(&sm.empty[stage(kt - 1)]);

    // P (columns are keys), exactly 0 where masked on edge tiles
    const bool edge =
        k0 + kDqKT > a.Sk ||
        (a.causal && (k0 + kDqKT - 1 > r0 ||
                      (a.window > 0 && r0 + 63 - k0 >= a.window)));
#pragma unroll
    for (int j = 0; j < kDqKT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        float p = ex2(fmaf(sc[4 * j + e], scale_log2, -lse2[e >> 1]));
        if (edge && (key < key_lo[e >> 1] || key > key_hi[e >> 1])) p = 0.f;
        sc[4 * j + e] = p;
      }
    wgmma_wait<0>();  // dP
    fence_regs(dp);

    // dS = P o (dP - D) (the scale at the end), split; dQ += dS K with K
    // MN-major, the low part first
#pragma unroll
    for (int j = 0; j < kDqKT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dlt[e >> 1]);
#pragma unroll
    for (int kk = 0; kk < kDqKT / 16; ++kk) split_frag(dp, kk, hi[kk], lo[kk]);
    const uint64_t mn_k = mn_desc<kDqKT>(sm.k[s]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqKT / 16; ++kk) {
      wgmma_m64n128_rs_t(dq, lo[kk], mn_k + mn_step(kk));
      wgmma_m64n128_rs_t(dq, hi[kk], mn_k + mn_step(kk));
    }
    wgmma_commit();
  }
  wgmma_wait<0>();  // on every path, so ptxas injects no wait of its own
  fence_regs(dq);
  if (live_b < live_e) mbar_arrive(&sm.empty[stage(live_e - 1)]);
  for (int kt = max(live_b, live_e); kt < kt_end; ++kt) pass_over(kt);

#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] *= a.scale;
  store_acc_rows((bf16*)a.out0 + ((long)b * a.Sq * a.H + h) * D,
                 (long)a.H * D, dq, r0, a.Sq);
}

// ---------------------------------------------------------------------------
// B3a, bf16 at head dim 128
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_dkv_any_kernel_bf16(const __grid_constant__ CUtensorMap tmQ,
                              const __grid_constant__ CUtensorMap tmK,
                              const __grid_constant__ CUtensorMap tmV,
                              const __grid_constant__ CUtensorMap tmDO,
                              const Args a) {
  static_assert(D == kD, "the route is built for head dim 128");
  extern __shared__ uint8_t smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(align_atom(smem_raw));
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * kDkvBN;  // causal: the first keys see most
  int qt_begin, qt_end;
  tpujob_flash::q_range<kDkvBN, kDkvQT>(k0, a.Sq, a.causal, a.window,
                                        &qt_begin, &qt_end);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&sm.full[s], 32);  // the producer warp's lanes
      mbar_init(&sm.empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: warp 0 keeps the ring full ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.kv_full, 2 * kDkvBN * kRowBytes);
        tma_rows<kDkvBN>(sm.k, &tmK, &sm.kv_full, k0, h, b);
        tma_rows<kDkvBN>(sm.v, &tmV, &sm.kv_full, k0, h, b);
      }
      for (int qt = qt_begin, i = 0; qt < qt_end; ++qt, ++i) {
        const int s = i % kDkvStages, q0 = qt * kDkvQT;
        mbar_wait(&sm.empty[s], ((i / kDkvStages) & 1) ^ 1);
        for (int r = lane; r < kDkvQT; r += 32) {
          const bool ok = q0 + r < a.Sq;
          sm.lse[s][r] = ok ? a.lse[(long)bh * a.Sq + q0 + r] * kLog2e : 0.f;
          sm.delta[s][r] = ok ? a.delta[(long)bh * a.Sq + q0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.full[s], 2 * kDkvQT * kRowBytes);
          tma_rows<kDkvQT>(sm.q[s], &tmQ, &sm.full[s], q0, h, b);
          tma_rows<kDkvQT>(sm.dout[s], &tmDO, &sm.full[s], q0, h, b);
        } else {
          mbar_arrive(&sm.full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 keys each, from kr0 ----
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1, tid = threadIdx.x % 128, t = tid % 4;
  const int kr0 = k0 + 64 * cw;
  const int wr = 16 * (tid / 32) + (tid % 32) / 4;
  const int krow[2] = {kr0 + wr, kr0 + wr + 8};  // the thread's two keys
  // the queries that see each of them: q_lo[r] .. q_hi[r]
  int q_lo[2], q_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    q_lo[r] = a.causal ? krow[r] : 0;
    q_hi[r] = (a.causal && a.window > 0)
                  ? min(krow[r] + a.window - 1, a.Sq - 1)
                  : a.Sq - 1;
    if (krow[r] >= a.Sk) q_hi[r] = -1;  // a key past Sk is seen by none
  }
  // the q-tiles holding a query that sees one of keys kr0 .. kr0 + 63;
  // none past Sk
  int live_b = qt_begin, live_e = qt_end;
  if (a.causal) {
    live_b = max(qt_begin, kr0 / kDkvQT);
    if (a.window > 0)
      live_e = min(qt_end, (kr0 + 63 + a.window - 1) / kDkvQT + 1);
  }
  if (kr0 >= a.Sk) live_e = live_b;
  const float scale_log2 = a.scale * kLog2e;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float st[kDkvQT / 2], dpt[kDkvQT / 2];  // S^T then P^T; dP^T then dS^T
  uint32_t phi[kDkvQT / 16][4], plo[kDkvQT / 16][4];  // P^T's two parts
  uint32_t dhi[kDkvQT / 16][4], dlo[kDkvQT / 16][4];  // dS^T's

  auto stage = [&](int qt) { return (qt - qt_begin) % kDkvStages; };
  auto wait_full = [&](int qt) {
    mbar_wait(&sm.full[stage(qt)], ((qt - qt_begin) / kDkvStages) & 1);
  };
  auto pass_over = [&](int qt) {
    wait_full(qt);
    mbar_arrive(&sm.empty[stage(qt)]);
  };

  mbar_wait(&sm.kv_full, 0);
  const uint64_t desc_k = rows_desc(sm.k, 64 * cw);
  const uint64_t desc_v = rows_desc(sm.v, 64 * cw);
  for (int qt = qt_begin; qt < min(live_b, qt_end); ++qt) pass_over(qt);
  for (int qt = live_b; qt < live_e; ++qt) {
    const int s = stage(qt), q0 = qt * kDkvQT;
    wait_full(qt);

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries, both K-major)
    const uint64_t desc_qt = rows_desc(sm.q[s], 0);
    const uint64_t desc_dot = rows_desc(sm.dout[s], 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64_ss(st, desc_k + kstep<kDkvBN>(kk),
                      desc_qt + kstep<kDkvQT>(kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64_ss(dpt, desc_v + kstep<kDkvBN>(kk),
                      desc_dot + kstep<kDkvQT>(kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S^T
    fence_regs(st);

    // P^T (columns are queries), exactly 0 where masked on edge tiles
    const bool edge =
        q0 + kDkvQT > a.Sq || kr0 + 64 > a.Sk ||
        (a.causal && (q0 < kr0 + 63 ||
                      (a.window > 0 && q0 + kDkvQT - 1 - kr0 >= a.window)));
    const float* lse2 = sm.lse[s];
#pragma unroll
    for (int j = 0; j < kDkvQT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        float p = ex2(fmaf(st[4 * j + e], scale_log2, -lse2[qc]));
        if (edge && (q0 + qc < q_lo[e >> 1] || q0 + qc > q_hi[e >> 1]))
          p = 0.f;
        st[4 * j + e] = p;
      }
    wgmma_wait<0>();  // dP^T
    fence_regs(dpt);

    // dS^T = P^T o (dP^T - D) scale; both split, then dV += P^T dO and
    // dK += dS^T Q with dO and Q MN-major, each low part first
    const float* dlt = sm.delta[s];
#pragma unroll
    for (int j = 0; j < kDkvQT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dlt[qc]) * a.scale;
      }
#pragma unroll
    for (int kk = 0; kk < kDkvQT / 16; ++kk) {
      split_frag(st, kk, phi[kk], plo[kk]);
      split_frag(dpt, kk, dhi[kk], dlo[kk]);
    }
    const uint64_t mn_do = mn_desc<kDkvQT>(sm.dout[s]);
    const uint64_t mn_q = mn_desc<kDkvQT>(sm.q[s]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDkvQT / 16; ++kk) {
      wgmma_m64n128_rs_t(dv, plo[kk], mn_do + mn_step(kk));
      wgmma_m64n128_rs_t(dv, phi[kk], mn_do + mn_step(kk));
    }
#pragma unroll
    for (int kk = 0; kk < kDkvQT / 16; ++kk) {
      wgmma_m64n128_rs_t(dk, dlo[kk], mn_q + mn_step(kk));
      wgmma_m64n128_rs_t(dk, dhi[kk], mn_q + mn_step(kk));
    }
    wgmma_commit();
    // the parts' registers are the next tile's S^T and dP^T: wait here
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(&sm.empty[s]);
  }
  for (int qt = max(live_b, live_e); qt < qt_end; ++qt) pass_over(qt);

  const long off = ((long)b * a.Sk * a.H + h) * D, stride = (long)a.H * D;
  store_acc_rows((bf16*)a.out0 + off, stride, dk, kr0, a.Sk);
  store_acc_rows((bf16*)a.out1 + off, stride, dv, kr0, a.Sk);
}

}  // namespace tpujob_flash_bf16
