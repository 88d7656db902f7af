// Tensor-core pieces of the general flash forward, B1a (flash_fwd_any.cu):
// fp32 or bf16 inputs at head dim 1-256 on Hopper's wgmma (sm_90a), the
// tiles copied asynchronously into shared memory by TMA or by a producer
// warpgroup.  The panel layout, the split, the tf32 register-A wgmmas, the
// TMA maps and the producer's plain copies are flash_tc.cuh's (B2a/B3a),
// used as they are; this header adds what only the forward needs.
//
// Layout (the tuned B1's, flash_fwd.cu): a block owns BM = 64 NC query
// rows, one consumer warpgroup of 64 rows (wgmma's M) each, and walks the
// keys in tiles of KT through a 2-stage ring that a producer warpgroup
// fills.  For each live key tile a consumer computes S = Q K^T (m64nKT,
// A = its rows of Q and B = the K tile, both K-major in shared memory as
// stored), runs the online softmax on the accumulator layout (a query's
// scores lie in the four threads of a quad: quad shuffles), and adds
// P V with A = P from registers and B = V.  The transposed pattern of
// B2a/B3a (queries as N, P through shared memory, A loaded element by
// element) is not used: every operand either is in shared memory as the
// wgmma reads it or is born in registers.
//
// Trouble 1, tf32 reads shared-memory operands K-major only.  S is not
// affected (Q [q][d] and K [k][d] are K-major over d).  P V sums over the
// keys, so its B must be [d][keys]: bf16 reads V [keys][d] with wgmma's
// transpose bit (MN-major, one n64 wgmma a 64-column panel of V, as the
// tuned B1); fp32 has no transpose bit, so the producer writes V^T, a
// [DP][KT] tile, as it copies V from device memory (TMA cannot
// transpose): one plain load of each V value and two shared stores (big
// and small part) a tile, about as much work as copying and splitting K.
//
// Trouble 2, P's registers are not a tf32 A fragment.  The accumulator
// holds keys 8j + 2t and 8j + 2t + 1 of k-step j, a tf32 A fragment keys
// 8j + t and 8j + t + 4.  The key axis is summed over, so V^T's columns
// are stored in the accumulator's order instead: position t of each
// group of 8 holds key 2t, position t + 4 key 2t + 1 (key_pos).  Then each
// thread's P values are its A fragment as they lie (p_tf32), with no
// shuffle.  bf16's m64nNk16 A fragment already is two n8 blocks of the
// accumulator (p_bf16, as hopper.cuh's a_from_acc).
//
// Trouble 3, the split (flash_tc.cuh): fp32 runs both products as 3xTF32
// (big.big + big.small + small.big, each operand big + small in tf32).  Q
// is split once a block, K and V^T every tile, by the producer after the
// tile has landed: the TMA-landed tile is rounded to tf32 in place and its
// small part written beside it (split_tile), the plain copies split as
// they store (copy_split, put_vt); then fence.proxy.async and the
// mbarrier arrival.  P is split in registers.  bf16: S is an exact
// product of bf16 inputs (one wgmma); P enters P V as a bf16 high part and
// a bf16 low part (two wgmmas; one rounding of P to bf16, 2^-9, would be
// as large as ANY_TOL's 1e-3 x row rms term).
//
// Trouble 4, truncating accumulation: the tensor core truncates each sum
// it accumulates.  S: all small passes of all k-steps first, into an
// accumulator the first one zeroes, then the big passes: one truncation
// near S's size a k-step, ceil(d / 8) in all.  O (fp32): each tile's
// P V goes into a zeroed accumulator (small passes first) and is added to
// O with the softmax's rescale in fp32, so no truncation chain runs
// across tiles.  bf16 accumulates P V into O directly: its truncations
// (2^-23) are far below the bf16 output's rounding.
//
// Trouble 5, the budget.  fp32 tiles carry their small parts, so fp32
// takes KT = 32 keys a tile: Q, K and V^T with their small parts are 64,
// 128 and 192 KB at DP = 32, 64 and 128 (two consumers at DP <= 64, one
// at 128), and a consumer's registers (O and its per-tile accumulator,
// S, P's two parts) stay under the 168 a thread of 384.  bf16 takes
// KT = 64 and two consumers (one at DP = 256: O alone is 128 registers a
// thread).  fp32 at DP = 256 does not fit this layout (Q big + small
// alone is 128 KB at 64 rows, the 2-stage ring 256 more; O is 128
// registers a thread): the C entry point sends that bucket to
// flash_fwd_any_kernel_f32_256 (FwdWideGeom below), which keeps Q raw
// and splits each k-step's A fragment in registers (64 KB), holds K and
// V^T in one 32-key buffer each (64 + 64 KB), released one at a time, and
// splits S's k-steps and O's columns between two consumers (O 64
// registers each), with setmaxnreg's budgets.
//
// Trouble 6, copies: TMA where tma_takes allows (flash_tc.cuh: row
// strides of 16 bytes and at least one panel), one box a 128-byte panel,
// zero-filled past S and d; otherwise the producer's plain loads into the
// same layout.  The host picks the path before the launch.  V in fp32 is
// always copied by the producer (trouble 1).
//
// Trouble 7, padding: S's loops run ceil(d / 8) (tf32) or ceil(d / 16)
// (bf16) k-steps; O is stored for the d real columns only.
#pragma once

#include "flash_tc.cuh"

namespace tpujob_flash_fwd_tc {

using tpujob_flash::bf16;
using namespace tpujob_hopper;
using namespace tpujob_flash_tc;

// The forward's tiles of input type T at padded head dim DP.
template <class T, int DP>
struct FwdGeom {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kEPP = kPanel / (int)sizeof(T);  // values a panel row
  static constexpr int kNP = (DP + kEPP - 1) / kEPP;    // panels of a row
  static constexpr int kCols = kNP * kEPP;              // stored columns
  static constexpr int NC = (kF32 ? DP >= 128 : DP >= 256) ? 1 : 2;
  static constexpr int BM = 64 * NC;                    // query rows a block
  static constexpr int KT = kF32 ? 32 : 64;             // keys a tile
  static constexpr int kBlockThreads = 128 * (1 + NC);
  static constexpr int kKW = kF32 ? 8 : 16;             // K of a k-step
  static constexpr int kParts = kF32 ? 2 : 1;           // big (+ small)
  // K/V tiles in flight (three where shared memory allows was no faster:
  // fp32 at GPT's shape 0.3892 -> 0.3997 ms, bf16 at d = 128 0.1332 ->
  // 0.1342, kernels.ab)
  static constexpr int kStages = 2;
  // S's k-steps, ceil(d / kKW), for the d of this bucket: kNksLo .. DP / kKW
  static constexpr int kNksLo = DP == 32 ? 1 : DP / 2 / kKW + 1;
  static constexpr int kNksHi = DP / kKW;
  // the softmax in base 2 (ex2 of the log2(e)-scaled score, one FFMA)
  // for bf16; fp32 keeps expf, as the plain version (ex2 rounds the
  // argument otherwise, by up to 1e-6 relative in P)
  static constexpr bool kExp2 = !kF32;
  // O's accumulators: fp32 N = DP as n64 blocks (one n32 at DP = 32);
  // bf16 one n64 block a panel of V
  static constexpr int kNB = kF32 ? (DP + 63) / 64 : kNP;
  static constexpr int kOW = kF32 && DP < 64 ? DP / 2 : 32;  // floats each
};

// Shared memory of a block.  fp32: q, k hold the tile rounded to tf32 and
// its small part, v holds V^T [DP][KT] (big, small); bf16: one part each,
// v is V [KT][kCols].  Every tile is a multiple of 1024 bytes.
template <class T, int DP>
struct FwdSmem {
  using G = FwdGeom<T, DP>;
  T q[G::kParts][G::BM * G::kCols];
  T k[G::kStages][G::kParts][G::KT * G::kCols];
  T v[G::kStages][G::kParts][G::KT * G::kCols];
  uint64_t q_land;              // fp32 by TMA: Q landed (then split)
  uint64_t q_full;              // Q ready for the consumers
  uint64_t land[G::kStages];    // fp32 by TMA: K landed
  uint64_t full[G::kStages];    // K and V ready
  uint64_t empty[G::kStages];   // the consumers are done with the stage
};

// ---------------------------------------------------------------------------
// wgmma: tf32 with A and B K-major in shared memory, m64n32k8
// ---------------------------------------------------------------------------

#define TPJ_FWD_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])

// d (+)= A B, A = da (64 rows), B = db (32 rows); acc 0 overwrites d
__device__ __forceinline__ void mma_tf32_ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : TPJ_FWD_D8(0), TPJ_FWD_D8(8)
      : "l"(da), "l"(db), "r"(acc));
}

#undef TPJ_FWD_D8

// S = Q K^T over NKS k-steps, issued as one batch and waited for: dq0 /
// dq1 this consumer's rows of Q (big / small part: a BM-row tile), dk0 /
// dk1 the K tile's (KT rows).  fp32 runs the small passes of every k-step
// first (the first overwrites the accumulator), then the big ones
// (trouble 4); bf16 one pass.  NKS is a compile-time count: a loop bound
// ptxas cannot see, between the wgmmas of a batch, serializes every wgmma
// of the kernel (its C7515).
template <class T, int BM, int KT, int NKS>
__device__ __forceinline__ void scores_of(float (&sc)[KT / 2], uint64_t dq0,
                                          uint64_t dq1, uint64_t dk0,
                                          uint64_t dk1) {
  wgmma_fence();
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      mma_tf32_ss(sc, dq0 + kstep<BM>(ks), dk1 + kstep<KT>(ks), ks > 0);
      mma_tf32_ss(sc, dq1 + kstep<BM>(ks), dk0 + kstep<KT>(ks), 1);
    }
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
      mma_tf32_ss(sc, dq0 + kstep<BM>(ks), dk0 + kstep<KT>(ks), 1);
  } else {
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
      wgmma_m64n64_ss(sc, dq0 + kstep<BM>(ks), dk0 + kstep<KT>(ks), ks > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
}

// scores_of at nks k-steps (LO <= nks <= HI), chosen by a binary search
// before any wgmma is issued (trouble 7: ceil(d / 8) or ceil(d / 16)
// k-steps, not the bucket's)
template <class T, int BM, int KT, int LO, int HI>
__device__ __forceinline__ void scores(int nks, float (&sc)[KT / 2],
                                       uint64_t dq0, uint64_t dq1,
                                       uint64_t dk0, uint64_t dk1) {
  if constexpr (LO == HI) {
    scores_of<T, BM, KT, LO>(sc, dq0, dq1, dk0, dk1);
  } else {
    constexpr int kMid = (LO + HI) / 2;
    if (nks <= kMid)
      scores<T, BM, KT, LO, kMid>(nks, sc, dq0, dq1, dk0, dk1);
    else
      scores<T, BM, KT, kMid + 1, HI>(nks, sc, dq0, dq1, dk0, dk1);
  }
}

// ---------------------------------------------------------------------------
// P as an A operand
// ---------------------------------------------------------------------------

// V^T's column of key kk (0-7) within its group of 8: the accumulator's
// key 2t at position t, key 2t + 1 at position t + 4 (trouble 2)
__device__ __forceinline__ int key_pos(int key) {
  return (key & ~7) | ((key & 1) << 2) | ((key & 7) >> 1);
}

// tf32 A fragment of k-step j (keys 8j .. 8j + 7 in key_pos order) from
// P in the accumulator layout: a[0] row g key 2t, a[1] row g + 8 key 2t,
// a[2] row g key 2t + 1, a[3] row g + 8 key 2t + 1; big and small parts
template <int R>
__device__ __forceinline__ void p_tf32(const float (&p)[R], int j,
                                       uint32_t big[4], uint32_t small[4]) {
  split_tf32(p[4 * j + 0], big[0], small[0]);
  split_tf32(p[4 * j + 2], big[1], small[1]);
  split_tf32(p[4 * j + 1], big[2], small[2]);
  split_tf32(p[4 * j + 3], big[3], small[3]);
}

// bf16 A fragment of k16 step kk from P in the accumulator layout, as a
// high part and a low part (x - high)
template <int R>
__device__ __forceinline__ void p_bf16(const float (&p)[R], int kk,
                                       uint32_t hi[4], uint32_t lo[4]) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const float x0 = p[8 * kk + 2 * w], x1 = p[8 * kk + 2 * w + 1];
    const bf16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
    hi[w] = bf16_bits(h0) | (bf16_bits(h1) << 16);
    lo[w] = pack_bf16x2(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
  }
}

// ---------------------------------------------------------------------------
// the producer's copies (its 128 threads)
// ---------------------------------------------------------------------------

// An fp32 tile of N values (TMA-landed) rounded to tf32 in place, its
// small part into xs: elementwise, so the layout does not matter.
template <int N>
__device__ __forceinline__ void split_tile(float* x, float* xs) {
  float4* x4 = reinterpret_cast<float4*>(x);
  float4* s4 = reinterpret_cast<float4*>(xs);
  for (int i = threadIdx.x % 128; i < N / 4; i += 128) {
    const float4 v = x4[i];
    const float4 big = make_float4(tf32_big(v.x), tf32_big(v.y),
                                   tf32_big(v.z), tf32_big(v.w));
    x4[i] = big;
    s4[i] = make_float4(tf32_small(v.x, big.x), tf32_small(v.y, big.y),
                        tf32_small(v.z, big.z), tf32_small(v.w, big.w));
  }
}

// Rows row0 .. row0 + R - 1 of fp32 x [B, S, H, d] at (b, h) into the
// panel tiles d0 (rounded to tf32) and d1 (small parts), C stored
// columns, zeros past S and past d.
template <int R, int C>
__device__ __forceinline__ void copy_split(float* d0, float* d1,
                                           const float* x, int b, int h,
                                           int H, int S, int d, int row0) {
  for (int i = threadIdx.x % 128; i < R * C; i += 128) {
    const int r = i / C, c = i % C, s = row0 + r;
    const float v = s < S && c < d ? x[((long)(b * S + s) * H + h) * d + c]
                                   : 0.f;
    const float big = tf32_big(v);
    at<float, R>(d0, r, c) = big;
    at<float, R>(d1, r, c) = tf32_small(v, big);
  }
}

// Keys k0 .. k0 + KT - 1 of fp32 v [B, S, H, d] at (b, h) as V^T: tile vb
// [DP][KT] (rounded to tf32) and vs (small parts), key columns in key_pos
// order, zeros past S and past d.  Every load is issued before the first
// store.  (Loading the next tile's values while waiting for the stage was
// slower: 0.389 -> 0.413 ms at GPT's fp32 shape, kernels.ab.)
template <int DP, int KT>
__device__ __forceinline__ void put_vt(float* vb, float* vs, const float* v,
                                       int b, int h, int H, int S, int d,
                                       int k0) {
  constexpr int kPer = KT * DP / 128;
  constexpr int kRound = kPer < 32 ? kPer : 32;  // loads in flight
  const int pt = threadIdx.x % 128;
#pragma unroll
  for (int u0 = 0; u0 < kPer; u0 += kRound) {
    float x[kRound];
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int i = pt + 128 * (u0 + u), key = i / DP, c = i % DP;
      const int s = k0 + key;
      x[u] = s < S && c < d ? v[((long)(b * S + s) * H + h) * d + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int i = pt + 128 * (u0 + u), key = i / DP, c = i % DP;
      const float big = tf32_big(x[u]);
      at<float, DP>(vb, c, key_pos(key)) = big;
      at<float, DP>(vs, c, key_pos(key)) = tf32_small(x[u], big);
    }
  }
}

// The producer warpgroup: Q once, then K and V for each key tile kt_begin
// .. kt_end - 1 into the ring (waiting for the stage to be empty), each
// completing on its barrier with the producer's 128 arrivals.
template <class T, int DP, class Sm>
__device__ __forceinline__ void produce_fwd(
    Sm& sm, const CUtensorMap* mq, const CUtensorMap* mk,
    const CUtensorMap* mv, const tpujob_flash_any::Args& a, int use_tma,
    int q0, int b, int h, int kt_begin, int kt_end) {
  using G = FwdGeom<T, DP>;
  constexpr int BM = G::BM, KT = G::KT, C = G::kCols;
  const T* q = (const T*)a.q;
  const T* k = (const T*)a.k;
  const T* v = (const T*)a.v;
  const int pt = threadIdx.x % 128;
  // one TMA box a panel of `rows` rows from sequence row `row0`
  auto tma_tile = [&](T* dst, const CUtensorMap* map, uint64_t* bar,
                      int rows, int row0) {
#pragma unroll
    for (int p = 0; p < G::kNP; ++p)
      tma_load_panel(reinterpret_cast<uint8_t*>(dst) + p * rows * kPanel,
                     map, bar, p * G::kEPP, row0, h, b);
  };
  if constexpr (G::kF32) {
    if (use_tma) {
      if (pt == 0) {
        mbar_arrive_expect_tx(&sm.q_land, BM * C * (int)sizeof(T));
        tma_tile(sm.q[0], mq, &sm.q_land, BM, q0);
      }
      mbar_wait(&sm.q_land, 0);
      split_tile<BM * C>(sm.q[0], sm.q[1]);
    } else {
      copy_split<BM, C>(sm.q[0], sm.q[1], q, b, h, a.H, a.Sq, a.d, q0);
    }
    fence_async_shared();
    mbar_arrive(&sm.q_full);
    for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
      const int s = i % G::kStages, ph = (i / G::kStages) & 1;
      mbar_wait(&sm.empty[s], ph ^ 1);
      if (use_tma && pt == 0) {
        mbar_arrive_expect_tx(&sm.land[s], KT * C * (int)sizeof(T));
        tma_tile(sm.k[s][0], mk, &sm.land[s], KT, kt * KT);
      }
      put_vt<DP, KT>(sm.v[s][0], sm.v[s][1], v, b, h, a.H, a.Sk, a.d,
                     kt * KT);
      if (use_tma) {
        mbar_wait(&sm.land[s], ph);
        split_tile<KT * C>(sm.k[s][0], sm.k[s][1]);
      } else {
        copy_split<KT, C>(sm.k[s][0], sm.k[s][1], k, b, h, a.H, a.Sk, a.d,
                          kt * KT);
      }
      fence_async_shared();
      mbar_arrive(&sm.full[s]);
    }
  } else {
    if (use_tma) {
      if (pt == 0) {
        mbar_arrive_expect_tx(&sm.q_full, BM * C * (int)sizeof(T));
        tma_tile(sm.q[0], mq, &sm.q_full, BM, q0);
      } else {
        mbar_arrive(&sm.q_full);
      }
    } else {
      copy_tile<T, BM, C>(sm.q[0], q, b, h, a.H, a.Sq, a.d, q0);
      fence_async_shared();
      mbar_arrive(&sm.q_full);
    }
    for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
      const int s = i % G::kStages;
      mbar_wait(&sm.empty[s], ((i / G::kStages) & 1) ^ 1);
      produce<T, KT, C>(sm.k[s][0], sm.v[s][0], mk, mv, k, v, &sm.full[s],
                        use_tma, kt * KT, b, h, a.H, a.Sk, a.d);
    }
  }
}

// ---------------------------------------------------------------------------
// the online softmax of one key tile (both layouts)
// ---------------------------------------------------------------------------

// Scores sc of KT keys from k0 (accumulator layout; the thread's rows
// qrow[0], qrow[1], quad t) scaled, masked where `edge` (masked scores
// -inf: P exactly 0; m starts at the reference's finite -1e30, so it stays
// finite) and turned into P; the rows' running max m and sum l updated,
// alpha their rescale.  kExp2: the scores times scale log2(e), then ex2
// (bf16); else expf (fp32).
template <int KT, bool kExp2>
__device__ __forceinline__ void online_softmax(
    float (&sc)[KT / 2], const int (&qrow)[2], int t, int k0, bool edge,
    float scale, const tpujob_flash_any::Args& a, float (&m)[2],
    float (&l)[2], float (&alpha)[2]) {
  auto exp_of = [](float x) { return kExp2 ? ex2(x) : expf(x); };
  const float masked = __int_as_float(0xff800000u);
  float mx[2] = {tpujob_flash::kNegInf, tpujob_flash::kNegInf};
#pragma unroll
  for (int j = 0; j < KT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * scale;
      if (edge && !tpujob_flash_any::sees(qrow[e >> 1],
                                          k0 + 8 * j + 2 * t + (e & 1), a.Sq,
                                          a.Sk, a.causal, a.window))
        x = masked;
      sc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], tpujob_flash::quad_max(mx[r]));
    alpha[r] = exp_of(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < KT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp_of(sc[4 * j + e] - m[e >> 1]);
      sc[4 * j + e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + tpujob_flash::quad_sum(sum[r]);
}

// ---------------------------------------------------------------------------
// fp32 at padded head dim 256 (trouble 5)
// ---------------------------------------------------------------------------

// The tiles of flash_fwd_any_kernel_f32_256: two consumers of the same 64
// query rows; Q raw fp32 (its tf32 parts made in registers as each
// k-step's A fragment is loaded, flash_tc.cuh's first_product), K and V^T
// (put_vt) with their small parts in 32-key tiles, one buffer each: 64 +
// 64 + 64 KB.  K is released after S and V^T after P V, so the next K
// lands during the softmax and P V and the next V^T during S.  Each
// consumer sums S over half of the head dim and holds half of O's columns
// (64 registers, not 128: one consumer with all of O spilled); the two
// halves of S meet in sx (by tile parity).
struct FwdWideGeom {
  static constexpr int DP = 256, BM = 64, KT = 32;
  static constexpr int kNC = 2;                     // consumer warpgroups
  static constexpr int kCols = DP;                  // stored columns of Q, K
  static constexpr int kNB = DP / 32 / kNC;         // a consumer's n32 blocks
  static constexpr int kBlockThreads = 128 * (1 + kNC);
  // setmaxnreg's budgets: at the 168 registers a thread that 384 threads
  // allow, the consumers spilled (0.8953 ms at b 8, s 1024, h 8, d 256;
  // 0.8733 with these budgets and no spill, kernels.ab)
  static constexpr int kProducerRegs = 96;
  static constexpr int kConsumerRegs = 200;
};

struct FwdWideSmem {
  using G = FwdWideGeom;
  float q[G::BM * G::kCols];
  float k[2][G::KT * G::kCols];           // big, small
  float v[2][G::DP * G::KT];              // V^T big, small
  float sx[2][G::kNC][G::KT / 2 * 128];   // each consumer's part of S
  uint64_t q_full;                        // Q landed
  uint64_t k_land;                        // by TMA: K landed
  uint64_t k_full, k_empty;               // K ready / released
  uint64_t v_full, v_empty;               // V^T ready / released
};

// The producer warpgroup of flash_fwd_any_kernel_f32_256: Q once (raw),
// then for each key tile kt_begin .. kt_end - 1 K (split after it lands)
// once the consumers have released the last one, and V^T likewise.  TMA
// loads only the panels holding one of the d real columns: the S k-steps
// read no others.
__device__ __forceinline__ void produce_fwd_wide(
    FwdWideSmem& sm, const CUtensorMap* mq, const CUtensorMap* mk,
    const tpujob_flash_any::Args& a, int use_tma, int q0, int b, int h,
    int kt_begin, int kt_end) {
  using G = FwdWideGeom;
  constexpr int KT = G::KT, C = G::kCols;
  produce_tile<float, G::BM, C>(sm.q, mq, (const float*)a.q, &sm.q_full,
                                use_tma, q0, b, h, a.H, a.Sq, a.d);
  const int np = (a.d + 31) / 32;
  for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
    const int ph = i & 1;
    mbar_wait(&sm.k_empty, ph ^ 1);
    if (use_tma) {
      if (threadIdx.x % 128 == 0) {
        mbar_arrive_expect_tx(&sm.k_land, np * KT * kPanel);
        for (int p = 0; p < np; ++p)
          tma_load_panel(reinterpret_cast<uint8_t*>(sm.k[0]) + p * KT * kPanel,
                         mk, &sm.k_land, 32 * p, kt * KT, h, b);
      }
      mbar_wait(&sm.k_land, ph);
      split_tile<KT * C>(sm.k[0], sm.k[1]);
    } else {
      copy_split<KT, C>(sm.k[0], sm.k[1], (const float*)a.k, b, h, a.H,
                        a.Sk, a.d, kt * KT);
    }
    fence_async_shared();
    mbar_arrive(&sm.k_full);
    mbar_wait(&sm.v_empty, ph ^ 1);
    put_vt<G::DP, KT>(sm.v[0], sm.v[1], (const float*)a.v, b, h, a.H, a.Sk,
                      a.d, kt * KT);
    fence_async_shared();
    mbar_arrive(&sm.v_full);
  }
}

}  // namespace tpujob_flash_fwd_tc
