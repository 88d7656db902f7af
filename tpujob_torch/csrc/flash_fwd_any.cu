// Flash-attention forward for any head dim 1-256, fp32 or bf16 in, on
// Hopper's tensor cores (wgmma, sm_90a) with split precision (B1a).
//
// Replaces the Pallas kernel tpujob/workloads/flash.py:_flash_kernel (with
// _flash_forward, _block_scores and _causal_live) for every input the
// tuned flash_fwd.cu does not take: O = softmax(scale Q K^T + mask) V with
// the causal / sliding-window mask, and the per-row logsumexp
// lse = m + log l the backward kernels recompute P from, o in the input's
// dtype, lse fp32.  The reference sums every product in fp32; masked
// scores are -1e30 and their P is 0.
//
// Bound on an H100 SXM at the GPT-2-medium shape in fp32 (b=8, s=1024,
// h=16, d=64, causal): it must read q, k, v and write o, 4 x 33.6 MB =
// 134 MB, 40 us at 3.35 TB/s; its causal FLOPs are 17.2 G, 35 us at tf32's
// 495 TFLOP/s in one pass: bound by bytes.  The split's reach is three
// tf32 passes of both products, 104 us (fp32 FFMA's 67 TFLOP/s: 257 us).
// In bf16 (b=8, s=1024, h=8, d=128) it moves 67 MB (20 us) for 17.2 GFLOP;
// S takes one bf16 pass and P V two, so the split's reach is 1.5 passes at
// 989 TFLOP/s, 26 us.  fp32 at d=256 (b=8, s=1024, h=8, causal): 4 x 67.1
// MB = 269 MB, 80 us; 34.4 GFLOP, 70 us in one tf32 pass: bound by bytes;
// the split's reach 209 us (FFMA: 514 us).
//
// Design (flash_fwd_tc.cuh, which says how each trouble of the design is
// met): one block per (BM-row q-tile, batch*head), the longest causal
// q-tiles first; a producer warpgroup and BM / 64 consumer warpgroups of 64
// queries each.  The producer copies Q once (TMA, or plain loads where TMA
// cannot take the strides; fp32 split into tf32 parts), then each live
// key tile's K and V (flash_common.cuh's k_range: dead tiles skipped)
// through a 2-stage ring (fp32: V written transposed, V^T).  Each
// consumer, per key tile that one of its rows sees:
//   S = Q K^T (64 x KT; A = its Q rows, B = K, both shared memory);
//   the online softmax in registers on the accumulator layout (each row's
//     running max m and sum l; fp32 with expf, as the plain version, bf16
//     in base 2 with ex2), masked only on tiles crossing the diagonal, the
//     window or the ragged edge;
//   O += P V (64 x d; A = P from registers, B = V^T or V transposed).
// fp32 runs both products as 3xTF32 (wgmma .tf32), each tile's P V into a
// zeroed accumulator added to O in fp32; bf16 S as one bf16 wgmma and P V
// with P as high + low bf16 parts.  O is the consumer's own (no atomics),
// so two launches on the same inputs give the same bits.
//
// fp32 at padded head dim 256 does not fit a block's shared memory on this
// layout (flash_fwd_tc.cuh, trouble 5): the C entry point sends that bucket
// to flash_fwd_any_kernel_f32_256, the same products with Q split in
// registers and K and V^T released one at a time (32-key tiles), two
// consumers splitting S's k-steps and O's columns.
#include "flash_bf16_128.cuh"
#include "flash_fwd_tc.cuh"

namespace tpujob_flash_any {

// B1a on the tensor cores: template on the input type and the padded head
// dim DP (32, 64, 128; 256 in bf16 only: fp32 at 256 below).
template <class T, int DP>
__global__ void
__launch_bounds__(tpujob_flash_fwd_tc::FwdGeom<T, DP>::kBlockThreads, 1)
    flash_fwd_any_kernel(const __grid_constant__ CUtensorMap tmQ,
                         const __grid_constant__ CUtensorMap tmK,
                         const __grid_constant__ CUtensorMap tmV,
                         const Args a, int use_tma) {
  using namespace tpujob_flash_fwd_tc;
  using G = FwdGeom<T, DP>;
  using Sm = FwdSmem<T, DP>;
  constexpr int BM = G::BM, KT = G::KT;
  extern __shared__ uint8_t smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(align_atom(smem_raw));
  const int n_qt = (a.Sq + BM - 1) / BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BM;  // longest first
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  int kt_begin, kt_end;
  tpujob_flash::k_range<BM, KT>(q0, a.Sk, a.causal, a.window, &kt_begin,
                                &kt_end);
  // warp-uniform to ptxas (see flash_fwd.cu)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_land, 1);
    mbar_init(&sm.q_full, 128);
#pragma unroll
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&sm.land[s], 1);
      mbar_init(&sm.full[s], 128);
      mbar_init(&sm.empty[s], 128 * G::NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    produce_fwd<T, DP>(sm, &tmQ, &tmK, &tmV, a, use_tma, q0, b, h, kt_begin,
                       kt_end);
    return;
  }

  // ---- consumers: 64 queries each, from r0 ----
  const int cw = wg - 1, r0 = q0 + 64 * cw;
  const int tid = threadIdx.x % 128, t = tid % 4;
  const int wr = 16 * (tid / 32) + (tid % 32) / 4;
  const int qrow[2] = {r0 + wr, r0 + wr + 8};  // the thread's two rows
  // the key tiles one of rows r0 .. r0 + 63 sees (the rest of the block's
  // range is passed over); none for rows wholly past Sq
  int live_b = kt_begin, live_e = kt_end;
  if (a.causal) {
    live_e = min(kt_end, (r0 + 63) / KT + 1);
    if (a.window > 0) live_b = max(kt_begin, max(r0 - a.window + 1, 0) / KT);
  }
  if (r0 >= a.Sq) live_e = live_b;
  const int nks = (a.d + G::kKW - 1) / G::kKW;
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale = G::kExp2 ? a.scale * kLog2e : a.scale;
  // this consumer's rows of Q: 64 cw rows into each panel
  auto rows = [&](const T* x) {
    return panel_desc(reinterpret_cast<const uint8_t*>(x) + 64 * cw * kPanel);
  };
  const uint64_t dq0 = rows(sm.q[0]), dq1 = rows(sm.q[G::kParts - 1]);

  float o[G::kNB][G::kOW];
#pragma unroll
  for (int nb = 0; nb < G::kNB; ++nb)
#pragma unroll
    for (int i = 0; i < G::kOW; ++i) o[nb][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(&sm.q_full, 0);

  for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
    const int s = i % G::kStages;
    mbar_wait(&sm.full[s], (i / G::kStages) & 1);
    if (kt >= live_b && kt < live_e) {
      const int k0 = kt * KT;
      const uint64_t dk0 = panel_desc(sm.k[s][0]);
      const uint64_t dk1 = panel_desc(sm.k[s][G::kParts - 1]);
      const uint64_t dv0 = panel_desc(sm.v[s][0]);

      // S = Q K^T (flash_fwd_tc.cuh: scores)
      float sc[KT / 2];
      scores<T, BM, KT, G::kNksLo, G::kNksHi>(nks, sc, dq0, dq1, dk0, dk1);

      // the online softmax (flash_fwd_tc.cuh: online_softmax)
      const bool edge =
          k0 + KT > a.Sk ||
          (a.causal && (k0 + KT - 1 > r0 ||
                        (a.window > 0 && r0 + 63 - k0 >= a.window)));
      float alpha[2];
      online_softmax<KT, G::kExp2>(sc, qrow, t, k0, edge, scale, a, m, l,
                                   alpha);

      // O += P V
      if constexpr (G::kF32) {
        // 3xTF32 into a zeroed accumulator, small passes first, added to
        // the rescaled O in fp32 (trouble 4); B = V^T, n64 blocks of its
        // DP rows (one n32 at DP = 32)
        const uint64_t dv1 = panel_desc(sm.v[s][1]);
        uint32_t pb[KT / 8][4], ps[KT / 8][4];
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) p_tf32(sc, j, pb[j], ps[j]);
        float ot[G::kNB][G::kOW];
#pragma unroll
        for (int nb = 0; nb < G::kNB; ++nb)
#pragma unroll
          for (int i2 = 0; i2 < G::kOW; ++i2) ot[nb][i2] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int nb = 0; nb < G::kNB; ++nb) {
            const uint64_t off = nb * 64 * (kPanel / 16) + kstep<DP>(j);
            mma_tf32(ot[nb], pb[j], dv1 + off);
            mma_tf32(ot[nb], ps[j], dv0 + off);
          }
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int nb = 0; nb < G::kNB; ++nb)
            mma_tf32(ot[nb], pb[j],
                     dv0 + nb * 64 * (kPanel / 16) + kstep<DP>(j));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int nb = 0; nb < G::kNB; ++nb) {
          fence_regs(ot[nb]);
#pragma unroll
          for (int i2 = 0; i2 < G::kOW; ++i2)
            o[nb][i2] = o[nb][i2] * alpha[(i2 >> 1) & 1] + ot[nb][i2];
        }
      } else {
        // O rescaled, then P's low and high parts times V, read transposed
        // (MN-major), one n64 wgmma a panel of V
        uint32_t hi[KT / 16][4], lo[KT / 16][4];
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) p_bf16(sc, kk, hi[kk], lo[kk]);
#pragma unroll
        for (int nb = 0; nb < G::kNB; ++nb)
#pragma unroll
          for (int i2 = 0; i2 < G::kOW; ++i2)
            o[nb][i2] *= alpha[(i2 >> 1) & 1];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
          for (int nb = 0; nb < G::kNB; ++nb) {
            const uint64_t dv = dv0 + nb * KT * (kPanel / 16) +
                                mnmajor_step<64>(kk);
            wgmma_m64nN_rs_t(o[nb], lo[kk], dv);
            wgmma_m64nN_rs_t(o[nb], hi[kk], dv);
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int nb = 0; nb < G::kNB; ++nb) fence_regs(o[nb]);
      }
    }
    mbar_arrive(&sm.empty[s]);
  }

  // o / l for the d real columns of the rows before Sq (0 for a row that
  // saw no key), lse = m + log l
  T* out = (T*)a.out0;
#pragma unroll
  for (int nb = 0; nb < G::kNB; ++nb)
#pragma unroll
    for (int j = 0; j < G::kOW / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = qrow[e >> 1], c = 64 * nb + 8 * j + 2 * t + (e & 1);
        const float lr = l[e >> 1];
        if (row < a.Sq && c < a.d)
          out[((long)(b * a.Sq + row) * a.H + h) * a.d + c] =
              from_f<T>(lr > 0.f ? o[nb][4 * j + e] / lr : 0.f);
      }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qrow[r] < a.Sq)
        a.lse_out[(long)bh * a.Sq + qrow[r]] =
            (G::kExp2 ? m[r] * 0.6931471805599453f : m[r]) + logf(l[r]);
  }
}

// B1a for fp32 at padded head dim 256 (flash_fwd_tc.cuh, trouble 5): the
// producer and two consumer warpgroups of the same 64 query rows.  S = Q
// K^T takes Q from registers (flash_tc.cuh's first_product: each k-step's A
// fragment loaded from the raw fp32 Q tile and split into its tf32 parts
// there, batches of four k-steps into a zeroed accumulator, small passes
// first), K from a 32-key tile; each consumer over its half of the
// k-steps, the halves added through shared memory (a + b in both, so both
// run the same softmax).  P V runs 32 of O's columns at a time, 3xTF32
// into a zeroed accumulator added to O with the softmax's rescale, the
// next block's wgmmas issued before this one's are waited for.
__global__ void __launch_bounds__(tpujob_flash_fwd_tc::FwdWideGeom::
                                      kBlockThreads, 1)
    flash_fwd_any_kernel_f32_256(const __grid_constant__ CUtensorMap tmQ,
                                 const __grid_constant__ CUtensorMap tmK,
                                 const Args a, int use_tma) {
  using namespace tpujob_flash_fwd_tc;
  using G = FwdWideGeom;
  using Sm = FwdWideSmem;
  constexpr int BM = G::BM, KT = G::KT, C = G::kCols, NB = G::kNB;
  extern __shared__ uint8_t smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(align_atom(smem_raw));
  const int n_qt = (a.Sq + BM - 1) / BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BM;  // longest first
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  int kt_begin, kt_end;
  tpujob_flash::k_range<BM, KT>(q0, a.Sk, a.causal, a.window, &kt_begin,
                                &kt_end);
  // warp-uniform to ptxas (see flash_fwd.cu)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 128);
    mbar_init(&sm.k_land, 1);
    mbar_init(&sm.k_full, 128);
    mbar_init(&sm.k_empty, 128 * G::kNC);
    mbar_init(&sm.v_full, 128);
    mbar_init(&sm.v_empty, 128 * G::kNC);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<G::kProducerRegs>();
    produce_fwd_wide(sm, &tmQ, &tmK, a, use_tma, q0, b, h, kt_begin, kt_end);
    return;
  }
  setmaxnreg_inc<G::kConsumerRegs>();

  // ---- consumer cw: rows q0 .. q0 + 63, O's columns 32 NB cw .. ----
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128, t = tid % 4;
  const int wr = 16 * (tid / 32) + (tid % 32) / 4;
  const int qrow[2] = {q0 + wr, q0 + wr + 8};  // the thread's two rows
  // this consumer's k-steps of S: whole panels (four k-steps) from ks0
  const int nks = (a.d + 7) / 8, half = (nks + 7) / 8 * 4;
  const int ks0 = cw == 0 ? 0 : half;
  const int my_nks = cw == 0 ? min(nks, half) : max(nks - half, 0);
  const float* qs = sm.q + ks0 / 4 * BM * 32;  // from panel ks0 / 4

  float o[NB][16];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 16; ++i) o[nb][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(&sm.q_full, 0);

  for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
    const int k0 = kt * KT;
    mbar_wait(&sm.k_full, i & 1);

    // S = Q K^T over this consumer's k-steps (K then released), then the
    // other's part added
    float sc[KT / 2];
    const uint64_t kpanel = ks0 / 4 * KT * (kPanel / 16);
    first_product<float, KT, KT, C>(sc, qs, panel_desc(sm.k[0]) + kpanel,
                                    panel_desc(sm.k[1]) + kpanel, my_nks);
    mbar_arrive(&sm.k_empty);
    {
      float* mine = sm.sx[i & 1][cw];
      const float* other = sm.sx[i & 1][cw ^ 1];
#pragma unroll
      for (int e = 0; e < KT / 2; ++e) mine[128 * e + tid] = sc[e];
      named_bar_sync(kFixedBar, 256);
#pragma unroll
      for (int e = 0; e < KT / 2; ++e) sc[e] += other[128 * e + tid];
    }

    const bool edge =
        k0 + KT > a.Sk ||
        (a.causal && (k0 + KT - 1 > q0 ||
                      (a.window > 0 && q0 + 63 - k0 >= a.window)));
    float alpha[2];
    online_softmax<KT, false>(sc, qrow, t, k0, edge, a.scale, a, m, l,
                              alpha);

    // O += P V, 32 columns a block: B = V^T's rows 32 (NB cw + nb) ..
    uint32_t pb[KT / 8][4], ps[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) p_tf32(sc, j, pb[j], ps[j]);
    mbar_wait(&sm.v_full, i & 1);
    const uint64_t dv0 = panel_desc(sm.v[0]), dv1 = panel_desc(sm.v[1]);
    auto issue = [&](float (&acc)[16], int nb) {
      const uint64_t blk = (NB * cw + nb) * 32 * (kPanel / 16);
#pragma unroll
      for (int i2 = 0; i2 < 16; ++i2) acc[i2] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {  // the small passes first
        mma_tf32(acc, pb[j], dv1 + blk + kstep<G::DP>(j));
        mma_tf32(acc, ps[j], dv0 + blk + kstep<G::DP>(j));
      }
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
        mma_tf32(acc, pb[j], dv0 + blk + kstep<G::DP>(j));
      wgmma_commit();
    };
    float ot[2][16];
    issue(ot[0], 0);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      if (nb + 1 < NB) {
        issue(ot[(nb + 1) & 1], nb + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(ot[nb & 1]);
#pragma unroll
      for (int i2 = 0; i2 < 16; ++i2)
        o[nb][i2] = o[nb][i2] * alpha[(i2 >> 1) & 1] + ot[nb & 1][i2];
    }
    mbar_arrive(&sm.v_empty);
  }

  // o / l for the d real columns of the rows before Sq, lse = m + log l
  float* out = (float*)a.out0;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = qrow[e >> 1];
        const int c = 32 * (NB * cw + nb) + 8 * j + 2 * t + (e & 1);
        const float lr = l[e >> 1];
        if (row < a.Sq && c < a.d)
          out[((long)(b * a.Sq + row) * a.H + h) * a.d + c] =
              lr > 0.f ? o[nb][4 * j + e] / lr : 0.f;
      }
  if (t == 0 && cw == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qrow[r] < a.Sq)
        a.lse_out[(long)bh * a.Sq + qrow[r]] = m[r] + logf(l[r]);
  }
}

}  // namespace tpujob_flash_any

// Host side: the launches and the C entry points.

using namespace tpujob_flash_any;

template <class T, int DP>
static int launch_fwd_tc(const Args& a, int B, void* stream) {
  using namespace tpujob_flash_fwd_tc;
  using G = FwdGeom<T, DP>;
  constexpr int smem = (int)sizeof(FwdSmem<T, DP>) + kAlignBytes;
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  const void* ptrs[3] = {a.q, a.k, a.v};
  const int use_tma = tma_takes<T>(a.d, ptrs, 3);
  CUtensorMap mq = {}, mk = {}, mv = {};
  int rc;
  if (use_tma &&
      ((rc = encode_panels<T>(&mq, a.q, B, a.Sq, a.H, a.d, G::BM)) ||
       (rc = encode_panels<T>(&mk, a.k, B, a.Sk, a.H, a.d, G::KT)) ||
       (rc = encode_panels<T>(&mv, a.v, B, a.Sk, a.H, a.d, G::KT))))
    return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_any_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + G::BM - 1) / G::BM, B * a.H);
  flash_fwd_any_kernel<T, DP><<<grid, G::kBlockThreads, smem,
                                (cudaStream_t)stream>>>(mq, mk, mv, a,
                                                        use_tma);
  return (int)cudaGetLastError();
}

static int launch_fwd_f32_256(const Args& a, int B, void* stream) {
  using namespace tpujob_flash_fwd_tc;
  using G = FwdWideGeom;
  constexpr int smem = (int)sizeof(FwdWideSmem) + kAlignBytes;
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  // setmaxnreg moves registers within the block's launch allocation (65,536
  // a SM over its threads, in multiples of 8): a larger sum never returns
  static_assert(G::kProducerRegs * 128 + G::kConsumerRegs * 128 * G::kNC <=
                    65536 / G::kBlockThreads / 8 * 8 * G::kBlockThreads,
                "setmaxnreg budgets over the block's registers");
  const void* ptrs[3] = {a.q, a.k, a.v};
  const int use_tma = tma_takes<float>(a.d, ptrs, 3);
  CUtensorMap mq = {}, mk = {};
  int rc;
  if (use_tma &&
      ((rc = encode_panels<float>(&mq, a.q, B, a.Sq, a.H, a.d, G::BM)) ||
       (rc = encode_panels<float>(&mk, a.k, B, a.Sk, a.H, a.d, G::KT))))
    return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_any_kernel_f32_256,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + G::BM - 1) / G::BM, B * a.H);
  flash_fwd_any_kernel_f32_256<<<grid, G::kBlockThreads, smem,
                                 (cudaStream_t)stream>>>(mq, mk, a, use_tma);
  return (int)cudaGetLastError();
}

// bf16 at head dim 128: the route's own kernel (flash_bf16_128.cuh), by
// TMA alone (16-byte aligned bases; the wrapper checks them)
static int launch_fwd_bf16_128(const Args& a, int B, void* stream) {
  using namespace tpujob_flash_bf16;
  constexpr int smem = (int)sizeof(FwdSmem) + kAlignBytes;
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumerThreads <=
                    65536 / kBlockThreads / 8 * 8 * kBlockThreads,
                "setmaxnreg budgets over the block's registers");
  const void* ptrs[3] = {a.q, a.k, a.v};
  if (!tpujob_flash_tc::tma_takes<bf16>(kD, ptrs, 3))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap mq, mk, mv;
  int rc;
  if ((rc = tpujob_flash_tc::encode_panels<bf16>(&mq, a.q, B, a.Sq, a.H, kD,
                                                 kFwdBM)) ||
      (rc = tpujob_flash_tc::encode_panels<bf16>(&mk, a.k, B, a.Sk, a.H, kD,
                                                 kFwdKT)) ||
      (rc = tpujob_flash_tc::encode_panels<bf16>(&mv, a.v, B, a.Sk, a.H, kD,
                                                 kFwdKT)))
    return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_any_kernel_bf16<kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * a.H, (a.Sq + kFwdBM - 1) / kFwdBM);
  flash_fwd_any_kernel_bf16<kD><<<grid, kBlockThreads, smem,
                                  (cudaStream_t)stream>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
}

// The padded head dim's instantiation, chosen before the launch: fp32 at
// 256 takes its own tensor-core kernel (its tiles), every other bucket the
// template.
template <class T>
static int dispatch_fwd_any(const Args& a, int B, void* stream) {
  switch (padded_dim(a.d)) {
    case 32: return launch_fwd_tc<T, 32>(a, B, stream);
    case 64: return launch_fwd_tc<T, 64>(a, B, stream);
    case 128: return launch_fwd_tc<T, 128>(a, B, stream);
    case 256:
      if constexpr (sizeof(T) == 4) return launch_fwd_f32_256(a, B, stream);
      else return launch_fwd_tc<T, 256>(a, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// q, k, v [B, S, H, D] fp32 (is_bf16 = 0) or bf16; o likewise; lse fp32
// [B, H, Sq].  D from 1 to 256.
extern "C" int tpujob_flash_fwd_any(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int H, int D, int Sq, int Sk, float scale,
                                    int causal, int window, int is_bf16,
                                    void* stream) {
  // bf16 at head dim 128 has an entry point of its own (below)
  if (Sq <= 0 || Sk <= 0 || B <= 0 || H <= 0 || B * H > 65535 ||
      (D == 128 && is_bf16))
    return (int)cudaErrorInvalidValue;
  Args a = {q, k, v, nullptr, nullptr, nullptr, o, nullptr, (float*)lse,
            H, D, Sq, Sk, scale, causal, window};
  return is_bf16 ? dispatch_fwd_any<bf16>(a, B, stream)
                 : dispatch_fwd_any<float>(a, B, stream);
}

// bf16 at head dim 128 (flash.route "bf16_128"): tpujob_flash_fwd's
// arguments, D 128 only.
extern "C" int tpujob_flash_fwd_bf16_128(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int B, int H, int D, int Sq, int Sk,
                                         float scale, int causal, int window,
                                         void* stream) {
  if (Sq <= 0 || Sk <= 0 || B <= 0 || H <= 0 || B * H > 65535 || D != 128)
    return (int)cudaErrorInvalidValue;
  Args a = {q, k, v, nullptr, nullptr, nullptr, o, nullptr, (float*)lse,
            H, D, Sq, Sk, scale, causal, window};
  return launch_fwd_bf16_128(a, B, stream);
}
