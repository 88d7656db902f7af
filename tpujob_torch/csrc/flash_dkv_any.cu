// Flash-attention dK and dV for any head dim 1-256, fp32 or bf16 in, on
// Hopper's tensor cores (wgmma, sm_90a) with split precision (B3a).
//
// Replaces the Pallas kernel tpujob/workloads/flash.py:_dkv_kernel for every
// input the tuned flash_dkv.cu does not take: dV = P^T dO and
// dK = scale * dS^T Q with dS = P o (dO V^T - D), summed over the query
// tiles, P recomputed from the forward's logsumexp (0 where masked); dk and
// dv in the input's dtype.  The reference sums every product in fp32.
//
// Bound on an H100 SXM at the GPT-2-medium shape in fp32 (b=8, s=1024,
// h=16, d=64, causal): it reads q, k, v, dO, lse and delta and writes dk
// and dv, 6 x 33.6 MB + 1 MB = 202 MB, 60 us; its causal FLOPs (S, dP,
// P^T dO and dS^T Q) are 34.4 G, 70 us at tf32's 495 TFLOP/s in one pass:
// bound by operations.  The split's reach is three tf32 passes, 209 us
// (fp32 FFMA's 67 TFLOP/s: 514 us).  In bf16 S and dP take one pass and
// P^T dO, dS^T Q two: 1.5x the bf16 bound.  fp32 at d=256 (b=8, s=1024,
// h=8, causal): 6 x 67.1 MB + 0.5 MB = 403 MB, 120 us; 68.8 GFLOP, 139 us
// in one tf32 pass: bound by operations; the split's reach 417 us (FFMA:
// 1,028 us).  There 16-key blocks re-read each live q-tile's Q and dO,
// 4.5 GB in all, from L2.
//
// Design (flash_tc.cuh, which also says how each trouble of the design is
// met): one block per (F-key tile, batch*head), a producer warpgroup and
// F / 32 consumer warpgroups of 32 keys each (two at F = 64: while one
// loads fragments or forms P and dS, the other's wgmmas run).  The
// producer copies K and V once (TMA, or plain loads where TMA cannot take
// the strides), then streams (Q, dO, lse, D) for each live 64-row q-tile
// (flash_common.cuh's q_range: dead tiles skipped) through a 2-stage
// ring.  Each consumer, per q-tile:
//   S = Q K^T (64 queries x 32 keys; A = Q from registers, B = K K-major
//     in shared memory), and dP = dO V^T likewise;
//   P = exp(scale S - lse) in registers, masked only on tiles crossing the
//     diagonal, the window or the ragged edge, written to shared memory as
//     [key][query] in two parts; dV^T += dO^T P (head dim x 32, in 64-row
//     blocks; A = dO^T read transposed into registers, B = P);
//   then dS = P o (dP - D) scale the same way, P read back from shared
//     memory, and dK^T += Q^T dS.  S and dP are never live together: with
//     dK^T and dV^T in registers, both would not fit the registers a
//     thread has (168 with two consumers, 255 with one at d = 128).
// fp32 runs every product as 3xTF32 (wgmma .tf32), bf16 S and dP as one
// bf16 wgmma and the last two with P and dS as high + low bf16 parts.
// dK^T and dV^T stay in registers; no atomics, so two launches on the same
// inputs give the same bits.
//
// fp32 at padded head dim 256 does not fit a block's shared memory on this
// layout (flash_tc.cuh, trouble 4): the C entry point sends that bucket to
// flash_dkv_any_kernel_f32_256, the same products on 16 fixed keys with
// the Q and dO tiles released one at a time.
#include "flash_bf16_128.cuh"
#include "flash_tc.cuh"

namespace tpujob_flash_any {

// B3a on the tensor cores: template on the input type and the padded head
// dim DP (32, 64, 128; 256 in bf16 only).
template <class T, int DP>
__global__ void
__launch_bounds__(tpujob_flash_tc::TcGeom<T, DP>::kBlockThreads, 1)
    flash_dkv_any_kernel(const __grid_constant__ CUtensorMap tmQ,
                         const __grid_constant__ CUtensorMap tmK,
                         const __grid_constant__ CUtensorMap tmV,
                         const __grid_constant__ CUtensorMap tmDO,
                         const Args a, int use_tma) {
  using namespace tpujob_flash_tc;
  using G = TcGeom<T, DP>;
  using Sm = TcSmem<T, DP, 2>;
  constexpr int F = G::F, N = G::N, C = G::kCols;
  extern __shared__ uint8_t smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(align_atom(smem_raw));
  const int k0 = blockIdx.x * F;  // causal: the first keys see most rows
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  int qt_begin, qt_end;
  tpujob_flash::q_range<F, kRows>(k0, a.Sq, a.causal, a.window, &qt_begin,
                                  &qt_end);
  // warp-uniform to ptxas (see flash_dkv.cu)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  init_barriers<G::kNC>(sm);

  if (wg == 0) {
    // ---- producer: K and V once, then the ring of (Q, dO, lse, D) ----
    produce<T, F, C>(sm.x[0], sm.x[1], &tmK, &tmV, (const T*)a.k,
                     (const T*)a.v, &sm.fixed_full, use_tma, k0, b, h, a.H,
                     a.Sk, a.d);
    for (int qt = qt_begin, i = 0; qt < qt_end; ++qt, ++i) {
      const int s = i % kStages, q0 = qt * kRows, r = threadIdx.x;
      mbar_wait(&sm.empty[s], ((i / kStages) & 1) ^ 1);
      if (r < kRows) {
        const bool ok = q0 + r < a.Sq;
        sm.row_lse[s][r] = ok ? a.lse[(long)bh * a.Sq + q0 + r] : 0.f;
        sm.row_delta[s][r] = ok ? a.delta[(long)bh * a.Sq + q0 + r] : 0.f;
      }
      produce<T, kRows, C>(sm.y[s][0], sm.y[s][1], &tmQ, &tmDO,
                           (const T*)a.q, (const T*)a.dout, &sm.full[s],
                           use_tma, q0, b, h, a.H, a.Sq, a.d);
    }
    return;
  }

  // ---- consumers: N keys each, from k0 + fo ----
  const int cw = wg - 1, fo = N * cw, kc0 = k0 + fo;
  const int tid = threadIdx.x % 128, t = tid % 4;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;  // the thread's q rows
  mbar_wait(&sm.fixed_full, 0);
  if constexpr (G::kF32) {  // K and V rounded to tf32, their small parts
    split_fixed<F * C, G::kNC>(sm.x[0], sm.x[2]);
    split_fixed<F * C, G::kNC>(sm.x[1], sm.x[3]);
    fence_async_shared();
    named_bar_sync(kFixedBar, 128 * G::kNC);
  }
  // this consumer's rows of K and V: fo rows into each panel
  auto rows = [&](const T* x) {
    return panel_desc(reinterpret_cast<const uint8_t*>(x) + fo * kPanel);
  };
  const uint64_t dxk = rows(sm.x[0]), dxv = rows(sm.x[1]);
  const uint64_t dxks = G::kF32 ? rows(sm.x[G::kXT - 2]) : 0;
  const uint64_t dxvs = G::kF32 ? rows(sm.x[G::kXT - 1]) : 0;
  T* const wp0 = sm.w[cw][0][0];
  T* const wp1 = sm.w[cw][0][1];
  T* const ws0 = sm.w[cw][1][0];
  T* const ws1 = sm.w[cw][1][1];
  const uint64_t dp0 = panel_desc(wp0), dp1 = panel_desc(wp1);
  const uint64_t ds0 = panel_desc(ws0), ds1 = panel_desc(ws1);
  const int nks = (a.d + G::kKW - 1) / G::kKW;

  float dkt[G::kMB][N / 2], dvt[G::kMB][N / 2];
#pragma unroll
  for (int mb = 0; mb < G::kMB; ++mb)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dkt[mb][i] = dvt[mb][i] = 0.f;

  for (int qt = qt_begin, i = 0; qt < qt_end; ++qt, ++i) {
    const int s = i % kStages, q0 = qt * kRows;
    mbar_wait(&sm.full[s], (i / kStages) & 1);
    const T* yq = sm.y[s][0];
    const T* ydo = sm.y[s][1];

    // S = Q K^T, then P into W_P as [key][query]
    float acc[N / 2];  // S, then dP
    first_product<T, N, F, C>(acc, yq, dxk, dxks, nks);
    const bool edge =
        q0 + kRows > a.Sq || kc0 + N > a.Sk ||
        (a.causal && (q0 < kc0 + N - 1 ||
                      (a.window > 0 && q0 + kRows - 1 - kc0 >= a.window)));
    const float lse[2] = {sm.row_lse[s][r0], sm.row_lse[s][r0 + 8]};
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = prob(acc[4 * j + e], a.scale, lse[e >> 1]);
        if (edge && !sees(q0 + r0 + 8 * (e >> 1),
                          kc0 + 8 * j + 2 * t + (e & 1), a.Sq, a.Sk,
                          a.causal, a.window))
          p = 0.f;
        put_w<T, N>(wp0, wp1, j, e, p);
      }
    fence_async_shared();
    named_bar_sync(kConsumerBar + cw, 128);

    // dV^T += dO^T P
#pragma unroll
    for (int mb = 0; mb < G::kMB; ++mb)
      second_product<T, N, C>(dvt[mb], ydo, 64 * mb, dp0, dp1);

    // dP = dO V^T, then dS = P o (dP - D) scale into W_dS, P read back
    // from W_P (so S and dP are never live together: the register budget)
    first_product<T, N, F, C>(acc, ydo, dxv, dxvs, nks);
    const float del[2] = {sm.row_delta[s][r0], sm.row_delta[s][r0 + 8]};
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        put_w<T, N>(ws0, ws1, j, e,
                    get_w<T, N>(wp0, wp1, j, e) *
                        (acc[4 * j + e] - del[e >> 1]) * a.scale);
    fence_async_shared();
    named_bar_sync(kConsumerBar + cw, 128);

    // dK^T += Q^T dS
#pragma unroll
    for (int mb = 0; mb < G::kMB; ++mb)
      second_product<T, N, C>(dkt[mb], yq, 64 * mb, ds0, ds1);
    mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int mb = 0; mb < G::kMB; ++mb) {
    store_zt<T, N>((T*)a.out0, dkt[mb], 64 * mb, kc0, b, h, a.H, a.Sk, a.d);
    store_zt<T, N>((T*)a.out1, dvt[mb], 64 * mb, kc0, b, h, a.H, a.Sk, a.d);
  }
}

// B3a for fp32 at padded head dim 256 (flash_tc.cuh, trouble 4): F = 16
// fixed keys, N = 16, the producer and two consumer warpgroups; the
// streamed Q and dO tiles each in one buffer with its own full and empty
// barriers.  Per q-tile consumer 0 runs S = Q K^T and writes P into W_P
// while consumer 1 runs dP = dO V^T; consumer 1 then forms dS = P o (dP -
// D) scale from W_P into W_dS.  Each consumer then adds its half of the
// head dim (two of Z^T's 64-row blocks) of dK^T += Q^T dS, releases Q, and
// of dV^T += dO^T P, and releases dO: the next tile's Q lands while dV^T
// runs, its dO while S and dP do.  W is kept by tile parity: consumer 0
// may write the next tile's P while consumer 1 still reads this one's.
// Eight k-steps a batch (the registers allow it: fewer waits, 2.738 ->
// 2.556 ms with one consumer at b 8, s 1024, h 8; two consumers 2.031,
// kernels.ab).
struct DkvWideSmem {
  static constexpr int F = 16, C = 256, kNC = 2;
  float x[4][F * C];               // K, V, then their small parts (64 KB)
  float yq[tpujob_flash_tc::kRows * C];   // the q-tile's Q (64 KB)
  float ydo[tpujob_flash_tc::kRows * C];  // its dO (64 KB)
  float w[2][2][2][F * tpujob_flash_tc::kRows];  // [parity] W_P, W_dS: parts
  float row_lse[tpujob_flash_tc::kRows];
  float row_delta[tpujob_flash_tc::kRows];
  uint64_t fixed_full;
  uint64_t full_q, full_do;        // Q (with lse, delta) / dO landed
  uint64_t empty_q, empty_do;      // the consumers are done with Q / dO
};

__global__ void __launch_bounds__(128 * (1 + DkvWideSmem::kNC), 1)
    flash_dkv_any_kernel_f32_256(const __grid_constant__ CUtensorMap tmQ,
                                 const __grid_constant__ CUtensorMap tmK,
                                 const __grid_constant__ CUtensorMap tmV,
                                 const __grid_constant__ CUtensorMap tmDO,
                                 const Args a, int use_tma) {
  using namespace tpujob_flash_tc;
  using Sm = DkvWideSmem;
  constexpr int F = Sm::F, N = F, C = Sm::C, kNC = Sm::kNC;
  constexpr int kMB = C / 64 / kNC;  // Z^T's 64-row blocks a consumer
  constexpr int kB = 8;              // k-steps a batch
  extern __shared__ uint8_t smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(align_atom(smem_raw));
  const int k0 = blockIdx.x * F;  // causal: the first keys see most rows
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  int qt_begin, qt_end;
  tpujob_flash::q_range<F, kRows>(k0, a.Sq, a.causal, a.window, &qt_begin,
                                  &qt_end);
  // warp-uniform to ptxas (see flash_dkv.cu)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(&sm.fixed_full, 2 * 128);  // K and V, 128 arrivals each
    mbar_init(&sm.full_q, 128);
    mbar_init(&sm.full_do, 128);
    mbar_init(&sm.empty_q, 128 * kNC);
    mbar_init(&sm.empty_do, 128 * kNC);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: K and V once, then each live q-tile's Q and dO ----
    produce_tile<float, F, C>(sm.x[0], &tmK, (const float*)a.k,
                              &sm.fixed_full, use_tma, k0, b, h, a.H, a.Sk,
                              a.d);
    produce_tile<float, F, C>(sm.x[1], &tmV, (const float*)a.v,
                              &sm.fixed_full, use_tma, k0, b, h, a.H, a.Sk,
                              a.d);
    for (int qt = qt_begin, i = 0; qt < qt_end; ++qt, ++i) {
      const int ph = i & 1, q0 = qt * kRows, r = threadIdx.x;
      mbar_wait(&sm.empty_q, ph ^ 1);
      if (r < kRows) {
        const bool ok = q0 + r < a.Sq;
        sm.row_lse[r] = ok ? a.lse[(long)bh * a.Sq + q0 + r] : 0.f;
        sm.row_delta[r] = ok ? a.delta[(long)bh * a.Sq + q0 + r] : 0.f;
      }
      produce_tile<float, kRows, C>(sm.yq, &tmQ, (const float*)a.q,
                                    &sm.full_q, use_tma, q0, b, h, a.H, a.Sq,
                                    a.d);
      mbar_wait(&sm.empty_do, ph ^ 1);
      produce_tile<float, kRows, C>(sm.ydo, &tmDO, (const float*)a.dout,
                                    &sm.full_do, use_tma, q0, b, h, a.H,
                                    a.Sq, a.d);
    }
    return;
  }

  // ---- consumer cw: S (0) or dP (1), then head-dim rows 64 kMB cw .. ----
  const int cw = wg - 1, m0 = 64 * kMB * cw;
  const int tid = threadIdx.x % 128, t = tid % 4;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;  // the thread's q rows
  mbar_wait(&sm.fixed_full, 0);
  split_fixed<F * C, kNC>(sm.x[0], sm.x[2]);  // K, V rounded to tf32, and
  split_fixed<F * C, kNC>(sm.x[1], sm.x[3]);  // their small parts
  fence_async_shared();
  named_bar_sync(kFixedBar, 128 * kNC);
  // consumer 0 multiplies by K (S), consumer 1 by V (dP)
  const uint64_t dx = panel_desc(sm.x[cw]), dxs = panel_desc(sm.x[2 + cw]);
  const int nks = (a.d + 7) / 8;

  float dkt[kMB][N / 2], dvt[kMB][N / 2];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dkt[mb][i] = dvt[mb][i] = 0.f;

  for (int qt = qt_begin, i = 0; qt < qt_end; ++qt, ++i) {
    const int ph = i & 1, q0 = qt * kRows;
    float* const wp0 = sm.w[ph][0][0];
    float* const wp1 = sm.w[ph][0][1];
    float* const ws0 = sm.w[ph][1][0];
    float* const ws1 = sm.w[ph][1][1];
    mbar_wait(&sm.full_q, ph);  // Q, and the rows' lse and delta
    if (cw == 0) {
      // S = Q K^T, then P into W_P as [key][query]
      float sc[N / 2];
      first_product<float, N, F, C, kB>(sc, sm.yq, dx, dxs, nks);
      const bool edge =
          q0 + kRows > a.Sq || k0 + N > a.Sk ||
          (a.causal && (q0 < k0 + N - 1 ||
                        (a.window > 0 && q0 + kRows - 1 - k0 >= a.window)));
      const float lse[2] = {sm.row_lse[r0], sm.row_lse[r0 + 8]};
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = prob(sc[4 * j + e], a.scale, lse[e >> 1]);
          if (edge && !sees(q0 + r0 + 8 * (e >> 1),
                            k0 + 8 * j + 2 * t + (e & 1), a.Sq, a.Sk,
                            a.causal, a.window))
            p = 0.f;
          put_w<float, N>(wp0, wp1, j, e, p);
        }
      fence_async_shared();
      named_bar_arrive(kPBar, 256);
      named_bar_sync(kDsBar, 256);
    } else {
      // dP = dO V^T, then dS = P o (dP - D) scale into W_dS, P read back
      // from W_P once consumer 0 has written it
      float dp[N / 2];
      mbar_wait(&sm.full_do, ph);
      first_product<float, N, F, C, kB>(dp, sm.ydo, dx, dxs, nks);
      const float del[2] = {sm.row_delta[r0], sm.row_delta[r0 + 8]};
      named_bar_sync(kPBar, 256);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          put_w<float, N>(ws0, ws1, j, e,
                          get_w<float, N>(wp0, wp1, j, e) *
                              (dp[4 * j + e] - del[e >> 1]) * a.scale);
      fence_async_shared();
      named_bar_arrive(kDsBar, 256);
    }

    // this consumer's rows of dK^T += Q^T dS, then Q (with its lse and
    // delta) is released
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
      second_product<float, N, C, kB>(dkt[mb], sm.yq, m0 + 64 * mb,
                                      panel_desc(ws0), panel_desc(ws1));
    mbar_arrive(&sm.empty_q);
    // and of dV^T += dO^T P, then dO is released
    if (cw == 0) mbar_wait(&sm.full_do, ph);
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
      second_product<float, N, C, kB>(dvt[mb], sm.ydo, m0 + 64 * mb,
                                      panel_desc(wp0), panel_desc(wp1));
    mbar_arrive(&sm.empty_do);
  }

#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) {
    store_zt<float, N>((float*)a.out0, dkt[mb], m0 + 64 * mb, k0, b, h, a.H,
                       a.Sk, a.d);
    store_zt<float, N>((float*)a.out1, dvt[mb], m0 + 64 * mb, k0, b, h, a.H,
                       a.Sk, a.d);
  }
}

}  // namespace tpujob_flash_any

// Host side: the launches and the C entry points.

using namespace tpujob_flash_any;

template <class T, int DP>
static int launch_dkv_tc(const Args& a, int B, void* stream) {
  using namespace tpujob_flash_tc;
  using G = TcGeom<T, DP>;
  constexpr int smem = (int)sizeof(TcSmem<T, DP, 2>) + kAlignBytes;
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const int use_tma = tma_takes<T>(a.d, ptrs, 4);
  CUtensorMap mq = {}, mk = {}, mv = {}, mdo = {};
  int rc;
  if (use_tma &&
      ((rc = encode_panels<T>(&mq, a.q, B, a.Sq, a.H, a.d, kRows)) ||
       (rc = encode_panels<T>(&mk, a.k, B, a.Sk, a.H, a.d, G::F)) ||
       (rc = encode_panels<T>(&mv, a.v, B, a.Sk, a.H, a.d, G::F)) ||
       (rc = encode_panels<T>(&mdo, a.dout, B, a.Sq, a.H, a.d, kRows))))
    return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_any_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sk + G::F - 1) / G::F, B * a.H);
  flash_dkv_any_kernel<T, DP><<<grid, G::kBlockThreads, smem,
                                (cudaStream_t)stream>>>(mq, mk, mv, mdo, a,
                                                        use_tma);
  return (int)cudaGetLastError();
}

static int launch_dkv_f32_256(const Args& a, int B, void* stream) {
  using namespace tpujob_flash_tc;
  constexpr int F = DkvWideSmem::F;
  constexpr int smem = (int)sizeof(DkvWideSmem) + kAlignBytes;
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const int use_tma = tma_takes<float>(a.d, ptrs, 4);
  CUtensorMap mq = {}, mk = {}, mv = {}, mdo = {};
  int rc;
  if (use_tma &&
      ((rc = encode_panels<float>(&mq, a.q, B, a.Sq, a.H, a.d, kRows)) ||
       (rc = encode_panels<float>(&mk, a.k, B, a.Sk, a.H, a.d, F)) ||
       (rc = encode_panels<float>(&mv, a.v, B, a.Sk, a.H, a.d, F)) ||
       (rc = encode_panels<float>(&mdo, a.dout, B, a.Sq, a.H, a.d, kRows))))
    return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_any_kernel_f32_256,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sk + F - 1) / F, B * a.H);
  flash_dkv_any_kernel_f32_256<<<grid, 128 * (1 + DkvWideSmem::kNC), smem,
                                 (cudaStream_t)stream>>>(mq, mk, mv, mdo, a,
                                                         use_tma);
  return (int)cudaGetLastError();
}

// bf16 at head dim 128: the route's own kernel (flash_bf16_128.cuh), by
// TMA alone (16-byte aligned bases; the wrapper checks them)
static int launch_dkv_bf16_128(const Args& a, int B, void* stream) {
  using namespace tpujob_flash_bf16;
  constexpr int smem = (int)sizeof(DkvSmem) + kAlignBytes;
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumerThreads <=
                    65536 / kBlockThreads / 8 * 8 * kBlockThreads,
                "setmaxnreg budgets over the block's registers");
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  if (!tpujob_flash_tc::tma_takes<bf16>(kD, ptrs, 4))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap mq, mk, mv, mdo;
  int rc;
  if ((rc = tpujob_flash_tc::encode_panels<bf16>(&mq, a.q, B, a.Sq, a.H, kD,
                                                 kDkvQT)) ||
      (rc = tpujob_flash_tc::encode_panels<bf16>(&mk, a.k, B, a.Sk, a.H, kD,
                                                 kDkvBN)) ||
      (rc = tpujob_flash_tc::encode_panels<bf16>(&mv, a.v, B, a.Sk, a.H, kD,
                                                 kDkvBN)) ||
      (rc = tpujob_flash_tc::encode_panels<bf16>(&mdo, a.dout, B, a.Sq, a.H,
                                                 kD, kDkvQT)))
    return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_any_kernel_bf16<kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * a.H, (a.Sk + kDkvBN - 1) / kDkvBN);
  flash_dkv_any_kernel_bf16<kD><<<grid, kBlockThreads, smem,
                                  (cudaStream_t)stream>>>(mq, mk, mv, mdo, a);
  return (int)cudaGetLastError();
}

// The padded head dim's instantiation, chosen before the launch: fp32 at
// 256 takes its own tensor-core kernel (its tiles), every other bucket the
// template.
template <class T>
static int dispatch_dkv_any(const Args& a, int B, void* stream) {
  switch (padded_dim(a.d)) {
    case 32: return launch_dkv_tc<T, 32>(a, B, stream);
    case 64: return launch_dkv_tc<T, 64>(a, B, stream);
    case 128: return launch_dkv_tc<T, 128>(a, B, stream);
    case 256:
      if constexpr (sizeof(T) == 4) return launch_dkv_f32_256(a, B, stream);
      else return launch_dkv_tc<T, 256>(a, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// q, k, v, dO [B, S, H, D] fp32 (is_bf16 = 0) or bf16, dk and dv likewise;
// lse and delta fp32 [B, H, Sq].  D from 1 to 256.
extern "C" int tpujob_flash_dkv_any(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int H, int D,
                                    int Sq, int Sk, float scale, int causal,
                                    int window, int is_bf16, void* stream) {
  // bf16 at head dim 128 has an entry point of its own (below)
  if (Sq <= 0 || Sk <= 0 || B <= 0 || H <= 0 || B * H > 65535 ||
      (D == 128 && is_bf16))
    return (int)cudaErrorInvalidValue;
  Args a = {q, k, v, dout, (const float*)lse, (const float*)delta, dk, dv,
            nullptr, H, D, Sq, Sk, scale, causal, window};
  return is_bf16 ? dispatch_dkv_any<bf16>(a, B, stream)
                 : dispatch_dkv_any<float>(a, B, stream);
}

// bf16 at head dim 128 (flash.route "bf16_128"): tpujob_flash_dkv's
// arguments, D 128 only.
extern "C" int tpujob_flash_dkv_bf16_128(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dk, void* dv, int B, int H,
                                         int D, int Sq, int Sk, float scale,
                                         int causal, int window,
                                         void* stream) {
  if (Sq <= 0 || Sk <= 0 || B <= 0 || H <= 0 || B * H > 65535 || D != 128)
    return (int)cudaErrorInvalidValue;
  Args a = {q, k, v, dout, (const float*)lse, (const float*)delta, dk, dv,
            nullptr, H, D, Sq, Sk, scale, causal, window};
  return launch_dkv_bf16_128(a, B, stream);
}
