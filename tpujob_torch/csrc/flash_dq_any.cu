// Flash-attention dQ for any head dim 1-256, fp32 or bf16 in, on Hopper's
// tensor cores (wgmma, sm_90a) with split precision (B2a).
//
// Replaces the Pallas kernel tpujob/workloads/flash.py:_dq_kernel for every
// input the tuned flash_dq.cu does not take: dQ = scale * sum_k (P o (dO V^T
// - D)) K, with P = exp(scale Q K^T - lse) recomputed from the forward's
// logsumexp (0 where masked) and D = rowsum(dO o O); dq in the input's
// dtype.  The reference sums every product in fp32.
//
// Bound on an H100 SXM at the GPT-2-medium shape in fp32 (b=8, s=1024,
// h=16, d=64, causal): it reads q, k, v, dO, lse and delta and writes dq,
// 5 x 33.6 MB + 1 MB = 169 MB, 50 us; its causal FLOPs (S, dP and dS K)
// are 25.8 G, 52 us at tf32's 495 TFLOP/s in one pass: bound by
// operations.  The split's reach is three tf32 passes, 156 us (fp32 FFMA's
// 67 TFLOP/s: 385 us).  In bf16 S and dP take one pass and dS K two: 4/3
// of the bf16 bound.
//
// Design (flash_tc.cuh, which also says how each trouble of the design is
// met): one block per (F-row q-tile, batch*head), a producer warpgroup and
// F / 32 consumer warpgroups of 32 queries each (two at F = 64: while one
// loads fragments or forms dS, the other's wgmmas run).  The producer
// copies Q, dO and their lse and D once (TMA, or plain loads where TMA
// cannot take the strides), then streams (K, V) for each live 64-key tile
// (flash_common.cuh's k_range: dead tiles skipped) through a 2-stage
// ring.  Each consumer, per k-tile:
//   S^T = K Q^T and dP^T = V dO^T (64 keys x 32 queries; A = K, V from
//     registers, B = Q, dO K-major in shared memory);
//   dS^T = P^T o (dP^T - D) scale with P^T = exp(scale S^T - lse) in
//     registers, masked only on tiles crossing the diagonal, the window or
//     the ragged edge;
//   dS written to shared memory as [query][key], split in two parts;
//   dQ^T += K^T dS (head dim x 32, in 64-row blocks; A = K^T read
//     transposed into registers, B = dS).
// fp32 runs every product as 3xTF32 (wgmma .tf32), bf16 S^T and dP^T as
// one bf16 wgmma and dQ's with dS as high + low bf16 parts.  dQ is this
// kernel's own (no atomics across key tiles), so two launches on the same
// inputs give the same bits.
//
// fp32 at padded head dim 256 does not fit a block's shared memory on this
// layout (flash_tc.cuh, trouble 4): the C entry point sends that bucket to
// flash_dq_any_kernel_f32_256, the same products on 16 fixed queries with
// the K and V tiles in one buffer each, released one at a time.  Bound at
// the d=256 GPT's attention in fp32 (b=8, s=1024, h=8, causal): 5 x 67.1
// MB + 0.5 MB = 336 MB, 100 us; 51.6 GFLOP, 104 us in one tf32 pass: bound
// by operations; the split's reach 313 us (fp32 FFMA's 67 TFLOP/s: 771 us).
#include "flash_bf16_128.cuh"
#include "flash_tc.cuh"

namespace tpujob_flash_any {

// B2a on the tensor cores: template on the input type and the padded head
// dim DP (32, 64, 128; 256 in bf16 only).
template <class T, int DP>
__global__ void
__launch_bounds__(tpujob_flash_tc::TcGeom<T, DP>::kBlockThreads, 1)
    flash_dq_any_kernel(const __grid_constant__ CUtensorMap tmQ,
                        const __grid_constant__ CUtensorMap tmK,
                        const __grid_constant__ CUtensorMap tmV,
                        const __grid_constant__ CUtensorMap tmDO,
                        const Args a, int use_tma) {
  using namespace tpujob_flash_tc;
  using G = TcGeom<T, DP>;
  using Sm = TcSmem<T, DP, 1>;
  constexpr int F = G::F, N = G::N, C = G::kCols;
  extern __shared__ uint8_t smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(align_atom(smem_raw));
  const int n_qt = (a.Sq + F - 1) / F;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * F;  // longest first
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  int kt_begin, kt_end;
  tpujob_flash::k_range<F, kRows>(q0, a.Sk, a.causal, a.window, &kt_begin,
                                  &kt_end);
  // warp-uniform to ptxas (see flash_dkv.cu)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  init_barriers<G::kNC>(sm);

  if (wg == 0) {
    // ---- producer: Q, dO, lse and D once, then the ring of (K, V) ----
    const int r = threadIdx.x;
    if (r < F) {
      const bool ok = q0 + r < a.Sq;
      sm.fix_lse[r] = ok ? a.lse[(long)bh * a.Sq + q0 + r] : 0.f;
      sm.fix_delta[r] = ok ? a.delta[(long)bh * a.Sq + q0 + r] : 0.f;
    }
    produce<T, F, C>(sm.x[0], sm.x[1], &tmQ, &tmDO, (const T*)a.q,
                     (const T*)a.dout, &sm.fixed_full, use_tma, q0, b, h,
                     a.H, a.Sq, a.d);
    for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
      const int s = i % kStages;
      mbar_wait(&sm.empty[s], ((i / kStages) & 1) ^ 1);
      produce<T, kRows, C>(sm.y[s][0], sm.y[s][1], &tmK, &tmV,
                           (const T*)a.k, (const T*)a.v, &sm.full[s],
                           use_tma, kt * kRows, b, h, a.H, a.Sk, a.d);
    }
    return;
  }

  // ---- consumers: N queries each, from q0 + fo ----
  const int cw = wg - 1, fo = N * cw, qc0 = q0 + fo;
  const int tid = threadIdx.x % 128, t = tid % 4;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;  // the thread's key rows
  mbar_wait(&sm.fixed_full, 0);
  if constexpr (G::kF32) {  // Q and dO rounded to tf32, their small parts
    split_fixed<F * C, G::kNC>(sm.x[0], sm.x[2]);
    split_fixed<F * C, G::kNC>(sm.x[1], sm.x[3]);
    fence_async_shared();
    named_bar_sync(kFixedBar, 128 * G::kNC);
  }
  // this consumer's rows of Q and dO: fo rows into each panel
  auto rows = [&](const T* x) {
    return panel_desc(reinterpret_cast<const uint8_t*>(x) + fo * kPanel);
  };
  const uint64_t dxq = rows(sm.x[0]), dxo = rows(sm.x[1]);
  const uint64_t dxqs = G::kF32 ? rows(sm.x[G::kXT - 2]) : 0;
  const uint64_t dxos = G::kF32 ? rows(sm.x[G::kXT - 1]) : 0;
  T* const w0 = sm.w[cw][0][0];
  T* const w1 = sm.w[cw][0][1];
  const uint64_t dw0 = panel_desc(w0), dw1 = panel_desc(w1);
  const int nks = (a.d + G::kKW - 1) / G::kKW;

  float dqt[G::kMB][N / 2];
#pragma unroll
  for (int mb = 0; mb < G::kMB; ++mb)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dqt[mb][i] = 0.f;

  for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
    const int s = i % kStages, kk0 = kt * kRows;
    mbar_wait(&sm.full[s], (i / kStages) & 1);
    const T* yk = sm.y[s][0];
    const T* yv = sm.y[s][1];

    // S^T = K Q^T and dP^T = V dO^T
    float st[N / 2], dpt[N / 2];
    first_product<T, N, F, C>(st, yk, dxq, dxqs, nks);
    first_product<T, N, F, C>(dpt, yv, dxo, dxos, nks);

    // Under the causal mask the first 64 queries see only the first k-tile's
    // keys.  A row of few keys can have one that holds nearly all of P, and
    // then its dS is mostly the rounding of dP - D (D = dP in real
    // arithmetic where one key holds all of P: query 0 always).  On GPT's
    // fp32 shape exact arithmetic lands at 0.95 of ANY_TOL's fp32 floor
    // (1e-6 x the rms of dQ) on such rows and 13x over it on query 0: only
    // the plain version's own rounding meets it.  So on these tiles dP is
    // taken on the CUDA cores in the plain version's order (fp32 fma over
    // the head dim from column 0) in place of the tensor cores' (one tile
    // of a head's 136 at s = 1024).
    if (a.causal && kk0 == 0 && qc0 + N <= kRows) {
      const T* dog = (const T*)a.dout + ((long)b * a.Sq * a.H + h) * a.d;
      const T* vg = (const T*)a.v + ((long)b * a.Sk * a.H + h) * a.d;
      const long stride = (long)a.H * a.d;  // between sequence rows
#pragma unroll
      for (int i = 0; i < N / 2; ++i) dpt[i] = 0.f;
      for (int c = 0; c < a.d; ++c) {
        float vv[2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          vv[u] = r0 + 8 * u < a.Sk ? to_f(vg[(r0 + 8 * u) * stride + c]) : 0.f;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qc0 + 8 * j + 2 * t + (e & 1);
            const float o = qi < a.Sq ? to_f(dog[qi * stride + c]) : 0.f;
            dpt[4 * j + e] = fmaf(o, vv[e >> 1], dpt[4 * j + e]);
          }
      }
    }

    // dS^T, into W as [query][key]
    const bool edge =
        qc0 + N > a.Sq || kk0 + kRows > a.Sk ||
        (a.causal && (qc0 < kk0 + kRows - 1 ||
                      (a.window > 0 && qc0 + N - 1 - kk0 >= a.window)));
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = fo + 8 * j + 2 * t + (e & 1);
        float p = prob(st[4 * j + e], a.scale, sm.fix_lse[qc]);
        if (edge && !sees(q0 + qc, kk0 + r0 + 8 * (e >> 1), a.Sq, a.Sk,
                          a.causal, a.window))
          p = 0.f;
        put_w<T, N>(w0, w1, j, e,
                    p * (dpt[4 * j + e] - sm.fix_delta[qc]) * a.scale);
      }
    fence_async_shared();
    named_bar_sync(kConsumerBar + cw, 128);

    // dQ^T += K^T dS
#pragma unroll
    for (int mb = 0; mb < G::kMB; ++mb)
      second_product<T, N, C>(dqt[mb], yk, 64 * mb, dw0, dw1);
    mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int mb = 0; mb < G::kMB; ++mb)
    store_zt<T, N>((T*)a.out0, dqt[mb], 64 * mb, qc0, b, h, a.H, a.Sq, a.d);
}

// B2a for fp32 at padded head dim 256 (flash_tc.cuh, trouble 4): B3a's
// flash_dkv_any_kernel_f32_256 with queries and keys swapped.  F = 16
// fixed queries (Q and dO, split into tf32 parts once: 64 KB), N = 16, the
// producer and two consumer warpgroups; the streamed K and V tiles raw
// fp32 (their k-steps' A fragments split in registers), each in one
// buffer with its own full and empty barriers (2 x 64 KB).  Per k-tile
// consumer 0 runs S^T = K Q^T and writes P into W_P while consumer 1 runs
// dP^T = V dO^T and releases V (the next V lands during the second
// product); consumer 1 then forms dS = P o (dP - D) scale from W_P into
// W_dS.  Each consumer then adds its half of the head dim (two of dQ^T's
// 64-row blocks) of dQ^T += K^T dS, and K is released once both have.
// W needs no second buffer: consumer 0 writes the next P only after
// consumer 1 has read this one (kDsBar), and consumer 1 the next dS only
// after consumer 0's second product has read this one (kPBar).  Eight
// k-steps a batch, as B3a's.  On the first diagonal tile (see
// flash_dq_any_kernel) consumer 1 takes dP from the raw dO and V in
// shared memory, in the plain version's order, before Q and dO are split.
struct DqWideSmem {
  static constexpr int F = 16, C = 256, kNC = 2;
  float x[4][F * C];                      // Q, dO, then their small parts
  float yk[tpujob_flash_tc::kRows * C];   // the k-tile's K (64 KB)
  float yv[tpujob_flash_tc::kRows * C];   // its V (64 KB)
  float ws[2][F * tpujob_flash_tc::kRows];  // W_dS [query][key]: parts
  float wp[F / 2 * 128];  // W_P: consumer 0's P, [element][thread] (the
                          // same thread of consumer 1 holds its dP)
  float fix_lse[F];
  float fix_delta[F];
  uint64_t fixed_full;
  uint64_t full_k, full_v;    // K / V landed
  uint64_t empty_k, empty_v;  // the consumers are done with K / V
};

__global__ void __launch_bounds__(128 * (1 + DqWideSmem::kNC), 1)
    flash_dq_any_kernel_f32_256(const __grid_constant__ CUtensorMap tmQ,
                                const __grid_constant__ CUtensorMap tmK,
                                const __grid_constant__ CUtensorMap tmV,
                                const __grid_constant__ CUtensorMap tmDO,
                                const Args a, int use_tma) {
  using namespace tpujob_flash_tc;
  using Sm = DqWideSmem;
  constexpr int F = Sm::F, N = F, C = Sm::C, kNC = Sm::kNC;
  constexpr int kMB = C / 64 / kNC;  // dQ^T's 64-row blocks a consumer
  constexpr int kB = 8;              // k-steps a batch
  extern __shared__ uint8_t smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(align_atom(smem_raw));
  const int n_qt = (a.Sq + F - 1) / F;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * F;  // longest first
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  int kt_begin, kt_end;
  tpujob_flash::k_range<F, kRows>(q0, a.Sk, a.causal, a.window, &kt_begin,
                                  &kt_end);
  // dP on the CUDA cores on the first k-tile: it is the first diagonal one
  const bool diag = a.causal && kt_begin == 0 && q0 + F <= kRows;
  // warp-uniform to ptxas (see flash_dkv.cu)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(&sm.fixed_full, 2 * 128);  // Q and dO, 128 arrivals each
    mbar_init(&sm.full_k, 128);
    mbar_init(&sm.full_v, 128);
    mbar_init(&sm.empty_k, 128 * kNC);
    mbar_init(&sm.empty_v, 128);         // consumer 1 alone reads V
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: Q, dO, lse and D once, then each live k-tile's V
    // (released first) and K ----
    const int r = threadIdx.x;
    if (r < F) {
      const bool ok = q0 + r < a.Sq;
      sm.fix_lse[r] = ok ? a.lse[(long)bh * a.Sq + q0 + r] : 0.f;
      sm.fix_delta[r] = ok ? a.delta[(long)bh * a.Sq + q0 + r] : 0.f;
    }
    produce_tile<float, F, C>(sm.x[0], &tmQ, (const float*)a.q,
                              &sm.fixed_full, use_tma, q0, b, h, a.H, a.Sq,
                              a.d);
    produce_tile<float, F, C>(sm.x[1], &tmDO, (const float*)a.dout,
                              &sm.fixed_full, use_tma, q0, b, h, a.H, a.Sq,
                              a.d);
    for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
      const int ph = i & 1, kk0 = kt * kRows;
      mbar_wait(&sm.empty_v, ph ^ 1);
      produce_tile<float, kRows, C>(sm.yv, &tmV, (const float*)a.v,
                                    &sm.full_v, use_tma, kk0, b, h, a.H,
                                    a.Sk, a.d);
      mbar_wait(&sm.empty_k, ph ^ 1);
      produce_tile<float, kRows, C>(sm.yk, &tmK, (const float*)a.k,
                                    &sm.full_k, use_tma, kk0, b, h, a.H,
                                    a.Sk, a.d);
    }
    return;
  }

  // ---- consumer cw: S^T (0) or dP^T (1), then head-dim rows m0 .. ----
  const int cw = wg - 1, m0 = 64 * kMB * cw;
  const int tid = threadIdx.x % 128, t = tid % 4;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;  // the thread's key rows
  mbar_wait(&sm.fixed_full, 0);
  float dpd[N / 2];  // consumer 1: the first diagonal tile's dP^T
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dpd[i] = 0.f;
  if (diag) {
    if (cw == 1) {  // as flash_dq_any_kernel's, from the raw tiles
      mbar_wait(&sm.full_v, 0);
#pragma unroll 4
      for (int c = 0; c < a.d; ++c) {
        const float vv[2] = {at<float, kRows>(sm.yv, r0, c),
                             at<float, kRows>(sm.yv, r0 + 8, c)};
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float o = at<float, F>(sm.x[1], 8 * j + 2 * t + (e & 1), c);
            dpd[4 * j + e] = fmaf(o, vv[e >> 1], dpd[4 * j + e]);
          }
      }
    }
    named_bar_sync(kFixedBar, 128 * kNC);  // dO read raw before the split
  }
  split_fixed<F * C, kNC>(sm.x[0], sm.x[2]);  // Q, dO rounded to tf32, and
  split_fixed<F * C, kNC>(sm.x[1], sm.x[3]);  // their small parts
  fence_async_shared();
  named_bar_sync(kFixedBar, 128 * kNC);
  // consumer 0 multiplies by Q (S^T), consumer 1 by dO (dP^T)
  const uint64_t dx = panel_desc(sm.x[cw]), dxs = panel_desc(sm.x[2 + cw]);
  const uint64_t ds0 = panel_desc(sm.ws[0]), ds1 = panel_desc(sm.ws[1]);
  const int nks = (a.d + 7) / 8;

  float dqt[kMB][N / 2];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dqt[mb][i] = 0.f;

  for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
    const int ph = i & 1, kk0 = kt * kRows;
    if (cw == 0) {
      // S^T = K Q^T, then P into W_P
      float sc[N / 2];
      mbar_wait(&sm.full_k, ph);
      first_product<float, N, F, C, kB>(sc, sm.yk, dx, dxs, nks);
      const bool edge =
          q0 + F > a.Sq || kk0 + kRows > a.Sk ||
          (a.causal && (q0 < kk0 + kRows - 1 ||
                        (a.window > 0 && q0 + F - 1 - kk0 >= a.window)));
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          float p = prob(sc[4 * j + e], a.scale, sm.fix_lse[qc]);
          if (edge && !sees(q0 + qc, kk0 + r0 + 8 * (e >> 1), a.Sq, a.Sk,
                            a.causal, a.window))
            p = 0.f;
          sm.wp[(4 * j + e) * 128 + tid] = p;
        }
      named_bar_arrive(kPBar, 256);
      named_bar_sync(kDsBar, 256);
    } else {
      // dP^T = V dO^T, V released; then dS = P o (dP - D) scale into
      // W_dS once consumer 0 has written P
      float dp[N / 2];
      mbar_wait(&sm.full_v, ph);
      first_product<float, N, F, C, kB>(dp, sm.yv, dx, dxs, nks);
      mbar_arrive(&sm.empty_v);
      if (diag && i == 0) {
#pragma unroll
        for (int u = 0; u < N / 2; ++u) dp[u] = dpd[u];
      }
      named_bar_sync(kPBar, 256);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          put_w<float, N>(sm.ws[0], sm.ws[1], j, e,
                          sm.wp[(4 * j + e) * 128 + tid] *
                              (dp[4 * j + e] - sm.fix_delta[qc]) * a.scale);
        }
      fence_async_shared();
      named_bar_arrive(kDsBar, 256);
      mbar_wait(&sm.full_k, ph);
    }

    // this consumer's rows of dQ^T += K^T dS, then K is released
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
      second_product<float, N, C, kB>(dqt[mb], sm.yk, m0 + 64 * mb, ds0,
                                      ds1);
    mbar_arrive(&sm.empty_k);
  }

#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
    store_zt<float, N>((float*)a.out0, dqt[mb], m0 + 64 * mb, q0, b, h, a.H,
                       a.Sq, a.d);
}

}  // namespace tpujob_flash_any

// Host side: the launches and the C entry points.

using namespace tpujob_flash_any;

template <class T, int DP>
static int launch_dq_tc(const Args& a, int B, void* stream) {
  using namespace tpujob_flash_tc;
  using G = TcGeom<T, DP>;
  constexpr int smem = (int)sizeof(TcSmem<T, DP, 1>) + kAlignBytes;
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const int use_tma = tma_takes<T>(a.d, ptrs, 4);
  CUtensorMap mq = {}, mk = {}, mv = {}, mdo = {};
  int rc;
  if (use_tma &&
      ((rc = encode_panels<T>(&mq, a.q, B, a.Sq, a.H, a.d, G::F)) ||
       (rc = encode_panels<T>(&mk, a.k, B, a.Sk, a.H, a.d, kRows)) ||
       (rc = encode_panels<T>(&mv, a.v, B, a.Sk, a.H, a.d, kRows)) ||
       (rc = encode_panels<T>(&mdo, a.dout, B, a.Sq, a.H, a.d, G::F))))
    return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_dq_any_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + G::F - 1) / G::F, B * a.H);
  flash_dq_any_kernel<T, DP><<<grid, G::kBlockThreads, smem,
                               (cudaStream_t)stream>>>(mq, mk, mv, mdo, a,
                                                       use_tma);
  return (int)cudaGetLastError();
}

static int launch_dq_f32_256(const Args& a, int B, void* stream) {
  using namespace tpujob_flash_tc;
  constexpr int F = DqWideSmem::F;
  constexpr int smem = (int)sizeof(DqWideSmem) + kAlignBytes;
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const int use_tma = tma_takes<float>(a.d, ptrs, 4);
  CUtensorMap mq = {}, mk = {}, mv = {}, mdo = {};
  int rc;
  if (use_tma &&
      ((rc = encode_panels<float>(&mq, a.q, B, a.Sq, a.H, a.d, F)) ||
       (rc = encode_panels<float>(&mk, a.k, B, a.Sk, a.H, a.d, kRows)) ||
       (rc = encode_panels<float>(&mv, a.v, B, a.Sk, a.H, a.d, kRows)) ||
       (rc = encode_panels<float>(&mdo, a.dout, B, a.Sq, a.H, a.d, F))))
    return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_dq_any_kernel_f32_256,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + F - 1) / F, B * a.H);
  flash_dq_any_kernel_f32_256<<<grid, 128 * (1 + DqWideSmem::kNC), smem,
                                (cudaStream_t)stream>>>(mq, mk, mv, mdo, a,
                                                        use_tma);
  return (int)cudaGetLastError();
}

// bf16 at head dim 128: the route's own kernel (flash_bf16_128.cuh), by
// TMA alone (16-byte aligned bases; the wrapper checks them)
static int launch_dq_bf16_128(const Args& a, int B, void* stream) {
  using namespace tpujob_flash_bf16;
  constexpr int smem = (int)sizeof(DqSmem) + kAlignBytes;
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
                                                 kDqBM)) ||
      (rc = tpujob_flash_tc::encode_panels<bf16>(&mk, a.k, B, a.Sk, a.H, kD,
                                                 kDqKT)) ||
      (rc = tpujob_flash_tc::encode_panels<bf16>(&mv, a.v, B, a.Sk, a.H, kD,
                                                 kDqKT)) ||
      (rc = tpujob_flash_tc::encode_panels<bf16>(&mdo, a.dout, B, a.Sq, a.H,
                                                 kD, kDqBM)))
    return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_dq_any_kernel_bf16<kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * a.H, (a.Sq + kDqBM - 1) / kDqBM);
  flash_dq_any_kernel_bf16<kD><<<grid, kBlockThreads, smem,
                                  (cudaStream_t)stream>>>(mq, mk, mv, mdo, a);
  return (int)cudaGetLastError();
}

// The padded head dim's instantiation, chosen before the launch: fp32 at
// 256 takes its own tensor-core kernel (its tiles), every other bucket the
// template.
template <class T>
static int dispatch_dq_any(const Args& a, int B, void* stream) {
  switch (padded_dim(a.d)) {
    case 32: return launch_dq_tc<T, 32>(a, B, stream);
    case 64: return launch_dq_tc<T, 64>(a, B, stream);
    case 128: return launch_dq_tc<T, 128>(a, B, stream);
    case 256:
      if constexpr (sizeof(T) == 4) return launch_dq_f32_256(a, B, stream);
      else return launch_dq_tc<T, 256>(a, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// q, k, v, dO, dq [B, S, H, D] fp32 (is_bf16 = 0) or bf16; lse and delta
// fp32 [B, H, Sq].  D from 1 to 256.
extern "C" int tpujob_flash_dq_any(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int B, int H, int D, int Sq,
                                   int Sk, float scale, int causal,
                                   int window, int is_bf16, void* stream) {
  // bf16 at head dim 128 has an entry point of its own (below)
  if (Sq <= 0 || Sk <= 0 || B <= 0 || H <= 0 || B * H > 65535 ||
      (D == 128 && is_bf16))
    return (int)cudaErrorInvalidValue;
  Args a = {q, k, v, dout, (const float*)lse, (const float*)delta, dq,
            nullptr, nullptr, H, D, Sq, Sk, scale, causal, window};
  return is_bf16 ? dispatch_dq_any<bf16>(a, B, stream)
                 : dispatch_dq_any<float>(a, B, stream);
}

// bf16 at head dim 128 (flash.route "bf16_128"): tpujob_flash_dq's
// arguments, D 128 only.
extern "C" int tpujob_flash_dq_bf16_128(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dq, int B, int H, int D, int Sq,
                                        int Sk, float scale, int causal,
                                        int window, void* stream) {
  if (Sq <= 0 || Sk <= 0 || B <= 0 || H <= 0 || B * H > 65535 || D != 128)
    return (int)cudaErrorInvalidValue;
  Args a = {q, k, v, dout, (const float*)lse, (const float*)delta, dq,
            nullptr, nullptr, H, D, Sq, Sk, scale, causal, window};
  return launch_dq_bf16_128(a, B, stream);
}
