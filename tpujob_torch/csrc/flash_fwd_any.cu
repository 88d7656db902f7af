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
// 989 TFLOP/s, 26 us.
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
// design (flash_fwd_tc.cuh, trouble 5): the C entry point sends that
// bucket alone to flash_fwd_any_kernel_ffma, the FFMA body of
// flash_any.cuh (fp32 arithmetic on the CUDA cores), still to redesign.
#include "flash_fwd_tc.cuh"

namespace tpujob_flash_any {

// B1a on the tensor cores: template on the input type and the padded head
// dim DP (32, 64, 128; 256 in bf16 only).
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
  auto exp_of = [](float x) { return G::kExp2 ? ex2(x) : expf(x); };
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

      // the online softmax: masked scores -inf (P exactly 0; m starts at
      // the reference's finite -1e30, so it stays finite); bf16 in base 2
      // (scores times scale log2(e), ex2), fp32 with expf
      const bool edge =
          k0 + KT > a.Sk ||
          (a.causal && (k0 + KT - 1 > r0 ||
                        (a.window > 0 && r0 + 63 - k0 >= a.window)));
      const float masked = __int_as_float(0xff800000u);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale;
          if (edge && !sees(qrow[e >> 1], k0 + 8 * j + 2 * t + (e & 1), a.Sq,
                            a.Sk, a.causal, a.window))
            x = masked;
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
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

// B1a's FFMA body (fp32 arithmetic on the CUDA cores, flash_any.cuh), for
// fp32 at padded head dim 256 only.  One block of 256 threads per (BR-row
// q-tile, batch*head); Q staged once, K and V a tile at a time, as fp32 in
// shared memory.  Each thread computes an RT x CT block of S = scale Q K^T
// with FFMA, masks it, and runs the online softmax for its rows in
// registers (each row's running max m, sum l and its DT output columns),
// the row reductions by shuffles within the half-warp that holds the row;
// P goes through shared memory to the same warp for O += P V.
template <class T, int DP>
__global__ void __launch_bounds__(kAnyThreads, 1)
    flash_fwd_any_kernel_ffma(Args a) {
  using G = Geom<DP>;
  extern __shared__ float smem[];
  float* sQ = smem;                  // BR x LD
  float* sK = sQ + G::BR * G::LD;    // BC x LD
  float* sV = sK + G::BC * G::LD;    // BC x LD
  float* sP = sV + G::BC * G::LD;    // BR x LDS
  const T* q = (const T*)a.q;
  const T* k = (const T*)a.k;
  const T* v = (const T*)a.v;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n_qt = (a.Sq + G::BR - 1) / G::BR;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * G::BR;  // longest first
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;

  load_rows<T, G::BR, DP>(sQ, q, b, h, a.H, a.Sq, a.d, q0);

  float acc[G::RT][G::DT];
  float m[G::RT], l[G::RT];
#pragma unroll
  for (int i = 0; i < G::RT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < G::DT; ++j) acc[i][j] = 0.f;
  }

  int kt_begin, kt_end;
  tpujob_flash::k_range<G::BR, G::BC>(q0, a.Sk, a.causal, a.window,
                                      &kt_begin, &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * G::BC;
    __syncthreads();  // the last tile's K and V are no longer read
    load_rows<T, G::BC, DP>(sK, k, b, h, a.H, a.Sk, a.d, k0);
    load_rows<T, G::BC, DP>(sV, v, b, h, a.H, a.Sk, a.d, k0);
    __syncthreads();

    float s[G::RT][G::CT];
#pragma unroll
    for (int i = 0; i < G::RT; ++i)
#pragma unroll
      for (int j = 0; j < G::CT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < a.d; ++dd) {
      float qv[G::RT], kv[G::CT];
#pragma unroll
      for (int i = 0; i < G::RT; ++i) qv[i] = sQ[(ty * G::RT + i) * G::LD + dd];
#pragma unroll
      for (int j = 0; j < G::CT; ++j) kv[j] = sK[(tx + 16 * j) * G::LD + dd];
#pragma unroll
      for (int i = 0; i < G::RT; ++i)
#pragma unroll
        for (int j = 0; j < G::CT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < G::RT; ++i) {
      const int r = ty * G::RT + i, qi = q0 + r;
      bool vis[G::CT];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < G::CT; ++j) {
        vis[j] = sees(qi, k0 + tx + 16 * j, a.Sq, a.Sk, a.causal, a.window);
        s[i][j] = vis[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < G::CT; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        sP[r * G::LDS + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < G::DT; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // P's rows are read by the warp that wrote them

#pragma unroll 4
    for (int c = 0; c < G::BC; ++c) {
      float pv[G::RT];
#pragma unroll
      for (int i = 0; i < G::RT; ++i) pv[i] = sP[(ty * G::RT + i) * G::LDS + c];
#pragma unroll
      for (int j = 0; j < G::DT; ++j) {
        const float vv = sV[c * G::LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < G::RT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* o = (T*)a.out0;
#pragma unroll
  for (int i = 0; i < G::RT; ++i) {
    const int qi = q0 + ty * G::RT + i;
    if (qi >= a.Sq) continue;
    const long row = ((long)(b * a.Sq + qi) * a.H + h) * a.d;
#pragma unroll
    for (int j = 0; j < G::DT; ++j) {
      const int c = tx + 16 * j;
      if (c < a.d) o[row + c] = from_f<T>(l[i] > 0.f ? acc[i][j] / l[i] : 0.f);
    }
    if (tx == 0) a.lse_out[(long)bh * a.Sq + qi] = m[i] + logf(l[i]);
  }
}

}  // namespace tpujob_flash_any

// Host side: the launches and the C entry point.

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

static int launch_fwd_ffma(const Args& a, int B, void* stream) {
  using G = Geom<256>;
  const int smem = ((G::BR + 2 * G::BC) * G::LD + G::BR * G::LDS) *
                   (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_any_kernel_ffma<float, 256>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + G::BR - 1) / G::BR, B * a.H);
  flash_fwd_any_kernel_ffma<float, 256>
      <<<grid, kAnyThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The padded head dim's instantiation, chosen before the launch: the
// tensor-core kernel for every bucket but fp32 at 256 (the FFMA body).
template <class T>
static int dispatch_fwd_any(const Args& a, int B, void* stream) {
  switch (padded_dim(a.d)) {
    case 32: return launch_fwd_tc<T, 32>(a, B, stream);
    case 64: return launch_fwd_tc<T, 64>(a, B, stream);
    case 128: return launch_fwd_tc<T, 128>(a, B, stream);
    case 256:
      if constexpr (sizeof(T) == 4) return launch_fwd_ffma(a, B, stream);
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
  if (Sq <= 0 || Sk <= 0 || B <= 0 || H <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a = {q, k, v, nullptr, nullptr, nullptr, o, nullptr, (float*)lse,
            H, D, Sq, Sk, scale, causal, window};
  return is_bf16 ? dispatch_fwd_any<bf16>(a, B, stream)
                 : dispatch_fwd_any<float>(a, B, stream);
}
