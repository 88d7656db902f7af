// Flash-attention dK/dV for Hopper (sm_90a), the second of the
// FlashAttention-2 pair of backward passes (dQ is flash_dq.cu), bf16 in
// and out, fp32 accumulation.
//
// flash_dkv_kernel replaces the Pallas kernel
// tpujob/workloads/flash.py:_dkv_kernel:
//   dV_j = sum_i P_ij^T dO_i,   dK_j = scale * sum_i dS_ij^T Q_i,
//   dS_ij = P_ij (dO_i V_j^T - D_i)
// P is recomputed from the forward's lse (P = exp(scale Q K^T - lse) on
// visible positions, 0 elsewhere); D = rowsum(dO o O) comes in from the
// wrapper.
//
// Bounds on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at the GPT-2-medium
// shape (b=8, s=1024, h=16, d=64, causal): it reads q, k, v, dO, lse, D and
// writes dK, dV, about 102 MB (30 us); 34.4 GFLOP (35 us): about 35 us,
// bound by operations.
//
// Design: one block per (128-row k-tile, batch*head), K-outer as the
// reference's grid is, so no atomics; the k-tiles that see the most causal
// q-tiles go first.  Three warpgroups:
//   producer (registers lowered by setmaxnreg): K and V once by TMA; then
//     one warp streams (Q tile, dO tile, lse, D) for each live 64-row
//     q-tile through a kStages ring (TMA for Q and dO, the warp's lanes for
//     lse and D), with a full and an empty mbarrier per stage.
//   two consumers, 64 keys each, K and V resident in shared memory; per
//     q-tile: S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, all operands
//     K-major in shared memory), P^T = exp(scale S^T - lse) and
//     dS^T = P^T o (dP^T - D) scale in registers, then dV += P^T dO and
//     dK += dS^T Q (A from registers, B = dO / Q MN-major in shared
//     memory).  dK and dV accumulate in fp32 registers (D / 2 a thread
//     each).
//     The loop is software-pipelined: tile n-1's dK product is still on the
//     tensor cores when tile n's S^T and dP^T are issued, and tile n's dS^T
//     arithmetic runs while its dV product does; the stage of tile n-1 is
//     released one tile late, so the ring is 3 deep.
// Only q-tiles crossing the diagonal, the window edge or the ragged edge
// are masked; q-tiles dead for all of a warpgroup's keys are not computed.
//
// Head dim D = 64 or 32, one template: at 32 the tiles' rows are 64 bytes
// (the 64-byte swizzle), S^T and dP^T take two k16 steps instead of four,
// and dK and dV are m64n32 accumulators (16 floats a thread each).
#include "flash_common.cuh"
#include "hopper.cuh"

using namespace tpujob_flash;
using namespace tpujob_hopper;

namespace {

constexpr int kBN = 128;     // keys a block: two consumer warpgroups of 64
constexpr int kBM = 64;      // q rows a ring stage
constexpr int kStages = 3;   // (Q, dO, lse, D) ring depth
constexpr int kDkvThreads = 384;  // producer + two consumer warpgroups
constexpr int kProducerRegs = 40;   // setmaxnreg budgets: 40 x 128 +
constexpr int kConsumerRegs = 232;  // 232 x 256 of the SM's 65,536
constexpr int kConsumerThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  bf16 k[kBN * D];
  bf16 v[kBN * D];
  bf16 q[kStages][kBM * D];
  bf16 dout[kStages][kBM * D];
  float lse[kStages][kBM];  // lse * log2(e): P = 2^(scale log2(e) S - this)
  float delta[kStages][kBM];
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
template <int D>
constexpr int kSmemBytes = sizeof(Smem<D>) + kAlignBytes;  // + alignment slack

}  // namespace

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tmQ,
                 const __grid_constant__ CUtensorMap tmK,
                 const __grid_constant__ CUtensorMap tmV,
                 const __grid_constant__ CUtensorMap tmDO,
                 const float* __restrict__ LSE, const float* __restrict__ DELTA,
                 bf16* __restrict__ dK, bf16* __restrict__ dV, int H, int Sq,
                 int Sk, float scale, float scale_log2, int causal,
                 int window) {
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(align_atom(smem_raw));
  constexpr int kRowBytes = Rows<D>::kBytes;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kBN;  // under causal the first k-tiles see most
  int qt_begin, qt_end;
  q_range<kBN, kBM>(k0, Sq, causal, window, &qt_begin, &qt_end);
  // ptxas serializes every wgmma of the kernel (its C7518) when a branch
  // it takes for divergent runs with wgmma results in flight; broadcast
  // from lane 0, the warpgroup index, and the loop bounds derived from it,
  // are warp-uniform to it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
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
        mbar_arrive_expect_tx(&sm.kv_full, 2 * kBN * kRowBytes);
        tma_load_bshd(sm.k, &tmK, &sm.kv_full, k0, h, b);
        tma_load_bshd(sm.v, &tmV, &sm.kv_full, k0, h, b);
      }
      for (int qt = qt_begin, i = 0; qt < qt_end; ++qt, ++i) {
        const int s = i % kStages;
        const int q0 = qt * kBM;
        mbar_wait(&sm.empty[s], ((i / kStages) & 1) ^ 1);
        for (int r = lane; r < kBM; r += 32) {
          const bool ok = q0 + r < Sq;
          sm.lse[s][r] = ok ? LSE[(long)bh * Sq + q0 + r] * kLog2e : 0.f;
          sm.delta[s][r] = ok ? DELTA[(long)bh * Sq + q0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.full[s], 2 * kBM * kRowBytes);
          tma_load_bshd(sm.q[s], &tmQ, &sm.full[s], q0, h, b);
          tma_load_bshd(sm.dout[s], &tmDO, &sm.full[s], q0, h, b);
        } else {
          mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int t = tid % 4;
    const int kr0 = k0 + 64 * cw;  // this warpgroup's first key
    const int krow[2] = {kr0 + 16 * (tid / 32) + (tid % 32) / 4,
                         kr0 + 16 * (tid / 32) + (tid % 32) / 4 + 8};
    // the queries that see each of the thread's two keys: q_lo[r] .. q_hi[r]
    int q_lo[2], q_hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      q_lo[r] = causal ? krow[r] : 0;
      q_hi[r] = (causal && window > 0) ? min(krow[r] + window - 1, Sq - 1)
                                       : Sq - 1;
      if (krow[r] >= Sk) q_hi[r] = -1;  // a key past Sk is seen by none
    }
    // this warpgroup's live q-tiles: those holding a query that sees one
    // of keys kr0 .. kr0+63 (the rest of the block's range is passed over)
    const int live_b = causal ? max(qt_begin, kr0 / kBM) : qt_begin;
    const int live_e = (causal && window > 0)
                           ? min(qt_end, (kr0 + 63 + window - 1) / kBM + 1)
                           : qt_end;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    float st[32], dpt[32];         // S^T then P^T; dP^T then dS^T
    uint32_t pa[kBM / 16][4];      // P^T of the tile whose dV is in flight
    uint32_t da[kBM / 16][4];      // dS^T of the tile whose dK is in flight

    auto stage = [&](int qt) { return (qt - qt_begin) % kStages; };
    auto wait_full = [&](int qt) {
      mbar_wait(&sm.full[stage(qt)], ((qt - qt_begin) / kStages) & 1);
    };
    auto pass_over = [&](int qt) {  // a q-tile dead for these keys
      wait_full(qt);
      mbar_arrive(&sm.empty[stage(qt)]);
    };

    mbar_wait(&sm.kv_full, 0);
    const uint64_t desc_k = smem_desc<D>(sm.k + 64 * cw * D);
    const uint64_t desc_v = smem_desc<D>(sm.v + 64 * cw * D);
    for (int qt = qt_begin; qt < min(live_b, qt_end); ++qt) pass_over(qt);
    // software pipeline: the dK product of q-tile n-1 runs on the tensor
    // cores ahead of S^T and dP^T of tile n, and the dS^T arithmetic of
    // tile n overlaps its dV product
    for (int qt = live_b; qt < live_e; ++qt) {
      const int s = stage(qt);
      const int q0 = qt * kBM;
      wait_full(qt);

      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries, fp32)
      const uint64_t desc_q = smem_desc<D>(sm.q[s]);
      const uint64_t desc_do = smem_desc<D>(sm.dout[s]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64_ss(st, desc_k + kmajor_step(kk),
                        desc_q + kmajor_step(kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64_ss(dpt, desc_v + kmajor_step(kk),
                        desc_do + kmajor_step(kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();  // these, and tile n-1's dV and dK
      fence_regs(st);
      fence_regs(dpt);
      fence_regs(dv);
      fence_regs(dk);
      if (qt > live_b) mbar_arrive(&sm.empty[stage(qt - 1)]);

      // P^T (columns are queries), then dV += P^T dO (B = dO MN-major)
      const bool edge =
          q0 + kBM > Sq || kr0 + 64 > Sk ||
          (causal && (q0 < kr0 + 63 ||
                      (window > 0 && q0 + kBM - 1 - kr0 >= window)));
#pragma unroll
      for (int j = 0; j < kBM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + 8 * j + 2 * t + (e & 1);
          float p = ex2(st[4 * j + e] * scale_log2 - sm.lse[s][q - q0]);
          if (edge && (q < q_lo[e >> 1] || q > q_hi[e >> 1])) p = 0.f;
          st[4 * j + e] = p;
        }
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk) a_from_acc(st, kk, pa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk)
        wgmma_m64nN_rs_t(dv, pa[kk], desc_do + mnmajor_step<D>(kk));
      wgmma_commit();

      // dS^T = P^T o (dP^T - D) scale, then dK += dS^T Q (B = Q MN-major)
#pragma unroll
      for (int j = 0; j < kBM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          dpt[4 * j + e] =
              st[4 * j + e] * (dpt[4 * j + e] - sm.delta[s][qc]) * scale;
        }
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk) a_from_acc(dpt, kk, da[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk)
        wgmma_m64nN_rs_t(dk, da[kk], desc_q + mnmajor_step<D>(kk));
      wgmma_commit();
    }
    wgmma_wait<0>();  // on every path, so ptxas injects no wait of its own
    fence_regs(dv);
    fence_regs(dk);
    if (live_b < live_e) mbar_arrive(&sm.empty[stage(live_e - 1)]);
    for (int qt = max(live_b, live_e); qt < qt_end; ++qt) pass_over(qt);

    const long off = ((long)b * Sk * H + h) * D, stride = (long)H * D;
    store_acc_rows(dK + off, stride, dk, kr0, Sk);
    store_acc_rows(dV + off, stride, dv, kr0, Sk);
  }
}

template <int D>
static int launch_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int H, int Sq, int Sk,
                      float scale, int causal, int window, void* stream) {
  CUtensorMap mq, mk, mv, mdo;
  int rc;
  if ((rc = encode_bshd<D>(&mq, q, B, Sq, H, kBM)) ||
      (rc = encode_bshd<D>(&mk, k, B, Sk, H, kBN)) ||
      (rc = encode_bshd<D>(&mv, v, B, Sk, H, kBN)) ||
      (rc = encode_bshd<D>(&mdo, dout, B, Sq, H, kBM)))
    return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes<D>);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Sk + kBN - 1) / kBN);
  flash_dkv_kernel<D><<<grid, kDkvThreads, kSmemBytes<D>,
                        (cudaStream_t)stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, H, Sq, Sk, scale, scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

extern "C" int tpujob_flash_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int H, int D, int Sq, int Sk, float scale,
                                int causal, int window, void* stream) {
  if (Sq <= 0 || Sk <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk,
                            scale, causal, window, stream);
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk,
                            scale, causal, window, stream);
  }
  return (int)cudaErrorInvalidValue;
}
