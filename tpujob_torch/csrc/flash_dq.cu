// Flash-attention dQ for Hopper (sm_90a), the first of the FlashAttention-2
// pair of backward passes (the dK/dV pass is flash_dkv.cu), bf16 in and out,
// fp32 accumulation.
//
// flash_dq_kernel replaces the Pallas kernel
// tpujob/workloads/flash.py:_dq_kernel:
//   dQ_i = scale * sum_j P_ij o (dO_i V_j^T - D_i) K_j
// P is recomputed from the forward's lse (P = exp(scale Q K^T - lse) on
// visible positions, 0 elsewhere); D = rowsum(dO o O) comes in from the
// wrapper, which computes it with one torch reduction as the JAX package
// does outside Pallas.
//
// Bounds on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at the GPT-2-medium
// shape (b=8, s=1024, h=16, d=64, causal): it reads q, k, v, dO, lse, D and
// writes dQ, about 85 MB (25 us); 25.8 GFLOP (26 us): about 26 us, bound by
// operations.
//
// Design: flash_fwd.cu's skeleton with flash_dkv.cu's products.  One block
// per (128-row q-tile, batch*head), the longest causal q-tiles first; the
// TPU grid's sequential k axis is a loop inside the block, dQ accumulating
// in registers, so no atomics.  Three warpgroups:
//   producer (registers lowered by setmaxnreg): warp 0 loads Q and dO once
//     by TMA and writes each row's lse (times log2 e) and D into shared
//     memory with its lanes; one thread of warp 1 streams K and V 64-row
//     tiles into a kStages ring, with a full and an empty mbarrier per
//     stage.  TMA's zero fill past S masks the ragged edge of every load.
//   two consumers, 64 q rows each; per k-tile: S = Q K^T and dP = dO V^T
//     (wgmma m64n64k16, all operands K-major in shared memory), P =
//     2^(scale log2(e) S - lse log2(e)) while dP is still on the tensor
//     cores, dS = P o (dP - D) in registers, then dQ += dS K (A from
//     registers, B = K MN-major in shared memory).  dQ accumulates in fp32
//     registers and takes the scale once, at the end.  The loop is
//     software-pipelined: the dQ product of k-tile n-1 is still on the
//     tensor cores when tile n's S and dP are issued; the stage of tile n-1
//     is released one tile late, so the ring is at least 3 deep.
// Only k-tiles crossing the diagonal, the window edge or the ragged edge
// are masked; k-tiles dead for all of a warpgroup's rows are not computed,
// and those dead for the whole block are not loaded.
//
// Head dim D = 64 or 32, one template: at 32 the tiles' rows are 64 bytes
// (the 64-byte swizzle), S and dP take two k16 steps instead of four, and
// dQ is an m64n32 accumulator (dQ += dS K is m64n32k16).
#include "flash_common.cuh"
#include "hopper.cuh"

using namespace tpujob_flash;
using namespace tpujob_hopper;

namespace {

constexpr int kBM = 128;     // q rows a block: two consumer warpgroups of 64
constexpr int kBN = 64;      // keys a k-tile
constexpr int kStages = 4;   // K/V ring depth
constexpr int kDqThreads = 384;  // producer + two consumer warpgroups
constexpr int kProducerRegs = 40;   // setmaxnreg budgets: 40 x 128 +
constexpr int kConsumerRegs = 232;  // 232 x 256 of the SM's 65,536
constexpr int kConsumerThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  bf16 q[kBM * D];
  bf16 dout[kBM * D];
  bf16 k[kStages][kBN * D];
  bf16 v[kStages][kBN * D];
  float lse[kBM];  // lse * log2(e): P = 2^(scale log2(e) S - this)
  float delta[kBM];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
template <int D>
constexpr int kSmemBytes = sizeof(Smem<D>) + kAlignBytes;  // + alignment slack

}  // namespace

template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tmQ,
                const __grid_constant__ CUtensorMap tmK,
                const __grid_constant__ CUtensorMap tmV,
                const __grid_constant__ CUtensorMap tmDO,
                const float* __restrict__ LSE, const float* __restrict__ DELTA,
                bf16* __restrict__ dQ, int H, int Sq, int Sk, float scale,
                float scale_log2, int causal, int window) {
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(align_atom(smem_raw));
  constexpr int kRowBytes = Rows<D>::kBytes;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest rows first
  int kt_begin, kt_end;
  k_range<kBM, kBN>(q0, Sk, causal, window, &kt_begin, &kt_end);
  // ptxas serializes every wgmma of the kernel (its C7518) when a branch
  // it takes for divergent runs with wgmma results in flight; broadcast
  // from lane 0, the warpgroup index, and the loop bounds derived from it,
  // are warp-uniform to it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 33);  // warp 0's lanes, and the TMA issue
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: warp 0 the Q side, warp 1 the K/V ring ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.q_full, 2 * kBM * kRowBytes);
        tma_load_bshd(sm.q, &tmQ, &sm.q_full, q0, h, b);
        tma_load_bshd(sm.dout, &tmDO, &sm.q_full, q0, h, b);
      }
      for (int r = lane; r < kBM; r += 32) {
        const bool ok = q0 + r < Sq;
        sm.lse[r] = ok ? LSE[(long)bh * Sq + q0 + r] * kLog2e : 0.f;
        sm.delta[r] = ok ? DELTA[(long)bh * Sq + q0 + r] : 0.f;
      }
      mbar_arrive(&sm.q_full);
    } else if (threadIdx.x == 32) {
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int s = i % kStages;
        mbar_wait(&sm.empty[s], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[s], 2 * kBN * kRowBytes);
        tma_load_bshd(sm.k[s], &tmK, &sm.full[s], kt * kBN, h, b);
        tma_load_bshd(sm.v[s], &tmV, &sm.full[s], kt * kBN, h, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int t = tid % 4;
    const int r0 = q0 + 64 * cw;  // this warpgroup's first q row
    const int lrow = 64 * cw + 16 * (tid / 32) + (tid % 32) / 4;
    const int qrow[2] = {q0 + lrow, q0 + lrow + 8};
    // the keys each of the thread's two rows sees: key_lo[r] .. key_hi[r]
    int key_lo[2], key_hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      key_hi[r] = causal ? min(qrow[r], Sk - 1) : Sk - 1;
      key_lo[r] = (causal && window > 0) ? qrow[r] - window + 1 : 0;
    }
    // this warpgroup's live k-tiles: those holding a key one of rows
    // r0 .. r0+63 sees (the rest of the block's range is passed over); a
    // warpgroup whose rows all lie past Sq has none
    const int live_b = (causal && window > 0)
                           ? max(kt_begin, max(r0 - window + 1, 0) / kBN)
                           : kt_begin;
    const int live_e =
        r0 >= Sq ? live_b
                 : (causal ? min(kt_end, (r0 + 63) / kBN + 1) : kt_end);

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    float sc[32], dp[32];        // S then P; dP then dS
    uint32_t da[kBN / 16][4];    // dS of the tile whose dQ is in flight

    auto stage = [&](int kt) { return (kt - kt_begin) % kStages; };
    auto wait_full = [&](int kt) {
      mbar_wait(&sm.full[stage(kt)], ((kt - kt_begin) / kStages) & 1);
    };
    auto pass_over = [&](int kt) {  // a k-tile dead for these rows
      wait_full(kt);
      mbar_arrive(&sm.empty[stage(kt)]);
    };

    mbar_wait(&sm.q_full, 0);
    const float lse2[2] = {sm.lse[lrow], sm.lse[lrow + 8]};
    const float dlt[2] = {sm.delta[lrow], sm.delta[lrow + 8]};
    const uint64_t desc_q = smem_desc<D>(sm.q + 64 * cw * D);
    const uint64_t desc_do = smem_desc<D>(sm.dout + 64 * cw * D);
    for (int kt = kt_begin; kt < min(live_b, kt_end); ++kt) pass_over(kt);
    // software pipeline: the dQ product of k-tile n-1 runs on the tensor
    // cores ahead of S and dP of tile n, and P of tile n is computed while
    // its dP product runs
    for (int kt = live_b; kt < live_e; ++kt) {
      const int s = stage(kt);
      const int k0 = kt * kBN;
      wait_full(kt);

      // S = Q K^T and dP = dO V^T (64 queries x 64 keys, fp32)
      const uint64_t desc_k = smem_desc<D>(sm.k[s]);
      const uint64_t desc_v = smem_desc<D>(sm.v[s]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64_ss(sc, desc_q + kmajor_step(kk),
                        desc_k + kmajor_step(kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64_ss(dp, desc_do + kmajor_step(kk),
                        desc_v + kmajor_step(kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // tile n-1's dQ product, and S
      fence_regs(sc);
      if (kt > live_b) mbar_arrive(&sm.empty[stage(kt - 1)]);

      // P (columns are keys), masked to exactly 0 on edge tiles
      const bool edge =
          k0 + kBN > Sk ||
          (causal && (k0 + kBN - 1 > r0 ||
                      (window > 0 && r0 + 63 - k0 >= window)));
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          float p = ex2(fmaf(sc[4 * j + e], scale_log2, -lse2[e >> 1]));
          if (edge && (key < key_lo[e >> 1] || key > key_hi[e >> 1])) p = 0.f;
          sc[4 * j + e] = p;
        }
      wgmma_wait<0>();  // dP
      fence_regs(dp);

      // dS = P o (dP - D) (the scale waits for the end), then dQ += dS K
      // (B = K MN-major)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dlt[e >> 1]);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) a_from_acc(dp, kk, da[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_m64nN_rs_t(dq, da[kk], desc_k + mnmajor_step<D>(kk));
      wgmma_commit();
    }
    wgmma_wait<0>();  // on every path, so ptxas injects no wait of its own
    fence_regs(dq);
    if (live_b < live_e) mbar_arrive(&sm.empty[stage(live_e - 1)]);
    for (int kt = max(live_b, live_e); kt < kt_end; ++kt) pass_over(kt);

#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] *= scale;
    store_acc_rows(dQ + ((long)b * Sq * H + h) * D, (long)H * D, dq, r0, Sq);
  }
}

template <int D>
static int launch_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int H, int Sq, int Sk, float scale,
                     int causal, int window, void* stream) {
  CUtensorMap mq, mk, mv, mdo;
  int rc;
  if ((rc = encode_bshd<D>(&mq, q, B, Sq, H, kBM)) ||
      (rc = encode_bshd<D>(&mk, k, B, Sk, H, kBN)) ||
      (rc = encode_bshd<D>(&mv, v, B, Sk, H, kBN)) ||
      (rc = encode_bshd<D>(&mdo, dout, B, Sq, H, kBM)))
    return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes<D>);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Sq + kBM - 1) / kBM);
  flash_dq_kernel<D><<<grid, kDqThreads, kSmemBytes<D>,
                       (cudaStream_t)stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta, (bf16*)dq, H,
      Sq, Sk, scale, scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

extern "C" int tpujob_flash_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int H,
                               int D, int Sq, int Sk, float scale, int causal,
                               int window, void* stream) {
  if (Sq <= 0 || Sk <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return launch_dq<32>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, scale,
                           causal, window, stream);
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, scale,
                           causal, window, stream);
  }
  return (int)cudaErrorInvalidValue;
}
