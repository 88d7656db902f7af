// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 statistics.
//
// Replaces the Pallas kernel tpujob/workloads/flash.py:_flash_kernel (with
// _flash_forward, _block_scores and _causal_live): O = softmax(scale Q K^T +
// mask) V with the causal / sliding-window mask, plus the per-row logsumexp
// lse = m + log l that the backward kernels recompute P from.  (The
// reference masks at -1e30; this kernel at -inf, which is the same function
// for every row that sees a key, as every causal row does.)
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at the GPT-2-medium
// shape (b=8, s=1024, h=16, d=64, causal): it must read q, k, v and write o,
// 4 x 16.8 MB = 67 MB, about 20 us; its causal FLOPs are 17.2 G, about
// 17 us.  So it is bound by memory at about 20 us.  At head dim 64 the
// softmax's exponentials (16 a clock an SM) take about as long as the
// tensor-core work, so the design overlaps the two.
//
// Design: one block per (128-row q-tile, batch*head), the longest causal
// q-tiles first; the TPU grid's sequential k axis is a loop inside the
// block, carrying each row's running (m, l, acc) in registers, so nothing
// but O and lse reaches device memory.  Three warpgroups:
//   producer (registers lowered by setmaxnreg): one thread issues TMA loads,
//     Q once, then K and V 128-row tiles into a kStages ring in shared
//     memory, with a full and an empty mbarrier per stage.  TMA's
//     out-of-bounds zero fill masks the ragged edge of every load.
//   two consumers, 64 q rows each: S = Q K^T is wgmma m64n128k16 (A = Q,
//     B = K, both K-major in shared memory); the online softmax runs on the
//     accumulator layout in registers (quad shuffles, in base 2); P goes to
//     bf16 in registers and O += P V is wgmma m64nDk16 with A from
//     registers and B = V, MN-major (transposed) in shared memory.  The
//     loop is software-pipelined: S of k-tile n and P V of tile n-1 are
//     issued together, and the softmax of tile n runs while P V of tile n-1
//     is still on the tensor cores.
// Only tiles crossing the diagonal, the window edge or the ragged edge are
// masked; tiles dead for all of a warpgroup's rows are not computed, and
// tiles dead for the whole block are not loaded.
//
// Head dim D = 64 or 32, one template: at 32 the tiles' rows are 64 bytes
// (the 64-byte swizzle), S = Q K^T takes two k16 steps instead of four, and
// O is an m64n32 accumulator of 16 floats a thread.  At b=8, s=1024,
// h=16, d=32, causal it moves 33.6 MB (10 us) for 8.6 GFLOP (8.7 us):
// bound by memory at about 10 us.
#include "flash_common.cuh"
#include "hopper.cuh"

using namespace tpujob_flash;
using namespace tpujob_hopper;

namespace {

constexpr int kBM = 128;     // q rows a block: two consumer warpgroups of 64
constexpr int kBN = 128;     // keys a k-tile
constexpr int kStages = 3;   // K/V ring depth
constexpr int kFwdThreads = 384;  // producer + two consumer warpgroups
constexpr int kProducerRegs = 40;   // setmaxnreg budgets: 40 x 128 +
constexpr int kConsumerRegs = 232;  // 232 x 256 of the SM's 65,536
constexpr int kConsumerThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  bf16 q[kBM * D];
  bf16 k[kStages][kBN * D];
  bf16 v[kStages][kBN * D];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
template <int D>
constexpr int kSmemBytes = sizeof(Smem<D>) + kAlignBytes;  // + alignment slack

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

}  // namespace

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tmQ,
                 const __grid_constant__ CUtensorMap tmK,
                 const __grid_constant__ CUtensorMap tmV, bf16* __restrict__ O,
                 float* __restrict__ LSE, int H, int Sq, int Sk,
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
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
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
      mbar_arrive_expect_tx(&sm.q_full, kBM * kRowBytes);
      tma_load_bshd(sm.q, &tmQ, &sm.q_full, q0, h, b);
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
    const int qrow[2] = {r0 + 16 * (tid / 32) + (tid % 32) / 4,
                         r0 + 16 * (tid / 32) + (tid % 32) / 4 + 8};
    // the keys each of the thread's two rows sees: key_lo[r] .. key_hi[r]
    int key_lo[2], key_hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      key_hi[r] = causal ? min(qrow[r], Sk - 1) : Sk - 1;
      key_lo[r] = (causal && window > 0) ? qrow[r] - window + 1 : 0;
    }
    // this warpgroup's live k-tiles: those holding a key one of rows
    // r0 .. r0+63 sees (the rest of the block's range is passed over)
    const int live_b = (causal && window > 0)
                           ? max(kt_begin, max(r0 - window + 1, 0) / kBN)
                           : kt_begin;
    const int live_e = causal ? min(kt_end, (r0 + 63) / kBN + 1) : kt_end;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float sc[64];                 // S of the newest tile, then its P
    uint32_t pa[kBN / 16][4];     // P of the tile whose P V is in flight

    auto stage = [&](int kt) { return (kt - kt_begin) % kStages; };
    auto wait_full = [&](int kt) {
      mbar_wait(&sm.full[stage(kt)], ((kt - kt_begin) / kStages) & 1);
    };
    // S = Q K^T (64 x 128, fp32), issued and committed, not waited for
    auto issue_s = [&](int kt) {
      wait_full(kt);
      const uint64_t desc_q = smem_desc<D>(sm.q + 64 * cw * D);
      const uint64_t desc_k = smem_desc<D>(sm.k[stage(kt)]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n128_ss(sc, desc_q + kmajor_step(kk),
                         desc_k + kmajor_step(kk), kk > 0);
      wgmma_commit();
    };
    // O += P V from `pa`, V MN-major, issued and committed
    auto issue_pv = [&](int kt) {
      const uint64_t desc_v = smem_desc<D>(sm.v[stage(kt)]);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_m64nN_rs_t(o, pa[kk], desc_v + mnmajor_step<D>(kk));
      wgmma_commit();
    };
    // online softmax of sc in place (edge tiles masked to -inf; max of the
    // raw scores, then p = 2^(scale log2(e) s - m) as one FFMA and ex2):
    // updates m and l, returns the factor that rescales O.  Row max and sum
    // are trees, to keep the dependency chains short.
    auto softmax = [&](int kt, float alpha[2]) {
      const int k0 = kt * kBN;
      const bool edge = k0 + kBN > Sk ||
                        (causal && (k0 + kBN - 1 > r0 ||
                                    (window > 0 && r0 + 63 - k0 >= window)));
      if (edge) {
        // -inf, so that 2^(scale log2(e) s - m) is exactly 0 (a finite
        // -1e30 would leave its product's rounding error, about 1e22, in
        // the exponent)
        const float masked = __int_as_float(0xff800000u);
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if (key > key_hi[e >> 1] || key < key_lo[e >> 1])
              sc[4 * j + e] = masked;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float red[kBN / 8];
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          red[j] = fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]);
        const float rmax =
            quad_max(tree16(red, [](float x, float y) { return fmaxf(x, y); }));
        const float mnew = fmaxf(m[r], rmax * scale_log2);
        alpha[r] = ex2(m[r] - mnew);
        m[r] = mnew;
      }
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -m[e >> 1]));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float red[kBN / 8];
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          red[j] = sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
        l[r] = l[r] * alpha[r] +
               quad_sum(tree16(red, [](float x, float y) { return x + y; }));
      }
    };
    // ping-pong: the two consumer warpgroups take turns to issue their
    // products (named barriers 1 and 2, one a warpgroup), so that one's
    // softmax runs while the other's products hold the tensor cores.  Each
    // takes kt_end - kt_begin + 1 turns, a k-tile it passes over included;
    // warpgroup 0 opens the first turn, warpgroup 1 skips its last arrive,
    // so both barriers end balanced.
    const int turns = kt_end - kt_begin + 1;
    int turn = 0;
    auto turn_begin = [&]() { named_bar_sync(1 + cw, kConsumerThreads); };
    auto turn_end = [&]() {
      if (cw == 0 || ++turn < turns) named_bar_arrive(2 - cw, kConsumerThreads);
    };
    auto pass_over = [&](int kt) {  // a k-tile dead for these rows
      wait_full(kt);
      mbar_arrive(&sm.empty[stage(kt)]);
      turn_begin();
      turn_end();
    };

    if (cw == 0) named_bar_arrive(1, kConsumerThreads);
    mbar_wait(&sm.q_full, 0);
    for (int kt = kt_begin; kt < min(live_b, kt_end); ++kt) pass_over(kt);
    if (live_b < live_e) {
      // software pipeline: S of tile n runs on the tensor cores while the
      // P V of tile n-1 does too, and the softmax of tile n overlaps the
      // latter
      float alpha[2];
      turn_begin();
      issue_s(live_b);
      turn_end();
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(live_b, alpha);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) a_from_acc(sc, kk, pa[kk]);
      for (int kt = live_b + 1; kt < live_e; ++kt) {
        turn_begin();
        issue_s(kt);
        issue_pv(kt - 1);
        turn_end();
        wgmma_wait<1>();  // S of tile kt
        fence_regs(sc);
        softmax(kt, alpha);
        wgmma_wait<0>();  // P V of tile kt-1
        fence_regs(o);
        mbar_arrive(&sm.empty[stage(kt - 1)]);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) a_from_acc(sc, kk, pa[kk]);
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

    const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= inv[e >> 1];
    store_acc_rows(O + ((long)b * Sq * H + h) * D, (long)H * D, o, r0, Sq);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (qrow[r] < Sq)
          LSE[(long)bh * Sq + qrow[r]] = m[r] / kLog2e + logf(l[r]);
    }
  }
}

template <int D>
static int launch_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int H, int Sq, int Sk, float scale,
                      int causal, int window, void* stream) {
  CUtensorMap mq, mk, mv;
  int rc;
  if ((rc = encode_bshd<D>(&mq, q, B, Sq, H, kBM)) ||
      (rc = encode_bshd<D>(&mk, k, B, Sk, H, kBN)) ||
      (rc = encode_bshd<D>(&mv, v, B, Sk, H, kBN)))
    return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes<D>);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Sq + kBM - 1) / kBM);
  flash_fwd_kernel<D><<<grid, kFwdThreads, kSmemBytes<D>,
                        (cudaStream_t)stream>>>(
      mq, mk, mv, (bf16*)o, (float*)lse, H, Sq, Sk, scale * kLog2e, causal,
      window);
  return (int)cudaGetLastError();
}

extern "C" int tpujob_flash_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int H, int D,
                                int Sq, int Sk, float scale, int causal,
                                int window, void* stream) {
  if (Sq <= 0 || Sk <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return launch_fwd<32>(q, k, v, o, lse, B, H, Sq, Sk, scale, causal,
                            window, stream);
    case 64:
      return launch_fwd<64>(q, k, v, o, lse, B, H, Sq, Sk, scale, causal,
                            window, stream);
  }
  return (int)cudaErrorInvalidValue;
}
