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
// Design: one block per (q-tile, batch*head) loops over k-tiles (the TPU
// grid's sequential axis), so no atomics.  Loop bounds skip dead tiles (the
// reference's _causal_live).  Each warp owns 16 rows of the block's tile;
// every product is mma.sync with fp32 accumulators in registers, and dS
// goes from accumulator to operand in registers.
#include "flash_common.cuh"

using namespace tpujob_flash;

__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                const bf16* __restrict__ V, const bf16* __restrict__ dO,
                const float* __restrict__ LSE, const float* __restrict__ DELTA,
                bf16* __restrict__ dQ, int H, int Sq, int Sk, float scale,
                int causal, int window) {
  __shared__ __align__(16) Tile sQ;   // q, then reused for dO
  __shared__ __align__(16) Tile sK;
  __shared__ __align__(16) Tile sV;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long stride = (long)H * kD;
  const long qoff = ((long)b * Sq * H + h) * kD;
  const long koff = ((long)b * Sk * H + h) * kD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int row0 = q0 + warp * 16;
  const int qrow[2] = {row0 + g, row0 + g + 8};

  uint32_t qf[4][4], dof[4][4];
  load_tile(sQ, Q + qoff, q0, Sq, stride);
  __syncthreads();
  load_a_frags(sQ, warp * 16, g, t, qf);
  __syncthreads();
  load_tile(sQ, dO + qoff, q0, Sq, stride);
  __syncthreads();
  load_a_frags(sQ, warp * 16, g, t, dof);

  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = qrow[i] < Sq;
    lse[i] = ok ? LSE[(long)bh * Sq + qrow[i]] : 0.f;
    delta[i] = ok ? DELTA[(long)bh * Sq + qrow[i]] : 0.f;
  }

  float dq[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  int kt_begin, kt_end;
  k_range<kTile, kTile>(q0, Sk, causal, window, &kt_begin, &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile(sK, K + koff, k0, Sk, stride);
    load_tile(sV, V + koff, k0, Sk, stride);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    mma_abt(s, qf, sK, g, t);    // Q K^T
    mma_abt(dp, dof, sV, g, t);  // dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const float p = visible(qrow[i], key, Sq, Sk, causal, window)
                            ? __expf(s[nt][e] * scale - lse[i]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta[i]) * scale;  // dS
      }
    mma_pt(dq, s, sK, g, t);  // dS K
  }
  store_acc(dQ + qoff, stride, dq, row0, Sq, g, t);
}

extern "C" int tpujob_flash_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int H,
                               int Sq, int Sk, float scale, int causal,
                               int window, void* stream) {
  if (Sq <= 0 || Sk <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + kTile - 1) / kTile, B * H);
  flash_dq_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, H, Sq, Sk, scale,
      causal, window);
  return (int)cudaGetLastError();
}
