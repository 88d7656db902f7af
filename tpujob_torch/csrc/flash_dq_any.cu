// Flash-attention dQ for any head dim 1-256, fp32 or bf16 in, fp32
// arithmetic on the CUDA cores (sm_90a).
//
// Replaces the Pallas kernel tpujob/workloads/flash.py:_dq_kernel for every
// input the tuned flash_dq.cu does not take: dQ = scale * sum_k (P o (dO V^T
// - D)) K, with P = exp(scale Q K^T - lse) recomputed from the forward's
// logsumexp (0 where masked) and D = rowsum(dO o O); dq in the input's dtype.
//
// Bound on an H100 SXM at the GPT-2-medium shape in fp32 (b=8, s=1024,
// h=16, d=64, causal): it reads q, k, v, dO, lse and delta and writes dq,
// 5 x 33.6 MB + 1 MB = 169 MB, 50 us; its causal FLOPs (S, dP and dS K)
// are 25.8 G, 52 us at tf32's 495 TFLOP/s, 385 us at fp32 FFMA's
// 67 TFLOP/s, which this kernel runs on: bound by operations.
//
// Design (flash_any.cuh): one block of 256 threads per (BR-row q-tile,
// batch*head); Q and dO staged once, then a loop over the live k-tiles
// (k_range: dead tiles skipped) staging K and V.  Each thread computes an
// RT x CT block of S and of dP = dO V^T in one pass over the head dim,
// forms dS = P (dP - D) scale in registers, and hands its rows of dS to
// its own warp through shared memory for dQ += dS K, DT columns a thread.
#include "flash_any.cuh"

namespace tpujob_flash_any {

template <class T, int DP>
__global__ void __launch_bounds__(kAnyThreads, 1)
    flash_dq_any_kernel(Args a) {
  using G = Geom<DP>;
  extern __shared__ float smem[];
  float* sQ = smem;                  // BR x LD
  float* sO = sQ + G::BR * G::LD;    // dO, BR x LD
  float* sK = sO + G::BR * G::LD;    // BC x LD
  float* sV = sK + G::BC * G::LD;    // BC x LD
  float* sS = sV + G::BC * G::LD;    // dS, BR x LDS
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n_qt = (a.Sq + G::BR - 1) / G::BR;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * G::BR;  // longest first
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;

  load_rows<T, G::BR, DP>(sQ, (const T*)a.q, b, h, a.H, a.Sq, a.d, q0);
  load_rows<T, G::BR, DP>(sO, (const T*)a.dout, b, h, a.H, a.Sq, a.d, q0);

  float acc[G::RT][G::DT], lse[G::RT], delta[G::RT];
#pragma unroll
  for (int i = 0; i < G::RT; ++i) {
    const int qi = q0 + ty * G::RT + i;
    lse[i] = qi < a.Sq ? a.lse[(long)bh * a.Sq + qi] : 0.f;
    delta[i] = qi < a.Sq ? a.delta[(long)bh * a.Sq + qi] : 0.f;
#pragma unroll
    for (int j = 0; j < G::DT; ++j) acc[i][j] = 0.f;
  }

  int kt_begin, kt_end;
  tpujob_flash::k_range<G::BR, G::BC>(q0, a.Sk, a.causal, a.window,
                                      &kt_begin, &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * G::BC;
    __syncthreads();  // the last tile's K and V are no longer read
    load_rows<T, G::BC, DP>(sK, (const T*)a.k, b, h, a.H, a.Sk, a.d, k0);
    load_rows<T, G::BC, DP>(sV, (const T*)a.v, b, h, a.H, a.Sk, a.d, k0);
    __syncthreads();

    float s[G::RT][G::CT], dp[G::RT][G::CT];
#pragma unroll
    for (int i = 0; i < G::RT; ++i)
#pragma unroll
      for (int j = 0; j < G::CT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < a.d; ++dd) {
      float qv[G::RT], ov[G::RT], kv[G::CT], vv[G::CT];
#pragma unroll
      for (int i = 0; i < G::RT; ++i) {
        qv[i] = sQ[(ty * G::RT + i) * G::LD + dd];
        ov[i] = sO[(ty * G::RT + i) * G::LD + dd];
      }
#pragma unroll
      for (int j = 0; j < G::CT; ++j) {
        kv[j] = sK[(tx + 16 * j) * G::LD + dd];
        vv[j] = sV[(tx + 16 * j) * G::LD + dd];
      }
#pragma unroll
      for (int i = 0; i < G::RT; ++i)
#pragma unroll
        for (int j = 0; j < G::CT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < G::RT; ++i) {
      const int r = ty * G::RT + i;
#pragma unroll
      for (int j = 0; j < G::CT; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (sees(q0 + r, k0 + c, a.Sq, a.Sk, a.causal, a.window)) {
          const float p = expf(s[i][j] * a.scale - lse[i]);
          ds = p * (dp[i][j] - delta[i]) * a.scale;
        }
        sS[r * G::LDS + c] = ds;
      }
    }
    __syncwarp();  // dS's rows are read by the warp that wrote them

#pragma unroll 4
    for (int c = 0; c < G::BC; ++c) {
      float dsv[G::RT];
#pragma unroll
      for (int i = 0; i < G::RT; ++i) dsv[i] = sS[(ty * G::RT + i) * G::LDS + c];
#pragma unroll
      for (int j = 0; j < G::DT; ++j) {
        const float kk = sK[c * G::LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < G::RT; ++i) acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
      }
    }
  }

  T* dq = (T*)a.out0;
#pragma unroll
  for (int i = 0; i < G::RT; ++i) {
    const int qi = q0 + ty * G::RT + i;
    if (qi >= a.Sq) continue;
    const long row = ((long)(b * a.Sq + qi) * a.H + h) * a.d;
#pragma unroll
    for (int j = 0; j < G::DT; ++j) {
      const int c = tx + 16 * j;
      if (c < a.d) dq[row + c] = from_f<T>(acc[i][j]);
    }
  }
}

}  // namespace tpujob_flash_any

// Host side: the launch and the C entry point.

using namespace tpujob_flash_any;

template <class T, int DP>
static int launch_dq_any(const Args& a, int B, void* stream) {
  using G = Geom<DP>;
  const int smem = ((2 * G::BR + 2 * G::BC) * G::LD + G::BR * G::LDS) *
                   (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_dq_any_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + G::BR - 1) / G::BR, B * a.H);
  flash_dq_any_kernel<T, DP>
      <<<grid, kAnyThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <class T>
static int dispatch_dq_any(const Args& a, int B, void* stream) {
  switch (padded_dim(a.d)) {
    case 32: return launch_dq_any<T, 32>(a, B, stream);
    case 64: return launch_dq_any<T, 64>(a, B, stream);
    case 128: return launch_dq_any<T, 128>(a, B, stream);
    case 256: return launch_dq_any<T, 256>(a, B, stream);
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
  if (Sq <= 0 || Sk <= 0 || B <= 0 || H <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a = {q, k, v, dout, (const float*)lse, (const float*)delta, dq,
            nullptr, nullptr, H, D, Sq, Sk, scale, causal, window};
  return is_bf16 ? dispatch_dq_any<bf16>(a, B, stream)
                 : dispatch_dq_any<float>(a, B, stream);
}
