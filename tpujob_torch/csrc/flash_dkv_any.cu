// Flash-attention dK and dV for any head dim 1-256, fp32 or bf16 in, fp32
// arithmetic on the CUDA cores (sm_90a).
//
// Replaces the Pallas kernel tpujob/workloads/flash.py:_dkv_kernel for every
// input the tuned flash_dkv.cu does not take: dV = P^T dO and
// dK = scale * dS^T Q with dS = P o (dO V^T - D), summed over the query
// tiles, P recomputed from the forward's logsumexp (0 where masked); dk and
// dv in the input's dtype.
//
// Bound on an H100 SXM at the GPT-2-medium shape in fp32 (b=8, s=1024,
// h=16, d=64, causal): it reads q, k, v, dO, lse and delta and writes dk
// and dv, 6 x 33.6 MB + 1 MB = 202 MB, 60 us; its causal FLOPs (S, dP,
// P^T dO and dS^T Q) are 34.4 G, 70 us at tf32's 495 TFLOP/s, 514 us at
// fp32 FFMA's 67 TFLOP/s, which this kernel runs on: bound by operations.
//
// Design (flash_any.cuh): one block of 256 threads per (BR-key tile,
// batch*head), the keys' K and V staged once; the TPU grid's sequential q
// axis is a loop over the live q-tiles (flash_common.cuh's q_range: dead
// tiles skipped), staging Q, dO and the tile's lse and delta.  Each thread
// computes an RT x CT block of S^T = K Q^T and dP^T = V dO^T (rows = keys),
// forms P^T and dS^T in registers and hands its rows of both to its own
// warp through shared memory for dV += P^T dO and dK += dS^T Q, DT columns
// a thread of each.
#include "flash_any.cuh"

namespace tpujob_flash_any {

template <class T, int DP>
__global__ void __launch_bounds__(kAnyThreads, 1)
    flash_dkv_any_kernel(Args a) {
  using G = Geom<DP>;
  extern __shared__ float smem[];
  float* sK = smem;                  // BR x LD
  float* sV = sK + G::BR * G::LD;    // BR x LD
  float* sQ = sV + G::BR * G::LD;    // BC x LD
  float* sO = sQ + G::BC * G::LD;    // dO, BC x LD
  float* sP = sO + G::BC * G::LD;    // P^T, BR x LDS
  float* sS = sP + G::BR * G::LDS;   // dS^T, BR x LDS
  float* sLse = sS + G::BR * G::LDS; // BC
  float* sDelta = sLse + G::BC;      // BC
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * G::BR;  // causal: the first keys see most rows
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;

  load_rows<T, G::BR, DP>(sK, (const T*)a.k, b, h, a.H, a.Sk, a.d, k0);
  load_rows<T, G::BR, DP>(sV, (const T*)a.v, b, h, a.H, a.Sk, a.d, k0);

  float dk[G::RT][G::DT], dv[G::RT][G::DT];
#pragma unroll
  for (int i = 0; i < G::RT; ++i)
#pragma unroll
    for (int j = 0; j < G::DT; ++j) dk[i][j] = dv[i][j] = 0.f;

  int qt_begin, qt_end;
  tpujob_flash::q_range<G::BR, G::BC>(k0, a.Sq, a.causal, a.window,
                                      &qt_begin, &qt_end);
  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * G::BC;
    __syncthreads();  // the last tile's Q, dO, lse and delta are no longer read
    load_rows<T, G::BC, DP>(sQ, (const T*)a.q, b, h, a.H, a.Sq, a.d, q0);
    load_rows<T, G::BC, DP>(sO, (const T*)a.dout, b, h, a.H, a.Sq, a.d, q0);
    for (int c = tid; c < G::BC; c += kAnyThreads) {
      const int qi = q0 + c;
      sLse[c] = qi < a.Sq ? a.lse[(long)bh * a.Sq + qi] : 0.f;
      sDelta[c] = qi < a.Sq ? a.delta[(long)bh * a.Sq + qi] : 0.f;
    }
    __syncthreads();

    float s[G::RT][G::CT], dp[G::RT][G::CT];
#pragma unroll
    for (int i = 0; i < G::RT; ++i)
#pragma unroll
      for (int j = 0; j < G::CT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < a.d; ++dd) {
      float kv[G::RT], vv[G::RT], qv[G::CT], ov[G::CT];
#pragma unroll
      for (int i = 0; i < G::RT; ++i) {
        kv[i] = sK[(ty * G::RT + i) * G::LD + dd];
        vv[i] = sV[(ty * G::RT + i) * G::LD + dd];
      }
#pragma unroll
      for (int j = 0; j < G::CT; ++j) {
        qv[j] = sQ[(tx + 16 * j) * G::LD + dd];
        ov[j] = sO[(tx + 16 * j) * G::LD + dd];
      }
#pragma unroll
      for (int i = 0; i < G::RT; ++i)
#pragma unroll
        for (int j = 0; j < G::CT; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < G::RT; ++i) {
      const int r = ty * G::RT + i;
#pragma unroll
      for (int j = 0; j < G::CT; ++j) {
        const int c = tx + 16 * j;
        float p = 0.f, ds = 0.f;
        if (sees(q0 + c, k0 + r, a.Sq, a.Sk, a.causal, a.window)) {
          p = expf(s[i][j] * a.scale - sLse[c]);
          ds = p * (dp[i][j] - sDelta[c]) * a.scale;
        }
        sP[r * G::LDS + c] = p;
        sS[r * G::LDS + c] = ds;
      }
    }
    __syncwarp();  // P^T's and dS^T's rows are read by the warp that wrote them

#pragma unroll 2
    for (int c = 0; c < G::BC; ++c) {
      float pv[G::RT], dsv[G::RT];
#pragma unroll
      for (int i = 0; i < G::RT; ++i) {
        pv[i] = sP[(ty * G::RT + i) * G::LDS + c];
        dsv[i] = sS[(ty * G::RT + i) * G::LDS + c];
      }
#pragma unroll
      for (int j = 0; j < G::DT; ++j) {
        const float qq = sQ[c * G::LD + tx + 16 * j];
        const float oo = sO[c * G::LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < G::RT; ++i) {
          dv[i][j] = fmaf(pv[i], oo, dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qq, dk[i][j]);
        }
      }
    }
  }

  T* dk_out = (T*)a.out0;
  T* dv_out = (T*)a.out1;
#pragma unroll
  for (int i = 0; i < G::RT; ++i) {
    const int kj = k0 + ty * G::RT + i;
    if (kj >= a.Sk) continue;
    const long row = ((long)(b * a.Sk + kj) * a.H + h) * a.d;
#pragma unroll
    for (int j = 0; j < G::DT; ++j) {
      const int c = tx + 16 * j;
      if (c < a.d) {
        dk_out[row + c] = from_f<T>(dk[i][j]);
        dv_out[row + c] = from_f<T>(dv[i][j]);
      }
    }
  }
}

}  // namespace tpujob_flash_any

// Host side: the launch and the C entry point.

using namespace tpujob_flash_any;

template <class T, int DP>
static int launch_dkv_any(const Args& a, int B, void* stream) {
  using G = Geom<DP>;
  const int smem = ((2 * G::BR + 2 * G::BC) * G::LD + 2 * G::BR * G::LDS +
                    2 * G::BC) * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_any_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sk + G::BR - 1) / G::BR, B * a.H);
  flash_dkv_any_kernel<T, DP>
      <<<grid, kAnyThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <class T>
static int dispatch_dkv_any(const Args& a, int B, void* stream) {
  switch (padded_dim(a.d)) {
    case 32: return launch_dkv_any<T, 32>(a, B, stream);
    case 64: return launch_dkv_any<T, 64>(a, B, stream);
    case 128: return launch_dkv_any<T, 128>(a, B, stream);
    case 256: return launch_dkv_any<T, 256>(a, B, stream);
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
  if (Sq <= 0 || Sk <= 0 || B <= 0 || H <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a = {q, k, v, dout, (const float*)lse, (const float*)delta, dk, dv,
            nullptr, H, D, Sq, Sk, scale, causal, window};
  return is_bf16 ? dispatch_dkv_any<bf16>(a, B, stream)
                 : dispatch_dkv_any<float>(a, B, stream);
}
