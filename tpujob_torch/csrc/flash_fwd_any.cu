// Flash-attention forward for any head dim 1-256, fp32 or bf16 in, fp32
// arithmetic on the CUDA cores (sm_90a).
//
// Replaces the Pallas kernel tpujob/workloads/flash.py:_flash_kernel (with
// _flash_forward, _block_scores and _causal_live) for every input the
// tuned flash_fwd.cu does not take: O = softmax(scale Q K^T + mask) V with
// the causal / sliding-window mask, and the per-row logsumexp
// lse = m + log l the backward kernels recompute P from, o in the input's
// dtype, lse fp32.
//
// Bound on an H100 SXM at the GPT-2-medium shape in fp32 (b=8, s=1024,
// h=16, d=64, causal): it must read q, k, v and write o, 4 x 33.6 MB =
// 134 MB, 40 us at 3.35 TB/s; its causal FLOPs are 17.2 G, 35 us at tf32's
// 495 TFLOP/s (what a tensor-core redesign could reach) but 257 us at the
// 67 TFLOP/s of fp32 FFMA, which is what this kernel runs on.  So this
// design is bound by operations.
//
// Design (simple first, flash_any.cuh): one block of 256 threads per
// (BR-row q-tile, batch*head), the longest causal q-tiles first; the TPU
// grid's sequential k axis is a loop inside the block over the live k-tiles
// only (flash_common.cuh's k_range: dead tiles skipped).  Q is staged once,
// K and V a tile at a time, as fp32 in shared memory.  Each thread computes
// an RT x CT block of S = scale Q K^T with FFMA, masks it, and runs the
// online softmax for its rows in registers (each row's running max m, sum l
// and its DT output columns), the row reductions by shuffles within the
// half-warp that holds the row; P goes through shared memory to the same
// warp for O += P V.  The reference's -1e30 mask value is kept; a masked
// score's P is 0.
#include "flash_any.cuh"

namespace tpujob_flash_any {

template <class T, int DP>
__global__ void __launch_bounds__(kAnyThreads, 1)
    flash_fwd_any_kernel(Args a) {
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

// Host side: the launch and the C entry point.

using namespace tpujob_flash_any;

template <class T, int DP>
static int launch_fwd_any(const Args& a, int B, void* stream) {
  using G = Geom<DP>;
  const int smem = ((G::BR + 2 * G::BC) * G::LD + G::BR * G::LDS) *
                   (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_any_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + G::BR - 1) / G::BR, B * a.H);
  flash_fwd_any_kernel<T, DP>
      <<<grid, kAnyThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <class T>
static int dispatch_fwd_any(const Args& a, int B, void* stream) {
  switch (padded_dim(a.d)) {
    case 32: return launch_fwd_any<T, 32>(a, B, stream);
    case 64: return launch_fwd_any<T, 64>(a, B, stream);
    case 128: return launch_fwd_any<T, 128>(a, B, stream);
    case 256: return launch_fwd_any<T, 256>(a, B, stream);
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
