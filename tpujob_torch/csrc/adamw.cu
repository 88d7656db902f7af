// AdamW's update for Hopper (sm_90a): the whole step in one pass over each
// tensor, fp32 throughout.
//
// Stands for optax.adamw in tpujob/workloads/train_lib.py:adamw (the JAX
// package's update, which XLA fuses into one loop over each leaf); it
// replaces no Pallas kernel.  The port's optimizer (workloads/optim.py,
// AdamW) launches it where torch's capturable foreach AdamW ran some ten
// passes a tensor and made a full-size temporary (the square roots).
//
// Per element, torch's capturable AdamW in its order (t is the tensor's own
// step count, already advanced; lr the group's 0-d tensor on the card):
//   p *= 1 - lr*wd
//   m  = m + (1-b1)*(g - m)                      (lerp)
//   v  = b2*v + (1-b2)*(g*g)
//   p += m / ((sqrt(v) / sqrt(1 - b2^t) + eps) / (lr / (b1^t - 1)))
// Where torch ends a pass (and rounds to fp32 in memory) the kernel rounds
// too (__f*_rn: no fused multiply-add across them); inside one of torch's
// passes (lerp, addcmul) it takes the fused form torch's kernels compile to.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  Each element reads p, g, m, v
// and writes p, m, v: 28 bytes, at a few dozen operations an element.
// GPT-2-medium's 354,873,344 parameters are 9.94 GB, 2.97 ms; BERT-large's
// 334,161,920 are 9.36 GB, 2.79 ms.
//
// Design: a launch updates up to kMaxTensors tensors, cut into chunks of
// kChunk elements, one block a chunk; the entry point splits a longer list
// into launches of kMaxTensors and works out each tensor's first chunk from
// its length.  The table of tensors (pointers, lengths, first chunks) is the
// kernel's argument (__grid_constant__, read through the constant cache:
// Hopper takes up to 32 KB of arguments), so a captured graph holds it and
// nothing is copied to the card at a step.  A block finds its tensor by a
// binary search over the first chunks, then streams its chunk with 16-byte
// loads and stores where all four of the tensor's arrays are 16-byte
// aligned, the last chunk's ragged end element by element; an unaligned
// tensor (a view at an odd offset) goes element by element throughout.
// Nothing is allocated and no intermediate reaches device memory.  The name
// avoids every substring by which a trace's kernels are sorted into matrix
// products, convolutions and flash kernels.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8192;       // elements a block: 8 float4 a thread
constexpr int kMaxTensors = 512;   // tensors a launch: a 26 KB table

struct Table {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  const float* step[kMaxTensors];
  long long n[kMaxTensors];
  int first[kMaxTensors + 1];  // first chunk of each tensor, then the total
  int count;
};

struct Hyper {
  const float* lr;
  float wd, b1, b2, w1, w2, eps;  // w1 = 1 - b1, w2 = 1 - b2, from doubles
};

struct Coef {
  float decay, w1, b2, w2, bc2_sqrt, eps, step_size;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Coef& c) {
  p = __fmul_rn(p, c.decay);
  m = fmaf(c.w1, __fsub_rn(g, m), m);
  v = fmaf(c.w2, __fmul_rn(g, g), __fmul_rn(v, c.b2));
  float d = __fdiv_rn(__fsqrt_rn(v), c.bc2_sqrt);
  d = __fdiv_rn(__fadd_rn(d, c.eps), c.step_size);
  p = __fadd_rn(p, __fdiv_rn(m, d));
}

__global__ void __launch_bounds__(kThreads)
tpujob_adamw_kernel(const __grid_constant__ Table t, const Hyper h) {
  const int c = blockIdx.x;
  int lo = 0, hi = t.count - 1;  // the last tensor whose first chunk <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= c) lo = mid; else hi = mid - 1;
  }
  const long long begin = (long long)(c - t.first[lo]) * kChunk;
  const long long end = min(t.n[lo], begin + kChunk);

  // the step's scalars, each rounded where torch's 0-d passes round
  const float lr = *h.lr, step = *t.step[lo];
  Coef k;
  k.decay = __fsub_rn(1.0f, __fmul_rn(lr, h.wd));
  k.w1 = h.w1;
  k.b2 = h.b2;
  k.w2 = h.w2;
  k.eps = h.eps;
  k.bc2_sqrt = __fsqrt_rn(-__fsub_rn(powf(h.b2, step), 1.0f));
  k.step_size = __frcp_rn(__fdiv_rn(__fsub_rn(powf(h.b1, step), 1.0f), lr));

  float* __restrict__ p = t.p[lo];
  const float* __restrict__ g = t.g[lo];
  float* __restrict__ m = t.m[lo];
  float* __restrict__ v = t.v[lo];
  long long j = begin + threadIdx.x;
  if (((uintptr_t)p | (uintptr_t)g | (uintptr_t)m | (uintptr_t)v) % 16 == 0) {
    const long long vend = begin + ((end - begin) & ~3LL);
#pragma unroll 4
    for (long long i = begin + 4 * threadIdx.x; i < vend; i += 4 * kThreads) {
      float4 pp = *reinterpret_cast<const float4*>(p + i);
      const float4 gg = __ldg(reinterpret_cast<const float4*>(g + i));
      float4 mm = *reinterpret_cast<const float4*>(m + i);
      float4 vv = *reinterpret_cast<const float4*>(v + i);
      update(pp.x, gg.x, mm.x, vv.x, k);
      update(pp.y, gg.y, mm.y, vv.y, k);
      update(pp.z, gg.z, mm.z, vv.z, k);
      update(pp.w, gg.w, mm.w, vv.w, k);
      *reinterpret_cast<float4*>(p + i) = pp;
      *reinterpret_cast<float4*>(m + i) = mm;
      *reinterpret_cast<float4*>(v + i) = vv;
    }
    j = vend + threadIdx.x;
  }
  for (; j < end; j += kThreads) {
    float pp = p[j], mm = m[j], vv = v[j];
    update(pp, g[j], mm, vv, k);
    p[j] = pp;
    m[j] = mm;
    v[j] = vv;
  }
}

}  // namespace

// Update `count` tensors on `stream`, kMaxTensors a launch.  `ptrs`: int64
// [count][5], each tensor's param, grad, exp_avg, exp_avg_sq and 0-d fp32
// step count (all fp32 on the card, the four arrays of `sizes[i]` elements
// each, an empty tensor taking no block); `lr`: the group's 0-d fp32 lr on
// the card.  Each table is copied into its launch's arguments before
// return.
extern "C" int tpujob_adamw(const void* ptrs, const void* sizes, int count,
                            const void* lr, float wd, float b1, float b2,
                            float w1, float w2, float eps, void* stream) {
  if (count < 0) return (int)cudaErrorInvalidValue;
  const long long* ptr = static_cast<const long long*>(ptrs);
  const long long* n = static_cast<const long long*>(sizes);
  const Hyper h{static_cast<const float*>(lr), wd, b1, b2, w1, w2, eps};
  for (int lo = 0; lo < count; lo += kMaxTensors) {
    Table t;
    t.count = count - lo < kMaxTensors ? count - lo : kMaxTensors;
    long long chunks = 0;
    for (int i = 0; i < t.count; ++i) {
      const long long* q = ptr + 5 * (lo + i);
      t.p[i] = reinterpret_cast<float*>(q[0]);
      t.g[i] = reinterpret_cast<const float*>(q[1]);
      t.m[i] = reinterpret_cast<float*>(q[2]);
      t.v[i] = reinterpret_cast<float*>(q[3]);
      t.step[i] = reinterpret_cast<const float*>(q[4]);
      t.n[i] = n[lo + i];
      if (t.n[i] < 0) return (int)cudaErrorInvalidValue;
      t.first[i] = (int)chunks;
      chunks += (t.n[i] + kChunk - 1) / kChunk;
      if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    }
    t.first[t.count] = (int)chunks;
    if (chunks == 0) continue;
    tpujob_adamw_kernel<<<(unsigned)chunks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(t, h);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
