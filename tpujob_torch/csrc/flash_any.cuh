// Shared pieces of the general flash-attention kernels (flash_fwd_any.cu,
// flash_dq_any.cu, flash_dkv_any.cu): fp32 or bf16 inputs at any head dim
// from 1 to 256, where the tuned kernels (bf16 at head dim 32 and 64) do
// not apply.  Their arguments, masks, conversions and head-dim buckets;
// the kernels themselves run on the tensor cores (flash_tc.cuh for dQ and
// dK/dV, flash_fwd_tc.cuh for the forward).  wgmma takes no fp32 input and
// one tf32 pass keeps about three digits, so each fp32 operand is split
// into two tf32 parts (3xTF32), which keeps fp32's accuracy.
//
// Layout as flash_common.cuh: q, k, v, o, dO, dQ, dK, dV contiguous
// [B, S, H, d] in the input's dtype; lse and delta flat fp32 [B, H, S].
// The head dim is padded to a bucket (32, 64, 128 or 256: padded_dim), one
// template instantiation each, with zeros past d.
#pragma once

#include "flash_common.cuh"

namespace tpujob_flash_any {

using tpujob_flash::bf16;
using tpujob_flash::kNegInf;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Whether query qi sees key kj: both inside their sequences, and under
// the causal mask kj <= qi (and qi - kj < window with a window).
__device__ __forceinline__ bool sees(int qi, int kj, int Sq, int Sk,
                                     int causal, int window) {
  if (qi >= Sq || kj >= Sk) return false;
  if (!causal) return true;
  const int delta = qi - kj;
  return delta >= 0 && (window <= 0 || delta < window);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;   // backward only
  const float* lse;   // backward only
  const float* delta; // backward only
  void* out0;         // o, dq or dk
  void* out1;         // dv (dK/dV kernel)
  float* lse_out;     // forward only
  int H, d, Sq, Sk;
  float scale;
  int causal, window;
};

// The head-dim bucket of d: 32, 64, 128 or 256 (0 outside 1..256).
inline int padded_dim(int d) {
  if (d < 1 || d > 256) return 0;
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

}  // namespace tpujob_flash_any
