// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_dq.cu,
// flash_dkv.cu, all wgmma kernels on hopper.cuh): the layout, the head dims
// they are built for, the quad reductions of the accumulator layout and the
// loop bounds that skip dead tiles.
//
// Layout: q, k, v, o, dO, dQ, dK, dV are contiguous [B, S, H, D] bf16 (the
// JAX package's [batch, seq, heads, head_dim]); the kernels index it
// directly, so no [B*H, S, D] transpose is ever materialised.  lse and
// delta are flat fp32 [B, H, S].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tpujob_flash {

// Each kernel is a template on the head dim D, instantiated for 32 and 64
// (hopper.cuh's Rows<D>); each C entry point takes D and launches that
// instantiation, or returns cudaErrorInvalidValue for any other D.

constexpr float kNegInf = -1e30f;  // finite, as in the reference: a fully
                                   // masked tile must not NaN the running max

typedef __nv_bfloat16 bf16;

// max / sum over the four threads of a quad, which hold one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The k-tiles (of KT rows) that the QT query rows from q0 must visit (the
// reference's _causal_live as loop bounds): under causal stop at the tile
// holding key q0+QT-1, under a window start at the tile holding key
// q0-window+1.
template <int QT, int KT>
__device__ __forceinline__ void k_range(int q0, int sk, int causal, int window,
                                        int* begin, int* end) {
  int b = 0, e = (sk + KT - 1) / KT;
  if (causal) {
    e = min(e, (q0 + QT - 1) / KT + 1);
    if (window > 0 && q0 - window + 1 > 0) b = (q0 - window + 1) / KT;
  }
  *begin = b;
  *end = e;
}

// The q-tiles (of QT rows) that the KT keys from k0 must visit (the
// transpose of k_range).
template <int KT, int QT>
__device__ __forceinline__ void q_range(int k0, int sq, int causal, int window,
                                        int* begin, int* end) {
  int b = 0, e = (sq + QT - 1) / QT;
  if (causal) {
    b = k0 / QT;
    if (window > 0) e = min(e, (k0 + KT - 1 + window - 1) / QT + 1);
  }
  *begin = b;
  *end = e;
}

}  // namespace tpujob_flash
