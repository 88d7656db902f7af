// Shared pieces of the general flash-attention kernels (flash_fwd_any.cu,
// flash_dq_any.cu, flash_dkv_any.cu): fp32 or bf16 inputs at any head dim
// from 1 to 256, where the tuned kernels (bf16 at head dim 32 and 64) do
// not apply.  Their arguments, masks and head-dim buckets, and the FFMA
// body (fp32 arithmetic on the CUDA cores) below, which dQ alone keeps for
// fp32 at padded head dim 256 (there its tensor-core tiles and their small
// parts do not fit shared memory; the forward and dK/dV run kernels of
// their own on the tensor cores there).  Every other input runs on the
// tensor cores: wgmma takes no fp32 input and one tf32 pass keeps about
// three digits, so each fp32 operand is split into two tf32 parts
// (3xTF32), which keeps fp32's accuracy (flash_tc.cuh for dQ and dK/dV,
// flash_fwd_tc.cuh for the forward).
//
// Layout as flash_common.cuh: q, k, v, o, dO, dQ, dK, dV contiguous
// [B, S, H, d] in the input's dtype; lse and delta flat fp32 [B, H, S].
//
// Tiling of the FFMA body (dQ's): each block owns BR rows of one (batch, head) and walks the other
// sequence in steps of BC; 256 threads as a 16 x 16 grid, thread (ty, tx)
// holding rows ty*RT .. ty*RT+RT-1 of the block and, of a step's scores,
// columns tx + 16 j (j < CT); of the head dim, columns tx + 16 j (j < DT).
// A row's scores live in the 16 lanes of one half-warp, so the online
// softmax reduces with four xor-shuffles and the probabilities it writes
// to shared memory are read back by the same warp only (__syncwarp).
// Tiles of K/V (forward, dQ) or Q/dO (dK/dV) are staged in shared memory
// as fp32 with a row stride of DP + 1 floats (odd: the 16 rows a warp
// reads at one head-dim column fall in 16 banks).  The head dim is
// padded to DP (32, 64, 128 or 256, one template instantiation each) with
// zeros in shared memory; the score loop runs over the d real columns.
#pragma once

#include "flash_common.cuh"

namespace tpujob_flash_any {

using tpujob_flash::bf16;
using tpujob_flash::kNegInf;

// 256 threads a block; each kernel's __launch_bounds__(kAnyThreads, 1)
// names one block an SM as the floor, so ptxas gives a thread the
// registers it needs (with the thread count alone it held the bf16
// head-dim-32 forward to 64 registers and spilled)
constexpr int kAnyThreads = 256;

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

// The tile geometry at padded head dim DP.  At DP >= 128 the tiles are 32
// rows so that a block's shared memory (at most 165 KB at DP = 128 with 64,
// 75 KB with 32) leaves room for three blocks an SM, and at DP = 256 in
// fp32 the dK/dV kernel's 140 KB fits the 227 KB a block may use.
template <int DP>
struct Geom {
  static constexpr int BR = DP >= 128 ? 32 : 64;  // rows a block owns
  static constexpr int BC = BR;                   // columns a step
  static constexpr int RT = BR / 16;              // rows a thread
  static constexpr int CT = BC / 16;              // score columns a thread
  static constexpr int DT = DP / 16;              // head-dim columns a thread
  static constexpr int LD = DP + 1;               // staged row stride, floats
  static constexpr int LDS = BC + 1;              // score tile row stride
};

// Rows row0 .. row0+ROWS-1 of x [B, S, H, d] at (b, h) into dst as fp32
// (row stride DP + 1), zero past S and past d.
template <class T, int ROWS, int DP>
__device__ __forceinline__ void load_rows(float* dst, const T* x, int b,
                                          int h, int H, int S, int d,
                                          int row0) {
  for (int i = threadIdx.x; i < ROWS * DP; i += kAnyThreads) {
    const int r = i / DP, c = i % DP, s = row0 + r;
    float val = 0.f;
    if (s < S && c < d) val = to_f(x[((long)(b * S + s) * H + h) * d + c]);
    dst[r * (DP + 1) + c] = val;
  }
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

// max / sum over the 16 lanes of a half-warp (one row's score columns)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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
