// Shared pieces of the flash-attention kernels: the mma.sync pieces of the
// dQ kernel (flash_bwd.cu), and the layout, masks and loop bounds that the
// wgmma kernels (flash_fwd.cu, flash_dkv.cu, with hopper.cuh) use too.
//
// Layout: q, k, v, o, dO, dQ, dK, dV are contiguous [B, S, H, D] bf16 (the
// JAX package's [batch, seq, heads, head_dim]); the kernels index it
// directly, so no [B*H, S, D] transpose is ever materialised.  lse and
// delta are flat fp32 [B, H, S].
//
// The dQ kernel's tiles are 64 rows by D = 64 columns.  A block has four
// warps; in every product a warp owns 16 rows of the block's tile and runs
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) on fragments it reads from
// shared memory.  Fragment layout (PTX ISA, mma.m16n8k16, .bf16), with
// g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): a0 (g,   2t..2t+1)   a1 (g+8, 2t..2t+1)
//                         a2 (g,   2t+8..+9)   a3 (g+8, 2t+8..+9)
//   B (16x8, k x n):      b0 (k = 2t..2t+1, n = g)  b1 (k = 2t+8..+9, n = g)
//   C (16x8, fp32):       c0,c1 (g, 2t..2t+1)  c2,c3 (g+8, 2t..2t+1)
// The C fragments of two neighbouring n-tiles are exactly the A fragment
// of one k16 step, which is how P (or dS) feeds the next product without
// leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tpujob_flash {

using tpujob_hopper::pack_bf16x2;

constexpr int kD = 64;           // head dim this build supports
constexpr int kTile = 64;        // rows of a q-tile and of a k-tile
constexpr int kPitch = kD + 8;   // smem row pitch (bf16): conflict-free fragment reads
constexpr int kThreads = 128;    // four warps, 16 tile rows each
constexpr float kNegInf = -1e30f;  // finite, as in the reference: a fully
                                   // masked tile must not NaN the running max

typedef __nv_bfloat16 bf16;
typedef bf16 Tile[kTile][kPitch];

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two adjacent bf16 of one smem row (column c even) as one register
__device__ __forceinline__ uint32_t ld_pair(const Tile& s, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(&s[r][c]);
}

// two bf16 of one column in rows r and r+1, packed (for B operands that
// run down a row-major tile)
__device__ __forceinline__ uint32_t ld_col_pair(const Tile& s, int r, int c) {
  const uint16_t lo = *reinterpret_cast<const uint16_t*>(&s[r][c]);
  const uint16_t hi = *reinterpret_cast<const uint16_t*>(&s[r + 1][c]);
  return uint32_t(lo) | (uint32_t(hi) << 16);
}

// A fragments (4 k16 steps over D) of the warp's 16 rows of a tile
__device__ __forceinline__ void load_a_frags(const Tile& s, int row0, int g,
                                             int t, uint32_t f[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    f[kk][0] = ld_pair(s, row0 + g, c);
    f[kk][1] = ld_pair(s, row0 + g + 8, c);
    f[kk][2] = ld_pair(s, row0 + g, c + 8);
    f[kk][3] = ld_pair(s, row0 + g + 8, c + 8);
  }
}

// The C fragments of n-tiles 2kk and 2kk+1 (fp32) as the A fragment of
// k16 step kk (bf16).
__device__ __forceinline__ void c_to_a(const float c[8][4], int kk,
                                       uint32_t a[4]) {
  a[0] = pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// acc[16 x 64] += A[16 x 64] . T[64 rows x 64]^T, i.e. the n index runs
// over the ROWS of T (S = Q K^T, dP = dO V^T): B(k, n) = T[n][k].
__device__ __forceinline__ void mma_abt(float acc[8][4], const uint32_t a[4][4],
                                        const Tile& s, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int n = nt * 8 + g, c = kk * 16 + 2 * t;
      mma16816(acc[nt], a[kk], ld_pair(s, n, c), ld_pair(s, n, c + 8));
    }
  }
}

// acc[16 x 64] += C2A(p)[16 x 64] . T[64 rows x 64], i.e. the k index runs
// over the rows of T (O = P V, dQ = dS K, dV = P^T dO, dK = dS^T Q):
// B(k, n) = T[k][n].
__device__ __forceinline__ void mma_pt(float acc[8][4], const float p[8][4],
                                       const Tile& s, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    c_to_a(p, kk, a);
    const int r = kk * 16 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = nt * 8 + g;
      mma16816(acc[nt], a, ld_col_pair(s, r, n), ld_col_pair(s, r + 8, n));
    }
  }
}

// rows row0 .. row0+63 of one (batch, head) into smem; rows at or past
// `rows` are zero.  `base` points at row 0 of this (batch, head); rows are
// `stride` elements apart (H * D in the [B, S, H, D] layout).
__device__ __forceinline__ void load_tile(Tile& dst, const bf16* base,
                                          int row0, int rows, long stride) {
  for (int i = threadIdx.x; i < kTile * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(base + (long)(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

// the warp's 16 x 64 fp32 accumulator, cast to bf16, into rows of `base`
// (row indices local to the tile start row0; rows at or past `rows` skipped)
__device__ __forceinline__ void store_acc(bf16* base, long stride,
                                          const float acc[8][4], int row0,
                                          int rows, int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= rows) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<uint32_t*>(base + (long)r * stride + nt * 8 + 2 * t) =
          pack_bf16x2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

// visibility of (query, key) in absolute positions: both in range, and
// under `causal` key <= query and (with a window) query - key < window
__device__ __forceinline__ bool visible(int q, int k, int sq, int sk,
                                        int causal, int window) {
  bool vis = q < sq && k < sk;
  if (causal) {
    vis = vis && q >= k;
    if (window > 0) vis = vis && (q - k < window);
  }
  return vis;
}

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
