// Device helpers shared by the flash-attention kernels for Hopper
// (flash_attention_fwd.cu, flash_attention_bwd.cu): the dropout keep hash
// and its per-fragment bitmask, the bf16 pair store, and the building
// blocks of the exact f32 kernels.
//
// The f32 kernels work on 64-row tiles with four warps, each warp owning
// 16 rows of the tile's "A" side (query rows in the forward and dq
// kernels, key rows in the dk/dv kernel). Tiles are staged in shared
// memory with a row stride of D + 4 floats, so consecutive rows start in
// different banks, and every product runs as FMA loops: the tensor cores
// would round f32 operands to TF32. The bf16 kernels are built from
// hopper_common.cuh instead.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ff_flash {

constexpr int TILE = 64;                // rows of every f32 tile
constexpr int NUM_WARPS = TILE / 16;    // each warp owns 16 rows
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int N_FRAGS = TILE / 8;       // 16x8 score fragments per warp
constexpr int P_LD = TILE + 4;          // f32 staging row stride
constexpr float NEG_INF = -1e30f;

// The dropout keep hash, bit for bit the JAX package's _position_keep:
// odd-constant multiplies folded by xor (int32 wrap == uint32 wrap), then
// the murmur3 fmix32 finalizer with logical shifts. The first two
// constants are that code's int32 values -1640531527 and 840146601 as
// uint32 (its comments misname them 0x9E3779B1 and 0x3243F6A9). The
// forward and both backward kernels call it with the same (seed, b*h,
// absolute q position, absolute k position) tuple, so they rebuild one
// keep mask whatever their tiling.
__device__ __forceinline__ uint32_t position_hash(uint32_t seed, uint32_t bh,
                                                  uint32_t q_pos,
                                                  uint32_t k_pos) {
  uint32_t u = (seed * 0x9E3779B9u) ^ (bh * 0x32139EA9u) ^
               (q_pos * 0x85EBCA6Bu) ^ (k_pos * 0xC2B2AE35u);
  u ^= u >> 16;
  u *= 0x85EBCA6Bu;
  u ^= u >> 13;
  u *= 0xC2B2AE35u;
  u ^= u >> 16;
  return u;
}

// The dropout keep mask of this thread's 32 scores of a tile of 64 keys
// [n0, n0 + 64) in the query-row frame of a wgmma accumulator (rows
// qpos[0] and qpos[1], the thread's columns 8 * nt + 2 * tig + {0, 1}),
// one bit each: bit 4 * nt + c for column block nt, fragment slot c.
__device__ __forceinline__ uint32_t keep_bits(int n0, const int (&qpos)[2],
                                              int tig, int bh, uint32_t seed,
                                              uint32_t threshold) {
  uint32_t bits = 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t kpos = n0 + nt * 8 + tig * 2 + (c & 1);
      bits |= (uint32_t)(position_hash(seed, bh, qpos[c >> 1], kpos) >=
                         threshold)
              << (4 * nt + c);
    }
  }
  return bits;
}

// Stage rows [row0, row0 + 64) of a (rows, D) f32 matrix into shared
// memory with row stride D + 4, in 16-byte chunks; rows past n_rows are
// zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int n_rows) {
  constexpr int CHUNKS = D / 4;
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += NUM_THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const int gr = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < n_rows)
      val = *reinterpret_cast<const float4*>(src + (size_t)gr * D + c * 4);
    *reinterpret_cast<float4*>(dst + r * LD + c * 4) = val;
  }
}

// s[nt][c] += a_row . b_row for this warp's 16 rows of sA and the 64 rows
// of sB (s = A . B^T), in the mma C-fragment layout: c = 0,1 -> row g,
// cols nt*8 + 2*tig + {0,1}; c = 2,3 -> row g + 8.
template <int D>
__device__ __forceinline__ void scores(float (&s)[N_FRAGS][4],
                                       const float* sA, const float* sB,
                                       int warp, int g, int tig) {
  constexpr int LD = D + 4;
  const float* q0 = sA + (warp * 16 + g) * LD;
  const float* q1 = q0 + 8 * LD;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float x0 = q0[d], x1 = q1[d];
#pragma unroll
    for (int nt = 0; nt < N_FRAGS; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float kv = sB[(nt * 8 + tig * 2 + j) * LD + d];
        s[nt][j] = fmaf(x0, kv, s[nt][j]);
        s[nt][2 + j] = fmaf(x1, kv, s[nt][2 + j]);
      }
    }
  }
}

// acc += P . V for P (this warp's 16 rows x 64 columns) held in score
// fragments and V a (64, D) tile in shared memory; acc[dt] is the C
// fragment of output columns dt*8... P goes through this warp's rows of
// the staging buffer sP.
template <int D>
__device__ __forceinline__ void accumulate_pv(float (&acc)[D / 8][4],
                                              const float (&p)[N_FRAGS][4],
                                              const float* sV, float* sP,
                                              int warp, int g, int tig) {
  constexpr int LD = D + 4;
  float* p0 = sP + (warp * 16 + g) * P_LD;
  float* p1 = p0 + 8 * P_LD;
#pragma unroll
  for (int nt = 0; nt < N_FRAGS; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      p0[nt * 8 + tig * 2 + j] = p[nt][j];
      p1[nt * 8 + tig * 2 + j] = p[nt][2 + j];
    }
  }
  __syncwarp();
#pragma unroll 4
  for (int kk = 0; kk < TILE; ++kk) {
    const float x0 = p0[kk], x1 = p1[kk];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float vv = sV[kk * LD + dt * 8 + tig * 2 + j];
        acc[dt][j] = fmaf(x0, vv, acc[dt][j]);
        acc[dt][2 + j] = fmaf(x1, vv, acc[dt][2 + j]);
      }
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// Write this warp's 16 rows of a C-fragment accumulator (rows row0 + warp
// * 16 + {g, g + 8}) to a (n_rows, D) f32 matrix, skipping rows past
// n_rows.
template <int D>
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&acc)[D / 8][4],
                                           int row0, int n_rows, int warp,
                                           int g, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= n_rows) continue;
    float* out = dst + (size_t)row * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store2(out + dt * 8 + tig * 2, acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

// Set the kernel's dynamic shared memory limit once per device (a racing
// second set is harmless).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem,
                       unsigned long long* done_mask) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!((*done_mask >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    *done_mask |= 1ull << dev;
  }
  return cudaSuccess;
}

}  // namespace ff_flash
