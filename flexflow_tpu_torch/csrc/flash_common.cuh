// Device helpers shared by the flash-attention kernels for Hopper
// (flash_attention_fwd.cu, flash_attention_bwd.cu).
//
// Every kernel works on 64-row tiles with four warps, each warp owning 16
// rows of the tile's "A" side (query rows in the forward and dq kernels,
// key rows in the dk/dv kernel). Tiles are staged in shared memory with a
// row stride of D + 16 bytes, so consecutive rows start in different
// banks. For bf16 the products run on the tensor cores through
// mma.sync.m16n8k16 with f32 accumulation; for f32 they run as FMA loops,
// because the tensor cores would round f32 operands to TF32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ff_flash {

constexpr int TILE = 64;                // rows of every tile
constexpr int NUM_WARPS = TILE / 16;    // each warp owns 16 rows
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int N_FRAGS = TILE / 8;       // 16x8 score fragments per warp
constexpr int P_LD = TILE + 4;          // f32 staging row stride (f32 path)
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

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(unsigned short lo,
                                             unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// Stage rows [row0, row0 + 64) of a (rows, D) matrix into shared memory
// with row stride D + VEC, in 16-byte chunks; rows past n_rows are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int n_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  constexpr int LD = D + VEC;
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += NUM_THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * D + c * VEC);
    *reinterpret_cast<uint4*>(dst + r * LD + c * VEC) = val;
  }
}

// s[nt][c] += a_row . b_row for this warp's 16 rows of sA and the 64 rows
// of sB (s = A . B^T), in the mma C-fragment layout: c = 0,1 -> row g,
// cols nt*8 + 2*tig + {0,1}; c = 2,3 -> row g + 8.
template <int D>
__device__ __forceinline__ void scores(float (&s)[N_FRAGS][4],
                                       const __nv_bfloat16* sA,
                                       const __nv_bfloat16* sB, int warp,
                                       int g, int tig) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const __nv_bfloat16* qa = sA + (warp * 16 + g) * LD + kc * 16 + tig * 2;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qa + 8 * LD);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qa + 8);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + 8);
#pragma unroll
    for (int nt = 0; nt < N_FRAGS; ++nt) {
      const __nv_bfloat16* kb = sB + (nt * 8 + g) * LD + kc * 16 + tig * 2;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kb);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kb + 8);
      mma_bf16_16816(s[nt], a0, a1, a2, a3, b0, b1);
    }
  }
}

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
// fragment of output columns dt*8... For bf16, P is rounded to bf16 here,
// where the reference casts its left operand to the right one's dtype.
template <int D>
__device__ __forceinline__ void accumulate_pv(float (&acc)[D / 8][4],
                                              const float (&p)[N_FRAGS][4],
                                              const __nv_bfloat16* sV,
                                              float* /*sP*/, int /*warp*/,
                                              int g, int tig) {
  constexpr int LD = D + 8;
  const unsigned short* v16 = reinterpret_cast<const unsigned short*>(sV);
#pragma unroll
  for (int kc = 0; kc < TILE / 16; ++kc) {
    // the C layout of two adjacent 16x8 score fragments is the A layout
    // of one 16x16 operand
    const uint32_t a0 = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
    const uint32_t a1 = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
    const uint32_t a2 = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    const uint32_t a3 = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const unsigned short* vb = v16 + (kc * 16 + tig * 2) * LD + dt * 8 + g;
      const uint32_t b0 = pack_raw(vb[0], vb[LD]);
      const uint32_t b1 = pack_raw(vb[8 * LD], vb[9 * LD]);
      mma_bf16_16816(acc[dt], a0, a1, a2, a3, b0, b1);
    }
  }
}

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
// * 16 + {g, g + 8}) to a (n_rows, D) matrix in T, skipping rows past
// n_rows.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[D / 8][4],
                                           int row0, int n_rows, int warp,
                                           int g, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= n_rows) continue;
    T* out = dst + (size_t)row * D;
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
