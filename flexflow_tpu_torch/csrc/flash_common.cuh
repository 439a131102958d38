// Device helpers shared by the flash-attention kernels for Hopper
// (flash_attention_fwd.cu, flash_attention_bwd.cu): the dropout keep hash
// and its per-fragment bitmask, the bf16 pair store, the 1-D grid of every
// kernel, and the building blocks of the wide FMA kernels (either type
// above d = 512), which stage either type as f32.
//
// The FMA kernels work on 64-row tiles with four warps, each warp owning
// 16 rows of the tile's "A" side (query rows in dq, key rows in dk/dv).
// Tiles are staged in shared memory with a row stride of 64 + 4 floats,
// so consecutive rows start in different banks, and every product runs
// as FMA loops in f32. The tensor-core kernels (bf16, and f32 up to d =
// 512 in split-precision TF32) are built from hopper_common.cuh
// instead.

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
// forward and both backward kernels call it with the same (seed, global
// b*h, absolute q position, absolute k position) tuple (DropKey below), so
// they rebuild one keep mask whatever their tiling or sharding.
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

// A launch's dropout key: the seed, and where the launch's b*h rows sit in
// the global batch the hash is taken over. A rank of a sharded run holds
// the rows b0.. of the batch and the heads h0.. of h_total (h_local of them
// here); its launch index bh = b * h_local + h hashes as the global
// (b0 + b) * h_total + h0 + h = bh + b * (h_total - h_local) + b0 *
// h_total + h0, with b = bh / h_local as umulhi(2 bh, magic), magic =
// floor(2**31 / h_local) + 1 (exact while bh * h_local < 2**31, which the
// host checks). No division and a few instructions from bh: the kernels
// recompute it where they hash rather than hold it in a register. The
// whole batch (extra = base = 0) maps every index to itself.
struct DropKey {
  uint32_t seed;
  uint32_t magic;  // floor(2**31 / h_local) + 1
  uint32_t extra;  // h_total - h_local
  uint32_t base;   // b0 * h_total + h0

  __device__ __forceinline__ uint32_t global_bh(int bh) const {
    const uint32_t u = (uint32_t)bh;
    return u + __umulhi(u << 1, magic) * extra + base;
  }
};

__device__ __forceinline__ uint32_t position_hash(const DropKey& key, int bh,
                                                  uint32_t q_pos,
                                                  uint32_t k_pos) {
  return position_hash(key.seed, key.global_bh(bh), q_pos, k_pos);
}

// The dropout keep mask of this thread's 4 * NB scores of a tile of 8 * NB
// keys [n0, n0 + 8 * NB) (64 by default) in the query-row frame of a
// wgmma accumulator (rows qpos[0] and qpos[1], the thread's columns 8 *
// nt + 2 * tig + {0, 1}), one bit each: bit 4 * nt + c for column block
// nt, fragment slot c.
template <int NB = 8>
__device__ __forceinline__ uint32_t keep_bits(int n0, const int (&qpos)[2],
                                              int tig, int bh,
                                              const DropKey& seed,
                                              uint32_t threshold) {
  static_assert(NB <= 8, "32 bits");
  uint32_t bits = 0;
#pragma unroll
  for (int nt = 0; nt < NB; ++nt) {
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

// The same mask in the key-row frame of the dk/dv kernels (s^T = K . Q^T):
// rows are the keys kpos[0] and kpos[1], columns the queries [m0, m0 + 8 *
// NB); bit 4 * nt + c as above.
template <int NB>
__device__ __forceinline__ uint32_t keep_bits_t(int m0, const int (&kpos)[2],
                                                int tig, int bh,
                                                const DropKey& seed,
                                                uint32_t threshold) {
  static_assert(NB <= 8, "32 bits");
  uint32_t bits = 0;
#pragma unroll
  for (int nt = 0; nt < NB; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t qpos = m0 + nt * 8 + tig * 2 + (c & 1);
      bits |= (uint32_t)(position_hash(seed, bh, qpos, kpos[c >> 1]) >=
                         threshold)
              << (4 * nt + c);
    }
  }
  return bits;
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

// ---------------------------------------------------------------------------
// the grid: one dimension, so b*h has no 65535 limit
// ---------------------------------------------------------------------------
// Every flash kernel runs on a grid whose x dimension carries bh (gridDim.x
// takes up to 2^31 - 1; gridDim.y, where bh sat before, only 65535). In
// the natural order, a 1-D grid of n_blocks * bh CTAs, the row blocks of
// one head are adjacent, so consecutive CTAs share that head's K/V (or
// Q/dO) in L2. A causal forward or dq whose heads' K and V all fit in L2
// together launches its heaviest row blocks, the last query blocks, which
// cross the most K/V tiles, first across all heads (FA2's order):
// launch_grid then makes the grid 2-D, bh on x and the row block, last
// first, on y, so the launch ends on the lightest blocks of all heads.
// Otherwise it keeps the natural 1-D order and its L2 sharing (LLaMA-7B's
// prefill, 64 MiB of K/V, ran 1-2% slower with its row blocks reversed
// within each head: PERF.md sec. 6). The host decides; a kernel reads the
// order from gridDim.y. dk/dv's first key blocks are its heaviest, so it
// keeps the natural order.
constexpr long long L2_BYTES = 50LL << 20;  // the H100's L2 cache

struct GridCell {
  int block;  // row block (query rows; key rows for dk/dv)
  int bh;     // batch * head
  int chunk;  // 64-column chunk of the output head dim (the wide kernels)
};

__device__ __forceinline__ GridCell grid_cell(int n_blocks,
                                              int n_chunks = 1) {
  if (gridDim.y > 1)  // launch_grid's order across heads
    return {n_blocks - 1 - (int)blockIdx.y, (int)blockIdx.x / n_chunks,
            (int)blockIdx.x % n_chunks};
  const int idx = blockIdx.x;
  const int rest = idx / n_chunks;
  const int bh = rest / n_blocks;
  return {rest - bh * n_blocks, bh, idx % n_chunks};
}

// The grid of n_blocks row blocks by bh heads (by n_chunks column chunks),
// in the order above; head_kv_bytes is one head's K and V. False when it
// exceeds gridDim.x's 2^31 - 1.
inline bool launch_grid(long long n_blocks, long long bh, long long n_chunks,
                        bool causal, long long head_kv_bytes, dim3* grid) {
  const long long n = n_blocks * bh * n_chunks;
  if (n <= 0 || n > 2147483647LL) return false;
  if (causal && n_blocks > 1 && n_blocks <= 65535 &&
      bh * head_kv_bytes <= L2_BYTES)
    *grid = dim3((unsigned)(bh * n_chunks), (unsigned)n_blocks);
  else
    *grid = dim3((unsigned)n);
  return true;
}

// ---------------------------------------------------------------------------
// the wide kernels (head dims above 128, f32 and bf16)
// ---------------------------------------------------------------------------
// A 64-column chunk of 4 consecutive elements, widened to f32: rows of
// either type are staged as f32 in shared memory and run the FMA loops.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // 8-byte aligned
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// x rounded to T and back: where the reference casts p or ds to the input
// type before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Stage rows [row0, row0 + 64) and columns [col0, col0 + 64) of a
// (n_rows, ld) matrix of T into shared memory as f32 with row stride 68
// (the layout scores<64> and accumulate_pv<64> read); rows past n_rows
// are zero.
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* src, int ld,
                                           int col0, int row0, int n_rows) {
  constexpr int CHUNKS = TILE / 4;
  constexpr int LD = TILE + 4;
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += NUM_THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const int gr = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < n_rows) val = load4(src + (size_t)gr * ld + col0 + c * 4);
    *reinterpret_cast<float4*>(dst + r * LD + c * 4) = val;
  }
}

// s = A . B^T over the whole head dim D (a multiple of 64, a runtime
// value) for this warp's 16 rows of the 64 rows of A from a_row0 and the
// 64 rows of B from b_row0 (both (rows, D) matrices of T), staged 64
// columns at a time through sA and sB. Starts with a barrier, so a caller
// may reuse any staging buffer that was read before it.
template <typename T>
__device__ __forceinline__ void scores_wide(float (&s)[N_FRAGS][4],
                                            float* sA, float* sB,
                                            const T* a, int a_row0,
                                            int a_rows, const T* b,
                                            int b_row0, int b_rows, int D,
                                            int warp, int g, int tig) {
#pragma unroll
  for (int nt = 0; nt < N_FRAGS; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  for (int c0 = 0; c0 < D; c0 += TILE) {
    __syncthreads();  // every warp is done with the previous chunk
    load_chunk(sA, a, D, c0, a_row0, a_rows);
    load_chunk(sB, b, D, c0, b_row0, b_rows);
    __syncthreads();
    scores<TILE>(s, sA, sB, warp, g, tig);
  }
}

// Write this warp's 16 rows of a 64-column C-fragment accumulator (rows
// row0 + warp * 16 + {g, g + 8}) into columns [col0, col0 + 64) of a
// (n_rows, ld) matrix of T, skipping rows past n_rows.
template <typename T>
__device__ __forceinline__ void store_chunk(T* dst,
                                            const float (&acc)[N_FRAGS][4],
                                            int ld, int col0, int row0,
                                            int n_rows, int warp, int g,
                                            int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= n_rows) continue;
    T* out = dst + (size_t)row * ld + col0;
#pragma unroll
    for (int dt = 0; dt < N_FRAGS; ++dt)
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
