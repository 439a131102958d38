// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel flexflow_tpu/kernels/flash_attention.py
// ::_fwd_kernel (launched by _fwd_call). It computes the same function:
//   s = (q . k^T) * sm_scale in f32, keys k_pos >= kv_len and (causal)
//   k_pos > q_pos set to NEG_INF = -1e30 (finite, so a fully masked tile
//   gives exp(0) rather than NaN), an online softmax over K/V tiles with
//   running max m, denominator l over the UNdropped p and an f32
//   accumulator, optional counter-hash dropout that scales only the
//   numerator (p / (1 - rate)), p cast to the input type before the P.V
//   product, o = acc / l written in the input type and lse = m + log l in
//   f32; rows with l == 0 write o = 0 and lse = m.
//
// Design. On the TPU the k axis of the grid runs in order on one core and
// carries m, l and the accumulator in VMEM scratch. Here one CTA owns one
// tile of BLOCK_M = 64 query rows of one (batch*head) and loops over the
// K/V tiles itself, staging each in shared memory; m, l and the
// accumulator stay in registers for the whole loop, so the (sq, sk) score
// matrix never reaches device memory. Four warps each own 16 query rows.
// For bf16 the two products run on the tensor cores through
// mma.sync.m16n8k16 (f32 accumulate), and the score fragment is reused in
// registers as the A operand of P.V; f32 inputs take plain FMA loops so
// they stay exact f32 (the tensor cores would round them to TF32). The
// kernel masks the ragged sq/kv_len edges itself, so nothing is padded in
// the sequence, and causal tiles past the diagonal are never loaded.
//
// Bound. At BERT shapes (d = 64, s <= 512) the arithmetic intensity of the
// whole function is ~s/2 flop per byte, below the H100's ~295 bf16
// flop/byte ridge, so the least time is set by reading q, k, v and writing
// o and lse once. This first version loads tiles synchronously (no
// cp.async/TMA pipeline, no wgmma) and re-reads K/V once per q tile from
// L2; making it approach that bound is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;  // query rows per CTA
constexpr int BLOCK_N = 64;  // keys per K/V tile
constexpr int NUM_WARPS = BLOCK_M / 16;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int N_FRAGS = BLOCK_N / 8;  // 16x8 score fragments per warp
constexpr int P_LD = BLOCK_N + 4;     // f32 P row stride (f32 path)
constexpr float NEG_INF = -1e30f;

// The dropout keep hash, bit for bit the JAX package's _position_keep:
// odd-constant multiplies folded by xor (int32 wrap == uint32 wrap), then
// the murmur3 fmix32 finalizer with logical shifts. The first two
// constants are that code's int32 values -1640531527 and 840146601 as
// uint32 (its comments misname them 0x9E3779B1 and 0x3243F6A9).
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
  for (int i = threadIdx.x; i < 64 * CHUNKS; i += NUM_THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * D + c * VEC);
    *reinterpret_cast<uint4*>(dst + r * LD + c * VEC) = val;
  }
}

// s[nt][c] = q_row . k_col for this warp's 16 rows and the tile's 64 keys,
// in the mma C-fragment layout: c = 0,1 -> row g, cols nt*8 + 2*tig + {0,1};
// c = 2,3 -> row g + 8.
template <int D>
__device__ __forceinline__ void scores(float (&s)[N_FRAGS][4],
                                       const __nv_bfloat16* sQ,
                                       const __nv_bfloat16* sK, int warp,
                                       int g, int tig) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const __nv_bfloat16* qa = sQ + (warp * 16 + g) * LD + kc * 16 + tig * 2;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qa + 8 * LD);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qa + 8);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + 8);
#pragma unroll
    for (int nt = 0; nt < N_FRAGS; ++nt) {
      const __nv_bfloat16* kb = sK + (nt * 8 + g) * LD + kc * 16 + tig * 2;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kb);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kb + 8);
      mma_bf16_16816(s[nt], a0, a1, a2, a3, b0, b1);
    }
  }
}

template <int D>
__device__ __forceinline__ void scores(float (&s)[N_FRAGS][4],
                                       const float* sQ, const float* sK,
                                       int warp, int g, int tig) {
  constexpr int LD = D + 4;
  const float* q0 = sQ + (warp * 16 + g) * LD;
  const float* q1 = q0 + 8 * LD;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float x0 = q0[d], x1 = q1[d];
#pragma unroll
    for (int nt = 0; nt < N_FRAGS; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float kv = sK[(nt * 8 + tig * 2 + j) * LD + d];
        s[nt][j] = fmaf(x0, kv, s[nt][j]);
        s[nt][2 + j] = fmaf(x1, kv, s[nt][2 + j]);
      }
    }
  }
}

// acc += P . V with P (this warp's 16 rows x 64 keys) taken from the
// score fragments; acc[dt] is the C fragment of head-dim columns dt*8..
template <int D>
__device__ __forceinline__ void accumulate_pv(float (&acc)[D / 8][4],
                                              const float (&p)[N_FRAGS][4],
                                              const __nv_bfloat16* sV,
                                              float* /*sP*/, int /*warp*/,
                                              int g, int tig) {
  constexpr int LD = D + 8;
  const unsigned short* v16 = reinterpret_cast<const unsigned short*>(sV);
#pragma unroll
  for (int kc = 0; kc < BLOCK_N / 16; ++kc) {
    // the C layout of two adjacent 16x8 score fragments is the A layout
    // of one 16x16 operand: p is rounded to bf16 here, as the reference
    // casts p to v's dtype before its P.V product
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
  for (int kk = 0; kk < BLOCK_N; ++kk) {
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

template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, float sm_scale,
                     int causal, int use_dropout, uint32_t threshold,
                     float keep_prob, uint32_t seed) {
  constexpr int LD = D + 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BLOCK_M * LD;
  T* sV = sK + BLOCK_N * LD;
  float* sP = reinterpret_cast<float*>(sV + BLOCK_N * LD);

  const int m0 = blockIdx.x * BLOCK_M;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const T* qb = q + (size_t)bh * sq * D;
  const T* kb = k + (size_t)bh * sk * D;
  const T* vb = v + (size_t)bh * sk * D;
  const int qpos[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};

  load_tile<T, D>(sQ, qb, m0, sq);

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};  // this thread's partial row sums

  int n_tiles = (sk + BLOCK_N - 1) / BLOCK_N;
  if (causal)  // a tile is live iff its first key is visible to the last row
    n_tiles = min(n_tiles, (m0 + BLOCK_M - 1) / BLOCK_N + 1);

  for (int tn = 0; tn < n_tiles; ++tn) {
    const int n0 = tn * BLOCK_N;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(sK, kb, n0, sk);
    load_tile<T, D>(sV, vb, n0, sk);
    __syncthreads();

    float s[N_FRAGS][4];
#pragma unroll
    for (int nt = 0; nt < N_FRAGS; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    scores<D>(s, sQ, sK, warp, g, tig);

    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int nt = 0; nt < N_FRAGS; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = n0 + nt * 8 + tig * 2 + (c & 1);
        const int r = c >> 1;
        const bool ok = kpos < sk && (!causal || kpos <= qpos[r]);
        s[nt][c] = ok ? s[nt][c] * sm_scale : NEG_INF;
        mx[r] = fmaxf(mx[r], s[nt][c]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m_i[r] - mx[r]);
      m_i[r] = mx[r];
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < N_FRAGS; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        const float p = expf(s[nt][c] - mx[r]);
        rowsum[r] += p;  // the denominator sums the undropped p
        float pe = p;
        if (use_dropout) {
          const uint32_t kpos = n0 + nt * 8 + tig * 2 + (c & 1);
          const bool keep =
              position_hash(seed, bh, qpos[r], kpos) >= threshold;
          pe = keep ? p / keep_prob : 0.f;
        }
        s[nt][c] = pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + rowsum[r];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    accumulate_pv<D>(acc, s, sV, sP, warp, g, tig);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = (l == 0.f) ? 1.f : l;
    if (qpos[r] >= sq) continue;
    T* orow = o + ((size_t)bh * sq + qpos[r]) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store2(orow + dt * 8 + tig * 2, acc[dt][2 * r] / l_safe,
             acc[dt][2 * r + 1] / l_safe);
    if (tig == 0) lse[(size_t)bh * sq + qpos[r]] = m_i[r] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int sq, int sk, int causal,
                   float sm_scale, int use_dropout, uint32_t threshold,
                   float keep_prob, uint32_t seed, cudaStream_t stream) {
  constexpr int LD = D + 16 / sizeof(T);
  size_t smem = (size_t)(BLOCK_M + 2 * BLOCK_N) * LD * sizeof(T);
  if (sizeof(T) == 4) smem += (size_t)BLOCK_M * P_LD * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  // once per instantiation and device (a racing second set is harmless)
  static unsigned long long smem_set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!((smem_set >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set |= 1ull << dev;
  }
  const dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, bh);
  kernel<<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      sq, sk, sm_scale, causal, use_dropout, threshold, keep_prob, seed);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, sq, d), k/v: (bh, sk, d), o: (bh, sq, d), all contiguous in the
// same type (dtype 0 = float32, 1 = bfloat16); lse: (bh, sq) float32.
// d is 64 or 128. Returns a cudaError_t (0 = launched).
extern "C" int ff_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int bh, int sq, int sk, int head_dim,
                                      int dtype, int causal, float sm_scale,
                                      int use_dropout, unsigned int threshold,
                                      float keep_prob, unsigned int seed,
                                      void* stream) {
  if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FF_LAUNCH(T, D)                                                     \
  return (int)launch<T, D>(q, k, v, o, lse, bh, sq, sk, causal, sm_scale, \
                           use_dropout, threshold, keep_prob, seed, st)
  if (dtype == 1 && head_dim == 64) FF_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) FF_LAUNCH(__nv_bfloat16, 128);
  if (dtype == 0 && head_dim == 64) FF_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) FF_LAUNCH(float, 128);
#undef FF_LAUNCH
  return (int)cudaErrorInvalidValue;
}
