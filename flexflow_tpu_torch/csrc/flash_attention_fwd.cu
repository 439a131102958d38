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
// tile of query rows of one (batch*head) and loops over the K/V tiles
// itself; m, l and the accumulator stay in registers for the whole loop,
// so the (sq, sk) score matrix never reaches device memory. Ragged sq and
// kv_len edges are masked in the kernel (rows past an edge arrive as
// zeros), so nothing is padded in the sequence, and causal tiles past the
// diagonal are never loaded. The type picks the kernel inside the C entry;
// neither is a fallback of the other:
//
//   bf16 (the main path) - flash_fwd_wgmma_kernel, built from
//   hopper_common.cuh. A CTA is one warpgroup owning RB blocks of 64 query
//   rows: RB = 2 (3 CTAs per SM) at d = 64 without dropout once that gives
//   at least two CTAs per SM of the H100's 132 (b8 h12 s512: 384 CTAs, one
//   wave), else RB = 1 (4 CTAs per SM; b8 h12 s128: 192 CTAs). K/V tiles
//   of 64 keys come by TMA (one thread issues a 3-d tensor copy per tile
//   into the 128-byte swizzle, completing on an mbarrier) through a ring of
//   two stages, the next tile's copy issued while this tile's S product
//   runs; no thread spends registers or issue slots on addresses. S = Q.K^T
//   is wgmma with both operands in shared memory (K-major), one commit
//   group per row block, so the softmax of one block overlaps the tensor
//   work of the other; P is rounded to bf16 in registers and is the
//   register A operand of O += P.V, with V read MN-major through the
//   descriptor's transpose bit (no scalar gathers of V). The softmax runs
//   in base 2 (ex2 on the MUFU, log2(e) folded into sm_scale; in unmasked
//   tiles the scale folds into the exponent's FMA); the mask is evaluated
//   only in tiles that cross an edge or the diagonal, and the dropout bits
//   are hashed while the S product runs.
//
//   f32 - flash_fwd_kernel below, the exact FMA path: 64-row tiles, four
//   warps, plain FMA loops, because the tensor cores would round f32
//   operands to TF32.
//
// Bound. At BERT shapes (d = 64, s <= 512) the arithmetic intensity of the
// whole function is ~s/2 flop per byte, below the H100's ~295 bf16
// flop/byte ridge, so the least time is set by reading q, k, v and writing
// o and lse once: 1.89 us at b8 h12 s128 d64 bf16, 7.57 us at s512 (3.35
// TB/s). Inside the kernel the exponentials and the products are the
// limit: one MUFU ex2 per score at 16 per SM per clock and 4*s^2*d flops
// per head at 989 TFLOP/s are each ~6.5 us at s512, and they overlap only
// in part.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace ff_flash;
using namespace ff_hopper;

// ---------------------------------------------------------------------------
// bf16: wgmma with a TMA tile ring
// ---------------------------------------------------------------------------
template <int D, int RB>
struct FwdTiles {
  static constexpr int BM = WG_ROWS * RB;  // query rows per CTA
  static constexpr int BN = 64;            // keys per K/V tile
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  // Q, then rings of two stages (the tile in use, the one in flight) for
  // K and for V
  static constexpr size_t SMEM = SW_ATOM + Q_BYTES + 4 * KV_BYTES;
};

// One tile of the online softmax for one 64-row block. s holds the raw
// scores of this thread's fragment of keys [n0, n0 + 64); on return it
// holds p_eff, m_i and l_i are updated and alpha is the factor that
// rescales the accumulator. m_i is kept in base-2 units (scores times
// sm_scale * log2(e)).
template <bool DROPOUT>
__device__ __forceinline__ void online_softmax(
    float (&s)[8][4], float (&m_i)[2], float (&l_i)[2], float (&alpha)[2],
    int n0, bool edge, const int (&qpos)[2], int tig, int sk, int causal,
    float scale_log2, uint32_t keep, float inv_keep) {
  float mx[2] = {m_i[0], m_i[1]};
  if (edge) {  // scale, mask and take the max in base-2 units
    const float neg_inf2 = NEG_INF * LOG2E;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = n0 + nt * 8 + tig * 2 + (c & 1);
        const bool ok = kpos < sk && (!causal || kpos <= qpos[c >> 1]);
        s[nt][c] = ok ? s[nt][c] * scale_log2 : neg_inf2;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[nt][c]);
      }
    }
  } else {  // no mask: the max of the scaled scores is the scale times the
            // max (or, for a negative scale, the min) of the raw ones, and
            // the scale folds into the exponent's FMA below
    float ex[2] = {s[0][0], s[0][2]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ex[c >> 1] = scale_log2 >= 0.f ? fmaxf(ex[c >> 1], s[nt][c])
                                       : fminf(ex[c >> 1], s[nt][c]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = fmaxf(mx[r], ex[r] * scale_log2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2_approx(m_i[r] - mx[r]);
    m_i[r] = mx[r];
  }
  // p = 2^(x - max): x already scaled on an edge tile, raw otherwise
  const float mul = edge ? 1.f : scale_log2;
  float rowsum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = c >> 1;
      const float p = exp2_approx(fmaf(s[nt][c], mul, -mx[r]));
      rowsum[r] += p;  // the denominator sums the undropped p
      if (DROPOUT) s[nt][c] = (keep >> (4 * nt + c)) & 1u ? p * inv_keep : 0.f;
      else s[nt][c] = p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + rowsum[r];
}

template <int D, int RB, int MIN_CTAS, bool DROPOUT>
__global__ void __launch_bounds__(WG_THREADS, MIN_CTAS)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o,
                           float* __restrict__ lse, int sq, int sk,
                           float sm_scale, int causal, uint32_t threshold,
                           float keep_prob, uint32_t seed) {
  using Tl = FwdTiles<D, RB>;
  constexpr int BM = Tl::BM, BN = Tl::BN;
  extern __shared__ unsigned char smem[];
  const uint32_t sQ = (smem_u32(smem) + SW_ATOM - 1) & ~(uint32_t)(SW_ATOM - 1);
  const uint32_t sKs = sQ + Tl::Q_BYTES;        // K ring
  const uint32_t sVs = sKs + 2 * Tl::KV_BYTES;  // V ring
  // per stage: the K tile (and, first, Q) landed; the V tile landed
  __shared__ __align__(8) uint64_t k_full[2], v_full[2];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  // row block rb: this warp's first row, and this thread's two rows
  int row_w[RB], qpos[RB][2];
#pragma unroll
  for (int rb = 0; rb < RB; ++rb) {
    row_w[rb] = m0 + rb * WG_ROWS + warp * 16;
    qpos[rb][0] = row_w[rb] + g;
    qpos[rb][1] = row_w[rb] + g + 8;
  }
  const float scale_log2 = sm_scale * LOG2E;
  const float inv_keep = 1.f / keep_prob;

  int n_tiles = (sk + BN - 1) / BN;
  if (causal)  // a tile is live iff its first key is visible to the last row
    n_tiles = min(n_tiles, (m0 + BM - 1) / BN + 1);

  auto k_stage = [&](int t) { return sKs + (t & 1) * Tl::KV_BYTES; };
  auto v_stage = [&](int t) { return sVs + (t & 1) * Tl::KV_BYTES; };
  auto k_bar = [&](int t) { return smem_u32(&k_full[t & 1]); };
  auto v_bar = [&](int t) { return smem_u32(&v_full[t & 1]); };
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto load_kv = [&](int t, int extra_bytes) {  // by thread 0
    mbar_expect_tx(k_bar(t), Tl::KV_BYTES + extra_bytes);
    tma_load_tile<BN, D>(k_stage(t), map_k, k_bar(t), t * BN, bh);
    mbar_expect_tx(v_bar(t), Tl::KV_BYTES);
    tma_load_tile<BN, D>(v_stage(t), map_v, v_bar(t), t * BN, bh);
  };

  // the ring: Q with K/V tile 0; then, after the barrier that frees its
  // stage, each iteration starts the copy of K/V tile t + 1. K and V
  // complete on separate barriers, so S starts before V has landed.
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      mbar_init(k_bar(st), 1);
      mbar_init(v_bar(st), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_kv(0, Tl::Q_BYTES);  // Q joins K tile 0's phase
    tma_load_tile<BM, D>(sQ, &tm_q, k_bar(0), m0, bh);
  }

  float acc[RB][D / 8][4];
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      acc[rb][dt][0] = acc[rb][dt][1] = acc[rb][dt][2] = acc[rb][dt][3] = 0.f;
  float m_i[RB][2], l_i[RB][2];  // running max (base 2), partial row sums
#pragma unroll
  for (int rb = 0; rb < RB; ++rb) {
    m_i[rb][0] = m_i[rb][1] = NEG_INF * LOG2E;
    l_i[rb][0] = l_i[rb][1] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(k_bar(t), (t >> 1) & 1);  // K tile t (and Q) have landed
    __syncthreads();  // every warp is done with the stage the next copy
                      // overwrites

    // S = Q . K^T of each row block (both operands K-major in shared
    // memory), one commit group each, so the softmax of one row block runs
    // while the tensor cores work on the next block's S or the previous
    // block's P.V
    const int n0 = t * BN;
    const uint32_t sK = k_stage(t), sV = v_stage(t);
    float s[RB][8][4];
    wgmma_fence();
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t a = sQ + (kc >> 2) * (BM * SW_ROW) +
                           rb * (WG_ROWS * SW_ROW) + (kc & 3) * 32;
        const uint32_t b = sK + (kc >> 2) * (BN * SW_ROW) + (kc & 3) * 32;
        wgmma_ss_m64n64k16(acc_block(s[rb], 0), desc_sw128(a, 16),
                           desc_sw128(b, 16), kc > 0);
      }
      wgmma_commit();
    }
    if (tid == 0 && t + 1 < n_tiles) load_kv(t + 1, 0);  // while S runs
    uint32_t keep[RB];  // the dropout mask, hashed while the products run
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
      keep[rb] = DROPOUT ? keep_bits(n0, qpos[rb], tig, bh, seed, threshold)
                         : 0u;

    mbar_wait(v_bar(t), (t >> 1) & 1);  // V tile t has landed
    uint32_t pa[RB][4][4];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      // groups complete in order: S of this block is done once at most
      // RB - 1 later groups (S of later blocks, P.V of earlier ones) are
      // in flight
      wgmma_wait<RB - 1>();
      fence_regs(acc_block(s[rb], 0));
      const bool edge =
          n0 + BN > sk || (causal && n0 + BN - 1 > row_w[rb]);
      float alpha[2];
      online_softmax<DROPOUT>(s[rb], m_i[rb], l_i[rb], alpha, n0, edge,
                              qpos[rb], tig, sk, causal, scale_log2,
                              keep[rb], inv_keep);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[rb][dt][0] *= alpha[0];
        acc[rb][dt][1] *= alpha[0];
        acc[rb][dt][2] *= alpha[1];
        acc[rb][dt][3] *= alpha[1];
      }
      to_a_frags(s[rb], pa[rb]);  // p_eff rounded to bf16
      // O += P . V: P in registers, V read MN-major
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < D / 64; ++h) {
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          const uint32_t b = sV + h * (BN * SW_ROW) + kc * 2 * SW_ATOM;
          wgmma_rs_m64n64k16<1>(acc_block(acc[rb], h), pa[rb][kc],
                                desc_sw128(b, BN * SW_ROW), 1);
        }
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      fence_regs_u32(pa[rb]);
#pragma unroll
      for (int h = 0; h < D / 64; ++h) fence_regs(acc_block(acc[rb], h));
    }
  }

  // o = acc / l, staged in bf16 in Q's tile (Q is no longer read) in the
  // swizzled layout and stored by one TMA copy, which clips rows past sq
#pragma unroll
  for (int rb = 0; rb < RB; ++rb) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[rb][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float l_safe = (l == 0.f) ? 1.f : l;
      const float inv_l = 1.f / l_safe;
      const int row = rb * WG_ROWS + warp * 16 + g + 8 * r;  // in the tile
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        __nv_bfloat162 v2 = __floats2bfloat162_rn(
            acc[rb][dt][2 * r] * inv_l, acc[rb][dt][2 * r + 1] * inv_l);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         sQ + sw128_offset<BM>(row, dt) + tig * 4),
                     "r"(*reinterpret_cast<uint32_t*>(&v2))
                     : "memory");
      }
      if (tig == 0 && qpos[rb][r] < sq)
        lse[(size_t)bh * sq + qpos[rb][r]] = m_i[rb][r] * LN2 + logf(l_safe);
    }
  }
  fence_proxy_async();  // the staged tile, visible to the TMA store
  __syncthreads();
  if (tid == 0) {
    tma_store_tile<BM, D>(&tm_o, sQ, m0, bh);
    tma_store_wait();  // the CTA's shared memory outlives the copy
  }
}

template <int D, int RB, int MIN_CTAS, bool DROPOUT>
cudaError_t launch_wgmma_t(const void* q, const void* k, const void* v,
                           void* o, void* lse, int bh, int sq, int sk,
                           int causal, float sm_scale, uint32_t threshold,
                           float keep_prob, uint32_t seed,
                           cudaStream_t stream) {
  using Tl = FwdTiles<D, RB>;
  auto kernel = flash_fwd_wgmma_kernel<D, RB, MIN_CTAS, DROPOUT>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  cudaError_t err = allow_smem(kernel, Tl::SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if ((err = tensor_map_bf16(&tm_q, q, bh, sq, D, Tl::BM)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_k, k, bh, sk, D, Tl::BN)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_v, v, bh, sk, D, Tl::BN)) != cudaSuccess ||
      (err = tensor_map_bf16(&tm_o, o, bh, sq, D, Tl::BM)) != cudaSuccess)
    return err;
  const dim3 grid((sq + Tl::BM - 1) / Tl::BM, bh);
  kernel<<<grid, WG_THREADS, Tl::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<float*>(lse), sq, sk, sm_scale,
      causal, threshold, keep_prob, seed);
  return cudaGetLastError();
}

// MIN_CTAS: the CTAs per SM the registers must allow (4 x 128 threads at
// one row block and d = 64, 3 at two; d = 128 holds twice the accumulator)
template <int D, int RB, int MIN_CTAS>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int sq, int sk,
                         int causal, float sm_scale, int use_dropout,
                         uint32_t threshold, float keep_prob, uint32_t seed,
                         cudaStream_t stream) {
  return use_dropout
             ? launch_wgmma_t<D, RB, MIN_CTAS, true>(
                   q, k, v, o, lse, bh, sq, sk, causal, sm_scale, threshold,
                   keep_prob, seed, stream)
             : launch_wgmma_t<D, RB, MIN_CTAS, false>(
                   q, k, v, o, lse, bh, sq, sk, causal, sm_scale, threshold,
                   keep_prob, seed, stream);
}

// ---------------------------------------------------------------------------
// f32: the exact FMA path
// ---------------------------------------------------------------------------
constexpr int BLOCK_M = TILE;  // query rows per CTA
constexpr int BLOCK_N = TILE;  // keys per K/V tile

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, float sm_scale,
                     int causal, int use_dropout, uint32_t threshold,
                     float keep_prob, uint32_t seed) {
  constexpr int LD = D + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + BLOCK_M * LD;
  float* sV = sK + BLOCK_N * LD;
  float* sP = sV + BLOCK_N * LD;

  const int m0 = blockIdx.x * BLOCK_M;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const float* qb = q + (size_t)bh * sq * D;
  const float* kb = k + (size_t)bh * sk * D;
  const float* vb = v + (size_t)bh * sk * D;
  const int qpos[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};

  load_tile<D>(sQ, qb, m0, sq);

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
    load_tile<D>(sK, kb, n0, sk);
    load_tile<D>(sV, vb, n0, sk);
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
    float* orow = o + ((size_t)bh * sq + qpos[r]) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store2(orow + dt * 8 + tig * 2, acc[dt][2 * r] / l_safe,
             acc[dt][2 * r + 1] / l_safe);
    if (tig == 0) lse[(size_t)bh * sq + qpos[r]] = m_i[r] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int sq, int sk, int causal,
                   float sm_scale, int use_dropout, uint32_t threshold,
                   float keep_prob, uint32_t seed, cudaStream_t stream) {
  const size_t smem = ((size_t)(BLOCK_M + 2 * BLOCK_N) * (D + 4) +
                       (size_t)BLOCK_M * P_LD) * sizeof(float);
  auto kernel = flash_fwd_kernel<D>;
  static unsigned long long smem_set = 0;  // per instantiation and device
  cudaError_t err = allow_smem(kernel, smem, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, bh);
  kernel<<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), sq, sk, sm_scale, causal, use_dropout,
      threshold, keep_prob, seed);
  return cudaGetLastError();
}

// Two row blocks per CTA once that still gives two CTAs per SM of an H100
// (132 SMs); the dropout hash leaves no registers for a second block.
constexpr long long TWO_BLOCK_MIN_CTAS = 2 * 132;

}  // namespace

// q: (bh, sq, d), k/v: (bh, sk, d), o: (bh, sq, d), all contiguous in the
// same type (dtype 0 = float32, 1 = bfloat16); lse: (bh, sq) float32.
// d is 64 or 128. bf16 launches the wgmma kernel, f32 the FMA kernel.
// Returns a cudaError_t (0 = launched).
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
  const bool two_blocks =
      !use_dropout &&
      (long long)((sq + 127) / 128) * bh >= TWO_BLOCK_MIN_CTAS;
#define FF_LAUNCH(KERNEL)                                                  \
  return (int)KERNEL(q, k, v, o, lse, bh, sq, sk, causal, sm_scale,      \
                     use_dropout, threshold, keep_prob, seed, st)
  if (dtype == 1 && head_dim == 64 && two_blocks)  // never with dropout
    return (int)launch_wgmma_t<64, 2, 3, false>(q, k, v, o, lse, bh, sq, sk,
                                                causal, sm_scale, threshold,
                                                keep_prob, seed, st);
  if (dtype == 1 && head_dim == 64) FF_LAUNCH((launch_wgmma<64, 1, 4>));
  if (dtype == 1 && head_dim == 128) FF_LAUNCH((launch_wgmma<128, 1, 2>));
  if (dtype == 0 && head_dim == 64) FF_LAUNCH((launch<64>));
  if (dtype == 0 && head_dim == 128) FF_LAUNCH((launch<128>));
#undef FF_LAUNCH
  return (int)cudaErrorInvalidValue;
}
